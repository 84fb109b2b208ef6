"""TTSDataset and its loader: host-side featurization and bucketed batches.

Counterpart of `tpu_tts/data/dataset.py` (`TTSDataset`:63, `collate_fn`:245,
`TTSDataLoader`:344). The collate pads to shape buckets (the next multiple
of `text_bucket` / `mel_bucket`), as the JAX one does, and returns CPU
tensors; the trainer moves each batch to its device. The waveform is
`[B, 1, T_mel · hop]`, channels-first. With the managers' maps the collate
adds per-row `speaker_ids`, `d_vectors` (each speaker's first d-vector) and
`language_ids` (`:330-340`); with sample `weights` (the speaker, language
and length balancers) the loader draws each epoch's items with replacement
in proportion to them, from the epoch's seeded generator, and sorts them
so that batches keep the length sorting. With `compute_f0` each item
carries its pyin F0 (`ap.compute_f0`, cached as .npy under `f0_cache_path`)
and the collate a `pitch` `[B, T_mel]` (`:321-328`); with `compute_energy`
each item its per-frame spectral norm (`ap.compute_energy`, `:170-172`,
cached under `energy_cache_path`) and the collate an `energy` `[B, T_mel]`;
with `use_attn_prior` an `attn_priors` `[B, T_mel, T_text]` of each row's
beta-binomial prior on its token and mel counts (`:307-319`, cached under
`attn_prior_cache_path`). The linear spectrograms of the other acoustic
models come with them (ROADMAP.md, M9b); VITS computes its spectrograms on
the device.

One divergence: the loader seeds each epoch's shuffle from (seed, epoch),
`set_epoch` as torch's samplers have it, where the JAX loader carries one
generator across epochs; so a run resumed at an epoch sees the batches the
uninterrupted run saw.
"""

import os
import threading
from typing import Dict, List, Optional

import numpy as np
import torch

from tpu_tts_torch.data import get_audio_size, prefetch_batches
from tpu_tts_torch.ops.helpers import compute_attn_prior


def _bucket(n: int, step: int) -> int:
    return int(np.ceil(max(n, 1) / step)) * step


def noise_augment_audio(wav):
    return wav + (1.0 / 32768.0) * np.random.rand(*wav.shape)


def string2filename(string: str) -> str:
    import base64

    return base64.urlsafe_b64encode(string.encode("utf-8")).decode("utf8", "ignore")


class FeatureCache:
    """Compute-or-load per-clip features cached as .npy."""

    def __init__(self, cache_path: Optional[str], suffix: str):
        self.cache_path = cache_path
        self.suffix = suffix
        if cache_path:
            os.makedirs(cache_path, exist_ok=True)

    def get(self, key: str, compute_fn):
        if not self.cache_path:
            return compute_fn()
        path = os.path.join(self.cache_path, string2filename(key) + self.suffix)
        if os.path.exists(path):
            try:
                return np.load(path, allow_pickle=False)
            except (OSError, ValueError):
                pass
        value = compute_fn()
        # atomic publish: loader threads may share the cache dir, and a reader
        # must never see a half-written .npy
        tmp = path + f".tmp{os.getpid()}-{threading.get_ident()}"
        with open(tmp, "wb") as f:
            np.save(f, value, allow_pickle=False)
        os.replace(tmp, path)
        return value


class TTSDataset:
    def __init__(
        self,
        outputs_per_step: int = 1,
        ap=None,
        samples: Optional[List[Dict]] = None,
        tokenizer=None,
        return_wav: bool = False,
        compute_f0: bool = False,
        f0_cache_path: Optional[str] = None,
        compute_energy: bool = False,
        energy_cache_path: Optional[str] = None,
        use_attn_prior: bool = False,
        attn_prior_cache_path: Optional[str] = None,
        batch_group_size: int = 0,
        min_text_len: int = 0,
        max_text_len: float = float("inf"),
        min_audio_len: int = 0,
        max_audio_len: float = float("inf"),
        phoneme_cache_path: Optional[str] = None,
        use_noise_augment: bool = False,
        start_by_longest: bool = False,
        text_bucket: int = 32,
        mel_bucket: int = 64,
        verbose: bool = False,
        speaker_id_mapping: Optional[Dict] = None,
        d_vector_mapping: Optional[Dict] = None,
        language_id_mapping: Optional[Dict] = None,
    ):
        self.samples = samples or []
        self.outputs_per_step = outputs_per_step
        self.return_wav = return_wav
        self.compute_f0 = compute_f0
        self.compute_energy = compute_energy
        self.use_attn_prior = use_attn_prior
        self.batch_group_size = batch_group_size
        self.min_audio_len = min_audio_len
        self.max_audio_len = max_audio_len
        self.min_text_len = min_text_len
        self.max_text_len = max_text_len
        self.ap = ap
        self.tokenizer = tokenizer
        self.use_noise_augment = use_noise_augment
        self.start_by_longest = start_by_longest
        self.text_bucket = text_bucket
        self.mel_bucket = max(mel_bucket, outputs_per_step)
        self.verbose = verbose
        self.speaker_id_mapping = speaker_id_mapping
        self.d_vector_mapping = d_vector_mapping
        self.language_id_mapping = language_id_mapping
        self.rescue_item_idx = 1
        self.phoneme_cache = FeatureCache(phoneme_cache_path, "_phoneme.npy")
        self.f0_cache = FeatureCache(f0_cache_path, "_f0.npy")
        self.energy_cache = FeatureCache(energy_cache_path, "_energy.npy")
        self.attn_prior_cache = FeatureCache(attn_prior_cache_path, "_attn_prior.npy")
        self._token_cache: Dict[int, np.ndarray] = {}

    def __len__(self):
        return len(self.samples)

    def get_token_ids(self, idx: int, text: str) -> np.ndarray:
        if idx in self._token_cache:
            return self._token_cache[idx]
        language = self.samples[idx].get("language") or None

        def compute():
            return np.asarray(self.tokenizer.text_to_ids(text, language=language), dtype=np.int32)

        if self.tokenizer.use_phonemes and self.phoneme_cache.cache_path:
            ids = self.phoneme_cache.get(self.samples[idx]["audio_unique_name"], compute)
        else:
            ids = compute()
        ids = np.asarray(ids, dtype=np.int32)
        self._token_cache[idx] = ids
        return ids

    def load_item(self, idx: int) -> Dict:
        item = self.samples[idx]
        wav = np.asarray(self.ap.load_wav(item["audio_file"]), dtype=np.float32)
        if len(wav) == 0:
            return self.load_item(self.rescue_item_idx)
        if self.use_noise_augment:
            wav = noise_augment_audio(wav)
        f0 = None
        if self.compute_f0:
            f0 = self.f0_cache.get(item["audio_unique_name"], lambda: self.ap.compute_f0(wav).astype(np.float32))
        energy = None
        if self.compute_energy:
            energy = self.energy_cache.get(item["audio_unique_name"],
                                           lambda: self.ap.compute_energy(wav).astype(np.float32))
        return {
            "raw_text": item["text"],
            "token_ids": self.get_token_ids(idx, item["text"]),
            "wav": wav,
            "pitch": f0,
            "energy": energy,
            "item_idx": item["audio_file"],
            "speaker_name": item.get("speaker_name"),
            "language_name": item.get("language"),
            "wav_file_name": os.path.basename(item["audio_file"]),
            "audio_unique_name": item["audio_unique_name"],
        }

    def __getitem__(self, idx):
        return self.load_item(idx)

    def preprocess_samples(self):
        """Length-filter and sort the samples by audio length."""
        new_samples = []
        lengths = []
        for item in self.samples:
            try:
                audio_len = get_audio_size(item["audio_file"])
            except (OSError, ValueError):
                continue
            text_len = len(item["text"])
            if (
                self.min_text_len <= text_len <= self.max_text_len
                and self.min_audio_len <= audio_len <= self.max_audio_len
            ):
                new_samples.append(item)
                lengths.append(audio_len)
        if not new_samples:
            raise RuntimeError(" [!] No samples left after filtering by length.")
        order = np.argsort(lengths)
        if self.start_by_longest:
            order = order[::-1]
        self.samples = [new_samples[i] for i in order]
        if self.verbose:
            print(f" | > Preprocessed {len(self.samples)} samples.")

    def collate_fn(self, batch: List[Dict]) -> Dict:
        """Pad to bucketed shapes; the keys of the JAX collate (Coqui's
        `format_batch` names): text_input, text_lengths, mel_input,
        mel_lengths, stop_targets, with `return_wav` waveform
        `[B, 1, T_mel · hop]` and waveform_lengths, with `use_attn_prior`
        attn_priors, with `compute_f0` pitch and with `compute_energy` energy."""
        B = len(batch)
        token_lens = np.array([len(d["token_ids"]) for d in batch], dtype=np.int32)
        mels = [self.ap.melspectrogram(d["wav"]).astype(np.float32).T for d in batch]  # [T, C]
        mel_lens = np.array([m.shape[0] for m in mels], dtype=np.int32)

        T_text = _bucket(int(token_lens.max()), self.text_bucket)
        T_mel = _bucket(int(mel_lens.max()), self.mel_bucket)
        r = self.outputs_per_step
        if T_mel % r != 0:
            T_mel += r - T_mel % r

        text_input = np.zeros((B, T_text), dtype=np.int64)
        mel_input = np.zeros((B, T_mel, mels[0].shape[1]), dtype=np.float32)
        stop_targets = np.zeros((B, T_mel // r), dtype=np.float32)
        for i, d in enumerate(batch):
            text_input[i, : token_lens[i]] = d["token_ids"]
            mel_input[i, : mel_lens[i]] = mels[i]
            stop_targets[i, (mel_lens[i] - 1) // r :] = 1.0

        out = {
            "text_input": torch.from_numpy(text_input),
            "text_lengths": torch.from_numpy(token_lens.astype(np.int64)),
            "mel_input": torch.from_numpy(mel_input),
            "mel_lengths": torch.from_numpy(mel_lens.astype(np.int64)),
            "stop_targets": torch.from_numpy(stop_targets),
            "item_idxs": [d["item_idx"] for d in batch],
            "speaker_names": [d["speaker_name"] for d in batch],
            "raw_text": [d["raw_text"] for d in batch],
            "audio_unique_names": [d["audio_unique_name"] for d in batch],
        }

        if self.return_wav:
            wav_lens = np.array([len(d["wav"]) for d in batch], dtype=np.int64)
            T_wav = T_mel * self.ap.hop_length
            waveform = np.zeros((B, 1, T_wav), dtype=np.float32)
            for i, d in enumerate(batch):
                w = d["wav"][:T_wav]
                waveform[i, 0, : len(w)] = w
            out["waveform"] = torch.from_numpy(waveform)
            out["waveform_lengths"] = torch.from_numpy(np.minimum(wav_lens, T_wav))
        if self.use_attn_prior:
            priors = np.zeros((B, T_mel, T_text), dtype=np.float32)
            for i, d in enumerate(batch):
                pr = self.attn_prior_cache.get(d["audio_unique_name"], lambda: compute_attn_prior(
                    int(token_lens[i]), int(mel_lens[i])).astype(np.float32))
                priors[i, : pr.shape[0], : pr.shape[1]] = pr[:T_mel, :T_text]
            out["attn_priors"] = torch.from_numpy(priors)
        for key in ("pitch", "energy"):
            if batch[0].get(key) is not None:
                arr = np.zeros((B, T_mel), dtype=np.float32)
                for i, d in enumerate(batch):
                    f = d[key][:T_mel]
                    arr[i, : len(f)] = f
                out[key] = torch.from_numpy(arr)
        if self.speaker_id_mapping:
            out["speaker_ids"] = torch.tensor([self.speaker_id_mapping[d["speaker_name"]] for d in batch])
        if self.d_vector_mapping:
            out["d_vectors"] = torch.from_numpy(np.array(
                [np.asarray(self.d_vector_mapping[d["speaker_name"]][0], dtype=np.float32) for d in batch]))
        if self.language_id_mapping:
            out["language_ids"] = torch.tensor([self.language_id_mapping[d["language_name"]] for d in batch])
        return out


class TTSDataLoader:
    """Batches of a TTSDataset: length-sorted batches (shuffled inside groups
    of `batch_group_size`), the batch order shuffled, each batch collated on
    the host, `num_workers` threads building batches ahead."""

    def __init__(self, dataset: TTSDataset, batch_size: int, shuffle: bool = True, drop_last: bool = True,
                 seed: int = 0, num_workers: int = 0, weights: Optional[np.ndarray] = None):
        self.dataset = dataset
        self.weights = None if weights is None else np.asarray(weights, dtype=np.float64) / np.sum(weights)
        self.batch_size = batch_size
        self.shuffle = shuffle
        self.drop_last = drop_last
        self.seed = seed
        self.num_workers = int(num_workers or 0)
        self.epoch = 0

    def set_epoch(self, epoch: int):
        """The epoch whose shuffle the next iteration takes."""
        self.epoch = int(epoch)

    def __len__(self):
        n = len(self.dataset)
        if self.drop_last:
            return n // self.batch_size
        return int(np.ceil(n / self.batch_size))

    def _batch_indices(self) -> List[List[int]]:
        rng = np.random.default_rng([self.seed, self.epoch])
        n = len(self.dataset)
        if self.weights is not None:
            idxs = sorted(int(i) for i in rng.choice(n, size=n, replace=True, p=self.weights))
        else:
            idxs = list(range(n))
        # group-local shuffle that keeps the length sorting
        if self.shuffle and self.dataset.batch_group_size > 0:
            g = self.dataset.batch_group_size
            for s in range(0, len(idxs), g):
                chunk = idxs[s : s + g]
                rng.shuffle(chunk)
                idxs[s : s + g] = chunk
        batches = [idxs[i : i + self.batch_size] for i in range(0, len(idxs), self.batch_size)]
        if self.drop_last and batches and len(batches[-1]) < self.batch_size:
            batches = batches[:-1]
        if self.shuffle:
            rng.shuffle(batches)
        return batches

    def _make_batch(self, batch_idx):
        return self.dataset.collate_fn([self.dataset[i] for i in batch_idx])

    def __iter__(self):
        yield from prefetch_batches(self._make_batch, self._batch_indices(), self.num_workers)
