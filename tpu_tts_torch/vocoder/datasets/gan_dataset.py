"""GAN vocoder dataset: random (mel segment, waveform segment) pairs.

Counterpart of `tpu_tts/vocoder/datasets/gan_dataset.py` (`GANDataset`:17,
`GANDataLoader`:102): each clip padded to `seq_len + pad_short`, a random
`seq_len` window of it (the first in eval), its mel cut to `seq_len / hop`
frames, and with `use_noise_augment` N(0, 1)/32768 added to the waveform
after the mel is taken; `use_cache` keeps each loaded clip; `return_pairs`
draws a second window for G. A batch is `mel_input` `[B, seq_len / hop, C]`
and `waveform` `[B, seq_len, 1]`, float32 tensors.

Two divergences (ROADMAP.md, queue 3): `tpu_tts` draws every window and
noise from one generator shared under a lock, so with loader workers its
draws depend on thread timing; the port draws an item's from a generator
seeded with (seed, epoch, item), so a run repeats and a resumed epoch draws
what the uninterrupted one did. And the loader seeds each epoch's shuffle
from (seed, epoch), `set_epoch` as the port's other loaders have it.
"""

from typing import Dict, List

import numpy as np
import torch

from tpu_tts_torch.data import prefetch_batches


class GANDataset:
    def __init__(self, ap, items: List, seq_len: int, hop_len: int, pad_short: int = 0, conv_pad: int = 2,
                 return_pairs: bool = False, is_training: bool = True, use_noise_augment: bool = False,
                 use_cache: bool = False, seed: int = 0):
        assert seq_len % hop_len == 0, " [!] seq_len must be a multiple of hop_len."
        self.ap = ap
        self.items = items
        self.seq_len = seq_len
        self.hop_len = hop_len
        self.pad_short = pad_short
        self.conv_pad = conv_pad
        self.return_pairs = return_pairs
        self.is_training = is_training
        self.use_noise_augment = use_noise_augment
        self.use_cache = use_cache
        self.seed = seed
        self.epoch = 0
        self._cache: Dict[int, np.ndarray] = {}

    def __len__(self):
        return len(self.items)

    def item_rng(self, idx: int) -> np.random.Generator:
        """The generator of item `idx`'s draws this epoch."""
        return np.random.default_rng([self.seed, self.epoch, idx])

    def _load_wav(self, idx: int) -> np.ndarray:
        if self.use_cache and idx in self._cache:
            return self._cache[idx]
        path = self.items[idx][0] if isinstance(self.items[idx], (list, tuple)) else self.items[idx]
        wav = np.asarray(self.ap.load_wav(path), dtype=np.float32)
        if len(wav) < self.seq_len + self.pad_short:
            wav = np.pad(wav, (0, self.seq_len + self.pad_short - len(wav)))
        if self.use_cache:
            self._cache[idx] = wav
        return wav

    def _sample_segment(self, wav: np.ndarray, rng: np.random.Generator):
        start = int(rng.integers(0, max(len(wav) - self.seq_len - 1, 1))) if self.is_training else 0
        seg = wav[start: start + self.seq_len]
        mel = self.ap.melspectrogram(seg).astype(np.float32).T[: self.seq_len // self.hop_len]  # [T, C]
        if self.use_noise_augment:
            seg = seg + (1.0 / 32768.0) * rng.standard_normal(len(seg)).astype(np.float32)
        return mel, seg.astype(np.float32)

    def __getitem__(self, idx: int) -> Dict:
        wav = self._load_wav(idx)
        rng = self.item_rng(idx)
        mel, seg = self._sample_segment(wav, rng)
        item = {"mel": mel, "waveform": seg}
        if self.return_pairs:
            item["mel_G"], item["waveform_G"] = self._sample_segment(wav, rng)
        return item

    def collate(self, batch: List[Dict]) -> Dict:
        T_mel = min(b["mel"].shape[0] for b in batch)
        out = {"mel_input": np.stack([b["mel"][:T_mel] for b in batch]),
               "waveform": np.stack([b["waveform"] for b in batch])[:, :, None]}
        if self.return_pairs:
            out["mel_input_G"] = np.stack([b["mel_G"][:T_mel] for b in batch])
            out["waveform_G"] = np.stack([b["waveform_G"] for b in batch])[:, :, None]
        return {k: torch.from_numpy(v) for k, v in out.items()}


class GANDataLoader:
    """Batches of a GANDataset, shuffled per epoch, `num_workers` threads
    building them ahead."""

    def __init__(self, dataset: GANDataset, batch_size: int, shuffle: bool = True, drop_last: bool = True,
                 seed: int = 0, num_workers: int = 0):
        self.dataset = dataset
        self.batch_size = batch_size
        self.shuffle = shuffle
        self.drop_last = drop_last
        self.seed = seed
        self.num_workers = int(num_workers or 0)
        self.epoch = 0

    def set_epoch(self, epoch: int):
        """The epoch whose shuffle and draws the next iteration takes."""
        self.epoch = int(epoch)

    def __len__(self):
        n = len(self.dataset)
        return n // self.batch_size if self.drop_last else int(np.ceil(n / self.batch_size))

    def __iter__(self):
        self.dataset.epoch = self.epoch
        idxs = np.arange(len(self.dataset))
        if self.shuffle:
            np.random.default_rng([self.seed, self.epoch]).shuffle(idxs)
        chunks = [idxs[s: s + self.batch_size] for s in range(0, len(idxs), self.batch_size)]
        if self.drop_last and chunks and len(chunks[-1]) < self.batch_size:
            chunks = chunks[:-1]
        yield from prefetch_batches(lambda chunk: self.dataset.collate([self.dataset[int(i)] for i in chunk]),
                                    chunks, self.num_workers)
