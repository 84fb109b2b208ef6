"""XTTS GPT fine-tuning dataset and loader.

Counterpart of `tpu_tts/layers/xtts/dataset.py` (`get_prompt_slice`:22,
`XttsDataset`:38, `XttsDataLoader`:116), which mirrors Coqui's
`XTTSDataset`: tokenised text, the target wav and a random conditioning
slice per item. Every batch is padded to the same shapes
(`max_text_length` tokens, `max_wav_length` samples,
`max_conditioning_length` samples) with the true lengths beside them; the
mels and DVAE codes are computed on the device inside the loss. The
tokenizer is anything with `encode(text, lang)`.

Two divergences (ROADMAP.md, queue 3): the loader seeds each epoch's
shuffle from (seed, epoch), as `TTSDataLoader.set_epoch` does; and an
item's conditioning slice is drawn from a generator seeded from (seed,
epoch, item), where JAX draws every item from one generator in the order
the items are read. So a slice depends neither on the loader threads'
order nor on where a run was resumed. `get_prompt_slice` itself is JAX's.
The JAX loader's per-process sharding comes with M10.
"""

import random
from typing import Dict, List, Optional

import numpy as np
import torch

from tpu_tts_torch.audio.numpy_transforms import load_wav
from tpu_tts_torch.data import prefetch_batches


def get_prompt_slice(wav: np.ndarray, max_len: int, min_len: int, rng: random.Random,
                     is_eval: bool = False) -> np.ndarray:
    """A uniform length in [min_len, max_len] at a uniform offset; in eval,
    the middle slice of at most `max_len`."""
    if is_eval:
        n = min(len(wav), max_len)
        lo = max(0, (len(wav) - n) // 2)
        return wav[lo : lo + n]
    n = min(len(wav), rng.randint(min_len, max_len))
    lo = rng.randint(0, max(0, len(wav) - n))
    return wav[lo : lo + n]


class XttsDataset:
    """Sample dicts {text, audio_file, language} → fixed-shape training items."""

    def __init__(self, samples: List[Dict], tokenizer, sample_rate: int, max_text_length: int = 200,
                 max_wav_length: int = 255995, min_conditioning_length: int = 66150,
                 max_conditioning_length: int = 132300, is_eval: bool = False, seed: int = 0):
        self.tokenizer = tokenizer
        self.sample_rate = sample_rate
        self.max_text_length = max_text_length
        self.max_wav_length = max_wav_length
        self.min_cond = min_conditioning_length
        self.max_cond = max_conditioning_length
        self.is_eval = is_eval
        self.seed = seed
        self.epoch = 0
        self.samples = [s for s in samples if s.get("text") and s.get("audio_file")]

    def __len__(self):
        return len(self.samples)

    def item_rng(self, idx: int) -> random.Random:
        """The generator of item `idx`'s conditioning slice in this epoch."""
        return random.Random(f"{self.seed}:{self.epoch}:{idx}")

    def __getitem__(self, idx) -> Optional[Dict]:
        s = self.samples[idx]
        ids = np.asarray(self.tokenizer.encode(s["text"], s.get("language") or "en"), dtype=np.int64)
        wav = load_wav(filename=s["audio_file"], sample_rate=self.sample_rate, resample=False)
        # the JAX loader truncates an overrun where Coqui's draws another item
        ids = ids[: self.max_text_length]
        wav = wav[: self.max_wav_length]
        cond = get_prompt_slice(wav, self.max_cond, min(self.min_cond, len(wav)), self.item_rng(idx), self.is_eval)
        return {"text_tokens": ids, "text_length": len(ids), "wav": wav.astype(np.float32), "wav_length": len(wav),
                "cond_wav": cond.astype(np.float32), "cond_length": len(cond)}

    def collate(self, items: List[Dict]) -> Dict[str, torch.Tensor]:
        B = len(items)
        text = np.zeros((B, self.max_text_length), dtype=np.int64)
        wav = np.zeros((B, self.max_wav_length), dtype=np.float32)
        cond = np.zeros((B, self.max_cond), dtype=np.float32)
        lengths = np.zeros((3, B), dtype=np.int64)
        for i, it in enumerate(items):
            text[i, : it["text_length"]] = it["text_tokens"]
            wav[i, : it["wav_length"]] = it["wav"]
            cond[i, : it["cond_length"]] = it["cond_wav"]
            lengths[:, i] = it["text_length"], it["wav_length"], it["cond_length"]
        return {"text_tokens": torch.from_numpy(text), "text_lengths": torch.from_numpy(lengths[0]),
                "wav": torch.from_numpy(wav), "wav_lengths": torch.from_numpy(lengths[1]),
                "cond_wav": torch.from_numpy(cond), "cond_lengths": torch.from_numpy(lengths[2])}


class XttsDataLoader:
    """Shuffled fixed-shape batches over an XttsDataset, `num_workers`
    threads building batches ahead."""

    def __init__(self, dataset: XttsDataset, batch_size: int, shuffle: bool = True, drop_last: bool = True,
                 seed: int = 0, num_workers: int = 0):
        self.dataset = dataset
        self.batch_size = batch_size
        self.shuffle = shuffle
        self.drop_last = drop_last
        self.seed = seed
        self.num_workers = int(num_workers or 0)
        self.epoch = 0

    def set_epoch(self, epoch: int):
        """The epoch whose shuffle and slices the next iteration takes."""
        self.epoch = int(epoch)

    def __len__(self):
        n = len(self.dataset)
        return n // self.batch_size if self.drop_last else int(np.ceil(n / self.batch_size))

    def _make_batch(self, idxs):
        return self.dataset.collate([self.dataset[int(i)] for i in idxs])

    def __iter__(self):
        self.dataset.epoch = self.epoch
        order = np.arange(len(self.dataset))
        if self.shuffle:
            np.random.default_rng([self.seed, self.epoch]).shuffle(order)
        chunks = [order[b * self.batch_size : (b + 1) * self.batch_size] for b in range(len(self))]
        yield from prefetch_batches(self._make_batch, chunks, self.num_workers)
