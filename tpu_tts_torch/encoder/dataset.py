"""Speaker-encoder data: class-labelled utterance crops and their augmentation.

Counterpart of `tpu_tts/encoder/dataset.py` (`EncoderDataset`:10,
`AugmentWAV`:84); batches come from `data/samplers.py::PerfectBatchSampler`
(`num_classes_in_batch` classes × `num_utter_per_class` utterances). Each
item is a `voice_len`-second crop of its clip, zero-padded when shorter.
Where `tpu_tts` draws the crop offset and the augmentation from the global
`random` and `np.random`, each draw here comes from a generator seeded by
(seed, epoch, item, the item's draw count this epoch), so a run is
reproducible whatever the order items are read in (ROADMAP.md, queue 3).
"""

import glob
import os
import random
from typing import Dict, List

import numpy as np


class EncoderDataset:
    def __init__(self, config, ap, meta_data: List[Dict], voice_len: float = 1.6, num_classes_in_batch: int = 8,
                 num_utter_per_class: int = 4, augmentation_config: Dict = None, label_key: str = "speaker_name",
                 seed: int = 0):
        self.config = config
        self.ap = ap
        self.items = [it for it in meta_data if it.get(label_key)]
        self.seq_len = int(voice_len * ap.sample_rate)
        self.num_classes_in_batch = num_classes_in_batch
        self.num_utter_per_class = num_utter_per_class
        self.label_key = label_key
        self.classname_to_classid = {name: i for i, name in enumerate(sorted({it[label_key] for it in self.items}))}
        self.seed = seed
        self.epoch = 0
        self._draws: Dict[int, int] = {}
        self.augmentator = None
        self.gaussian_augmentation_config = None
        self.data_augmentation_p = 0.0
        if augmentation_config:
            self.data_augmentation_p = augmentation_config.get("p", 0.0)
            if self.data_augmentation_p and ("additive" in augmentation_config or "rir" in augmentation_config):
                self.augmentator = AugmentWAV(ap, augmentation_config)
            if "gaussian" in augmentation_config:
                self.gaussian_augmentation_config = augmentation_config["gaussian"]

    def __len__(self):
        return len(self.items)

    @property
    def num_classes(self):
        return len(self.classname_to_classid)

    def get_class_list(self):
        return list(self.classname_to_classid.keys())

    def set_epoch(self, epoch: int):
        self.epoch = epoch
        self._draws = {}

    def item_rng(self, idx: int) -> random.Random:
        """The generator of item `idx`'s next draw in this epoch."""
        n = self._draws.get(idx, 0)
        self._draws[idx] = n + 1
        return random.Random(f"{self.seed}:{self.epoch}:{idx}:{n}")

    def load_wav(self, path):
        return np.asarray(self.ap.load_wav(path), dtype=np.float32)

    def __getitem__(self, idx):
        item = self.items[idx]
        rng = self.item_rng(idx)
        wav = self.load_wav(item["audio_file"])
        if len(wav) < self.seq_len:
            wav = np.pad(wav, (0, self.seq_len - len(wav)))
        offset = rng.randint(0, max(len(wav) - self.seq_len, 0))
        wav = wav[offset : offset + self.seq_len]
        if self.augmentator is not None and self.data_augmentation_p and rng.random() < self.data_augmentation_p:
            wav = self.augmentator.apply_one(wav, rng)
        g = self.gaussian_augmentation_config
        if g and rng.random() < g.get("p", 0):
            noise = np.random.default_rng(rng.getrandbits(32)).normal(g.get("offset", 0), g.get("std", 0.01), len(wav))
            wav = wav + noise.astype(np.float32)
        return {"wav": wav, "class_name": item[self.label_key], "class_id": self.classname_to_classid[item[self.label_key]]}

    def collate_fn(self, batch):
        return {"wavs": np.stack([b["wav"] for b in batch]),
                "labels": np.array([b["class_id"] for b in batch], dtype=np.int64)}


class AugmentWAV:
    """Additive noise from `additive.sounds_path/<type>/**/*.wav` at a drawn
    SNR, or reverberation with a drawn room impulse response."""

    def __init__(self, ap, augmentation_config: Dict):
        self.ap = ap
        self.additive_config = augmentation_config.get("additive", {})
        self.rir_config = augmentation_config.get("rir", {})
        self.noise_list = {}
        if self.additive_config:
            path = self.additive_config.get("sounds_path", "")
            for t in self.additive_config:
                if isinstance(self.additive_config[t], dict):
                    self.noise_list[t] = glob.glob(os.path.join(path, t, "**/*.wav"), recursive=True)
        self.rir_files = []
        if self.rir_config:
            self.rir_files = glob.glob(os.path.join(self.rir_config.get("rir_path", ""), "**/*.wav"), recursive=True)

    def additive_noise(self, noise_type, audio, rng: random.Random):
        cfg = self.additive_config[noise_type]
        clean_db = 10 * np.log10(np.mean(audio**2) + 1e-4)
        files = self.noise_list.get(noise_type)
        if not files:
            return audio
        noise = np.asarray(self.ap.load_wav(rng.choice(files)), dtype=np.float32)
        if len(noise) < len(audio):
            noise = np.tile(noise, int(np.ceil(len(audio) / len(noise))))
        noise = noise[: len(audio)]
        snr = rng.uniform(cfg.get("min_snr_in_db", 0), cfg.get("max_snr_in_db", 15))
        noise_db = 10 * np.log10(np.mean(noise**2) + 1e-4)
        return audio + np.sqrt(10 ** ((clean_db - noise_db - snr) / 10)) * noise

    def reverberate(self, audio, rng: random.Random):
        if not self.rir_files:
            return audio
        from scipy.signal import fftconvolve

        rir = np.asarray(self.ap.load_wav(rng.choice(self.rir_files)), dtype=np.float32)
        rir = rir / np.sqrt(np.sum(rir**2) + 1e-9)
        return fftconvolve(audio, rir, mode="full")[: len(audio)]

    def apply_one(self, audio, rng: random.Random):
        if self.noise_list and (not self.rir_files or rng.random() < 0.75):
            return self.additive_noise(rng.choice(list(self.noise_list.keys())), audio, rng)
        return self.reverberate(audio, rng)
