"""Vocoder datasets: wav discovery, the train/eval split and the dataset registry.

Counterpart of `tpu_tts/vocoder/datasets/__init__.py` (`find_wav_files`:11,
`find_feat_files`:15, `load_wav_data`:19, `load_wav_feat_data`:27,
`setup_dataset`:62). Only the GAN models' dataset is ported; WaveGrad's
and WaveRNN's come with those models (ROADMAP.md, M8).
"""

import glob
import os
from typing import List, Tuple

import numpy as np


def find_wav_files(data_path: str) -> List[str]:
    return sorted(glob.glob(os.path.join(data_path, "**", "*.wav"), recursive=True))


def find_feat_files(data_path: str) -> List[str]:
    return sorted(glob.glob(os.path.join(data_path, "**", "*.npy"), recursive=True))


def load_wav_data(data_path: str, eval_split_size: int) -> Tuple[List[str], List[str]]:
    """Every wav under `data_path`, shuffled by a fixed seed → (train, eval)."""
    wav_paths = find_wav_files(data_path)
    assert len(wav_paths) > 0, f" [!] {data_path} is empty."
    np.random.RandomState(0).shuffle(wav_paths)
    return wav_paths[:-eval_split_size], wav_paths[-eval_split_size:]


def load_wav_feat_data(data_path: str, feat_path: str, eval_split_size: int):
    """(wav, feature) path pairs matched by file name → (train, eval)."""
    wav_paths = find_wav_files(data_path)
    feat_paths = find_feat_files(feat_path)
    wav_paths.sort(key=lambda x: os.path.splitext(os.path.basename(x))[0])
    feat_paths.sort(key=lambda x: os.path.splitext(os.path.basename(x))[0])
    assert len(wav_paths) == len(feat_paths), " [!] wav and feature file counts mismatch."
    items = list(zip(wav_paths, feat_paths))
    np.random.RandomState(0).shuffle(items)
    return items[:-eval_split_size], items[-eval_split_size:]


GAN_MODELS = ("gan", "hifigan", "melgan", "fullband_melgan", "multiband_melgan", "parallel_wavegan", "univnet")


def setup_dataset(config, ap, is_eval, samples, verbose=False, seed: int = 0):
    """The dataset of the model a config names."""
    name = config.model.lower()
    if name in GAN_MODELS:
        from tpu_tts_torch.vocoder.datasets.gan_dataset import GANDataset

        return GANDataset(ap=ap, items=samples, seq_len=config.seq_len, hop_len=ap.hop_length,
                          pad_short=config.pad_short, conv_pad=config.conv_pad,
                          return_pairs=getattr(config, "diff_samples_for_G_and_D", False), is_training=not is_eval,
                          use_noise_augment=config.use_noise_augment and not is_eval, use_cache=config.use_cache,
                          seed=seed)
    if name in ("wavegrad", "wavernn"):
        raise NotImplementedError(f"the {name} dataset is not ported yet (ROADMAP.md, queue 1, M8)")
    raise ValueError(f" [!] Dataset for model {config.model} cannot be found.")
