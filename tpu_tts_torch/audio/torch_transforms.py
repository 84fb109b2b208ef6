"""On-device spectrograms of the port.

Counterpart of `tpu_tts/audio/jax_transforms.py` (`wav_to_spec`:281,
`spec_to_mel`:303, `wav_to_mel`:318): VITS-semantics log-mel, the
conditioning mel of XTTS's `get_conditioning_latents` and VITS training's
spectrograms and mel loss (differentiable). The STFT is `torch.stft` (an
FFT) on JAX's frames, where JAX multiplies the frames by windowed DFT bases
(`_dft_bases`:38, `frame_signal`:84); the two agree within 1e-5 at the
test widths (`tests/test_torch_port_train.py`). With `center=False`
the signal is reflect-padded by `(fft_size - hop_length) / 2` on each side,
framed without centring, and the magnitude is `sqrt(re² + im² + 1e-6)`;
the mel basis is the port's librosa-compatible one
(`numpy_transforms.mel_filterbank`); the log is `log(clamp(mel, 1e-5))`.
`torchaudio_mel` (`jax_transforms.py`:242) is XTTS fine-tuning's mel:
torchaudio's `MelSpectrogram` (power 2, centred frames with reflect
padding, a Slaney-normalised HTK mel basis), the log clamped at 1e-5 and
divided per bin by `mel_norms` when given. `resize_linear` is
`jax.image.resize(..., method="linear")` along time, which antialiases a
downscale (the `encoder_sample_rate` posterior's waveform, XTTS's 16 kHz
speaker-encoder input).
"""

import math
from typing import Optional

import numpy as np
import torch
import torch.nn.functional as F

from tpu_tts_torch.audio.numpy_transforms import _pad_window, get_window, mel_filterbank


def wav_to_spec(y: torch.Tensor, *, fft_size: int, hop_length: int, win_length: int,
                center: bool = False) -> torch.Tensor:
    """Linear magnitude spectrogram: `[B, T] → [B, fft_size//2 + 1, T_spec]`."""
    if not center:
        pad = (fft_size - hop_length) // 2
        y = F.pad(y[:, None], (pad, pad), mode="reflect")[:, 0]
    window = torch.from_numpy(_pad_window(get_window("hann", win_length), fft_size).astype(np.float32))
    spec = torch.stft(y.float(), fft_size, hop_length=hop_length, win_length=fft_size,
                      window=window.to(y.device), center=center, pad_mode="reflect", return_complex=True)
    return torch.sqrt(spec.real**2 + spec.imag**2 + 1e-6)


def spec_to_mel(spec: torch.Tensor, *, fft_size: int, num_mels: int, sample_rate: int, fmin: float,
                fmax: Optional[float]) -> torch.Tensor:
    """`[B, C, T] → [B, num_mels, T]` log-mel."""
    basis = mel_filterbank(sample_rate=sample_rate, fft_size=fft_size, num_mels=num_mels, mel_fmin=fmin,
                           mel_fmax=fmax)
    mel = torch.matmul(torch.from_numpy(basis).to(spec.device), spec)
    return torch.log(torch.clamp(mel, min=1e-5))


def wav_to_mel(y: torch.Tensor, *, fft_size: int, num_mels: int, sample_rate: int, hop_length: int,
               win_length: int, fmin: float, fmax: Optional[float], center: bool = False) -> torch.Tensor:
    """VITS-semantics log-mel: `[B, T] → [B, num_mels, T_spec]`."""
    spec = wav_to_spec(y, fft_size=fft_size, hop_length=hop_length, win_length=win_length, center=center)
    return spec_to_mel(spec, fft_size=fft_size, num_mels=num_mels, sample_rate=sample_rate, fmin=fmin, fmax=fmax)


def torchaudio_mel(y: torch.Tensor, *, fft_size: int, hop_length: int, win_length: int, sample_rate: int,
                   num_mels: int, fmin: float = 0.0, fmax: Optional[float] = None, htk: bool = True,
                   log_clamp: float = 1e-5, mel_norms: Optional[torch.Tensor] = None) -> torch.Tensor:
    """torchaudio-semantics log-mel: `[B, T] → [B, num_mels, 1 + T // hop_length]`."""
    window = torch.from_numpy(_pad_window(get_window("hann", win_length), fft_size).astype(np.float32))
    spec = torch.stft(y.float(), fft_size, hop_length=hop_length, win_length=fft_size, window=window.to(y.device),
                      center=True, pad_mode="reflect", return_complex=True)
    power = spec.real**2 + spec.imag**2
    basis = mel_filterbank(sample_rate=sample_rate, fft_size=fft_size, num_mels=num_mels, mel_fmin=fmin,
                           mel_fmax=fmax, htk=htk, norm="slaney")
    mel = torch.log(torch.clamp(torch.matmul(torch.from_numpy(basis).to(y.device), power), min=log_clamp))
    if mel_norms is not None:
        mel = mel / mel_norms.to(mel.device)[:, None]
    return mel


def resize_linear(y: torch.Tensor, size: int) -> torch.Tensor:
    """`jax.image.resize(y, (..., size), method="linear")` on the last axis.
    Output i samples the input at s_i = (i + 0.5)·n/size − 0.5 through a
    triangle kernel widened by n/size when that exceeds 1 (antialiasing on a
    downscale, which `F.interpolate` does not do), its weights normalised
    to sum 1 (`jax._src.image.scale.compute_weight_mat`). The positions are
    rounded to float32 once, as XLA's fused arithmetic rounds them, so long
    signals get JAX's weights too."""
    n = y.shape[-1]
    if size == n:
        return y
    inv = torch.tensor(1.0 / (size / n), dtype=torch.float32)  # JAX's inv_scale, rounded to float32
    width = torch.clamp(inv, min=1.0)
    sample = ((torch.arange(size, dtype=torch.float64) + 0.5) * inv.double() - 0.5).float()
    taps = int(math.ceil(2 * float(width))) + 2  # a spare on each side; the kernel zeroes those outside its width
    j = torch.floor(sample - width).long()[:, None] + torch.arange(taps)[None]  # [size, taps]
    w = torch.clamp(1.0 - torch.abs(sample[:, None] - j.float()) / width, min=0.0) * ((j >= 0) & (j < n))
    total = w.sum(dim=1, keepdim=True)
    w = torch.where(total.abs() > 1000.0 * float(np.finfo(np.float32).eps), w / torch.where(total != 0, total, 1.0),
                    0.0)
    w = w * ((sample >= -0.5) & (sample <= n - 0.5))[:, None]
    j, w = j.clamp(0, n - 1).to(y.device), w.to(device=y.device, dtype=y.dtype)
    return torch.sum(y[..., j] * w, dim=-1)
