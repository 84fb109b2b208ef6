"""GAN vocoder losses, in float32.

Counterpart of `tpu_tts/vocoder/layers/losses.py` (`stft_loss`:17,
`multi_scale_stft_loss`:32, `l1_spec_loss`:51, the MSE and hinge G and D
losses :79-113, `feature_matching_loss`:116, `GeneratorLossConfig`:130,
`generator_loss`:162, `discriminator_loss`:221). Waveforms are `[B, 1, T]`
or `[B, T]`; the STFT magnitudes come from `torch.stft` on the JAX
package's centred frames (within 1e-5 of its matmul STFT). Every loss is a
sum or a mean, so the port's channels-first layout does not change it.

The subband STFT term follows `tpu_tts` exactly: it reshapes the
channels-last `[B, T/N, N]` bands row-major to `[B·N, T/N]` rows
(`:182-183`), which interleaves the bands within each row rather than
separating them (ROADMAP.md, queue 3). The port lays its `[B, N, T/N]`
bands out channels-last first, so the rows are the same.
"""

from typing import Dict, List, Optional

import numpy as np
import torch

from tpu_tts_torch.audio import torch_transforms as tt
from tpu_tts_torch.audio.numpy_transforms import _pad_window, get_window
from tpu_tts_torch.layers.common import reflect_pad


def _wide(x: torch.Tensor) -> torch.Tensor:
    """x in float32, or float64 if it is (bfloat16 scores and features are read in float32)."""
    return x if x.dtype == torch.float64 else x.float()


def _flat(y: torch.Tensor) -> torch.Tensor:
    return _wide(y[:, 0] if y.dim() == 3 else y)


def stft_magnitude(y: torch.Tensor, fft_size: int, hop_length: int, win_length: int) -> torch.Tensor:
    """|STFT| of `[B, T]` (`stft`), sqrt(max(power, 1e-8)): `[B, bins, frames]`."""
    spec = stft(y, fft_size, hop_length, win_length)
    return torch.sqrt(torch.clamp(spec.real**2 + spec.imag**2, min=1e-8))


def stft(y: torch.Tensor, fft_size: int, hop_length: int, win_length: int) -> torch.Tensor:
    """The complex STFT of `[B, T]` on the JAX package's centred frames: the
    signal reflected by fft_size // 2 at each end (as `jnp.pad`, also when
    that is longer than the signal), the Hann window of `win_length` centred
    in `fft_size`: `[B, bins, frames]`."""
    window = torch.from_numpy(_pad_window(get_window("hann", win_length), fft_size))
    y = reflect_pad(_wide(y), fft_size // 2)
    return torch.stft(y, fft_size, hop_length=hop_length, win_length=fft_size, window=window.to(y.device, y.dtype),
                      center=False, return_complex=True)


def stft_loss(y_hat: torch.Tensor, y: torch.Tensor, n_fft: int, hop_length: int, win_length: int):
    """(log-magnitude L1, spectral convergence) of one resolution; y, y_hat `[B, T]`."""
    y_hat_m = stft_magnitude(y_hat, n_fft, hop_length, win_length)
    y_m = stft_magnitude(y, n_fft, hop_length, win_length)
    loss_mag = torch.mean(torch.abs(torch.log(torch.clamp(y_m, min=1e-5)) - torch.log(torch.clamp(y_hat_m, min=1e-5))))
    loss_sc = torch.linalg.vector_norm(y_m - y_hat_m) / torch.clamp(torch.linalg.vector_norm(y_m), min=1e-8)
    return loss_mag, loss_sc


def multi_scale_stft_loss(y_hat, y, n_ffts=(1024, 2048, 512), hop_lengths=(120, 240, 50),
                          win_lengths=(600, 1200, 240)):
    """The mean over resolutions of `stft_loss`'s two terms."""
    loss_mag, loss_sc = 0.0, 0.0
    for n_fft, hop, win in zip(n_ffts, hop_lengths, win_lengths):
        lm, lsc = stft_loss(y_hat, y, n_fft, hop, win)
        loss_mag, loss_sc = loss_mag + lm, loss_sc + lsc
    return loss_mag / len(n_ffts), loss_sc / len(n_ffts)


def l1_spec_loss(y_hat, y, sample_rate: int = 22050, n_fft: int = 1024, hop_length: int = 256, win_length: int = 1024,
                 num_mels: int = 80, fmin: float = 0.0, fmax: Optional[float] = None, use_mel: bool = True):
    """Mean L1 distance of the log-mels (VITS framing), or of the log
    magnitudes; y, y_hat `[B, T]`."""
    if use_mel:
        kw = dict(fft_size=n_fft, num_mels=num_mels, sample_rate=sample_rate, hop_length=hop_length,
                  win_length=win_length, fmin=fmin, fmax=fmax)
        s_hat, s = tt.wav_to_mel(y_hat.float(), **kw), tt.wav_to_mel(y.float(), **kw)
    else:
        s_hat = torch.log(torch.clamp(stft_magnitude(y_hat, n_fft, hop_length, win_length), min=1e-5))
        s = torch.log(torch.clamp(stft_magnitude(y, n_fft, hop_length, win_length), min=1e-5))
    return torch.mean(torch.abs(s - s_hat))


# ----------------------------------------------------------------- GAN terms

def mse_G_loss(scores_fake: List[torch.Tensor]) -> torch.Tensor:
    return sum(torch.mean((1.0 - _wide(sf)) ** 2) for sf in scores_fake) / len(scores_fake)


def hinge_G_loss(scores_fake: List[torch.Tensor]) -> torch.Tensor:
    return sum(-torch.mean(_wide(sf)) for sf in scores_fake) / len(scores_fake)


def mse_D_loss(scores_fake, scores_real):
    """(total, real, fake), each the mean over discriminators."""
    real = [torch.mean((1.0 - _wide(sr)) ** 2) for sr in scores_real]
    fake = [torch.mean(_wide(sf) ** 2) for sf in scores_fake]
    n = len(scores_fake)
    return sum(r + f for r, f in zip(real, fake)) / n, sum(real) / n, sum(fake) / n


def hinge_D_loss(scores_fake, scores_real):
    real = [torch.mean(torch.relu(1.0 - _wide(sr))) for sr in scores_real]
    fake = [torch.mean(torch.relu(1.0 + _wide(sf))) for sf in scores_fake]
    n = len(scores_fake)
    return sum(r + f for r, f in zip(real, fake)) / n, sum(real) / n, sum(fake) / n


def feature_matching_loss(feats_fake, feats_real) -> torch.Tensor:
    """The mean over every feature map of every discriminator of the mean L1
    distance; the real side carries no gradient."""
    terms = [torch.mean(torch.abs(_wide(f_fake) - _wide(f_real.detach())))
             for d_fake, d_real in zip(feats_fake, feats_real) for f_fake, f_real in zip(d_fake, d_real)]
    return sum(terms) / max(len(terms), 1)


# ------------------------------------------------------------------ composite

class GeneratorLossConfig:
    """The G loss's switches and weights, read from a GAN vocoder config."""

    def __init__(self, C):
        self.use_stft_loss = getattr(C, "use_stft_loss", False)
        self.use_subband_stft_loss = getattr(C, "use_subband_stft_loss", False)
        self.use_mse_gan_loss = getattr(C, "use_mse_gan_loss", True)
        self.use_hinge_gan_loss = getattr(C, "use_hinge_gan_loss", False)
        self.use_feat_match_loss = getattr(C, "use_feat_match_loss", True)
        self.use_l1_spec_loss = getattr(C, "use_l1_spec_loss", False)
        self.stft_loss_weight = getattr(C, "stft_loss_weight", 0.0)
        self.subband_stft_loss_weight = getattr(C, "subband_stft_loss_weight", 0.0)
        self.mse_gan_loss_weight = getattr(C, "mse_G_loss_weight", 1.0)
        self.hinge_gan_loss_weight = getattr(C, "hinge_G_loss_weight", 0.0)
        self.feat_match_loss_weight = getattr(C, "feat_match_loss_weight", 100.0)
        self.l1_spec_loss_weight = getattr(C, "l1_spec_loss_weight", 0.0)
        self.stft_loss_params = getattr(C, "stft_loss_params", None) or {
            "n_ffts": [1024, 2048, 512], "hop_lengths": [120, 240, 50], "win_lengths": [600, 1200, 240]
        }
        self.subband_stft_loss_params = getattr(C, "subband_stft_loss_params", None) or {
            "n_ffts": [384, 683, 171], "hop_lengths": [30, 60, 10], "win_lengths": [150, 300, 60]
        }
        self.l1_spec_params = {
            "sample_rate": C.audio.sample_rate,
            "n_fft": C.audio.fft_size,
            "hop_length": C.audio.hop_length,
            "win_length": C.audio.win_length,
            "num_mels": C.audio.num_mels,
            "fmin": C.audio.mel_fmin,
            "fmax": C.audio.mel_fmax,
        }


def _resolutions(params) -> tuple:
    return tuple(params["n_ffts"]), tuple(params["hop_lengths"]), tuple(params["win_lengths"])


def _band_rows(bands: torch.Tensor) -> torch.Tensor:
    """`[B, N, L]` bands → the `[B·N, L]` rows of `tpu_tts`'s row-major
    reshape of its channels-last `[B, L, N]`."""
    return _wide(bands).transpose(1, 2).reshape(-1, bands.shape[2])


def generator_loss(cfg: GeneratorLossConfig, y_hat=None, y=None, scores_fake=None, feats_fake=None, feats_real=None,
                   y_hat_sub=None, y_sub=None) -> Dict[str, torch.Tensor]:
    """The G loss and its terms: y_hat, y `[B, 1, T]`; y_hat_sub, y_sub `[B, N, T / N]`."""
    gen_loss, adv_loss, out = 0.0, 0.0, {}
    if cfg.use_stft_loss:
        mag, sc = multi_scale_stft_loss(_flat(y_hat), _flat(y), *_resolutions(cfg.stft_loss_params))
        out["G_stft_loss_mg"], out["G_stft_loss_sc"] = mag, sc
        gen_loss = gen_loss + cfg.stft_loss_weight * (mag + sc)
    if cfg.use_subband_stft_loss:
        mag, sc = multi_scale_stft_loss(_band_rows(y_hat_sub), _band_rows(y_sub),
                                        *_resolutions(cfg.subband_stft_loss_params))
        out["G_subband_stft_loss_mg"], out["G_subband_stft_loss_sc"] = mag, sc
        gen_loss = gen_loss + cfg.subband_stft_loss_weight * (mag + sc)
    if cfg.use_l1_spec_loss:
        l1 = l1_spec_loss(_flat(y_hat), _flat(y), **cfg.l1_spec_params)
        out["G_l1_spec_loss"] = l1
        gen_loss = gen_loss + cfg.l1_spec_loss_weight * l1
    if cfg.use_mse_gan_loss and scores_fake is not None:
        out["G_mse_fake_loss"] = mse_G_loss(scores_fake)
        adv_loss = adv_loss + cfg.mse_gan_loss_weight * out["G_mse_fake_loss"]
    if cfg.use_hinge_gan_loss and scores_fake is not None:
        out["G_hinge_fake_loss"] = hinge_G_loss(scores_fake)
        adv_loss = adv_loss + cfg.hinge_gan_loss_weight * out["G_hinge_fake_loss"]
    if cfg.use_feat_match_loss and feats_fake is not None:
        out["G_feat_match_loss"] = feature_matching_loss(feats_fake, feats_real)
        adv_loss = adv_loss + cfg.feat_match_loss_weight * out["G_feat_match_loss"]
    out["loss"] = gen_loss + adv_loss
    out["G_gen_loss"] = gen_loss
    out["G_adv_loss"] = adv_loss
    return out


def discriminator_loss(cfg, scores_fake, scores_real) -> Dict[str, torch.Tensor]:
    """The D loss and its terms (MSE, and hinge when the config asks)."""
    out, loss = {}, 0.0
    if getattr(cfg, "use_mse_gan_loss", True):
        total, real, fake = mse_D_loss(scores_fake, scores_real)
        out["D_mse_gan_loss"], out["D_mse_gan_real_loss"], out["D_mse_gan_fake_loss"] = total, real, fake
        loss = loss + total
    if getattr(cfg, "use_hinge_gan_loss", False):
        out["D_hinge_gan_loss"] = hinge_D_loss(scores_fake, scores_real)[0]
        loss = loss + out["D_hinge_gan_loss"]
    out["loss"] = loss
    return out
