"""HiFi-GAN discriminators of VITS training and of the HiFi-GAN vocoder, channels-first.

Counterpart of `tpu_tts/vocoder/models/hifigan_discriminator.py`
(`_spectral_normalize`:19, `NormConv`:33, `DiscriminatorP`:76,
`DiscriminatorS`:114 with VITS's `slim` schedule or the vocoder's full one,
`MultiPeriodDiscriminator`:158, `_avg_pool`:175, `MultiScaleDiscriminator`
:181, `HifiganDiscriminator`:199). Module and
parameter names are Coqui's (`convs.{i}`, `conv_post`, `mpd.discriminators.{i}`,
`msd.discriminators.{i}`, weight norm as
`parametrizations.weight.original0/1` with g per output channel), so a Coqui
VITS checkpoint's `disc.*` tensors and a Coqui HiFi-GAN's `model_d.*` load by
name. Spectral norm (the vocoder's first scale discriminator) is the JAX
package's stateless kind: three power iterations from a uniform vector on
every call, on a plain `weight`; the vocoder's loader reads a Coqui
checkpoint's `parametrizations.weight.original` as that weight
(`vocoder/models/vocoder_convert.py`), as the JAX converter does.

Mixed precision (`tpu_tts/vocoder/models/hifigan_discriminator.py`:42-73):
with a bfloat16 `compute_dtype` (`layers.common.set_compute_dtype`) each
conv normalises its float32 parameters in float32, then computes in
bfloat16; its features and scores are bfloat16, which the losses read in
float32.
"""

import math
from typing import Sequence

import torch
import torch.nn as nn
import torch.nn.functional as F

from tpu_tts_torch.layers.common import WeightNorm, cast_conv

LRELU_SLOPE = 0.1


def _spectral_normalize(w: torch.Tensor, n_iters: int = 3) -> torch.Tensor:
    """w / σ_max(w) with w flattened to `[out, -1]`, stateless."""
    mat = w.reshape(w.shape[0], -1)
    u = torch.full((mat.shape[0],), mat.shape[0] ** -0.5, dtype=w.dtype, device=w.device)
    for _ in range(n_iters):
        v = mat.t() @ u
        v = v / torch.clamp(torch.linalg.vector_norm(v), min=1e-12)
        u = mat @ v
        u = u / torch.clamp(torch.linalg.vector_norm(u), min=1e-12)
    return w / torch.clamp(u @ (mat @ v), min=1e-12)


class NormConv(nn.Module):
    """A 1-D or 2-D conv (by the length of `kernel_size`) with weight norm,
    or spectral norm with `use_spectral_norm`."""

    def __init__(self, in_channels: int, out_channels: int, kernel_size: Sequence[int], stride: Sequence[int],
                 padding: Sequence[int], groups: int = 1, use_spectral_norm: bool = False):
        super().__init__()
        self.compute_dtype = None
        self.stride, self.padding, self.groups = tuple(stride), tuple(padding), groups
        self.conv = F.conv1d if len(kernel_size) == 1 else F.conv2d
        shape = (out_channels, in_channels // groups) + tuple(kernel_size)
        fan_in = shape[1] * math.prod(kernel_size)
        if use_spectral_norm:
            self.weight = nn.Parameter(torch.randn(shape) * (2.0 / fan_in) ** 0.5)
        else:
            self.parametrizations = nn.ModuleDict({"weight": WeightNorm(shape)})
            self.parametrizations["weight"].reset_parameters(fan_in)
        self.bias = nn.Parameter(torch.zeros(out_channels))

    def kernel(self) -> torch.Tensor:
        if hasattr(self, "parametrizations"):
            return self.parametrizations["weight"]()
        return _spectral_normalize(self.weight)

    def forward(self, x):
        w = self.kernel() if self.compute_dtype is None else self.kernel().to(self.compute_dtype)
        return cast_conv(self.conv, x, w, self.bias, stride=self.stride, padding=self.padding, groups=self.groups)


class DiscriminatorP(nn.Module):
    """Period discriminator: the waveform folded by `period` into 2-D, a
    stack of (k, 1) convs. x `[B, 1, T]` → (score `[B, N]`, features)."""

    def __init__(self, period: int, kernel_size: int = 5, stride: int = 3, use_spectral_norm: bool = False):
        super().__init__()
        self.period = period
        k = kernel_size
        chans = [1, 32, 128, 512, 1024]
        self.convs = nn.ModuleList(
            NormConv(c_in, c_out, (k, 1), (stride, 1), (k // 2, 0), use_spectral_norm=use_spectral_norm)
            for c_in, c_out in zip(chans[:-1], chans[1:])
        )
        self.convs.append(NormConv(1024, 1024, (k, 1), (1, 1), (2, 0), use_spectral_norm=use_spectral_norm))
        self.conv_post = NormConv(1024, 1, (3, 1), (1, 1), (1, 0), use_spectral_norm=use_spectral_norm)

    def forward(self, x):
        feat = []
        b, c, t = x.shape
        if t % self.period:
            n_pad = self.period - t % self.period
            x = F.pad(x, (0, n_pad), mode="reflect")
            t += n_pad
        x = x.view(b, c, t // self.period, self.period)
        for conv in self.convs:
            x = F.leaky_relu(conv(x), LRELU_SLOPE)
            feat.append(x)
        x = self.conv_post(x)
        feat.append(x)
        return torch.flatten(x, 1), feat


# (out channels, kernel, stride, groups, padding) of each conv of VITS's scale discriminator
_SLIM = [(16, 15, 1, 1, 7), (64, 41, 4, 4, 20), (256, 41, 4, 16, 20), (1024, 41, 4, 64, 20),
         (1024, 41, 4, 256, 20), (1024, 5, 1, 1, 2)]
# and of the HiFi-GAN vocoder's
_FULL = [(128, 15, 1, 1, 7), (128, 41, 2, 4, 20), (256, 41, 2, 16, 20), (512, 41, 4, 16, 20),
         (1024, 41, 4, 16, 20), (1024, 41, 1, 16, 20), (1024, 5, 1, 1, 2)]


class DiscriminatorS(nn.Module):
    """A scale discriminator: a stack of grouped 1-D convs, VITS's schedule
    (`slim`) or the HiFi-GAN vocoder's. x `[B, 1, T]` → (score `[B, N]`,
    features)."""

    def __init__(self, use_spectral_norm: bool = False, slim: bool = True):
        super().__init__()
        self.convs = nn.ModuleList()
        c_in = 1
        for c_out, k, s, g, p in _SLIM if slim else _FULL:
            self.convs.append(NormConv(c_in, c_out, (k,), (s,), (p,), groups=g, use_spectral_norm=use_spectral_norm))
            c_in = c_out
        self.conv_post = NormConv(c_in, 1, (3,), (1,), (1,), use_spectral_norm=use_spectral_norm)

    def forward(self, x):
        feat = []
        for conv in self.convs:
            x = F.leaky_relu(conv(x), LRELU_SLOPE)
            feat.append(x)
        x = self.conv_post(x)
        feat.append(x)
        return torch.flatten(x, 1), feat


class MultiPeriodDiscriminator(nn.Module):
    """One period discriminator per period (2, 3, 5, 7, 11): (scores, features)."""

    def __init__(self, periods=(2, 3, 5, 7, 11), use_spectral_norm: bool = False):
        super().__init__()
        self.discriminators = nn.ModuleList(DiscriminatorP(p, use_spectral_norm=use_spectral_norm) for p in periods)

    def forward(self, x):
        scores, feats = [], []
        for disc in self.discriminators:
            score, feat = disc(x)
            scores.append(score)
            feats.append(feat)
        return scores, feats


def avg_pool(x: torch.Tensor, window: int = 4, stride: int = 2) -> torch.Tensor:
    """The JAX package's `_avg_pool`: a mean over `window` samples every
    `stride`, two zeros padded on each side and counted."""
    return F.avg_pool1d(F.pad(x, (2, 2)), window, stride)


class MultiScaleDiscriminator(nn.Module):
    """Three full-schedule scale discriminators, the first spectral-normed,
    each on the waveform average-pooled once more than the one before."""

    def __init__(self):
        super().__init__()
        self.discriminators = nn.ModuleList(DiscriminatorS(use_spectral_norm=i == 0, slim=False) for i in range(3))

    def forward(self, x):
        scores, feats = [], []
        for i, disc in enumerate(self.discriminators):
            score, feat = disc(x)
            scores.append(score)
            feats.append(feat)
            if i < len(self.discriminators) - 1:
                x = avg_pool(x)
        return scores, feats


class HifiganDiscriminator(nn.Module):
    """The period discriminators then the scale discriminators: x `[B, 1, T]`
    → (8 scores, 8 feature lists)."""

    def __init__(self):
        super().__init__()
        self.mpd = MultiPeriodDiscriminator()
        self.msd = MultiScaleDiscriminator()

    def forward(self, x):
        p_scores, p_feats = self.mpd(x)
        s_scores, s_feats = self.msd(x)
        return p_scores + s_scores, p_feats + s_feats
