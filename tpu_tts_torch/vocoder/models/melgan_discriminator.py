"""MelGAN discriminators, channels-first.

Counterpart of `tpu_tts/vocoder/models/melgan_discriminator.py`
(`MelganDiscriminator`:16, `MelganMultiscaleDiscriminator`:51): weight-norm
1-D convs with zero padding, grouped strided downsampling, leaky relu 0.2;
each scale after the first sees the waveform average-pooled once more. The
JAX package converts no Coqui MelGAN discriminator (its first conv pads by
reflection, the flax one by zeros), so the names here are the flax ones:
`discriminators.{i}.conv_pre`, `.down.{j}`, `.conv_mid`, `.conv_post`.
"""

from typing import Sequence

import torch
import torch.nn as nn
import torch.nn.functional as F

from tpu_tts_torch.vocoder.models.hifigan_discriminator import NormConv, avg_pool

SLOPE = 0.2


class MelganDiscriminator(nn.Module):
    """x `[B, 1, T]` → (score `[B, N]`, features)."""

    def __init__(self, in_channels: int = 1, out_channels: int = 1, kernel_sizes=(5, 3), base_channels: int = 16,
                 max_channels: int = 1024, downsample_factors: Sequence[int] = (4, 4, 4, 4)):
        super().__init__()
        k0 = kernel_sizes[0] * kernel_sizes[1]
        self.conv_pre = NormConv(in_channels, base_channels, (k0,), (1,), (k0 // 2,))
        self.down = nn.ModuleList()
        ch = base_channels
        for df in downsample_factors:
            ch_out = min(ch * df, max_channels)
            k = df * 10 + 1
            self.down.append(NormConv(ch, ch_out, (k,), (df,), (k // 2,), groups=max(ch // 4, 1)))
            ch = ch_out
        self.conv_mid = NormConv(ch, min(ch * 2, max_channels), (kernel_sizes[0],), (1,), (kernel_sizes[0] // 2,))
        self.conv_post = NormConv(min(ch * 2, max_channels), out_channels, (kernel_sizes[1],), (1,),
                                  (kernel_sizes[1] // 2,))

    def forward(self, x):
        feats = []
        for conv in (self.conv_pre, *self.down, self.conv_mid):
            x = F.leaky_relu(conv(x), SLOPE)
            feats.append(x)
        score = self.conv_post(x)
        feats.append(score)
        return torch.flatten(score, 1), feats


class MelganMultiscaleDiscriminator(nn.Module):
    def __init__(self, num_scales: int = 3, base_channels: int = 16, max_channels: int = 1024,
                 downsample_factors: Sequence[int] = (4, 4, 4), pooling_factor: int = 4):
        super().__init__()
        self.pooling_factor = pooling_factor
        self.discriminators = nn.ModuleList(
            MelganDiscriminator(base_channels=base_channels, max_channels=max_channels,
                                downsample_factors=downsample_factors) for _ in range(num_scales))

    def forward(self, x):
        scores, feats = [], []
        for i, disc in enumerate(self.discriminators):
            score, feat = disc(x)
            scores.append(score)
            feats.append(feat)
            if i < len(self.discriminators) - 1:
                x = avg_pool(x, window=self.pooling_factor, stride=2)
        return scores, feats
