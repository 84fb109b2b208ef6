"""MelGAN generators (full-band, and the 4-band one PQMF recombines), channels-first.

Counterpart of `tpu_tts/vocoder/models/melgan_generator.py` (`ResidualStack`
:19, `MelganGenerator`:39 with its `inference`:69). Module names are
Coqui's `MelganGenerator.layers` indices, so a Coqui `.pth` loads by name:
`layers.1` the first conv, per upsample stage i `layers.{3 + 3i}` the
transposed conv and `layers.{4 + 3i}` the residual stack (`blocks.{b}.2`,
`blocks.{b}.4`, `shortcuts.{b}`), the last conv before the tanh. Where
Coqui has a `ReflectionPad1d` the port holds an `nn.Identity`: the conv
after it pads itself by reflection, as the flax convs do (`pad_mode`).
Every conv is weight-normalised. The transposed conv of factor u has kernel
2u and gives T·u samples (the flax `WNConvTranspose1d`'s crop).
"""

from typing import Sequence

import torch
import torch.nn as nn
import torch.nn.functional as F

from tpu_tts_torch.layers.common import WNConv1d
from tpu_tts_torch.vocoder.models.hifigan_generator import WNConvTranspose1d

SLOPE = 0.2


class ResidualStack(nn.Module):
    """Blocks of [lrelu → dilated (3^b) k3 conv, reflect-padded → lrelu →
    1×1 conv], each added to a 1×1 shortcut of its input."""

    def __init__(self, channels: int, num_res_blocks: int, kernel_size: int = 3):
        super().__init__()
        self.blocks = nn.ModuleList(
            nn.Sequential(nn.LeakyReLU(SLOPE), nn.Identity(),
                          WNConv1d(channels, channels, kernel_size, dilation=kernel_size**b, pad_mode="reflect"),
                          nn.LeakyReLU(SLOPE), WNConv1d(channels, channels, 1))
            for b in range(num_res_blocks))
        self.shortcuts = nn.ModuleList(WNConv1d(channels, channels, 1) for _ in range(num_res_blocks))

    def forward(self, x):
        for block, shortcut in zip(self.blocks, self.shortcuts):
            x = block(x) + shortcut(x)
        return x


class MelganGenerator(nn.Module):
    """mel `[B, C_mel, T]` → waveform `[B, out_channels, T·prod(upsample_factors)]`."""

    def __init__(self, in_channels: int = 80, out_channels: int = 1, proj_kernel: int = 7,
                 base_channels: int = 512, upsample_factors: Sequence[int] = (8, 8, 2, 2),
                 num_res_blocks: int = 3):
        super().__init__()
        layers = [nn.Identity(), WNConv1d(in_channels, base_channels, proj_kernel, pad_mode="reflect")]
        ch = base_channels
        for i, u in enumerate(upsample_factors):
            ch = base_channels // 2 ** (i + 1)
            layers += [nn.LeakyReLU(SLOPE), WNConvTranspose1d(base_channels // 2**i, ch, 2 * u, u),
                       ResidualStack(ch, num_res_blocks)]
        layers += [nn.LeakyReLU(SLOPE), nn.Identity(), WNConv1d(ch, out_channels, proj_kernel, pad_mode="reflect"),
                   nn.Tanh()]
        self.layers = nn.Sequential(*layers)

    def forward(self, x):
        return self.layers(x)

    def inference(self, c):
        """`forward` on the mel edge-padded by 2 frames a side."""
        return self(F.pad(c, (2, 2), mode="replicate"))


def multiband_melgan_generator(in_channels: int = 80, upsample_factors=(2, 8, 2, 2), num_res_blocks: int = 4):
    """The 4-band generator of `setup_generator`: 384 channels at the first
    conv, 4 output channels for `PQMF.synthesis`."""
    return MelganGenerator(in_channels, 4, proj_kernel=7, base_channels=384, upsample_factors=upsample_factors,
                           num_res_blocks=num_res_blocks)
