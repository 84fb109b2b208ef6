"""UnivNet generator: location-variable convolutions, channels-first.

Counterpart of `tpu_tts/vocoder/models/univnet_generator.py`
(`KernelPredictor`:19, `location_variable_convolution`:70, `LVCBlock`:93,
`UnivnetGenerator`:142). `tpu_tts` computes the LVC as an einsum in XLA,
outside any Pallas kernel, so `torch.einsum` is its port. Module names are
Coqui's (`first_conv`, `lvc_blocks.{n}.upsample`, `.convs.{i}`,
`.kernel_predictor.input_conv.0`, `.residual_conv.{1,3,6,8,11,13}`,
`.kernel_conv`, `.bias_conv`, `last_conv_layers.0`), every conv
weight-normalised. The kernel predictor wraps one residual around its six
convs (Coqui's `lvc_block.py`). Its dropout never acts: `tpu_tts`'s GAN
never calls the generator with `train=True`, so the port holds an
`nn.Identity` where Coqui has its `nn.Dropout`.

The noise z `[B, in_channels, T_mel]` is an argument, or drawn from the
`torch.Generator` given. `tpu_tts`'s GAN passes the generator no `noise`
rng, so it cannot build a UnivNet GAN at all (ROADMAP.md, queue 3).
"""

from typing import Optional, Sequence

import torch
import torch.nn as nn
import torch.nn.functional as F

from tpu_tts_torch.layers.common import WNConv1d
from tpu_tts_torch.vocoder.models.hifigan_generator import WNConvTranspose1d


class KernelPredictor(nn.Module):
    """mel `[B, C_cond, T]` → the per-frame kernels `[B, L, C_in, C_out, K, T]`
    and biases `[B, L, C_out, T]` of the L LVC layers."""

    def __init__(self, cond_channels: int, conv_in_channels: int, conv_out_channels: int, conv_layers: int,
                 conv_kernel_size: int = 3, kpnet_hidden_channels: int = 64, kpnet_conv_size: int = 3,
                 lrelu_slope: float = 0.1):
        super().__init__()
        self.shape = (conv_layers, conv_in_channels, conv_out_channels, conv_kernel_size)
        h, k = kpnet_hidden_channels, kpnet_conv_size
        self.input_conv = nn.Sequential(WNConv1d(cond_channels, h, 5), nn.LeakyReLU(lrelu_slope))
        residual = []
        for _ in range(3):
            residual += [nn.Identity(), WNConv1d(h, h, k), nn.LeakyReLU(lrelu_slope), WNConv1d(h, h, k),
                         nn.LeakyReLU(lrelu_slope)]
        self.residual_conv = nn.Sequential(*residual)
        self.kernel_conv = WNConv1d(h, conv_in_channels * conv_out_channels * conv_kernel_size * conv_layers, k)
        self.bias_conv = WNConv1d(h, conv_out_channels * conv_layers, k)

    def forward(self, c):
        h = self.input_conv(c)
        h = h + self.residual_conv(h)
        B, T = c.shape[0], c.shape[2]
        L, c_in, c_out, K = self.shape
        return self.kernel_conv(h).view(B, L, c_in, c_out, K, T), self.bias_conv(h).view(B, L, c_out, T)


def location_variable_convolution(x: torch.Tensor, kernel: torch.Tensor, bias: torch.Tensor, dilation: int,
                                  hop_size: int) -> torch.Tensor:
    """Each frame's kernel applied to its hop of samples: x `[B, C_in, T]`,
    kernel `[B, C_in, C_out, K, T_frames]`, bias `[B, C_out, T_frames]`,
    T = T_frames · hop_size → `[B, C_out, T]` (zero padding at the ends)."""
    B, c_in, T = x.shape
    K, Tf = kernel.shape[3], kernel.shape[4]
    if T != Tf * hop_size:
        raise ValueError(f"LVC length mismatch {T} vs {Tf}*{hop_size}")
    pad = dilation * (K - 1) // 2
    xp = F.pad(x, (pad, pad))
    taps = torch.stack([xp[:, :, k * dilation: k * dilation + T] for k in range(K)], dim=-1)  # [B, C_in, T, K]
    taps = taps.view(B, c_in, Tf, hop_size, K)
    out = torch.einsum("bifhk,biokf->bofh", taps, kernel) + bias[:, :, :, None]
    return out.reshape(B, -1, T)


class LVCBlock(nn.Module):
    """lrelu → transposed-conv upsampling, then L layers of [lrelu → dilated
    conv → lrelu → LVC → gated (sigmoid of the first half × tanh of the
    second) residual]."""

    def __init__(self, in_channels: int, cond_channels: int, upsample_ratio: int, conv_layers: int = 4,
                 conv_kernel_size: int = 3, kpnet_hidden_channels: int = 64, kpnet_conv_size: int = 3,
                 dilations: Sequence[int] = (1, 3, 9, 27)):
        super().__init__()
        self.kernel_predictor = KernelPredictor(cond_channels, in_channels, 2 * in_channels, conv_layers,
                                                conv_kernel_size, kpnet_hidden_channels, kpnet_conv_size)
        self.upsample = WNConvTranspose1d(in_channels, in_channels, 2 * upsample_ratio, upsample_ratio)
        self.convs = nn.ModuleList(WNConv1d(in_channels, in_channels, conv_kernel_size, dilation=dilations[i])
                                   for i in range(conv_layers))

    def forward(self, x, c):
        kernels, bias = self.kernel_predictor(c)
        x = self.upsample(F.leaky_relu(x, 0.2))
        hop = x.shape[2] // c.shape[2]
        for i, conv in enumerate(self.convs):
            y = F.leaky_relu(conv(F.leaky_relu(x, 0.2)), 0.2)
            y = location_variable_convolution(y, kernels[:, i], bias[:, i], dilation=1, hop_size=hop)
            ya, yb = torch.chunk(y, 2, dim=1)
            x = x + torch.sigmoid(ya) * torch.tanh(yb)
        return x


class UnivnetGenerator(nn.Module):
    """noise + mel `[B, C_mel, T]` → waveform `[B, 1, T·prod(upsample_factors)]`."""

    def __init__(self, in_channels: int = 64, out_channels: int = 1, hidden_channels: int = 32,
                 cond_channels: int = 80, upsample_factors: Sequence[int] = (8, 8, 4), lvc_layers_each_block: int = 4,
                 lvc_kernel_size: int = 3, kpnet_hidden_channels: int = 64, kpnet_conv_size: int = 3,
                 dropout: float = 0.0):
        super().__init__()
        self.in_channels = in_channels
        self.first_conv = WNConv1d(in_channels, hidden_channels, 7)
        self.lvc_blocks = nn.ModuleList(
            LVCBlock(hidden_channels, cond_channels, s, lvc_layers_each_block, lvc_kernel_size,
                     kpnet_hidden_channels, kpnet_conv_size) for s in upsample_factors)
        self.last_conv_layers = nn.ModuleList([WNConv1d(hidden_channels, out_channels, 7)])

    def forward(self, c, z: Optional[torch.Tensor] = None, generator: Optional[torch.Generator] = None):
        if z is None:
            z = torch.randn(c.shape[0], self.in_channels, c.shape[2], generator=generator, device=c.device,
                            dtype=c.dtype)
        x = self.first_conv(z)
        for block in self.lvc_blocks:
            x = block(x, c)
        return torch.tanh(self.last_conv_layers[0](F.leaky_relu(x, 0.1)))

    def inference(self, c, z=None, generator=None):
        return self(c, z, generator)
