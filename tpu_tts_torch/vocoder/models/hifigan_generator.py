"""HiFi-GAN generator, channels-first, with every ResBlock1 MRF stage on the CUDA kernel.

Counterpart of `tpu_tts/vocoder/models/hifigan_generator.py`
(`WNConvTranspose1d`:26, `ResBlock1`:57, `ResBlock2`:76, `HifiganGenerator`
:93). In `eval()` mode, with ResBlock1 each stage's MRF stack goes through
`ops.hifigan_mrf.mrf_stack`, at every width. In `train()` mode each stage
is the mean of its ResBlock1 modules in plain PyTorch, on the live
parameters, as the flax generator computes it in plain XLA for training:
the kernel has no backward. ResBlock2 (YourTTS's decoder)
runs in plain PyTorch, as `tpu_tts` runs it in plain XLA and never sends it
to its Pallas kernel. With `cond_channels`, a 1×1 projection of the speaker
embedding g `[B, C_g, 1]` is added after `conv_pre`, outside the kernel, as
in `tpu_tts/ops/hifigan_pallas.py::hifigan_apply_pallas`. With
`cond_in_each_up_layer` (the XTTS decoder), a 1×1 projection `conds.{i}` of
g is also added after each `ups.{i}`, before the stage's MRF, outside the
kernel too (`tpu_tts/vocoder/models/hifigan_generator.py`:128-129). As in the flax
generator, the final leaky relu has slope 0.01.

The vocoder's flags (`:104-108`): `conv_post_bias=False` builds `conv_post`
without a bias; `inference` edge-pads the mel by `inference_padding` frames
a side first (`:141-143`). `conv_pre_weight_norm` and
`conv_post_weight_norm` are taken and, as in the flax module, not read: both
convs are weight-normalised, and a Coqui checkpoint that stores either as a
plain `weight` loads through `vocoder/models/vocoder_convert.py`.

Mixed precision (`tpu_tts/vocoder/models/hifigan_generator.py`:33-54,
112-139): once `layers.common.set_compute_dtype` has given the generator
bfloat16 (VITS training), `conv_pre`, `cond_layer`, the upsampling,
`conds.{i}`, the resblocks and their mean compute in it, and the last leaky
relu, `conv_post` and the tanh in float32; `Vits.init_training` keeps
`conv_post` float32. Serving runs in float32 (K1 also takes bfloat16).
"""

from typing import Dict, Sequence, Tuple

import torch
import torch.nn as nn
import torch.nn.functional as F

from tpu_tts_torch.layers.common import WeightNorm, WNConv1d, cast_conv, project
from tpu_tts_torch.ops.hifigan_mrf import LRELU_SLOPE, MrfStage, mrf_stack, pack_stage


class WNConvTranspose1d(nn.Module):
    """Weight-normalised transposed conv, output length T·stride. The weight
    has torch's ConvTranspose1d layout `[C_in, C_out, k]`, normalised per
    input channel (dim 0), as Coqui's checkpoints store it."""

    def __init__(self, in_channels: int, out_channels: int, kernel_size: int, stride: int):
        super().__init__()
        self.compute_dtype = None
        self.stride = stride
        self.padding = (kernel_size - stride) // 2
        self.parametrizations = nn.ModuleDict({"weight": WeightNorm((in_channels, out_channels, kernel_size))})
        self.bias = nn.Parameter(torch.zeros(out_channels))
        self.parametrizations["weight"].reset_parameters(in_channels * kernel_size)

    def forward(self, x):
        w = self.parametrizations["weight"]()
        w = w if self.compute_dtype is None else w.to(self.compute_dtype)
        return cast_conv(F.conv_transpose1d, x, w, self.bias, stride=self.stride, padding=self.padding)


class ResBlock1(nn.Module):
    """One ResBlock1: convs1 (dilated) and convs2 per unit. `forward` is the
    plain PyTorch math (training); `units` hands the folded weights to the
    stage's MRF stack (inference)."""

    def __init__(self, channels: int, kernel_size: int = 3, dilation: Tuple[int, ...] = (1, 3, 5)):
        super().__init__()
        self.dilation = tuple(dilation)
        self.convs1 = nn.ModuleList(WNConv1d(channels, channels, kernel_size, dilation=d) for d in self.dilation)
        self.convs2 = nn.ModuleList(WNConv1d(channels, channels, kernel_size) for _ in self.dilation)

    def forward(self, x):
        for c1, c2 in zip(self.convs1, self.convs2):
            x = c2(F.leaky_relu(c1(F.leaky_relu(x, LRELU_SLOPE)), LRELU_SLOPE)) + x
        return x

    def units(self):
        return [
            (c1.weight, c1.bias, c2.weight, c2.bias, d)
            for c1, c2, d in zip(self.convs1, self.convs2, self.dilation)
        ]


class ResBlock2(nn.Module):
    """One dilated conv per dilation, each `lrelu → conv` with a residual,
    in plain PyTorch. As the flax ResBlock2, it has a conv for every
    dilation given."""

    def __init__(self, channels: int, kernel_size: int = 3, dilation: Tuple[int, ...] = (1, 3)):
        super().__init__()
        self.convs = nn.ModuleList(WNConv1d(channels, channels, kernel_size, dilation=d) for d in dilation)

    def forward(self, x):
        for conv in self.convs:
            x = conv(F.leaky_relu(x, LRELU_SLOPE)) + x
        return x


class HifiganGenerator(nn.Module):
    """latent `[B, C_in, T]` → waveform `[B, 1, T·prod(upsample_factors)]`."""

    def __init__(
        self,
        in_channels: int = 80,
        out_channels: int = 1,
        resblock_type: str = "1",
        resblock_dilation_sizes: Sequence[Sequence[int]] = ((1, 3, 5), (1, 3, 5), (1, 3, 5)),
        resblock_kernel_sizes: Sequence[int] = (3, 7, 11),
        upsample_kernel_sizes: Sequence[int] = (16, 16, 4, 4),
        upsample_initial_channel: int = 512,
        upsample_factors: Sequence[int] = (8, 8, 2, 2),
        cond_channels: int = 0,
        cond_in_each_up_layer: bool = False,
        inference_padding: int = 5,
        conv_pre_weight_norm: bool = True,
        conv_post_weight_norm: bool = True,
        conv_post_bias: bool = True,
    ):
        super().__init__()
        self.compute_dtype = None  # of cond_layer and conds.{i}; the convs hold their own
        self.resblock_type = str(resblock_type)
        resblock_cls = ResBlock1 if self.resblock_type == "1" else ResBlock2
        self.inference_padding = inference_padding
        self.num_kernels = len(resblock_kernel_sizes)
        self.num_upsamples = len(upsample_factors)
        self.conv_pre = WNConv1d(in_channels, upsample_initial_channel, 7)
        if cond_channels:
            self.cond_layer = nn.Conv1d(cond_channels, upsample_initial_channel, 1)
        self.ups = nn.ModuleList()
        self.resblocks = nn.ModuleList()
        if cond_channels and cond_in_each_up_layer:
            self.conds = nn.ModuleList()
        for i, (u, k) in enumerate(zip(upsample_factors, upsample_kernel_sizes)):
            ch_in = upsample_initial_channel // (2**i)
            ch = upsample_initial_channel // (2 ** (i + 1))
            self.ups.append(WNConvTranspose1d(ch_in, ch, k, u))
            if hasattr(self, "conds"):
                self.conds.append(nn.Conv1d(cond_channels, ch, 1))
            for rk, rd in zip(resblock_kernel_sizes, resblock_dilation_sizes):
                self.resblocks.append(resblock_cls(ch, rk, tuple(rd)))
        self.conv_post = WNConv1d(ch, out_channels, 7, bias=conv_post_bias)
        self._packed: Dict[int, Tuple[tuple, MrfStage]] = {}

    def mrf_stage(self, i: int) -> MrfStage:
        """Stage i's MRF weights, folded and packed once and repacked only
        when a parameter of the stage changes."""
        blocks = self.resblocks[i * self.num_kernels : (i + 1) * self.num_kernels]
        params = [p for rb in blocks for p in rb.parameters()]
        key = tuple((p._version, p.data_ptr(), p.dtype) for p in params)
        hit = self._packed.get(i)
        if hit is None or hit[0] != key:
            with torch.no_grad():
                hit = (key, pack_stage([rb.units() for rb in blocks], sources=params))
            self._packed[i] = hit
        return hit[1]

    def forward(self, x, g=None):
        """x `[B, C_in, T]`; g `[B, C_g, 1]`, read when the generator has a
        `cond_layer` (and `conds`)."""
        o = self.conv_pre(x)
        if g is not None and hasattr(self, "cond_layer"):
            o = o + project(self.cond_layer, g, self.compute_dtype)
        for i in range(self.num_upsamples):
            o = self.ups[i](F.leaky_relu(o, LRELU_SLOPE))
            if g is not None and hasattr(self, "conds"):
                o = o + project(self.conds[i], g, self.compute_dtype)
            if self.resblock_type == "1" and not self.training:
                o = mrf_stack(o, self.mrf_stage(i))
            else:
                blocks = self.resblocks[i * self.num_kernels : (i + 1) * self.num_kernels]
                o = sum(rb(o) for rb in blocks) / self.num_kernels
        # slope 0.01 here, as in the flax generator (torch's default)
        return torch.tanh(self.conv_post(F.leaky_relu(o.float(), 0.01)))

    def inference(self, c, g=None):
        """`forward` on the mel edge-padded by `inference_padding` frames a side."""
        p = self.inference_padding
        return self(F.pad(c, (p, p), mode="replicate"), g)
