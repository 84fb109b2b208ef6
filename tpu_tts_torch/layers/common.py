"""Common building blocks, channels-first `[B, C, T]` with `[B, 1, T]` masks.

Counterparts of `tpu_tts/layers/common.py` (`Conv1d`:19, `WNConv1d`:46,
`LayerNorm`:99, `ResidualConv1dLayerNormBlock`:160, `WN`:266,
`DurationPredictor`:312). Dropout (`dropout_p` of `WN` and the
`DurationPredictor`) acts in `train()` mode only, as the JAX modules' under
`train=True`. Parameter names follow the Coqui state dict:
a weight-normalised conv stores `parametrizations.weight.original0` (g, one
norm per dim-0 slice) and `parametrizations.weight.original1` (v), as
`torch.nn.utils.parametrizations.weight_norm` does.

Mixed precision (VITS's own route, `tpu_tts/layers/common.py`:59-95 and
the flax modules' `dtype`): a module with a `compute_dtype` attribute
computes in it once `set_compute_dtype` has set it. A weight-normalised
conv folds g·v/‖v‖ in its parameters' float32 and then casts the kernel,
the input and the bias; a 1×1 projection through `project` casts the same
three (flax's `Dense(dtype=)`). What such a module returns is combined
with float32 tensors by torch's type promotion, which is JAX's: bfloat16
with float32 gives float32.
"""

import contextlib
import math

import torch
import torch.nn as nn
import torch.nn.functional as F


class Conv1d(nn.Conv1d):
    """Length-preserving conv: symmetric padding (k//2)·d for odd k,
    asymmetric (left (k//2)·d, right the rest) for even k."""

    def __init__(self, in_channels: int, out_channels: int, kernel_size: int = 1, dilation: int = 1):
        super().__init__(in_channels, out_channels, kernel_size, dilation=dilation)
        total = (kernel_size - 1) * dilation
        self._left = (kernel_size // 2) * dilation
        self._right = total - self._left

    def forward(self, x):
        if self._left or self._right:
            x = F.pad(x, (self._left, self._right))
        return super().forward(x)


class WeightNorm(nn.Module):
    """The `(g, v)` pair of one weight-normalised kernel; weight = g·v/‖v‖
    with the norm over every dim but 0. The folded kernel is cached and
    recomputed only when either tensor changes (load, `.to`, in-place)."""

    def __init__(self, shape):
        super().__init__()
        self.original0 = nn.Parameter(torch.ones((shape[0],) + (1,) * (len(shape) - 1)))
        self.original1 = nn.Parameter(torch.empty(shape))
        self._key = None
        self._weight = None

    def reset_parameters(self, fan_in: int):
        nn.init.normal_(self.original1, std=math.sqrt(2.0 / fan_in))
        with torch.no_grad():
            self.original0.copy_(self._norm(self.original1))

    @staticmethod
    def _norm(v):
        return torch.sqrt(torch.sum(v * v, dim=tuple(range(1, v.ndim)), keepdim=True))

    def forward(self) -> torch.Tensor:
        g, v = self.original0, self.original1
        if torch.is_grad_enabled() and (g.requires_grad or v.requires_grad):
            return v * (g / self._norm(v))
        key = (g._version, v._version, g.data_ptr(), v.data_ptr(), g.dtype, v.dtype)
        if key != self._key:
            with torch.no_grad():
                self._weight = v * (g / self._norm(v))
            self._key = key
        return self._weight


def set_compute_dtype(module: nn.Module, dtype) -> None:
    """Set the compute dtype (None: the parameters' float32) of every module
    inside `module` that has one."""
    for m in module.modules():
        if hasattr(m, "compute_dtype"):
            m.compute_dtype = dtype


@contextlib.contextmanager
def frozen(module: nn.Module):
    """Within: `module`'s parameters take no gradient."""
    params = [p for p in module.parameters() if p.requires_grad]
    for p in params:
        p.requires_grad_(False)
    try:
        yield
    finally:
        for p in params:
            p.requires_grad_(True)


def cast_conv(conv, x: torch.Tensor, w: torch.Tensor, b=None, **kwargs) -> torch.Tensor:
    """`conv(x, w) + b` in `w`'s dtype, `x` and `b` cast to it. In bfloat16
    the conv's output is rounded and the bias added in bfloat16, as in the
    flax modules. On the CPU a bfloat16 conv runs in float32 on the rounded
    operands and rounds its output, the same function (bfloat16 operands, a
    float32 sum) as XLA's CPU backend computes; torch 2.13's CPU bfloat16
    `conv_transpose1d` gives wrong input gradients at some widths (16 → 8)."""
    x = x.to(w.dtype)
    if w.dtype != torch.bfloat16:
        return conv(x, w, b, **kwargs)
    if x.device.type == "cpu":
        y = conv(x.float(), w.float(), **kwargs).to(torch.bfloat16)
    else:
        y = conv(x, w, **kwargs)
    return y if b is None else y + b.to(y.dtype).reshape(-1, *([1] * (y.ndim - 2)))


def project(conv: nn.Conv1d, x: torch.Tensor, dtype=None) -> torch.Tensor:
    """`conv(x)`, or with `dtype` its input, weight and bias cast to `dtype`
    first (flax's `Dense(dtype=)`)."""
    if dtype is None:
        return conv(x)
    return cast_conv(F.conv1d, x, conv.weight.to(dtype), conv.bias, stride=conv.stride, padding=conv.padding,
                     dilation=conv.dilation, groups=conv.groups)


def reflect_pad(x: torch.Tensor, pad: int) -> torch.Tensor:
    """`x` reflected by `pad` samples at both ends of its last axis, as
    `jnp.pad(mode="reflect")`: a pad as long as the axis or longer keeps
    reflecting (the axis extended with period 2·(T − 1))."""
    T = x.shape[-1]
    if pad < T:
        return F.pad(x, (pad, pad), mode="reflect")
    i = torch.arange(-pad, T + pad, device=x.device).abs() % max(2 * (T - 1), 1)
    return x[..., torch.where(i < T, i, 2 * (T - 1) - i)]


class WNConv1d(nn.Module):
    """Weight-normalised conv with (k//2)·d padding on both sides, zeros or
    (`pad_mode="reflect"`, MelGAN's) the reflection of the input; without
    a bias when `bias` is False. The input is cast to the kernel's dtype, as
    in the flax module."""

    def __init__(self, in_channels: int, out_channels: int, kernel_size: int = 1, dilation: int = 1,
                 bias: bool = True, pad_mode: str = "zeros"):
        super().__init__()
        self.compute_dtype = None
        self.kernel_size = kernel_size
        self.dilation = dilation
        self.pad_mode = pad_mode
        self.parametrizations = nn.ModuleDict({"weight": WeightNorm((out_channels, in_channels, kernel_size))})
        self.bias = nn.Parameter(torch.zeros(out_channels)) if bias else None
        self.parametrizations["weight"].reset_parameters(in_channels * kernel_size)

    @property
    def weight(self) -> torch.Tensor:
        return self.parametrizations["weight"]()

    def forward(self, x):
        pad = (self.kernel_size // 2) * self.dilation
        w = self.weight if self.compute_dtype is None else self.weight.to(self.compute_dtype)
        if self.pad_mode == "reflect" and pad:
            x, pad = reflect_pad(x, pad), 0
        return cast_conv(F.conv1d, x, w, self.bias, padding=pad, dilation=self.dilation)


class LayerNorm(nn.Module):
    """Layer norm over the channel dim of `[B, C, T]` (eps 1e-4)."""

    def __init__(self, channels: int, eps: float = 1e-4):
        super().__init__()
        self.eps = eps
        self.gamma = nn.Parameter(torch.ones(channels))
        self.beta = nn.Parameter(torch.zeros(channels))

    def forward(self, x):
        mean = torch.mean(x, dim=1, keepdim=True)
        var = torch.mean((x - mean) ** 2, dim=1, keepdim=True)
        x = (x - mean) * torch.rsqrt(var + self.eps)
        return x * self.gamma[None, :, None] + self.beta[None, :, None]


class WN(nn.Module):
    """Gated WaveNet stack with weight norm, x `[B, C, T]`. With
    `cond_channels`, `cond_layer` maps g `[B, C_g, 1]` to 2·hidden channels
    per layer, layer i taking slice i of them (`tpu_tts/layers/common.py`
    :283-297)."""

    def __init__(self, hidden_channels: int, kernel_size: int, dilation_rate: int, num_layers: int,
                 cond_channels: int = 0, dropout_p: float = 0.0):
        super().__init__()
        self.hidden_channels = hidden_channels
        self.drop = nn.Dropout(dropout_p)
        self.num_layers = num_layers
        self.in_layers = nn.ModuleList(
            WNConv1d(hidden_channels, 2 * hidden_channels, kernel_size, dilation=dilation_rate**i)
            for i in range(num_layers)
        )
        self.res_skip_layers = nn.ModuleList(
            WNConv1d(hidden_channels, 2 * hidden_channels if i < num_layers - 1 else hidden_channels, 1)
            for i in range(num_layers)
        )
        if cond_channels:
            self.cond_layer = WNConv1d(cond_channels, 2 * hidden_channels * num_layers, 1)

    def forward(self, x, x_mask, g=None):
        h = self.hidden_channels
        output = torch.zeros_like(x)
        g_all = self.cond_layer(g) if g is not None else None
        for i in range(self.num_layers):
            z = self.drop(self.in_layers[i](x))
            if g_all is not None:
                z = z + g_all[:, i * 2 * h : (i + 1) * 2 * h]
            acts = torch.tanh(z[:, :h]) * torch.sigmoid(z[:, h:])
            res_skip = self.res_skip_layers[i](acts)
            if i < self.num_layers - 1:
                x = (x + res_skip[:, :h]) * x_mask
                output = output + res_skip[:, h:]
            else:
                output = output + res_skip
        return output * x_mask


class ResidualConv1dLayerNormBlock(nn.Module):
    """[k-conv → LN → relu] × N, then a residual 1×1 projection (the Glow-TTS
    encoder prenet)."""

    def __init__(self, in_channels: int, hidden_channels: int, out_channels: int, kernel_size: int, num_layers: int):
        super().__init__()
        self.conv_layers = nn.ModuleList(
            Conv1d(in_channels if i == 0 else hidden_channels, hidden_channels, kernel_size) for i in range(num_layers)
        )
        self.norm_layers = nn.ModuleList(LayerNorm(hidden_channels) for _ in range(num_layers))
        self.proj = nn.Conv1d(hidden_channels, out_channels, 1)

    def forward(self, x, x_mask):
        x_res = x
        for conv, norm in zip(self.conv_layers, self.norm_layers):
            x = torch.relu(norm(conv(x * x_mask) * x_mask))
        return (x_res + self.proj(x)) * x_mask


class DurationPredictor(nn.Module):
    """[k-conv → relu → LN] × 2 → 1×1 conv: log durations `[B, 1, T]`. With
    `cond_channels` / `language_emb_dim`, 1×1 projections of g and the
    language embedding (`[B, C, 1]`) are added to the input first."""

    def __init__(self, in_channels: int, hidden_channels: int, kernel_size: int, cond_channels: int = 0,
                 language_emb_dim: int = 0, dropout_p: float = 0.0):
        super().__init__()
        self.drop = nn.Dropout(dropout_p)
        self.conv_1 = Conv1d(in_channels, hidden_channels, kernel_size)
        self.norm_1 = LayerNorm(hidden_channels)
        self.conv_2 = Conv1d(hidden_channels, hidden_channels, kernel_size)
        self.norm_2 = LayerNorm(hidden_channels)
        self.proj = nn.Conv1d(hidden_channels, 1, 1)
        if cond_channels:
            self.cond = nn.Conv1d(cond_channels, in_channels, 1)
        if language_emb_dim:
            self.cond_lang = nn.Conv1d(language_emb_dim, in_channels, 1)

    def forward(self, x, x_mask, g=None, lang_emb=None):
        if g is not None:
            x = x + self.cond(g)
        if lang_emb is not None:
            x = x + self.cond_lang(lang_emb)
        x = self.drop(self.norm_1(torch.relu(self.conv_1(x * x_mask))))
        x = self.drop(self.norm_2(torch.relu(self.conv_2(x * x_mask))))
        return self.proj(x * x_mask) * x_mask
