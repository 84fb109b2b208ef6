"""The feed-forward encoders and decoders of the ForwardTTS family and its
aligner, channels-last `[B, T, C]` with `[B, T, 1]` masks.

Counterpart of `tpu_tts/layers/feed_forward.py` (Coqui's
`generic/transformer.py`, `feed_forward/{encoder,decoder}.py`,
`generic/res_conv_bn.py`, `generic/pos_encoding.py`, `generic/aligner.py`):
`FFTransformerLayer`:20, `FFTransformerBlock`:53, `Conv1dBN`:83,
`Conv1dBNBlock`:126, `ResidualConv1dBNBlock`:148, `ResidualConv1dBNEncoder`
:179, `ResidualConv1dBNDecoder`:206, `WaveNetDecoder`:226,
`PositionalEncoding`:247 and `AlignmentNetwork`:280. Each module keeps the
flax module's name, so that the JAX param tree reaches the port by renames
(`models/forward_convert.py`): flax's `Conv1d` of
`tpu_tts/layers/common.py`:19 is `FlaxConv1d` holding `conv`, a flax
`Dense` is a 1×1 `Conv` (weight `[out, in, 1]`, Coqui's 1×1 conv layout),
flax's `MultiHeadDotProductAttention` is `MultiHeadAttention` with its
`query`, `key`, `value` and `out` projections. Dropout acts in `train()`
mode only.
"""

import math
from typing import Sequence

import numpy as np
import torch
import torch.nn as nn
import torch.nn.functional as F

from tpu_tts_torch.layers.common import WN
from tpu_tts_torch.layers.delightful import Conv
from tpu_tts_torch.layers.norms import make_norm


class FlaxConv1d(nn.Module):
    """`tpu_tts.layers.common.Conv1d` on `[B, T, C]`: a dense layer named
    `conv` at kernel size 1, else a length-preserving conv named `conv`,
    (k // 2) frames of zeros on the left and the rest on the right."""

    def __init__(self, in_channels: int, out_channels: int, kernel_size: int = 1):
        super().__init__()
        if kernel_size == 1:
            self.conv = nn.Linear(in_channels, out_channels)
        else:
            self.conv = Conv(in_channels, out_channels, kernel_size)
            self.conv.pads = (kernel_size // 2, kernel_size - 1 - kernel_size // 2)

    def forward(self, x):
        return self.conv(x)


class MultiHeadAttention(nn.Module):
    """flax's `MultiHeadDotProductAttention` as the FFT layer builds it
    (`qkv_features` = `out_features` = channels): the query scaled by
    1/√head_dim, keys where `mask` `[B, T]` is False scored at the dtype's
    lowest value, softmax, dropout on the weights."""

    def __init__(self, channels: int, num_heads: int, dropout_p: float = 0.0):
        super().__init__()
        assert channels % num_heads == 0
        self.num_heads = num_heads
        self.query = nn.Linear(channels, channels)
        self.key = nn.Linear(channels, channels)
        self.value = nn.Linear(channels, channels)
        self.out = nn.Linear(channels, channels)
        self.drop = nn.Dropout(dropout_p)

    def forward(self, x, mask=None):
        B, T, C = x.shape
        heads = lambda t: t.view(B, T, self.num_heads, C // self.num_heads)  # noqa: E731
        q = heads(self.query(x)) / math.sqrt(C // self.num_heads)
        w = torch.einsum("bqhd,bkhd->bhqk", q, heads(self.key(x)))
        if mask is not None:
            w = w.masked_fill(~mask[:, None, None, :], torch.finfo(w.dtype).min)
        w = self.drop(torch.softmax(w, dim=-1))
        return self.out(torch.einsum("bhqk,bkhd->bqhd", w, heads(self.value(x))).reshape(B, T, C))


class FFTransformerLayer(nn.Module):
    """Self-attention, then a two-conv feed-forward. As in the reference the
    attention output is added twice (`x + dropout(x2)`, then `norm1(x + x2)`)."""

    def __init__(self, channels: int, num_heads: int, hidden_channels_ffn: int = 1024, kernel_size_fft: int = 3,
                 dropout_p: float = 0.1):
        super().__init__()
        self.self_attn = MultiHeadAttention(channels, num_heads, dropout_p)
        self.norm1 = nn.LayerNorm(channels, eps=1e-6)
        self.conv1 = FlaxConv1d(channels, hidden_channels_ffn, kernel_size_fft)
        self.conv2 = FlaxConv1d(hidden_channels_ffn, channels, kernel_size_fft)
        self.norm2 = nn.LayerNorm(channels, eps=1e-6)
        self.drop = nn.Dropout(dropout_p)

    def forward(self, x, key_padding_mask=None):
        x2 = self.self_attn(x, key_padding_mask)
        x = x + self.drop(x2)
        x = self.norm1(x + x2)
        y = self.drop(self.conv2(F.relu(self.conv1(x))))
        return self.norm2(x + y)


class FFTransformerBlock(nn.Module):
    """`num_layers` FFT layers (`fft_{i}`), keys masked by `x_mask`, the
    output masked."""

    def __init__(self, channels: int, num_heads: int, hidden_channels_ffn: int, num_layers: int, dropout_p: float):
        super().__init__()
        self.num_layers = num_layers
        for i in range(num_layers):
            self.add_module(f"fft_{i}", FFTransformerLayer(channels, num_heads, hidden_channels_ffn,
                                                           dropout_p=dropout_p))

    def forward(self, x, x_mask=None):
        kpm = x_mask[:, :, 0] > 0 if x_mask is not None else None
        for i in range(self.num_layers):
            x = getattr(self, f"fft_{i}")(x, key_padding_mask=kpm)
        return x * x_mask if x_mask is not None else x


class Conv1dBN(nn.Module):
    """Conv → zero the boundary rows → relu → norm, the reference's valid
    conv padded after it (`tpu_tts/layers/feed_forward.py`:83): the input is
    padded by d·(k − 1) frames, split (⌊p/2⌋, ⌈p/2⌉), and the conv's rows
    before ⌊p/2⌋ and from each row's length − ⌈p/2⌉ on (`x_mask` given; else
    from T − ⌈p/2⌉) are zeroed, so that a row padded to a bucket gives what
    it gives alone. The norm then acts on the zeroed rows too."""

    def __init__(self, in_channels: int, out_channels: int, kernel_size: int, dilation: int = 1,
                 norm_type: str = "layer"):
        super().__init__()
        pad = dilation * (kernel_size - 1)
        self.pads = (pad // 2, pad - pad // 2)
        self.conv1d = nn.Conv1d(in_channels, out_channels, kernel_size, dilation=dilation)
        self.norm = make_norm(norm_type, out_channels)

    def forward(self, x, x_mask=None):
        T = x.shape[1]
        ps, pe = self.pads
        y = self.conv1d(F.pad(x.transpose(1, 2), self.pads))  # [B, C, T]
        if ps or pe:
            idx = torch.arange(T, device=x.device)
            if x_mask is not None:
                lengths = x_mask[:, :, 0].sum(1)
                edge = (idx[None, :] >= ps) & (idx[None, :] < torch.clamp(lengths - pe, min=ps)[:, None])
            else:
                edge = ((idx >= ps) & (idx < max(T - pe, ps)))[None, :]
            y = y * edge[:, None, :].to(y.dtype)
        return self.norm(F.relu(y)).transpose(1, 2)


class Conv1dBNBlock(nn.Module):
    """`num_conv_blocks` Conv1dBN at one dilation (`conv_bn_{i}`); the last
    gives `out_channels`, the others `hidden_channels`."""

    def __init__(self, in_channels: int, out_channels: int, hidden_channels: int, kernel_size: int,
                 dilation: int = 1, num_conv_blocks: int = 2, norm_type: str = "layer"):
        super().__init__()
        self.num_conv_blocks = num_conv_blocks
        for i in range(num_conv_blocks):
            self.add_module(f"conv_bn_{i}", Conv1dBN(
                in_channels if i == 0 else hidden_channels,
                out_channels if i == num_conv_blocks - 1 else hidden_channels, kernel_size, dilation, norm_type))

    def forward(self, x, x_mask=None):
        for i in range(self.num_conv_blocks):
            x = getattr(self, f"conv_bn_{i}")(x, x_mask)
        return x


class ResidualConv1dBNBlock(nn.Module):
    """One Conv1dBNBlock a dilation (`res_block_{b}`), each with a residual
    and the mask; the SpeedySpeech encoder's and decoder's core."""

    def __init__(self, hidden_channels: int, out_channels: int, kernel_size: int, dilations: Sequence[int],
                 num_conv_blocks: int = 2, norm_type: str = "layer"):
        super().__init__()
        self.n = len(dilations)
        for b, d in enumerate(dilations):
            ch = out_channels if b == self.n - 1 else hidden_channels
            self.add_module(f"res_block_{b}", Conv1dBNBlock(hidden_channels, ch, hidden_channels, kernel_size, d,
                                                            num_conv_blocks, norm_type))

    def forward(self, x, x_mask=None):
        m = x_mask if x_mask is not None else 1.0
        o = x * m
        for b in range(self.n):
            o = (getattr(self, f"res_block_{b}")(o, x_mask) + o) * m
        return o


class ResidualConv1dBNEncoder(nn.Module):
    """SpeedySpeech's encoder: a 1×1 relu prenet, the residual conv stack,
    the input added back, then 1×1 → relu → norm → 1×1, masked."""

    def __init__(self, in_channels: int, hidden_channels: int, out_channels: int, kernel_size: int = 4,
                 dilations: Sequence[int] = (1, 2, 4, 1, 2, 4, 1, 2, 4, 1, 2, 4, 1), num_conv_blocks: int = 2,
                 norm_type: str = "layer"):
        super().__init__()
        self.prenet = Conv(in_channels, hidden_channels, 1)
        self.res_conv_block = ResidualConv1dBNBlock(hidden_channels, hidden_channels, kernel_size, tuple(dilations),
                                                    num_conv_blocks, norm_type)
        self.postnet_0 = Conv(hidden_channels, hidden_channels, 1)
        self.postnet_norm = make_norm(norm_type, hidden_channels)
        self.postnet_1 = Conv(hidden_channels, out_channels, 1)

    def forward(self, x, x_mask=None):
        m = x_mask if x_mask is not None else 1.0
        o = F.relu(self.prenet(x)) * m
        o = self.res_conv_block(o, x_mask) + x
        o = F.relu(self.postnet_0(o))
        o = self.postnet_norm(o.transpose(1, 2)).transpose(1, 2)
        return self.postnet_1(o) * m


class ResidualConv1dBNDecoder(nn.Module):
    """SpeedySpeech's decoder: the residual conv stack, a 1×1 `post_conv`
    with the input added back, a two-conv Conv1dBNBlock postnet, masked; the
    reference's last 1×1 conv is the model's `proj`."""

    def __init__(self, hidden_channels: int, out_channels: int, kernel_size: int = 4,
                 dilations: Sequence[int] = tuple(4 * [1, 2, 4, 8] + [1]), num_conv_blocks: int = 2,
                 norm_type: str = "layer"):
        super().__init__()
        self.res_conv_block = ResidualConv1dBNBlock(hidden_channels, hidden_channels, kernel_size, tuple(dilations),
                                                    num_conv_blocks, norm_type)
        self.post_conv = Conv(hidden_channels, hidden_channels, 1)
        self.postnet_block = Conv1dBNBlock(hidden_channels, hidden_channels, hidden_channels, kernel_size, 1,
                                           num_conv_blocks=2, norm_type=norm_type)

    def forward(self, x, x_mask=None):
        o = self.post_conv(self.res_conv_block(x, x_mask)) + x
        o = self.postnet_block(o, x_mask)
        return o * x_mask if x_mask is not None else o


class WaveNetDecoder(nn.Module):
    """The port's weight-normalised `WN` stack (`wn`), then a 1×1 `proj`, masked."""

    def __init__(self, hidden_channels: int, out_channels: int, kernel_size: int = 3, dilation_rate: int = 1,
                 num_layers: int = 10):
        super().__init__()
        self.wn = WN(hidden_channels, kernel_size, dilation_rate, num_layers)
        self.proj = FlaxConv1d(hidden_channels, out_channels, 1)

    def forward(self, x, x_mask=None):
        m = x_mask if x_mask is not None else torch.ones_like(x[:, :, :1])
        h = self.wn(x.transpose(1, 2), m.transpose(1, 2)).transpose(1, 2)
        return self.proj(h) * m


def sinusoid_table(length: int, channels: int) -> np.ndarray:
    """`[length, channels]` float32: sin at even channels and cos at odd ones
    of position · 10000^(2i/C). The reference MULTIPLIES by 10000^(2i/C),
    the inverse of the usual transformer table (`generic/pos_encoding.py`
    :29); kept, as `tpu_tts` keeps it, for its checkpoints."""
    position = np.arange(length)[:, None].astype(np.float32)
    div_term = np.power(10000.0, np.arange(0, channels, 2).astype(np.float32) / channels)
    pe = np.zeros((length, channels), dtype=np.float32)
    pe[:, 0::2] = np.sin(position * div_term)
    pe[:, 1::2] = np.cos(position * div_term)[:, : channels // 2]
    return pe


class PositionalEncoding(nn.Module):
    """x · √C plus the sinusoid table (times the learned `scale` with
    `use_scale`), the table and the sum masked by `x_mask`."""

    def __init__(self, channels: int, use_scale: bool = False, max_len: int = 10000):
        super().__init__()
        self.channels = channels
        self.max_len = max_len
        if use_scale:
            self.scale = nn.Parameter(torch.ones(1))
        else:
            self.scale = None
        self._table = None

    def table(self, length: int, device, dtype) -> torch.Tensor:
        if length > self.max_len:
            raise ValueError(f"{length} frames exceed the positional table's {self.max_len}")
        t = self._table
        if t is None or t.shape[0] < length or t.device != torch.device(device) or t.dtype != dtype:
            self._table = t = torch.from_numpy(sinusoid_table(max(length, 1024), self.channels)).to(device, dtype)
        return t[:length]

    def forward(self, x, x_mask=None):
        pe = self.table(x.shape[1], x.device, x.dtype)[None]
        x = x * math.sqrt(self.channels)
        if x_mask is not None:
            pe = pe * x_mask
        x = x + (self.scale * pe if self.scale is not None else pe)
        return x * x_mask if x_mask is not None else x


class AlignmentNetwork(nn.Module):
    """Gaussian-attention aligner: queries (mel) `[B, T_de, C_q]` and keys
    (token embeddings) `[B, T_en, C_k]` → (soft attention, its log-probs),
    each `[B, T_de, T_en]`. The log-probs are −temperature · the squared L2
    distance of the projected query and key; with a prior `[B, T_de, T_en]`
    they become log_softmax over the keys + log(prior + 1e-8). Masked keys
    (`mask` `[B, T_en]`, True or > 0 where valid) get −inf."""

    def __init__(self, in_query_channels: int = 80, in_key_channels: int = 512, attn_channels: int = 80,
                 temperature: float = 0.0005):
        super().__init__()
        self.temperature = temperature
        self.key_conv1 = FlaxConv1d(in_key_channels, in_key_channels * 2, 3)
        self.key_conv2 = FlaxConv1d(in_key_channels * 2, attn_channels, 1)
        self.query_conv1 = FlaxConv1d(in_query_channels, in_query_channels * 2, 3)
        self.query_conv2 = FlaxConv1d(in_query_channels * 2, in_query_channels, 1)
        self.query_conv3 = FlaxConv1d(in_query_channels, attn_channels, 1)

    def forward(self, queries, keys, mask=None, attn_prior=None):
        key_out = self.key_conv2(F.relu(self.key_conv1(keys)))
        q = self.query_conv3(F.relu(self.query_conv2(F.relu(self.query_conv1(queries)))))
        attn_factor = torch.sum((q[:, :, None, :] - key_out[:, None, :, :]) ** 2, dim=-1)
        attn_logp = -self.temperature * attn_factor
        if attn_prior is not None:
            attn_logp = F.log_softmax(attn_logp, dim=-1) + torch.log(attn_prior + 1e-8)
        if mask is not None:
            attn_logp = torch.where(mask[:, None, :] > 0, attn_logp, torch.full_like(attn_logp, float("-inf")))
        return torch.softmax(attn_logp, dim=-1), attn_logp
