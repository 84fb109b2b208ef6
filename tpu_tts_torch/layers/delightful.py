"""DelightfulTTS layers, channels-last `[B, T, C]`: the conformer, the prosody
reference encoders and the variance adaptors.

Counterpart of `tpu_tts/layers/delightful.py`, class by class and with its
module names, so the port's state dict keeps the flax tree's paths
(`models/delightful_convert.py`): `positional_encoding`:30, `_norm_last`:40,
`EmbeddingPadded`:47, `BSConv1d`:65, `ConvTransposed`:78, `Conv1dGLU`:90,
`CoordConv1d`:108, `InstanceNorm1dAffine`:132, `RelativeMultiHeadAttention`
:153 (`_relative_shift`:159), `ConformerMultiHeadedSelfAttention`:188,
`ConformerFeedForward`:206, `ConformerConvModule`:226, `ConformerBlock`:249,
`Conformer`:286, `ReferenceEncoder`:318, `StyleEmbedAttention`:365, `STL`
:390, `UtteranceLevelProsodyEncoder`:405, `PhonemeLevelProsodyEncoder`:432,
`VariancePredictor`:469, `PhonemeProsodyPredictor`:491, `PitchAdaptor`:512,
`EnergyAdaptor`:550.

What the flax modules fix and the port keeps:
- masks are boolean valid masks (True = keep);
- convs pad SAME (the strided convs of the reference encoder pad k//2 a
  side) and take channels-last input (`Conv`: weight `[out, in/groups, k]`);
- layer and group norms use flax's eps 1e-6; `_norm_last` and
  `InstanceNorm1dAffine` use 1e-5; `GroupNorm1` normalises over time and
  channels together, as flax's `GroupNorm(num_groups=1)`;
- `EmbeddingPadded` zeroes the rows whose index is the pad index, not
  torch's `padding_idx` (which only freezes the row);
- the conformer's GLU gate is a leaky ReLU of slope `lrelu_slope` (0.3),
  and `Conv1dGLU` adds the soft-sign of the speaker projection;
- the reference encoder's GRU runs over the whole padded sequence (no
  packing) and its final state is read at `out_lens − 1`; torch's GRU
  computes flax's `GRUCell` once `bias_hh` holds zeros for r and z
  (`vocoder/models/wavernn_convert.py::gru_from_flax`), and a hook zeroes
  their gradient, so training keeps them at 0.
Dropout acts in `train()` mode only, as the flax modules' under
`train=True`.
"""

import math
from typing import Sequence

import torch
import torch.nn as nn
import torch.nn.functional as F

from tpu_tts_torch.ops.helpers import average_over_durations, sequence_mask

NORM_EPS = 1e-6  # flax LayerNorm and GroupNorm


def positional_encoding(d_model: int, length: int, device=None, dtype=torch.float32) -> torch.Tensor:
    """Sinusoidal table `[1, length, d_model]`."""
    position = torch.arange(length, dtype=dtype, device=device)[:, None]
    div_term = torch.exp(torch.arange(0, d_model, 2, dtype=dtype, device=device) * -(math.log(10000.0) / d_model))
    pe = torch.zeros(length, d_model, dtype=dtype, device=device)
    pe[:, 0::2] = torch.sin(position * div_term)
    pe[:, 1::2] = torch.cos(position * div_term)
    return pe[None]


def _norm_last(x: torch.Tensor, eps: float = 1e-5) -> torch.Tensor:
    """torch's `InstanceNorm1d(affine=False)` of a `[B, x, C]` tensor: over the last axis."""
    mean = x.mean(dim=-1, keepdim=True)
    var = x.var(dim=-1, unbiased=False, keepdim=True)
    return (x - mean) * torch.rsqrt(var + eps)


class Conv(nn.Conv1d):
    """flax's `nn.Conv` on `[B, T, C]`: SAME padding, or `padding` frames a
    side; a 1×1 conv is a matmul over the channels."""

    def __init__(self, in_channels: int, out_channels: int, kernel_size: int, stride: int = 1, padding="SAME",
                 groups: int = 1, bias: bool = True):
        super().__init__(in_channels, out_channels, kernel_size, stride=stride, groups=groups, bias=bias)
        if padding == "SAME":
            lo = (kernel_size - 1) // 2
            self.pads = (lo, kernel_size - 1 - lo)
        else:
            self.pads = (padding, padding)

    def forward(self, x):
        if self.kernel_size[0] == 1 and self.stride[0] == 1 and self.groups == 1:
            return F.linear(x, self.weight[:, :, 0], self.bias)
        y = F.conv1d(F.pad(x.transpose(1, 2), self.pads), self.weight, self.bias, self.stride, 0, 1, self.groups)
        return y.transpose(1, 2)


class GroupNorm1(nn.Module):
    """flax's `GroupNorm(num_groups=1)` on `[B, T, C]`: one mean and variance
    over time and channels, a scale and bias per channel."""

    def __init__(self, channels: int, eps: float = NORM_EPS):
        super().__init__()
        self.eps = eps
        self.weight = nn.Parameter(torch.ones(channels))
        self.bias = nn.Parameter(torch.zeros(channels))

    def forward(self, x):
        mean = x.mean(dim=(1, 2), keepdim=True)
        var = x.var(dim=(1, 2), unbiased=False, keepdim=True)
        return (x - mean) * torch.rsqrt(var + self.eps) * self.weight + self.bias


class EmbeddingPadded(nn.Module):
    """Token embedding whose pad index gives a zero row."""

    def __init__(self, num_embeddings: int, embedding_dim: int, padding_idx: int = 0):
        super().__init__()
        self.padding_idx = padding_idx
        self.embeddings = nn.Embedding(num_embeddings, embedding_dim)
        nn.init.normal_(self.embeddings.weight, std=math.sqrt(2 / embedding_dim))

    def forward(self, idx):
        emb = self.embeddings(idx)
        return emb * (idx != self.padding_idx)[..., None].to(emb.dtype)


class BSConv1d(nn.Module):
    """Blueprint-separable conv: depthwise (k taps) then pointwise."""

    def __init__(self, channels_in: int, channels_out: int, kernel_size: int):
        super().__init__()
        self.depthwise = Conv(channels_in, channels_in, kernel_size, groups=channels_in)
        self.pointwise = Conv(channels_in, channels_out, 1)

    def forward(self, x):
        return self.pointwise(self.depthwise(x))


class ConvTransposed(nn.Module):
    """`BSConv1d` on `[B, T, C]` (the reference's transposes are layout only)."""

    def __init__(self, channels_in: int, channels_out: int, kernel_size: int = 1):
        super().__init__()
        self.conv = BSConv1d(channels_in, channels_out, kernel_size)

    def forward(self, x):
        return self.conv(x)


class Conv1dGLU(nn.Module):
    """Gated conv with speaker conditioning (DeepVoice 3)."""

    def __init__(self, d_model: int, kernel_size: int, embedding_dim: int):
        super().__init__()
        self.conv = BSConv1d(d_model, 2 * d_model, kernel_size)
        self.embedding_proj = nn.Linear(embedding_dim, d_model)

    def forward(self, x, embeddings):
        """x `[B, T, d_model]`, embeddings `[B, E]`."""
        a, b = self.conv(x).chunk(2, dim=-1)
        a = a + F.softsign(self.embedding_proj(embeddings))[:, None, :]
        return (a * torch.sigmoid(b) + x) * math.sqrt(0.5)


class CoordConv1d(nn.Module):
    """Conv over the input with a coordinate channel (linspace −1…1) and its
    magnitude appended."""

    def __init__(self, in_channels: int, out_channels: int, kernel_size: int, stride: int = 1, with_r: bool = True):
        super().__init__()
        self.with_r = with_r
        self.conv = Conv(in_channels + 1 + int(with_r), out_channels, kernel_size, stride=stride,
                         padding=kernel_size // 2)

    def forward(self, x):
        B, T, _ = x.shape
        coords = (torch.linspace(-1.0, 1.0, T, dtype=x.dtype, device=x.device) if T > 1
                  else torch.zeros(1, dtype=x.dtype, device=x.device))
        coords = coords[None, :, None].expand(B, T, 1)
        feats = [x, coords] + ([coords.abs()] if self.with_r else [])
        return self.conv(torch.cat(feats, dim=-1))


class InstanceNorm1dAffine(nn.Module):
    """torch's `InstanceNorm1d(affine=True)` on `[B, T, C]`: per channel over time."""

    def __init__(self, features: int, eps: float = 1e-5):
        super().__init__()
        self.eps = eps
        self.weight = nn.Parameter(torch.ones(features))
        self.bias = nn.Parameter(torch.zeros(features))

    def forward(self, x):
        mean = x.mean(dim=1, keepdim=True)
        var = x.var(dim=1, unbiased=False, keepdim=True)
        return (x - mean) * torch.rsqrt(var + self.eps) * self.weight + self.bias


# --------------------------------------------------------------------------- conformer


class RelativeMultiHeadAttention(nn.Module):
    """Transformer-XL relative-position multi-head attention."""

    def __init__(self, d_model: int, num_heads: int):
        super().__init__()
        self.d_model, self.num_heads = d_model, num_heads
        d_head = d_model // num_heads
        self.query_proj = nn.Linear(d_model, d_model)
        self.key_proj = nn.Linear(d_model, d_model, bias=False)
        self.value_proj = nn.Linear(d_model, d_model, bias=False)
        self.pos_proj = nn.Linear(d_model, d_model, bias=False)
        self.u_bias = nn.Parameter(nn.init.xavier_uniform_(torch.empty(num_heads, d_head)))
        self.v_bias = nn.Parameter(nn.init.xavier_uniform_(torch.empty(num_heads, d_head)))
        self.out_proj = nn.Linear(d_model, d_model)

    @staticmethod
    def _relative_shift(pos_score: torch.Tensor) -> torch.Tensor:
        b, h, l1, l2 = pos_score.shape
        padded = F.pad(pos_score, (1, 0)).reshape(b, h, l2 + 1, l1)
        return padded[:, :, 1:].reshape(b, h, l1, l2)

    def forward(self, query, key, value, pos_embedding, valid_mask):
        """valid_mask `[B, 1, 1, T_k]` or `[B, 1, T_q, T_k]` (True = keep);
        pos_embedding `[1, T_k, d_model]`, broadcast over B."""
        B = query.shape[0]
        h, d_head = self.num_heads, self.d_model // self.num_heads
        q = self.query_proj(query).reshape(B, -1, h, d_head)
        k = self.key_proj(key).reshape(B, -1, h, d_head)
        v = self.value_proj(value).reshape(B, -1, h, d_head)
        pos = self.pos_proj(pos_embedding).reshape(-1, pos_embedding.shape[1], h, d_head)
        content_score = torch.einsum("bqhd,bkhd->bhqk", q + self.u_bias, k)
        pos_score = torch.einsum("bqhd,bkhd->bhqk", q + self.v_bias, pos.expand(k.shape[0], -1, -1, -1))
        score = (content_score + self._relative_shift(pos_score)) / math.sqrt(self.d_model)
        score = score.masked_fill(~valid_mask, -1e9)
        attn = torch.softmax(score, dim=-1)
        context = torch.einsum("bhqk,bkhd->bqhd", attn, v).reshape(B, -1, self.d_model)
        return self.out_proj(context), attn


class ConformerMultiHeadedSelfAttention(nn.Module):
    """`RelativeMultiHeadAttention` on the positional table cut to the key's length, then dropout."""

    def __init__(self, d_model: int, num_heads: int, dropout_p: float):
        super().__init__()
        self.attention = RelativeMultiHeadAttention(d_model, num_heads)
        self.dropout = nn.Dropout(dropout_p)

    def forward(self, query, key, value, valid_mask, encoding):
        out, attn = self.attention(query, key, value, encoding[:, : key.shape[1]], valid_mask)
        return self.dropout(out), attn


class ConformerFeedForward(nn.Module):
    """Pre-norm conv feed-forward, halved (the block adds the residual)."""

    def __init__(self, d_model: int, kernel_size: int = 3, dropout: float = 0.1, lrelu_slope: float = 0.3,
                 expansion_factor: int = 4):
        super().__init__()
        self.lrelu_slope = lrelu_slope
        self.ln = nn.LayerNorm(d_model, eps=NORM_EPS)
        self.conv_1 = Conv(d_model, d_model * expansion_factor, kernel_size)
        self.conv_2 = Conv(d_model * expansion_factor, d_model, 1)
        self.dropout = nn.Dropout(dropout)

    def forward(self, x):
        x = F.leaky_relu(self.conv_1(self.ln(x)), self.lrelu_slope)
        return 0.5 * self.dropout(self.conv_2(self.dropout(x)))


class ConformerConvModule(nn.Module):
    """Pointwise conv with a leaky-ReLU gate, depthwise conv, group norm, pointwise conv."""

    def __init__(self, d_model: int, kernel_size: int = 7, expansion_factor: int = 2, dropout: float = 0.1,
                 lrelu_slope: float = 0.3):
        super().__init__()
        inner = d_model * expansion_factor
        self.lrelu_slope = lrelu_slope
        self.ln_1 = nn.LayerNorm(d_model, eps=NORM_EPS)
        self.conv_1 = Conv(d_model, inner * 2, 1)
        self.depthwise = Conv(inner, inner, kernel_size, groups=inner)
        self.ln_2 = GroupNorm1(inner)
        self.conv_2 = Conv(inner, d_model, 1)
        self.dropout = nn.Dropout(dropout)

    def forward(self, x):
        out, gate = self.conv_1(self.ln_1(x)).chunk(2, dim=-1)
        x = self.depthwise(out * F.leaky_relu(gate, self.lrelu_slope))
        x = F.leaky_relu(self.ln_2(x), self.lrelu_slope)
        return self.dropout(self.conv_2(x))


class ConformerBlock(nn.Module):
    """(speaker GLU) → feed-forward → conv module → self-attention → conv module, with residuals."""

    def __init__(self, d_model: int, n_heads: int, kernel_size_conv_mod: int, speaker_embedding_dim: int,
                 dropout: float, lrelu_slope: float = 0.3):
        super().__init__()
        if speaker_embedding_dim:
            self.conditioning = Conv1dGLU(d_model, kernel_size_conv_mod, speaker_embedding_dim)
        self.ff = ConformerFeedForward(d_model, dropout=dropout, lrelu_slope=lrelu_slope)
        self.conformer_conv_1 = ConformerConvModule(d_model, kernel_size_conv_mod, dropout=dropout,
                                                    lrelu_slope=lrelu_slope)
        self.ln = nn.LayerNorm(d_model, eps=NORM_EPS)
        self.slf_attn = ConformerMultiHeadedSelfAttention(d_model, n_heads, dropout)
        self.conformer_conv_2 = ConformerConvModule(d_model, kernel_size_conv_mod, dropout=dropout,
                                                    lrelu_slope=lrelu_slope)

    def forward(self, x, valid_mask, attn_valid_mask, speaker_embedding, encoding):
        if speaker_embedding is not None and hasattr(self, "conditioning"):
            x = self.conditioning(x, speaker_embedding)
        x = self.ff(x) + x
        x = self.conformer_conv_1(x) + x
        y = self.ln(x)
        x = self.slf_attn(y, y, y, attn_valid_mask, encoding)[0] + x
        x = x * valid_mask[:, :, None].to(x.dtype)
        return self.conformer_conv_2(x) + x


class Conformer(nn.Module):
    """A stack of `ConformerBlock`s, `block_{i}`."""

    def __init__(self, dim: int, n_layers: int, n_heads: int, speaker_embedding_dim: int, p_dropout: float,
                 kernel_size_conv_mod: int, lrelu_slope: float = 0.3):
        super().__init__()
        self.n_layers = n_layers
        for i in range(n_layers):
            self.add_module(f"block_{i}", ConformerBlock(dim, n_heads, kernel_size_conv_mod, speaker_embedding_dim,
                                                         p_dropout, lrelu_slope))

    def forward(self, x, valid_mask, speaker_embedding, encoding):
        attn_valid_mask = valid_mask[:, None, None, :]
        for i in range(self.n_layers):
            x = getattr(self, f"block_{i}")(x, valid_mask, attn_valid_mask, speaker_embedding, encoding)
        return x


# --------------------------------------------------------------------------- prosody reference encoders


def _zero_rz_grad(grad):
    """A GRU `bias_hh`'s gradient with its r and z thirds zeroed."""
    n = grad.shape[0] // 3
    return torch.cat([torch.zeros_like(grad[: 2 * n]), grad[2 * n:]])


class ReferenceEncoder(nn.Module):
    """Mel reference encoder: a coordinate conv and strided convs (each with a
    leaky ReLU and an instance norm), then a GRU. Returns (outputs
    `[B, T', H]`, the final state `[B, H]`, out_lens `[B]`)."""

    def __init__(self, num_mels: int, ref_enc_filters: Sequence[int] = (32, 32, 64, 64, 128, 128),
                 ref_enc_size: int = 3, ref_enc_strides: Sequence[int] = (1, 2, 1, 2, 1), ref_enc_gru_size: int = 32):
        super().__init__()
        self.strides = [1] + list(ref_enc_strides)
        filters = list(ref_enc_filters)
        self.n_convs = len(filters)
        pad = ref_enc_size // 2
        for i in range(self.n_convs):
            if i == 0:
                conv = CoordConv1d(num_mels, filters[0], ref_enc_size, stride=self.strides[0])
            else:
                conv = Conv(filters[i - 1], filters[i], ref_enc_size, stride=self.strides[i], padding=pad)
            self.add_module(f"conv_{i}", conv)
            self.add_module(f"norm_{i}", InstanceNorm1dAffine(filters[i]))
        self.gru = nn.GRU(filters[-1], ref_enc_gru_size, batch_first=True)
        # flax's GRUCell has no hidden-side bias for r and z: those entries of
        # bias_hh hold 0 and get no gradient, so training moves what JAX moves
        with torch.no_grad():
            self.gru.bias_hh_l0[: 2 * ref_enc_gru_size].zero_()
        self.gru.bias_hh_l0.register_hook(_zero_rz_grad)

    def forward(self, mels, mel_lens):
        """mels `[B, T, num_mels]`, mel_lens `[B]`."""
        x = mels * sequence_mask(mel_lens, mels.shape[1]).to(mels.dtype)[:, :, None]
        for i in range(self.n_convs):
            x = F.leaky_relu(getattr(self, f"conv_{i}")(x), 0.3)
            x = getattr(self, f"norm_{i}")(x)
        out_lens = mel_lens
        for s in self.strides:
            if s > 1:
                out_lens = torch.div(out_lens + s - 1, s, rounding_mode="floor")
        x = x * sequence_mask(out_lens, x.shape[1]).to(x.dtype)[:, :, None]
        dtype = torch.promote_types(x.dtype, self.gru.weight_ih_l0.dtype)
        if x.dtype == dtype == self.gru.weight_ih_l0.dtype:
            outputs, _ = self.gru(x)
        else:  # bfloat16 weights and a float32 input (mixed precision): float32, as flax promotes
            weights = {n: p.to(dtype) for n, p in self.gru.named_parameters()}
            outputs, _ = torch.func.functional_call(self.gru, weights, (x.to(dtype),))
        idx = (out_lens - 1).clamp(0, x.shape[1] - 1).long()
        final = outputs[torch.arange(x.shape[0], device=x.device), idx]
        return outputs, final, out_lens


class StyleEmbedAttention(nn.Module):
    """Multi-head attention of a query over style tokens."""

    def __init__(self, query_dim: int, key_in_dim: int, num_units: int, num_heads: int, key_dim: int):
        super().__init__()
        self.num_units, self.num_heads, self.key_dim = num_units, num_heads, key_dim
        self.W_query = nn.Linear(query_dim, num_units, bias=False)
        self.W_key = nn.Linear(key_in_dim, num_units, bias=False)
        self.W_value = nn.Linear(key_in_dim, num_units, bias=False)

    def forward(self, query, key_soft):
        h = self.num_heads
        d = self.num_units // h
        q, k, v = self.W_query(query), self.W_key(key_soft), self.W_value(key_soft)
        B, Tq, _ = q.shape
        Tk = k.shape[1]
        q = q.reshape(B, Tq, h, d).transpose(1, 2)
        k = k.reshape(B, Tk, h, d).transpose(1, 2)
        v = v.reshape(B, Tk, h, d).transpose(1, 2)
        scores = torch.softmax(torch.einsum("bhqd,bhkd->bhqk", q, k) / (self.key_dim**0.5), dim=-1)
        out = torch.einsum("bhqk,bhkd->bhqd", scores, v)
        return out.transpose(1, 2).reshape(B, Tq, self.num_units)


class STL(nn.Module):
    """Style token layer: `[B, E/2]` → `[B, 1, E]`."""

    def __init__(self, n_hidden: int, token_num: int = 32):
        super().__init__()
        self.embed = nn.Parameter(torch.randn(token_num, n_hidden) * 0.5)
        self.attention = StyleEmbedAttention(n_hidden // 2, n_hidden, n_hidden, 1, n_hidden)

    def forward(self, x):
        keys = torch.tanh(self.embed)[None].expand(x.shape[0], -1, -1)
        return self.attention(x[:, None, :], keys)


class UtteranceLevelProsodyEncoder(nn.Module):
    """Utterance prosody: the reference encoder's final state → STL → bottleneck."""

    def __init__(self, num_mels: int, ref_enc_filters: Sequence[int], ref_enc_size: int,
                 ref_enc_strides: Sequence[int], ref_enc_gru_size: int, dropout: float, n_hidden: int,
                 bottleneck_size_u: int, token_num: int):
        super().__init__()
        self.encoder = ReferenceEncoder(num_mels, ref_enc_filters, ref_enc_size, ref_enc_strides, ref_enc_gru_size)
        self.encoder_prj = nn.Linear(ref_enc_gru_size, n_hidden // 2)
        self.stl = STL(n_hidden, token_num)
        self.encoder_bottleneck = nn.Linear(n_hidden, bottleneck_size_u)
        self.dropout = nn.Dropout(dropout)

    def forward(self, mels, mel_lens):
        """mels `[B, T, C]` → `[B, 1, bottleneck_size_u]`."""
        _, memory, _ = self.encoder(mels, mel_lens)
        out = self.stl(self.encoder_prj(memory))
        return self.dropout(self.encoder_bottleneck(out))


class PhonemeLevelProsodyEncoder(nn.Module):
    """Phoneme prosody: the text's frames attend over the reference-encoded mel frames."""

    def __init__(self, num_mels: int, ref_enc_filters: Sequence[int], ref_enc_size: int,
                 ref_enc_strides: Sequence[int], ref_enc_gru_size: int, dropout: float, n_hidden: int, n_heads: int,
                 bottleneck_size_p: int):
        super().__init__()
        self.encoder = ReferenceEncoder(num_mels, ref_enc_filters, ref_enc_size, ref_enc_strides, ref_enc_gru_size)
        self.encoder_prj = nn.Linear(ref_enc_gru_size, n_hidden)
        self.attention = ConformerMultiHeadedSelfAttention(n_hidden, n_heads, dropout)
        self.encoder_bottleneck = nn.Linear(n_hidden, bottleneck_size_p)

    def forward(self, x, src_valid_mask, mels, mel_lens, encoding):
        """x `[B, T_src, E]` → `[B, T_src, bottleneck_size_p]`."""
        outputs, _, out_lens = self.encoder(mels, mel_lens)
        embedded_prosody = self.encoder_prj(outputs)
        attn_valid = sequence_mask(out_lens, outputs.shape[1])[:, None, None, :]
        x, _ = self.attention(x, embedded_prosody, embedded_prosody, attn_valid, encoding)
        return self.encoder_bottleneck(x) * src_valid_mask[:, :, None].to(x.dtype)


# --------------------------------------------------------------------------- variance adaptors


class VariancePredictor(nn.Module):
    """Two (BSConv, leaky ReLU, layer norm, dropout) stages and a linear head."""

    def __init__(self, channels_in: int, channels: int, channels_out: int = 1, kernel_size: int = 5,
                 p_dropout: float = 0.5, lrelu_slope: float = 0.3):
        super().__init__()
        self.channels_out, self.lrelu_slope = channels_out, lrelu_slope
        self.conv_0 = ConvTransposed(channels_in, channels, kernel_size)
        self.ln_0 = nn.LayerNorm(channels, eps=NORM_EPS)
        self.conv_1 = ConvTransposed(channels, channels, kernel_size)
        self.ln_1 = nn.LayerNorm(channels, eps=NORM_EPS)
        self.dropout = nn.Dropout(p_dropout)
        self.linear_layer = nn.Linear(channels, channels_out)

    def forward(self, x, valid_mask):
        """x `[B, T, C]`, valid_mask `[B, T]` (float) → `[B, T]` (`channels_out` 1)."""
        for conv, ln in ((self.conv_0, self.ln_0), (self.conv_1, self.ln_1)):
            x = self.dropout(ln(F.leaky_relu(conv(x), self.lrelu_slope)))
        x = self.linear_layer(x)
        x = x[..., 0] if self.channels_out == 1 else x
        return x * valid_mask


class PhonemeProsodyPredictor(nn.Module):
    """Two (BSConv, leaky ReLU, layer norm, dropout) stages and a bottleneck."""

    def __init__(self, hidden_size: int, kernel_size: int, dropout: float, bottleneck_size: int,
                 lrelu_slope: float = 0.3):
        super().__init__()
        self.lrelu_slope = lrelu_slope
        self.conv_0 = ConvTransposed(hidden_size, hidden_size, kernel_size)
        self.ln_0 = nn.LayerNorm(hidden_size, eps=NORM_EPS)
        self.conv_1 = ConvTransposed(hidden_size, hidden_size, kernel_size)
        self.ln_1 = nn.LayerNorm(hidden_size, eps=NORM_EPS)
        self.dropout = nn.Dropout(dropout)
        self.predictor_bottleneck = nn.Linear(hidden_size, bottleneck_size)

    def forward(self, x, valid_mask):
        for conv, ln in ((self.conv_0, self.ln_0), (self.conv_1, self.ln_1)):
            x = self.dropout(ln(F.leaky_relu(conv(x), self.lrelu_slope)))
        return self.predictor_bottleneck(x * valid_mask[:, :, None].to(x.dtype))


class PitchAdaptor(nn.Module):
    """Pitch predictor and the conv embedding of a pitch contour."""

    def __init__(self, n_input: int, n_hidden: int, kernel_size: int = 5, emb_kernel_size: int = 3,
                 p_dropout: float = 0.5, lrelu_slope: float = 0.3):
        super().__init__()
        self.pitch_predictor = VariancePredictor(n_input, n_hidden, 1, kernel_size, p_dropout, lrelu_slope)
        self.pitch_emb = Conv(1, n_input, emb_kernel_size)

    def get_pitch_embedding_train(self, x, target, dr, valid_mask):
        """x `[B, T_src, C]`, target `[B, T_mel]`, dr `[B, T_src]` → (pred
        `[B, T_src]`, the target averaged over each token `[B, T_src]`, its
        embedding `[B, T_src, C]`)."""
        pitch_pred = self.pitch_predictor(x, valid_mask)
        avg_target = average_over_durations(target[:, None, :], dr.long())[:, 0]
        return pitch_pred, avg_target, self.pitch_emb(avg_target[:, :, None])

    def get_pitch_embedding(self, x, valid_mask, pitch_transform=None, pitch_mean=None, pitch_std=None):
        pitch_pred = self.pitch_predictor(x, valid_mask)
        if pitch_transform is not None:
            pitch_pred = pitch_transform(pitch_pred, valid_mask.sum(), pitch_mean, pitch_std)
        return self.pitch_emb(pitch_pred[:, :, None]), pitch_pred


class EnergyAdaptor(nn.Module):
    """Energy predictor and the conv embedding of an energy contour."""

    def __init__(self, channels_in: int, channels_hidden: int, kernel_size: int = 5, emb_kernel_size: int = 3,
                 dropout: float = 0.5, lrelu_slope: float = 0.3):
        super().__init__()
        self.energy_predictor = VariancePredictor(channels_in, channels_hidden, 1, kernel_size, dropout, lrelu_slope)
        self.energy_emb = Conv(1, channels_hidden, emb_kernel_size)

    def get_energy_embedding_train(self, x, target, dr, valid_mask):
        energy_pred = self.energy_predictor(x, valid_mask)
        avg_target = average_over_durations(target[:, None, :], dr.long())[:, 0]
        return energy_pred, avg_target, self.energy_emb(avg_target[:, :, None])

    def get_energy_embedding(self, x, valid_mask, energy_transform=None):
        energy_pred = self.energy_predictor(x, valid_mask)
        if energy_transform is not None:
            energy_pred = energy_transform(energy_pred, valid_mask.sum(dim=-1))
        return self.energy_emb(energy_pred[:, :, None]), energy_pred
