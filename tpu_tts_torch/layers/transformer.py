"""Relative-position transformer of the VITS text encoder, channels-first.

Counterpart of `tpu_tts/layers/transformer.py` (`RelativePositionMultiHead
Attention`:22, `FeedForwardNetwork`:109, `RelativePositionTransformer`:125).
Relative keys and values are learned for offsets within ±window and are zero
beyond it. The band is gathered through one `[T, T]` offset index rather
than the JAX version's per-diagonal masks; each score receives exactly one
relative term either way. Dropout (`dropout_p`) acts in `train()` mode only,
where the JAX modules take `train=True`: on the attention weights, after the
feed-forward's relu, and on each sub-layer's output.
"""

import math

import torch
import torch.nn as nn

from tpu_tts_torch.layers.common import Conv1d, LayerNorm


class RelativePositionMultiHeadAttention(nn.Module):
    def __init__(self, channels: int, out_channels: int, num_heads: int, rel_attn_window_size: int = 4,
                 dropout_p: float = 0.0):
        super().__init__()
        assert channels % num_heads == 0
        self.channels = channels
        self.num_heads = num_heads
        self.k_channels = channels // num_heads
        self.window = rel_attn_window_size
        self.conv_q = nn.Conv1d(channels, channels, 1)
        self.conv_k = nn.Conv1d(channels, channels, 1)
        self.conv_v = nn.Conv1d(channels, channels, 1)
        self.conv_o = nn.Conv1d(channels, out_channels, 1)
        self.drop = nn.Dropout(dropout_p)
        std = self.k_channels**-0.5
        self.emb_rel_k = nn.Parameter(torch.randn(1, 2 * self.window + 1, self.k_channels) * std)
        self.emb_rel_v = nn.Parameter(torch.randn(1, 2 * self.window + 1, self.k_channels) * std)

    def _heads(self, x):
        B, _, T = x.shape
        return x.view(B, self.num_heads, self.k_channels, T).transpose(2, 3)  # [B, H, T, dk]

    def forward(self, x, attn_mask):
        B, _, T = x.shape
        q, k, v = self._heads(self.conv_q(x)), self._heads(self.conv_k(x)), self._heads(self.conv_v(x))
        scale = 1.0 / math.sqrt(self.k_channels)
        scores = torch.matmul(q, k.transpose(2, 3)) * scale  # [B, H, T, T]

        w = self.window
        pos = torch.arange(T, device=x.device)
        rel = pos[None, :] - pos[:, None] + w  # band index of score [t, s]: s - t + w
        band = ((rel >= 0) & (rel <= 2 * w)).to(scores.dtype)
        rel = rel.clamp(0, 2 * w).expand(B, self.num_heads, T, T)
        qE = torch.matmul(q, self.emb_rel_k[0].t())  # [B, H, T, 2w+1]
        scores = scores + torch.gather(qE, 3, rel) * band * scale

        scores = scores.masked_fill(attn_mask == 0, -1e4)
        p_attn = self.drop(torch.softmax(scores, dim=-1))
        out = torch.matmul(p_attn, v)
        pB = torch.zeros(B, self.num_heads, T, 2 * w + 1, dtype=p_attn.dtype, device=x.device)
        pB.scatter_add_(3, rel, p_attn * band)
        out = out + torch.matmul(pB, self.emb_rel_v[0])
        out = out.transpose(2, 3).reshape(B, self.channels, T)
        return self.conv_o(out)


class FeedForwardNetwork(nn.Module):
    def __init__(self, in_channels: int, out_channels: int, hidden_channels: int, kernel_size: int,
                 dropout_p: float = 0.0):
        super().__init__()
        self.conv_1 = Conv1d(in_channels, hidden_channels, kernel_size)
        self.conv_2 = Conv1d(hidden_channels, out_channels, kernel_size)
        self.drop = nn.Dropout(dropout_p)

    def forward(self, x, x_mask):
        x = self.drop(torch.relu(self.conv_1(x * x_mask)))
        return self.conv_2(x * x_mask) * x_mask


class RelativePositionTransformer(nn.Module):
    """x `[B, C, T]`, x_mask `[B, 1, T]`; hidden and out widths are equal
    in VITS, so the JAX module's optional `proj` never exists here."""

    def __init__(self, hidden_channels: int, hidden_channels_ffn: int, num_heads: int, num_layers: int,
                 kernel_size: int = 1, rel_attn_window_size: int = 4, dropout_p: float = 0.0):
        super().__init__()
        self.num_layers = num_layers
        self.drop = nn.Dropout(dropout_p)
        self.attn_layers = nn.ModuleList(
            RelativePositionMultiHeadAttention(hidden_channels, hidden_channels, num_heads, rel_attn_window_size,
                                               dropout_p)
            for _ in range(num_layers)
        )
        self.norm_layers_1 = nn.ModuleList(LayerNorm(hidden_channels) for _ in range(num_layers))
        self.ffn_layers = nn.ModuleList(
            FeedForwardNetwork(hidden_channels, hidden_channels, hidden_channels_ffn, kernel_size, dropout_p)
            for _ in range(num_layers)
        )
        self.norm_layers_2 = nn.ModuleList(LayerNorm(hidden_channels) for _ in range(num_layers))

    def forward(self, x, x_mask):
        attn_mask = x_mask[:, :, :, None] * x_mask[:, :, None, :]  # [B, 1, T, T]
        for i in range(self.num_layers):
            x = x * x_mask
            y = self.drop(self.attn_layers[i](x, attn_mask))
            x = self.norm_layers_1[i](x + y)
            y = self.drop(self.ffn_layers[i](x, x_mask))
            x = self.norm_layers_2[i](x + y)
        return x * x_mask
