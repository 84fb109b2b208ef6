"""XTTS conditioning stack: mel → ConditioningEncoder → PerceiverResampler.

Counterpart of `tpu_tts/layers/xtts/perceiver.py` (`_group_count`:22,
`AttentionBlock`:29, `ConditioningEncoder`:55, `PerceiverAttention`:72,
`GEGLUFeedForward`:98, `PerceiverResampler`:113). The conditioning encoder
runs channels-first `[B, C, T]` with 1×1 convs, as Coqui's
`ConditioningEncoder` does; the perceiver runs `[B, T, C]`. Attribute names
are those of Coqui's state dict (`attn.{i}.qkv`, `layers.{i}.0.to_q`,
`layers.{i}.1.0`, `norm.gamma`).

- AttentionBlock: GroupNorm (groups as `_group_count`), a per-head packed
  qkv (channels [h0:(q, k, v), h1:(q, k, v), ...]), q and k each scaled by
  1/sqrt(sqrt(ch)), and the residual taken from the NORMED input, as JAX.
- PerceiverResampler: learned latents; per layer latents += attn(latents,
  cat(latents, x)), then latents += GEGLU feed-forward (exact GELU); a
  final RMSNorm with a learned gamma.
"""

import math

import torch
import torch.nn as nn
import torch.nn.functional as F


def _group_count(channels: int) -> int:
    groups = 16
    while channels % groups != 0:
        groups //= 2
    return groups


class AttentionBlock(nn.Module):
    def __init__(self, channels: int, num_heads: int = 4):
        super().__init__()
        self.num_heads = num_heads
        self.norm = nn.GroupNorm(_group_count(channels), channels, eps=1e-5)
        self.qkv = nn.Conv1d(channels, 3 * channels, 1)
        self.proj_out = nn.Conv1d(channels, channels, 1)
        nn.init.zeros_(self.proj_out.weight)
        nn.init.zeros_(self.proj_out.bias)

    def forward(self, x):
        """x `[B, C, T]`."""
        B, C, T = x.shape
        H = self.num_heads
        ch = C // H
        h = self.norm(x)
        qkv = self.qkv(h).reshape(B, H, 3, ch, T)
        q, k, v = qkv[:, :, 0], qkv[:, :, 1], qkv[:, :, 2]  # [B, H, ch, T]
        scale = 1.0 / math.sqrt(math.sqrt(ch))
        att = torch.softmax(torch.einsum("bhct,bhcs->bhts", q * scale, k * scale), dim=-1)
        y = torch.einsum("bhts,bhcs->bhct", att, v).reshape(B, C, T)
        return h + self.proj_out(y)


class ConditioningEncoder(nn.Module):
    """1×1 conv + `attn_blocks` attention blocks: mel `[B, C_mel, T]` →
    `[B, embedding_dim, T]`."""

    def __init__(self, spec_dim: int = 80, embedding_dim: int = 1024, attn_blocks: int = 6,
                 num_attn_heads: int = 4):
        super().__init__()
        self.init = nn.Conv1d(spec_dim, embedding_dim, 1)
        self.attn = nn.Sequential(*(AttentionBlock(embedding_dim, num_attn_heads) for _ in range(attn_blocks)))

    def forward(self, mel):
        return self.attn(self.init(mel))


class PerceiverAttention(nn.Module):
    """Cross-attention whose context includes the queries."""

    def __init__(self, dim: int, heads: int = 8, dim_head: int = 64):
        super().__init__()
        self.heads, self.dim_head = heads, dim_head
        inner = heads * dim_head
        self.to_q = nn.Linear(dim, inner, bias=False)
        self.to_kv = nn.Linear(dim, 2 * inner, bias=False)
        self.to_out = nn.Linear(inner, dim, bias=False)

    def forward(self, latents, context):
        B, Tq, _ = latents.shape
        H, D = self.heads, self.dim_head
        ctx = torch.cat([latents, context], dim=1)
        q = self.to_q(latents).reshape(B, Tq, H, D)
        k, v = self.to_kv(ctx).chunk(2, dim=-1)
        k, v = k.reshape(B, -1, H, D), v.reshape(B, -1, H, D)
        att = torch.softmax(torch.einsum("bthd,bshd->bhts", q, k) / math.sqrt(D), dim=-1)
        return self.to_out(torch.einsum("bhts,bshd->bthd", att, v).reshape(B, Tq, H * D))


class GEGLUFeedForward(nn.Sequential):
    """Linear(dim → 2·inner) → gelu(gate)·x → Linear(inner → dim), inner =
    dim·mult·2/3; the GEGLU has no weights, so the Linears are `0` and `2`."""

    def __init__(self, dim: int, mult: int = 4):
        inner = int(dim * mult * 2 / 3)
        super().__init__(nn.Linear(dim, 2 * inner), GEGLU(), nn.Linear(inner, dim))


class GEGLU(nn.Module):
    def forward(self, x):
        a, gate = x.chunk(2, dim=-1)
        return F.gelu(gate) * a


class RMSNorm(nn.Module):
    def __init__(self, dim: int):
        super().__init__()
        self.scale = math.sqrt(dim)
        self.gamma = nn.Parameter(torch.ones(dim))

    def forward(self, x):
        return x / torch.clamp(torch.linalg.vector_norm(x, dim=-1, keepdim=True), min=1e-12) * self.scale * self.gamma


class PerceiverResampler(nn.Module):
    """Learned latents resampling features of any length to `num_latents`:
    x `[B, T, dim]` → `[B, num_latents, dim]`."""

    def __init__(self, dim: int = 1024, depth: int = 2, num_latents: int = 32, heads: int = 8, dim_head: int = 64):
        super().__init__()
        self.latents = nn.Parameter(torch.randn(num_latents, dim) * 0.02)
        self.layers = nn.ModuleList(
            nn.ModuleList([PerceiverAttention(dim, heads, dim_head), GEGLUFeedForward(dim)]) for _ in range(depth)
        )
        self.norm = RMSNorm(dim)

    def forward(self, x):
        h = self.latents[None].expand(x.shape[0], -1, -1)
        for attn, ff in self.layers:
            h = attn(h, x) + h
            h = ff(h) + h
        return self.norm(h)
