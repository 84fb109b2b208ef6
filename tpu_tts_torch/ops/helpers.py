"""Sequence ops of the inference path.

Counterparts of `tpu_tts/ops/helpers.py` (`sequence_mask`:16, `segment`:22,
`rand_segments`:33, `generate_path`:58) and `tpu_tts/utils/generic_utils.py`
(`bucket_len`:56). `generate_path` keeps the JAX layout: durations
`[B, T_en]`, mask and path `[B, T_en, T_de]`.
"""

from typing import Optional, Tuple

import torch
import torch.nn.functional as F


def sequence_mask(sequence_length: torch.Tensor, max_len: int) -> torch.Tensor:
    """`[B] → [B, max_len]` boolean mask."""
    seq_range = torch.arange(max_len, dtype=sequence_length.dtype, device=sequence_length.device)
    return seq_range[None, :] < sequence_length[:, None]


def segment(x: torch.Tensor, segment_indices: torch.Tensor, segment_size: int, pad_short: bool = False
            ) -> torch.Tensor:
    """A window of `segment_size` frames per row: `[B, C, T] → [B, C,
    segment_size]`. A start past `T - segment_size` is clamped to it, as
    `lax.dynamic_slice` clamps."""
    if pad_short and x.shape[-1] < segment_size:
        x = F.pad(x, (0, segment_size - x.shape[-1]))
    start = segment_indices.long().clamp(0, x.shape[-1] - segment_size)
    idx = start[:, None] + torch.arange(segment_size, device=x.device)[None, :]  # [B, segment_size]
    return torch.gather(x, 2, idx[:, None, :].expand(-1, x.shape[1], -1))


def rand_segments(x: torch.Tensor, x_lengths: Optional[torch.Tensor] = None, segment_size: int = 4,
                  let_short_samples: bool = False, pad_short: bool = False, u: Optional[torch.Tensor] = None,
                  generator: Optional[torch.Generator] = None) -> Tuple[torch.Tensor, torch.Tensor]:
    """Random windows per row (VITS's decoder-memory trick): (segments `[B, C,
    segment_size]`, start indices `[B]`). The start is ⌊u · (len − size +
    1)⌋ for u ~ U[0, 1) `[B]`, drawn from `generator` unless given."""
    B, _, T = x.shape
    if pad_short and T < segment_size:
        x = F.pad(x, (0, segment_size - T))
        T = segment_size
    if x_lengths is None:
        x_lengths = torch.full((B,), T, device=x.device)
    if let_short_samples or pad_short:
        x_lengths = torch.clamp(x_lengths, min=segment_size)
    len_diff = x_lengths - segment_size
    if u is None:
        u = torch.rand(B, generator=generator, device=x.device)
    segment_indices = (u.float() * (len_diff + 1).float()).long()
    return segment(x, segment_indices, segment_size, pad_short=pad_short), segment_indices


def generate_path(duration: torch.Tensor, mask: torch.Tensor) -> torch.Tensor:
    """Durations → hard monotonic attention map `[B, T_en, T_de]`."""
    t_y = mask.shape[2]
    cum_duration = torch.cumsum(duration, dim=1)
    seq = torch.arange(t_y, device=duration.device)
    path = (seq[None, None, :] < cum_duration[:, :, None]).to(mask.dtype)
    path = path - F.pad(path, (0, 0, 1, 0))[:, :-1]
    return path * mask


def bucket_len(n: int, grid: int, cap: int = None) -> int:
    """The smallest multiple of `grid` ≥ max(n, grid), optionally capped at
    max(cap, n)."""
    b = max(grid, -(-n // grid) * grid)
    if cap is not None:
        b = min(b, max(cap, n))
    return b
