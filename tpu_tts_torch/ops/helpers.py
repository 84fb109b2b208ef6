"""Sequence ops of the inference path.

Counterparts of `tpu_tts/ops/helpers.py` (`sequence_mask`:16,
`generate_path`:58) and `tpu_tts/utils/generic_utils.py` (`bucket_len`:56).
`generate_path` keeps the JAX layout: durations `[B, T_en]`, mask and path
`[B, T_en, T_de]`.
"""

import torch
import torch.nn.functional as F


def sequence_mask(sequence_length: torch.Tensor, max_len: int) -> torch.Tensor:
    """`[B] → [B, max_len]` boolean mask."""
    seq_range = torch.arange(max_len, dtype=sequence_length.dtype, device=sequence_length.device)
    return seq_range[None, :] < sequence_length[:, None]


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
