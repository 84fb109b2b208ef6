"""Sequence ops of the inference path.

Counterparts of `tpu_tts/ops/helpers.py` (`sequence_mask`:16, `segment`:22,
`rand_segments`:33, `generate_path`:58, `average_over_durations`:71,
`beta_binomial_prior_distribution`:101, `compute_attn_prior`:114) and
`tpu_tts/utils/generic_utils.py` (`bucket_len`:56). `generate_path` keeps
the JAX layout: durations `[B, T_en]`, mask and path `[B, T_en, T_de]`.
The aligner's prior is host-side numpy, as in JAX.
"""

from typing import Optional, Tuple

import numpy as np
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


def average_over_durations(values: torch.Tensor, durs: torch.Tensor) -> torch.Tensor:
    """The mean of the nonzero frame values over each token's span of
    frames: values `[B, C, T_de]`, durations `[B, T_en]` → `[B, C, T_en]`
    (0 where a span holds no nonzero value)."""
    ends = torch.cumsum(durs, dim=1).long()  # [B, T_en]
    starts = F.pad(ends[:, :-1], (1, 0))
    nonzero_cums = F.pad(torch.cumsum((values != 0).to(values.dtype), dim=2), (1, 0))
    cums = F.pad(torch.cumsum(values, dim=2), (1, 0))
    C, last = values.shape[1], values.shape[2]
    dcs = starts.clamp(0, last)[:, None, :].expand(-1, C, -1)
    dce = ends.clamp(0, last)[:, None, :].expand(-1, C, -1)
    sums = torch.gather(cums, 2, dce) - torch.gather(cums, 2, dcs)
    nelems = torch.gather(nonzero_cums, 2, dce) - torch.gather(nonzero_cums, 2, dcs)
    return torch.where(nelems == 0, torch.zeros_like(sums), sums / nelems)


def bucket_len(n: int, grid: int, cap: int = None) -> int:
    """The smallest multiple of `grid` ≥ max(n, grid), optionally capped at
    max(cap, n)."""
    b = max(grid, -(-n // grid) * grid)
    if cap is not None:
        b = min(b, max(cap, n))
    return b


def beta_binomial_prior_distribution(phoneme_count: int, mel_count: int, scaling_factor: float = 1.0) -> np.ndarray:
    """The beta-binomial alignment prior `[mel_count, phoneme_count]`: row i
    (1-based) is BetaBinom(P, c·i, c·(M + 1 − i)) over the P tokens, all
    rows in one scipy call (`tpu_tts` freezes one distribution a row)."""
    from scipy.stats import betabinom

    i = np.arange(1, mel_count + 1, dtype=np.float64)[:, None]
    return betabinom.pmf(np.arange(phoneme_count)[None, :], phoneme_count, scaling_factor * i,
                         scaling_factor * (mel_count + 1 - i))


def compute_attn_prior(x_len: int, y_len: int, scaling_factor: float = 1.0) -> np.ndarray:
    """`[y_len, x_len]` prior of the aligner's attention (`use_attn_priors`)."""
    return beta_binomial_prior_distribution(x_len, y_len, scaling_factor)
