"""Pseudo-QMF filter bank of the multi-band vocoders, channels-first.

Counterpart of `tpu_tts/vocoder/layers/pqmf.py` (`PQMF`:14): the
cosine-modulated bank of N bands around a Kaiser prototype from
`scipy.signal.firwin`; analysis and synthesis are strided 1-D convolutions,
plain PyTorch as they are plain XLA in `tpu_tts`.
"""

import numpy as np
import torch
import torch.nn.functional as F


class PQMF:
    def __init__(self, N: int = 4, taps: int = 62, cutoff: float = 0.15, beta: float = 9.0):
        from scipy.signal import firwin

        self.N = N
        self.taps = taps
        qmf = firwin(taps + 1, cutoff, window=("kaiser", beta))
        H = np.zeros((N, len(qmf)))
        G = np.zeros((N, len(qmf)))
        for k in range(N):
            constant_factor = (2 * k + 1) * (np.pi / (2 * N)) * (np.arange(taps + 1) - (taps - 1) / 2)
            phase = (-1) ** k * np.pi / 4
            H[k] = 2 * qmf * np.cos(constant_factor + phase)
            G[k] = 2 * qmf * np.cos(constant_factor - phase)
        self.H = torch.from_numpy(H[:, None, :].astype(np.float32))  # analysis: [N, 1, taps + 1]
        self.G = torch.from_numpy(G[None].astype(np.float32))  # synthesis: [1, N, taps + 1]
        self.pad = taps // 2

    def analysis(self, x: torch.Tensor) -> torch.Tensor:
        """`[B, 1, T] → [B, N, T // N]`."""
        w = self.H.to(device=x.device, dtype=x.dtype)
        return F.conv1d(F.pad(x, (self.pad, self.pad)), w, stride=self.N)

    def synthesis(self, x: torch.Tensor) -> torch.Tensor:
        """`[B, N, T // N] → [B, 1, T]`: each band stuffed with N − 1 zeros
        between its samples (and scaled by N), then filtered."""
        B, N, T = x.shape
        up = torch.zeros(B, N, T * N, dtype=x.dtype, device=x.device)
        up[:, :, ::N] = x * N
        w = self.G.to(device=x.device, dtype=x.dtype)
        return F.conv1d(F.pad(up, (self.pad, self.pad)), w)
