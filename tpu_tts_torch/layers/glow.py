"""Glow-TTS decoder flows, reverse direction (inference), channels-first.

Counterparts of `tpu_tts/layers/glow.py` (`squeeze`:22, `unsqueeze`:39,
`ActNorm`:50, `InvConvNear`:75, `CouplingBlock`:122, `GlowDecoder`:169) on
`[B, C, T]` with `[B, 1, T]` masks. Module and parameter names are Coqui's
(`TTS/tts/layers/glow_tts/{glow,decoder}.py`, `generic/normalization.py`):
`flows` holds [ActNorm, InvConvNear, CouplingBlock] per flow block. The
forward direction and its log-determinants belong to training (ROADMAP.md).
"""

import torch
import torch.nn as nn

from tpu_tts_torch.layers.common import WN, WNConv1d


def squeeze(x, x_mask, num_sqz: int = 2):
    """`[B, C, T] → [B, C·s, T/s]`: channel block k holds frame offset k."""
    b, c, t = x.shape
    t = (t // num_sqz) * num_sqz
    x_sqz = x[:, :, :t].reshape(b, c, t // num_sqz, num_sqz).permute(0, 3, 1, 2).reshape(b, c * num_sqz, t // num_sqz)
    x_mask = x_mask[:, :, num_sqz - 1 : t : num_sqz]
    return x_sqz * x_mask, x_mask


def unsqueeze(x, x_mask, num_sqz: int = 2):
    """Inverse of `squeeze`."""
    b, c, t = x.shape
    x_unsqz = x.reshape(b, num_sqz, c // num_sqz, t).permute(0, 2, 3, 1).reshape(b, c // num_sqz, t * num_sqz)
    x_mask = torch.repeat_interleave(x_mask, num_sqz, dim=2)
    return x_unsqz * x_mask, x_mask


class ActNorm(nn.Module):
    def __init__(self, channels: int):
        super().__init__()
        self.logs = nn.Parameter(torch.zeros(1, channels, 1))
        self.bias = nn.Parameter(torch.zeros(1, channels, 1))

    def reverse(self, x, x_mask):
        return (x - self.bias) * torch.exp(-self.logs) * x_mask


class InvConvNear(nn.Module):
    """Invertible 1×1 convolution over `num_splits` channel groups; the
    reverse applies the inverse of the `[s, s]` weight."""

    def __init__(self, channels: int, num_splits: int = 4):
        super().__init__()
        assert channels % num_splits == 0
        self.num_splits = num_splits
        self.weight = nn.Parameter(torch.eye(num_splits))

    def reverse(self, x, x_mask):
        b, c, t = x.shape
        s = self.num_splits
        # channels [2, c/s, s/2] regrouped to [s = 2·(s/2), c/s]
        xg = x.reshape(b, 2, c // s, s // 2, t).permute(0, 1, 3, 2, 4).reshape(b, s, c // s, t)
        w = torch.linalg.inv(self.weight.float()).to(self.weight.dtype)
        z = torch.einsum("rs,bsct->brct", w, xg)
        z = z.reshape(b, 2, s // 2, c // s, t).permute(0, 1, 3, 2, 4).reshape(b, c, t)
        return z * x_mask


class CouplingBlock(nn.Module):
    """Affine coupling: the first half of the channels, through a WN stack,
    gives the shift and log-scale of the second half."""

    def __init__(self, in_channels: int, hidden_channels: int, kernel_size: int, dilation_rate: int,
                 num_layers: int, sigmoid_scale: bool = False):
        super().__init__()
        self.sigmoid_scale = sigmoid_scale
        self.start = WNConv1d(in_channels // 2, hidden_channels, 1)
        self.wn = WN(hidden_channels, kernel_size, dilation_rate, num_layers)
        self.end = nn.Conv1d(hidden_channels, in_channels, 1)

    def reverse(self, x, x_mask):
        half = x.shape[1] // 2
        x_0, x_1 = x[:, :half], x[:, half:]
        h = self.wn(self.start(x_0) * x_mask, x_mask)
        out = self.end(h)
        t, s = out[:, :half], out[:, half:]
        if self.sigmoid_scale:
            s = torch.log(1e-6 + torch.sigmoid(s + 2))
        return torch.cat([x_0, (x_1 - t) * torch.exp(-s) * x_mask], dim=1)


class GlowDecoder(nn.Module):
    """squeeze → the flow blocks in reverse → unsqueeze."""

    def __init__(self, in_channels: int, hidden_channels: int, kernel_size: int, dilation_rate: int,
                 num_flow_blocks: int, num_coupling_layers: int, num_splits: int = 4, num_squeeze: int = 2,
                 sigmoid_scale: bool = False):
        super().__init__()
        self.num_squeeze = num_squeeze
        ch = in_channels * num_squeeze
        self.flows = nn.ModuleList()
        for _ in range(num_flow_blocks):
            self.flows.append(ActNorm(ch))
            self.flows.append(InvConvNear(ch, num_splits))
            self.flows.append(CouplingBlock(ch, hidden_channels, kernel_size, dilation_rate, num_coupling_layers,
                                            sigmoid_scale))

    def reverse(self, z, z_mask):
        """z `[B, C, T]`, z_mask `[B, 1, T]` → mel `[B, C, T]`."""
        if self.num_squeeze > 1:
            z, z_mask = squeeze(z, z_mask, self.num_squeeze)
        for flow in reversed(self.flows):
            z = flow.reverse(z, z_mask)
        if self.num_squeeze > 1:
            z, z_mask = unsqueeze(z, z_mask, self.num_squeeze)
        return z
