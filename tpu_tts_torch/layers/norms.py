"""Norms selected by a `norm_type`, on channels-first `[B, C, ...]` tensors.

Counterpart of `tpu_tts/layers/tacotron.py` (`FrozenBatchNorm`:311, `_norm`
:329, `_apply_norm`:340), `tpu_tts/layers/common.py` (`TorchBatchNorm`:116)
and the speaker encoder's `_Norm2d` (`tpu_tts/encoder/models.py`:57):

- "batch" is torch's `nn.BatchNorm1d/2d` (momentum 0.1, eps 1e-5), the
  conventions of `TorchBatchNorm`: in `train()` mode it normalises by the
  batch's biased variance over every axis but the channels (padded frames
  included) and moves the running mean and the running variance, the latter
  by the unbiased batch variance; in `eval()` mode it normalises by them;
- "frozen_batch" always normalises by its running statistics (a Coqui
  checkpoint's) and takes no gradient for them;
- "layer" is a LayerNorm over the channels with flax's eps 1e-6.
"""

import torch
import torch.nn as nn
import torch.nn.functional as F


class FrozenBatchNorm(nn.modules.batchnorm._BatchNorm):
    """A batch norm that always normalises by its running statistics."""

    def _check_input_dim(self, x):
        pass

    def forward(self, x):
        return F.batch_norm(x, self.running_mean, self.running_var, self.weight, self.bias, False, 0.0, self.eps)


class ChannelLayerNorm(nn.Module):
    """LayerNorm over dim 1 of `[B, C, ...]` (flax's, eps 1e-6)."""

    def __init__(self, channels: int, eps: float = 1e-6):
        super().__init__()
        self.eps = eps
        self.weight = nn.Parameter(torch.ones(channels))
        self.bias = nn.Parameter(torch.zeros(channels))

    def forward(self, x):
        return F.layer_norm(x.movedim(1, -1), self.weight.shape, self.weight, self.bias, self.eps).movedim(-1, 1)


def make_norm(norm_type: str, channels: int, dims: int = 1) -> nn.Module:
    """The norm `norm_type` names over `channels`, for `[B, C, T]` (`dims`
    1) or `[B, C, H, W]` (2) inputs."""
    if norm_type == "batch":
        return (nn.BatchNorm2d if dims == 2 else nn.BatchNorm1d)(channels, eps=1e-5, momentum=0.1)
    if norm_type == "frozen_batch":
        return FrozenBatchNorm(channels, eps=1e-5)
    if norm_type == "layer":
        return ChannelLayerNorm(channels)
    raise ValueError(f" [!] Unknown norm_type {norm_type}")
