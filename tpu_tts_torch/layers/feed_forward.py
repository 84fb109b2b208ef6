"""The aligner of the forward-TTS family, channels-last `[B, T, C]`.

Counterpart of `tpu_tts/layers/feed_forward.py::AlignmentNetwork`:280 (Coqui's
`generic/aligner.py`), with its module names: each conv is flax's `Conv1d`
of `tpu_tts/layers/common.py`:19, a module holding `conv`, which is a dense
layer at kernel size 1 and a length-preserving conv otherwise. The other
feed-forward layers of the JAX module (FastPitch's encoders and decoders)
come with the ForwardTTS models (ROADMAP.md, M9b).
"""

import torch
import torch.nn as nn
import torch.nn.functional as F

from tpu_tts_torch.layers.delightful import Conv


class FlaxConv1d(nn.Module):
    """`tpu_tts.layers.common.Conv1d` on `[B, T, C]`: a dense layer named
    `conv` at kernel size 1, else a SAME-padded conv named `conv`."""

    def __init__(self, in_channels: int, out_channels: int, kernel_size: int = 1):
        super().__init__()
        self.conv = nn.Linear(in_channels, out_channels) if kernel_size == 1 else Conv(in_channels, out_channels,
                                                                                         kernel_size)

    def forward(self, x):
        return self.conv(x)


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
