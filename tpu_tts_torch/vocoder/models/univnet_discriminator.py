"""UnivNet discriminator: spectrogram discriminators at three resolutions and the period discriminators.

Counterpart of `tpu_tts/vocoder/models/univnet_discriminator.py`
(`SpecDiscriminator`:17, `UnivnetDiscriminator`:43), channels-first. A
resolution's magnitude is sqrt(re² + im² + 1e-9) of the centred STFT
(`vocoder/layers/losses.py::stft`, on the JAX package's frames), read as
a one-channel image `[B, 1, frames, bins]` by spectral-normed 2-D convs.
The JAX package converts no Coqui UnivNet discriminator; the names are the
port's (`spec.{i}.convs.{j}`, `spec.{i}.conv_post`, `mpd`).
"""

import torch
import torch.nn as nn
import torch.nn.functional as F

from tpu_tts_torch.vocoder.layers.losses import stft
from tpu_tts_torch.vocoder.models.hifigan_discriminator import MultiPeriodDiscriminator, NormConv

# (out channels, kernel, stride) of each conv
_SPEC_CONVS = [(32, (3, 9), (1, 1)), (32, (3, 9), (1, 2)), (32, (3, 9), (1, 2)), (32, (3, 9), (1, 2)),
               (32, (3, 3), (1, 1))]


class SpecDiscriminator(nn.Module):
    def __init__(self, fft_size: int = 1024, hop_length: int = 120, win_length: int = 600):
        super().__init__()
        self.resolution = (fft_size, hop_length, win_length)
        self.convs = nn.ModuleList()
        c_in = 1
        for c_out, k, s in _SPEC_CONVS:
            self.convs.append(NormConv(c_in, c_out, k, s, (k[0] // 2, k[1] // 2), use_spectral_norm=True))
            c_in = c_out
        self.conv_post = NormConv(c_in, 1, (3, 3), (1, 1), (1, 1), use_spectral_norm=True)

    def forward(self, x):
        spec = stft(x[:, 0], *self.resolution)
        h = torch.sqrt(spec.real**2 + spec.imag**2 + 1e-9).transpose(1, 2)[:, None]  # [B, 1, frames, bins]
        feats = []
        for conv in self.convs:
            h = F.leaky_relu(conv(h), 0.2)
            feats.append(h)
        score = self.conv_post(h)
        feats.append(score)
        return torch.flatten(score, 1), feats


class UnivnetDiscriminator(nn.Module):
    def __init__(self, resolutions=((1024, 120, 600), (2048, 240, 1200), (512, 50, 240))):
        super().__init__()
        self.spec = nn.ModuleList(SpecDiscriminator(*r) for r in resolutions)
        self.mpd = MultiPeriodDiscriminator()

    def forward(self, x):
        scores, feats = [], []
        for disc in self.spec:
            score, feat = disc(x)
            scores.append(score)
            feats.append(feat)
        p_scores, p_feats = self.mpd(x)
        return scores + p_scores, feats + p_feats
