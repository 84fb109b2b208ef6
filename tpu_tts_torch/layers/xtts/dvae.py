"""Discrete VAE over mel spectrograms: the audio tokenizer that gives the XTTS
GPT its fine-tuning codes.

Counterpart of `tpu_tts/layers/xtts/dvae.py` (`DiscreteVAE`:65 with
`encode_latents`:112, `get_codebook_indices`:121 and `decode`:136;
`convert_dvae_torch_state_dict`:152), the XTTS configuration of Coqui's
`DiscreteVAE` (positional_dims=1, codebook_dim=512, hidden_dim=512,
num_layers=2, num_resnet_blocks=3, channels=80, kernel_size=3, no
transposed convs). The modules carry Coqui's state-dict names
(`encoder.{i}.0`, `encoder.{n}.net.{0,2,4}`, `decoder.{j}.0.conv`,
`codebook.embed` `[codebook_dim, num_tokens]`), so a released `dvae.pth`
loads by name (`load_dvae_state`). Channels-first `[B, C, T]`; the two
stride-2 encoder convs give one code per 4 mel frames. The DVAE is frozen:
fine-tuning only reads its codes, under `no_grad`.
"""

from typing import Dict

import torch
import torch.nn as nn
import torch.nn.functional as F


class ResBlock(nn.Module):
    """conv3 → relu → conv3 → relu → conv1, plus the input."""

    def __init__(self, channels: int):
        super().__init__()
        self.net = nn.Sequential(nn.Conv1d(channels, channels, 3, padding=1), nn.ReLU(),
                                 nn.Conv1d(channels, channels, 3, padding=1), nn.ReLU(),
                                 nn.Conv1d(channels, channels, 1))

    def forward(self, x):
        return self.net(x) + x


class UpsampledConv(nn.Module):
    """Nearest 2× upsampling in time, then a conv."""

    def __init__(self, c_in: int, c_out: int, kernel_size: int):
        super().__init__()
        self.conv = nn.Conv1d(c_in, c_out, kernel_size, padding=(kernel_size - 1) // 2)

    def forward(self, x):
        return self.conv(torch.repeat_interleave(x, 2, dim=-1))


class Quantize(nn.Module):
    """The codebook, `embed` `[codebook_dim, num_tokens]` as Coqui's buffer."""

    def __init__(self, dim: int, num_tokens: int):
        super().__init__()
        self.register_buffer("embed", torch.randn(dim, num_tokens))


class DiscreteVAE(nn.Module):
    def __init__(self, num_tokens: int = 8192, codebook_dim: int = 512, hidden_dim: int = 512, num_layers: int = 2,
                 num_resnet_blocks: int = 3, channels: int = 80, kernel_size: int = 3):
        super().__init__()
        enc_chans = [hidden_dim * 2**i for i in range(num_layers)]
        inner = enc_chans[-1]
        pad = (kernel_size - 1) // 2
        enc, c_in = [], channels
        for c in enc_chans:
            enc.append(nn.Sequential(nn.Conv1d(c_in, c, kernel_size, stride=2, padding=pad), nn.ReLU()))
            c_in = c
        enc += [ResBlock(inner) for _ in range(num_resnet_blocks)]
        enc.append(nn.Conv1d(inner, codebook_dim, 1))
        self.encoder = nn.Sequential(*enc)
        dec = [nn.Conv1d(codebook_dim, inner, 1)] + [ResBlock(inner) for _ in range(num_resnet_blocks)]
        c_in = inner
        for c in reversed(enc_chans):
            dec.append(nn.Sequential(UpsampledConv(c_in, c, kernel_size), nn.ReLU()))
            c_in = c
        dec.append(nn.Conv1d(c_in, channels, 1))
        self.decoder = nn.Sequential(*dec)
        self.codebook = Quantize(codebook_dim, num_tokens)

    def encode_latents(self, mel):
        """mel `[B, C, T]` → pre-quantisation latents `[B, codebook_dim, T / 4]`."""
        return self.encoder(mel)

    @torch.no_grad()
    def get_codebook_indices(self, mel):
        """The nearest code of each latent: argmin over the codebook of
        ‖z‖² − 2 z·E + ‖E‖². `[B, C, T]` → `[B, T / 4]` int64."""
        z = self.encode_latents(mel).float().transpose(1, 2)  # [B, Tc, D]
        embed = self.codebook.embed.float()
        dist = z.pow(2).sum(-1, keepdim=True) - 2 * torch.matmul(z, embed) + embed.pow(2).sum(0)
        return torch.argmin(dist, dim=-1)

    @torch.no_grad()
    def decode(self, codes):
        """codes `[B, Tc]` → mel `[B, C, 4 · Tc]`."""
        return self.decoder(F.embedding(codes, self.codebook.embed.t()).transpose(1, 2))


def load_dvae_state(dvae: DiscreteVAE, state_dict: Dict, strict: bool = True) -> None:
    """A Coqui `dvae.pth` (`{"model": ...}` or flat) into `dvae`: the keys are
    the module's; the codebook's training buffers (`cluster_size`,
    `embed_avg`) and other keys the frozen DVAE does not read are skipped."""
    sd = state_dict["model"] if isinstance(state_dict.get("model"), dict) else state_dict
    wanted = set(dvae.state_dict())
    dvae.load_state_dict({k: v for k, v in sd.items() if k in wanted}, strict=strict)
