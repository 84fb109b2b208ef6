"""WaveRNN vocoder inference on the port's sampler.

Counterpart of `tpu_tts/vocoder/models/wavernn.py`: `MelResNet`:45,
`UpsampleNetwork`:71, `WavernnCell`:110 and `Wavernn.inference`:330 with
its folded decode (`fold_with_overlap`:293, `xfade_and_unfold`:309). The
sampling loop always runs through `ops/wavernn_sampler.py` (the K2 kernel on
the card), the JAX package's `use_pallas=True` path; the per-sample
`lax.scan` path has no counterpart. Module and parameter names are Coqui's
(`TTS/vocoder/models/wavernn.py`), so the state dict has its keys.

'bits' modes with the aux net only: `mold`/`gauss` modes and
`use_aux_net=False` raise `NotImplementedError` (ROADMAP.md, M8). BatchNorm
runs at its running statistics (inference).
"""

from dataclasses import dataclass, field
from typing import List

import numpy as np
import torch
import torch.nn as nn
import torch.nn.functional as F

from tpu_tts_torch.audio import mulaw_decode
from tpu_tts_torch.config.base import Coqpit
from tpu_tts_torch.device import resolve_device
from tpu_tts_torch.utils.checkpoint import load_net_checkpoint
from tpu_tts_torch.ops import wavernn_sampler


@dataclass
class WavernnArgs(Coqpit):
    rnn_dims: int = 512
    fc_dims: int = 512
    compute_dims: int = 128
    res_out_dims: int = 128
    num_res_blocks: int = 10
    use_aux_net: bool = True
    upsample_factors: List[int] = field(default_factory=lambda: [4, 8, 8])
    mode: str = "mold"
    mulaw: bool = True
    pad: int = 2
    feat_dims: int = 80


class ResBlock(nn.Module):
    def __init__(self, dims: int):
        super().__init__()
        self.conv1 = nn.Conv1d(dims, dims, 1, bias=False)
        self.conv2 = nn.Conv1d(dims, dims, 1, bias=False)
        self.batch_norm1 = nn.BatchNorm1d(dims)
        self.batch_norm2 = nn.BatchNorm1d(dims)

    def forward(self, x):
        y = torch.relu(self.batch_norm1(self.conv1(x)))
        return self.batch_norm2(self.conv2(y)) + x


class MelResNet(nn.Module):
    """Aux conv resnet over mels, `[B, C_mel, T] → [B, res_out, T − 2·pad]`."""

    def __init__(self, num_res_blocks: int, in_dims: int, compute_dims: int, res_out_dims: int, pad: int):
        super().__init__()
        self.conv_in = nn.Conv1d(in_dims, compute_dims, 2 * pad + 1, bias=False)
        self.batch_norm = nn.BatchNorm1d(compute_dims)
        self.layers = nn.ModuleList(ResBlock(compute_dims) for _ in range(num_res_blocks))
        self.conv_out = nn.Conv1d(compute_dims, res_out_dims, 1)

    def forward(self, x):
        x = torch.relu(self.batch_norm(self.conv_in(x)))
        for layer in self.layers:
            x = layer(x)
        return self.conv_out(x)


class Stretch2d(nn.Module):
    """Repeat each frame `scale` times along time (`[B, 1, C, T]`)."""

    def __init__(self, scale: int):
        super().__init__()
        self.scale = scale

    def forward(self, x):
        return torch.repeat_interleave(x, self.scale, dim=-1)


class UpsampleNetwork(nn.Module):
    """Mel stretch with one shared moving-average smoothing conv per scale,
    and the aux resnet branch. Takes and returns the JAX layout:
    m `[B, T, C_mel]` → (mels_up `[B, (T − 2·pad)·hop, C_mel]`,
    aux `[B, (T − 2·pad)·hop, res_out]`)."""

    def __init__(self, feat_dims: int, upsample_scales, compute_dims: int, num_res_blocks: int, res_out_dims: int,
                 pad: int):
        super().__init__()
        self.total_scale = int(np.prod(upsample_scales))
        self.indent = pad * self.total_scale
        self.resnet = MelResNet(num_res_blocks, feat_dims, compute_dims, res_out_dims, pad)
        self.up_layers = nn.ModuleList()
        for s in upsample_scales:
            k = 2 * s + 1
            conv = nn.Conv2d(1, 1, kernel_size=(1, k), padding=(0, s), bias=False)
            nn.init.constant_(conv.weight, 1.0 / k)
            self.up_layers.extend([Stretch2d(s), conv])

    def forward(self, m):
        m = m.transpose(1, 2)  # [B, C, T]
        aux = torch.repeat_interleave(self.resnet(m), self.total_scale, dim=-1)
        x = m.unsqueeze(1)
        for layer in self.up_layers:
            x = layer(x)
        x = x.squeeze(1)[:, :, self.indent : x.shape[-1] - self.indent]
        return x.transpose(1, 2), aux.transpose(1, 2)


def _gru_cell(gru: nn.GRU, x, h):
    """One step of a single-layer torch GRU (gate rows r | z | n)."""
    gi = F.linear(x, gru.weight_ih_l0, gru.bias_ih_l0)
    gh = F.linear(h, gru.weight_hh_l0, gru.bias_hh_l0)
    R = h.shape[-1]
    r = torch.sigmoid(gi[:, :R] + gh[:, :R])
    z = torch.sigmoid(gi[:, R : 2 * R] + gh[:, R : 2 * R])
    n = torch.tanh(gi[:, 2 * R :] + r * gh[:, 2 * R :])
    return (1.0 - z) * n + z * h


class WavernnCell(nn.Module):
    """The per-sample layers and their plain one-step forward; the sampler
    packs these layers' weights for its loop."""

    def __init__(self, rnn_dims: int, fc_dims: int, n_classes: int, feat_dims: int, aux_dims: int):
        super().__init__()
        self.I = nn.Linear(feat_dims + aux_dims + 1, rnn_dims)
        self.rnn1 = nn.GRU(rnn_dims, rnn_dims, batch_first=True)
        self.rnn2 = nn.GRU(rnn_dims + aux_dims, rnn_dims, batch_first=True)
        self.fc1 = nn.Linear(rnn_dims + aux_dims, fc_dims)
        self.fc2 = nn.Linear(fc_dims + aux_dims, fc_dims)
        self.fc3 = nn.Linear(fc_dims, n_classes)

    def forward(self, h1, h2, x_prev, mel_t, aux_t):
        """h1, h2 `[B, R]`, x_prev `[B, 1]`, mel_t `[B, C_mel]`, aux_t
        `[B, 4·aux]` → (h1, h2, logits `[B, n_classes]`)."""
        a1, a2, a3, a4 = torch.chunk(aux_t, 4, dim=-1)
        x = self.I(torch.cat([x_prev, mel_t, a1], dim=-1))
        h1 = _gru_cell(self.rnn1, x, h1)
        x = x + h1
        h2 = _gru_cell(self.rnn2, torch.cat([x, a2], dim=-1), h2)
        x = x + h2
        x = torch.relu(self.fc1(torch.cat([x, a3], dim=-1)))
        x = torch.relu(self.fc2(torch.cat([x, a4], dim=-1)))
        return h1, h2, self.fc3(x)


class WavernnNet(WavernnCell):
    """The cell's layers plus the upsample network, under Coqui's names."""

    def __init__(self, args: WavernnArgs):
        if not str(args.mode).isdigit():
            raise NotImplementedError(f"WaveRNN mode `{args.mode}` is not ported yet; 'bits' modes are (ROADMAP.md, M8)")
        if not args.use_aux_net:
            raise NotImplementedError("WaveRNN without the aux net is not ported yet (ROADMAP.md, M8)")
        aux_dims = args.res_out_dims // 4
        super().__init__(args.rnn_dims, args.fc_dims, 2 ** int(args.mode), args.feat_dims, aux_dims)
        self.upsample = UpsampleNetwork(args.feat_dims, args.upsample_factors, args.compute_dims,
                                        args.num_res_blocks, args.res_out_dims, args.pad)


class Wavernn:
    """Orchestrator: folded inference through the sampler."""

    def __init__(self, config, device=None):
        self.config = config
        args = config.model_args or {}
        if isinstance(args, dict):
            args = WavernnArgs.from_dict(args)
        self.args = args
        self.device = resolve_device(device)
        self.net = WavernnNet(args).to(self.device).eval()

    @staticmethod
    def fold_with_overlap(x: np.ndarray, target: int, overlap: int) -> np.ndarray:
        """`[1, T, C]` → `[num_folds, target + 2·overlap, C]`, zero-padding the tail."""
        _, total_len, features = x.shape
        num_folds = (total_len - overlap) // (target + overlap)
        extended_len = num_folds * (overlap + target) + overlap
        remaining = total_len - extended_len
        if remaining != 0:
            num_folds += 1
            padding = target + 2 * overlap - remaining
            x = np.pad(x, [(0, 0), (0, padding), (0, 0)], mode="constant")
        folded = np.zeros((num_folds, target + 2 * overlap, features), dtype=np.float32)
        for i in range(num_folds):
            start = i * (target + overlap)
            folded[i] = x[0, start : start + target + 2 * overlap]
        return folded

    @staticmethod
    def xfade_and_unfold(y: np.ndarray, target: int, overlap: int) -> np.ndarray:
        """`[num_folds, length]` → one waveform, the folds cross-faded over
        `overlap` samples (half silence, half equal-power fade)."""
        num_folds, length = y.shape
        target = length - 2 * overlap
        total_len = num_folds * (target + overlap) + overlap
        silence_len = overlap // 2
        fade_len = overlap - silence_len
        silence = np.zeros(silence_len, dtype=np.float64)
        t = np.linspace(-1, 1, fade_len, dtype=np.float64)
        fade_in = np.concatenate([silence, np.sqrt(0.5 * (1 + t))])
        fade_out = np.concatenate([np.sqrt(0.5 * (1 - t)), silence])
        y = y.astype(np.float64).copy()
        y[:, :overlap] *= fade_in
        y[:, -overlap:] *= fade_out
        unfolded = np.zeros(total_len, dtype=np.float64)
        for i in range(num_folds):
            start = i * (target + overlap)
            unfolded[start : start + length] += y[i]
        return unfolded.astype(np.float32)

    @torch.no_grad()
    def inference(self, mels: np.ndarray, batched: bool = True, target: int = 11000, overlap: int = 550,
                  seed: int = 0) -> np.ndarray:
        """mel `[T, C]` (or `[1, T, C]`), normalised as the vocoder's audio
        config says → waveform `[T · hop]` (float32, 1-D)."""
        a = self.args
        mels = np.asarray(mels, dtype=np.float32)
        if mels.ndim == 2:
            mels = mels[None]
        hop = int(np.prod(a.upsample_factors))
        if batched:
            t_frames = max(target // hop, 1)
            o_frames = max(overlap // hop, 1)
            mels_p = np.pad(mels, [(0, 0), (a.pad, a.pad), (0, 0)], mode="edge")
            folded = self.fold_with_overlap(mels_p, t_frames, o_frames)
            gen_in = np.pad(folded, [(0, 0), (a.pad, a.pad), (0, 0)], mode="edge")  # resnet context per fold
        else:
            gen_in = np.pad(mels, [(0, 0), (2 * a.pad, 2 * a.pad), (0, 0)], mode="edge")
        mels_up, aux = self.net.upsample(torch.from_numpy(gen_in).to(self.device))
        w = wavernn_sampler.pack_weights(self.net)
        streams, time_chunk = wavernn_sampler.precompute_streams(w, mels_up, aux)
        samples = wavernn_sampler.sample(w, streams, time_chunk, seed=seed)[:, : mels_up.shape[1]]
        samples = samples.cpu().numpy()
        if a.mulaw:
            samples = mulaw_decode(samples, int(a.mode))
        if batched:
            return self.xfade_and_unfold(samples, t_frames * hop, o_frames * hop)[: mels.shape[1] * hop]
        return samples[0][: mels.shape[1] * hop]

    def load_checkpoint(self, config, checkpoint_path: str, eval: bool = True, strict: bool = True):
        """Load a `.pth` file into `self.net`: the port's `state_dict`, or a
        Coqui-format checkpoint (`{"model": ...}` or flat), as
        `BaseTTSModel.load_checkpoint` does."""
        ckpt = load_net_checkpoint(self.net, checkpoint_path, strict=strict)
        if eval:
            self.net.eval()
        return ckpt

    @staticmethod
    def init_from_config(config, device=None) -> "Wavernn":
        return Wavernn(config, device=device)
