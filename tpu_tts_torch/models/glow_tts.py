"""Glow-TTS inference, channels-first inside, on the port's modules.

Counterpart of `tpu_tts/models/glow_tts.py`: `GlowTTSEncoder`:36 (the
relative-position transformer encoder with its prenet), `GlowTTSNet.
inference`:261 and `GlowTTS.inference`:427 with its static mel bucket (24
frames per token at most, rounded up to 128). Durations come from the
encoder's duration predictor; the reverse flow decodes the expanded prior
mean, plus noise from a `torch.Generator` seeded from `aux_input["seed"]`
(none at `inference_noise_scale` 0, as in JAX).

Single-speaker only. The other encoder types (`gated_conv`,
`residual_conv_bn`, `time_depth_separable`), speaker embeddings and
d-vectors raise `NotImplementedError` (ROADMAP.md). Module names are
Coqui's, so the state dict has its keys.
"""

import math
from typing import Dict

import numpy as np
import torch
import torch.nn as nn

from tpu_tts_torch.audio import AudioProcessor
from tpu_tts_torch.layers.common import DurationPredictor, ResidualConv1dLayerNormBlock
from tpu_tts_torch.layers.glow import GlowDecoder
from tpu_tts_torch.layers.transformer import RelativePositionTransformer
from tpu_tts_torch.models.base_tts import BaseTTSModel
from tpu_tts_torch.ops.helpers import generate_path, sequence_mask


class GlowTTSEncoder(nn.Module):
    """emb → prenet → rel-pos transformer → (mean, log-scale, log-durations)."""

    def __init__(self, num_chars: int, out_channels: int, hidden_channels: int, hidden_channels_dp: int,
                 encoder_type: str = "rel_pos_transformer", encoder_params: dict = None, mean_only: bool = False,
                 use_prenet: bool = True):
        super().__init__()
        if encoder_type.lower() != "rel_pos_transformer":
            raise NotImplementedError(f"Glow-TTS encoder `{encoder_type}` is not ported yet (ROADMAP.md, queue 1)")
        params = dict(encoder_params or {})
        self.hidden_channels = hidden_channels
        self.mean_only = mean_only
        self.emb = nn.Embedding(num_chars, hidden_channels)
        self.prenet = (ResidualConv1dLayerNormBlock(hidden_channels, hidden_channels, hidden_channels, 5, 3)
                       if use_prenet else None)
        self.encoder = RelativePositionTransformer(
            hidden_channels,
            params.get("hidden_channels_ffn", 768),
            params.get("num_heads", 2),
            params.get("num_layers", 6),
            kernel_size=params.get("kernel_size", 3),
            rel_attn_window_size=params.get("rel_attn_window_size", 4),
        )
        self.proj_m = nn.Conv1d(hidden_channels, out_channels, 1)
        self.proj_s = None if mean_only else nn.Conv1d(hidden_channels, out_channels, 1)
        self.duration_predictor = DurationPredictor(hidden_channels, hidden_channels_dp, 3)

    def forward(self, x, x_lengths):
        """x `[B, T]` ids → x_m, x_logs `[B, C_out, T]`, logw `[B, 1, T]`, x_mask `[B, 1, T]`."""
        h = self.emb(x).transpose(1, 2) * math.sqrt(self.hidden_channels)  # [B, C, T]
        x_mask = sequence_mask(x_lengths, x.shape[1]).to(h.dtype)[:, None, :]
        if self.prenet is not None:
            h = self.prenet(h, x_mask)
        h = self.encoder(h, x_mask)
        x_m = self.proj_m(h) * x_mask
        x_logs = torch.zeros_like(x_m) if self.mean_only else self.proj_s(h) * x_mask
        logw = self.duration_predictor(h, x_mask)
        return x_m, x_logs, logw, x_mask


class GlowTTSNet(nn.Module):
    def __init__(self, config, num_chars: int):
        super().__init__()
        c = config
        self.length_scale = c.length_scale
        self.inference_noise_scale = c.inference_noise_scale
        self.num_squeeze = c.num_squeeze
        self.encoder = GlowTTSEncoder(
            num_chars, c.out_channels, c.hidden_channels_enc, c.hidden_channels_dp, c.encoder_type,
            c.encoder_params, c.mean_only, c.use_encoder_prenet,
        )
        self.decoder = GlowDecoder(
            c.out_channels, c.hidden_channels_dec, c.kernel_size_dec, c.dilation_rate, c.num_flow_blocks_dec,
            c.num_block_layers, c.num_splits, c.num_squeeze, c.sigmoid_scale,
        )

    def inference(self, x, x_lengths, y_max_length: int, generator: torch.Generator = None) -> Dict:
        """Decode at a static `y_max_length` (bucketed by the caller).
        Returns mel `[B, y_max_length, C]` and the true `y_lengths`."""
        o_mean, o_log_scale, o_dur_log, x_mask = self.encoder(x, x_lengths)
        w = (torch.exp(o_dur_log) - 1) * x_mask * self.length_scale
        w_ceil = torch.clamp(torch.ceil(w), min=1.0) * x_mask
        y_lengths = torch.clamp(torch.sum(w_ceil, dim=(1, 2)), min=1).long()
        y_lengths = torch.clamp(y_lengths, max=y_max_length)
        y_lengths = (y_lengths // self.num_squeeze) * self.num_squeeze
        y_mask = sequence_mask(y_lengths, y_max_length).to(x_mask.dtype)[:, None, :]  # [B, 1, T_de]
        attn = generate_path(w_ceil[:, 0], x_mask.transpose(1, 2) * y_mask)  # [B, T_en, T_de]
        y_mean = torch.matmul(o_mean, attn)  # [B, C, T_de]
        y_log_scale = torch.matmul(o_log_scale, attn)
        z = y_mean
        if self.inference_noise_scale > 0:
            noise = torch.randn(y_mean.shape, generator=generator, device=y_mean.device)
            z = y_mean + torch.exp(y_log_scale) * noise * self.inference_noise_scale
        y = self.decoder.reverse(z * y_mask, y_mask)
        return {
            "model_outputs": y.transpose(1, 2),
            "alignments": attn.transpose(1, 2),
            "durations_log": o_dur_log.transpose(1, 2),
            "y_lengths": y_lengths,
        }


class GlowTTS(BaseTTSModel):
    MEL_BUCKET = 128
    FRAMES_PER_TOKEN = 24  # the bound the mel bucket is sized for

    def __init__(self, config, ap=None, tokenizer=None, device=None):
        super().__init__(config, ap, tokenizer, device)
        if config.use_speaker_embedding or config.use_d_vector_file:
            raise NotImplementedError("multi-speaker Glow-TTS is not ported yet (ROADMAP.md, queue 1)")
        if tokenizer is not None and tokenizer.characters is not None:
            num_chars = tokenizer.characters.num_chars
        else:
            num_chars = config.num_chars or 130
        self.net = GlowTTSNet(config, num_chars).to(self.device).eval()

    @torch.no_grad()
    def inference(self, x, aux_input=None) -> Dict:
        """x: token ids `[T]` or `[B, T]`. aux_input: `x_lengths`, `seed`."""
        aux_input = aux_input or {}
        for key in ("speaker_ids", "d_vectors"):
            if aux_input.get(key) is not None:
                raise NotImplementedError(f"`{key}` is not ported yet (ROADMAP.md, queue 1)")
        x = torch.as_tensor(np.asarray(x)).to(device=self.device, dtype=torch.long)
        if x.ndim == 1:
            x = x[None]
        x_lengths = aux_input.get("x_lengths")
        x_lengths = [x.shape[1]] * x.shape[0] if x_lengths is None else x_lengths
        x_lengths = torch.as_tensor(np.asarray(x_lengths)).to(device=self.device, dtype=torch.long)
        est = x.shape[1] * self.FRAMES_PER_TOKEN
        y_max = max(self.MEL_BUCKET, int(np.ceil(est / self.MEL_BUCKET)) * self.MEL_BUCKET)
        gen = torch.Generator(device=self.device).manual_seed(int(aux_input.get("seed", 0)))
        return self.net.inference(x, x_lengths, y_max, generator=gen)

    @staticmethod
    def init_from_config(config, device=None) -> "GlowTTS":
        from tpu_tts_torch.text.tokenizer import TTSTokenizer

        ap = AudioProcessor.init_from_config(config)
        tokenizer, new_config = TTSTokenizer.init_from_config(config)
        return GlowTTS(new_config, ap, tokenizer, device=device)
