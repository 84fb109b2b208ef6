"""VITS inference, channels-first inside, on the port's modules.

Counterpart of `tpu_tts/models/vits.py`: `VitsNet` (`setup`:73,
`infer_durations`:303, `infer_decode`:326) and `Vits.inference`:614 with its
two-stage bucketing. Stage 1 runs the text encoder and the reverse
stochastic duration predictor; the host reads the longest mel length and
picks a decode bucket; stage 2 expands the prior by the durations, runs the
reverse flow and the HiFi-GAN decoder at that bucket. Noise comes from a
`torch.Generator` seeded from `aux_input["seed"]`; noise scales of 0 give
a noise-free path, as in JAX.

Single-speaker, single-language VITS with the stochastic duration predictor
and the decoder at the flow's rate. Speaker and language embeddings, the
deterministic duration predictor and `encoder_sample_rate` raise
`NotImplementedError` (ROADMAP.md).
"""

from typing import Dict

import numpy as np
import torch
import torch.nn as nn

from tpu_tts_torch.audio import AudioProcessor
from tpu_tts_torch.layers.vits import ResidualCouplingBlocks, StochasticDurationPredictor, VitsTextEncoder
from tpu_tts_torch.models.base_tts import BaseTTSModel
from tpu_tts_torch.ops.helpers import bucket_len, generate_path, sequence_mask
from tpu_tts_torch.vocoder.models.hifigan_generator import HifiganGenerator


def _check_supported(a):
    unsupported = {
        "speaker embeddings": a.use_speaker_embedding and a.num_speakers > 1,
        "d-vectors": a.use_d_vector_file,
        "language embeddings": a.use_language_embedding,
        "encoder_sample_rate": bool(a.encoder_sample_rate),
        "the deterministic duration predictor (use_sdp=False)": not a.use_sdp,
    }
    for what, used in unsupported.items():
        if used:
            raise NotImplementedError(f"VITS with {what} is not ported yet (ROADMAP.md, queue 1)")


class VitsNet(nn.Module):
    """Generator side of VITS, the modules inference reads. Attribute names
    are the Coqui state-dict prefixes."""

    def __init__(self, args):
        super().__init__()
        _check_supported(args)
        self.args = args
        self.text_encoder = VitsTextEncoder(
            n_vocab=args.num_chars,
            out_channels=args.hidden_channels,
            hidden_channels=args.hidden_channels,
            hidden_channels_ffn=args.hidden_channels_ffn_text_encoder,
            num_heads=args.num_heads_text_encoder,
            num_layers=args.num_layers_text_encoder,
            kernel_size=args.kernel_size_text_encoder,
        )
        self.flow = ResidualCouplingBlocks(
            channels=args.hidden_channels,
            hidden_channels=args.hidden_channels,
            kernel_size=args.kernel_size_flow,
            dilation_rate=args.dilation_rate_flow,
            num_layers=args.num_layers_flow,
        )
        self.duration_predictor = StochasticDurationPredictor(args.hidden_channels, 192, 3, num_flows=4)
        self.waveform_decoder = HifiganGenerator(
            in_channels=args.hidden_channels,
            out_channels=1,
            resblock_type=str(args.resblock_type_decoder),
            resblock_dilation_sizes=args.resblock_dilation_sizes_decoder,
            resblock_kernel_sizes=args.resblock_kernel_sizes_decoder,
            upsample_kernel_sizes=args.upsample_kernel_sizes_decoder,
            upsample_initial_channel=args.upsample_initial_channel_decoder,
            upsample_factors=args.upsample_rates_decoder,
        )

    def infer_durations(self, x, x_lengths, length_scale: float = None, sdp_noise_scale: float = None,
                        generator: torch.Generator = None) -> Dict:
        """Stage 1: text encoder + reverse SDP → frame counts per token."""
        a = self.args
        length_scale = a.length_scale if length_scale is None else length_scale
        sdp_noise_scale = a.inference_noise_scale_dp if sdp_noise_scale is None else sdp_noise_scale
        h_text, m_p, logs_p, x_mask = self.text_encoder(x, x_lengths)
        noise = torch.randn(x.shape[0], 2, x.shape[1], generator=generator, device=x.device)
        logw = self.duration_predictor.reverse(h_text, x_mask, noise, noise_scale=sdp_noise_scale)
        w = torch.exp(logw) * x_mask * length_scale
        w_ceil = torch.ceil(w) * x_mask
        y_lengths = torch.clamp(torch.sum(w_ceil, dim=(1, 2)), min=1).long()
        return {"w_ceil": w_ceil[:, 0], "y_lengths": y_lengths, "m_p": m_p, "logs_p": logs_p, "x_mask": x_mask}

    def infer_decode(self, w_ceil, y_lengths, m_p, logs_p, x_mask, y_max_length: int, noise_scale: float = None,
                     generator: torch.Generator = None) -> Dict:
        """Stage 2: expand, reverse flow, decode at `y_max_length` frames.
        Returns `model_outputs` `[B, T·hop, 1]` and `alignments` `[B, T_de, T_en]`."""
        noise_scale = self.args.inference_noise_scale if noise_scale is None else noise_scale
        y_lengths = torch.clamp(y_lengths, max=y_max_length)
        y_mask = sequence_mask(y_lengths, y_max_length).to(x_mask.dtype)[:, None, :]  # [B, 1, T_de]
        attn = generate_path(w_ceil, x_mask.transpose(1, 2) * y_mask)  # [B, T_en, T_de]
        m_p_ex = torch.matmul(m_p, attn)  # [B, C, T_de]
        logs_p_ex = torch.matmul(logs_p, attn)
        noise = torch.randn(m_p_ex.shape, generator=generator, device=m_p_ex.device)
        z_p = m_p_ex + noise * torch.exp(logs_p_ex) * noise_scale
        z = self.flow.reverse(z_p * y_mask, y_mask)
        o = self.waveform_decoder(z * y_mask)
        return {"model_outputs": o.transpose(1, 2), "alignments": attn.transpose(1, 2), "y_lengths": y_lengths}


class Vits(BaseTTSModel):
    # text ids are right-padded to this grid, as in the JAX model
    TEXT_BUCKET = 32

    def __init__(self, config, ap=None, tokenizer=None, device=None):
        super().__init__(config, ap, tokenizer, device)
        args = config.model_args
        if tokenizer is not None and tokenizer.characters is not None:
            args.num_chars = tokenizer.characters.num_chars
        self.args = args
        self.net = VitsNet(args).to(self.device).eval()

    def _long(self, v) -> torch.Tensor:
        v = v if isinstance(v, torch.Tensor) else torch.as_tensor(np.asarray(v))
        return v.to(device=self.device, dtype=torch.long)

    @torch.no_grad()
    def inference(self, x, aux_input=None, bucket: int = 128) -> Dict:
        """Two-stage bucketed inference. x: token ids `[T]` or `[B, T]`.
        aux_input: `x_lengths`, `seed`."""
        aux_input = aux_input or {}
        for key in ("speaker_ids", "d_vectors", "language_ids"):
            if aux_input.get(key) is not None:
                raise NotImplementedError(f"`{key}` is not ported yet (ROADMAP.md, queue 1)")
        x = self._long(x)
        if x.ndim == 1:
            x = x[None]
        x_lengths = aux_input.get("x_lengths")
        x_lengths = self._long([x.shape[1]] * x.shape[0] if x_lengths is None else x_lengths)
        T_pad = bucket_len(x.shape[1], self.TEXT_BUCKET)
        if T_pad != x.shape[1]:
            x = torch.nn.functional.pad(x, (0, T_pad - x.shape[1]))
        gen = torch.Generator(device=self.device).manual_seed(int(aux_input.get("seed", 0)))

        s1 = self.net.infer_durations(x, x_lengths, generator=gen)
        true_max = int(s1["y_lengths"].max())
        y_max = max(bucket, int(np.ceil(true_max / bucket)) * bucket)
        if self.args.max_inference_len:
            y_max = min(y_max, self.args.max_inference_len)
        out = self.net.infer_decode(
            s1["w_ceil"], s1["y_lengths"], s1["m_p"], s1["logs_p"], s1["x_mask"], y_max, generator=gen
        )
        out["durations"] = s1["w_ceil"]
        return out

    @staticmethod
    def init_from_config(config, device=None):
        from tpu_tts_torch.text.tokenizer import TTSTokenizer

        upsample_rate = int(np.prod(config.model_args.upsample_rates_decoder))
        if upsample_rate != config.audio.hop_length:
            raise ValueError(
                f" [!] Product of upsample rates must equal the hop length - {upsample_rate} vs {config.audio.hop_length}"
            )
        ap = AudioProcessor.init_from_config(config)
        tokenizer, new_config = TTSTokenizer.init_from_config(config)
        return Vits(new_config, ap, tokenizer, device=device)
