"""VITS inference, channels-first inside, on the port's modules.

Counterpart of `tpu_tts/models/vits.py`: `VitsNet` (`setup`:73,
`_cond_embeddings`:156, `infer_durations`:303, `infer_decode`:326) and
`Vits.inference`:614 with its two-stage bucketing. Stage 1 runs the text
encoder and the duration predictor (stochastic, or deterministic with
`use_sdp=False`); the host reads the longest mel length and picks a decode
bucket; stage 2 expands the prior by the durations, runs the reverse flow
and the HiFi-GAN decoder at that bucket. Noise comes from a
`torch.Generator` seeded from `aux_input["seed"]`; noise scales of 0 give
a noise-free path, as in JAX.

Multi-speaker models condition the duration predictor (unless
`condition_dp_on_speaker` is off), the flow and the decoder on g, a row's
speaker embedding (`emb_g`, `speaker_ids`) or its d-vector (`d_vectors`);
multilingual models add a language embedding (`emb_l`, `language_ids`) to
the text encoder and the duration predictor. With `encoder_sample_rate`
the flow's output is interpolated ×`interp_factor` in time before the
decoder, and `y_lengths` counts frames at the decoder's rate.
"""

from typing import Dict

import numpy as np
import torch
import torch.nn as nn
import torch.nn.functional as F

from tpu_tts_torch.audio import AudioProcessor
from tpu_tts_torch.layers.common import DurationPredictor
from tpu_tts_torch.layers.vits import ResidualCouplingBlocks, StochasticDurationPredictor, VitsTextEncoder
from tpu_tts_torch.models.base_tts import BaseTTSModel
from tpu_tts_torch.ops.helpers import bucket_len, generate_path, sequence_mask
from tpu_tts_torch.vocoder.models.hifigan_generator import HifiganGenerator


class VitsNet(nn.Module):
    """Generator side of VITS, the modules inference reads. Attribute names
    are the Coqui state-dict prefixes. `output_sample_rate` is the audio
    config's rate, which `encoder_sample_rate` is a fraction of."""

    def __init__(self, args, output_sample_rate: int = None):
        super().__init__()
        self.args = args
        embedded_speaker_dim = 0
        if args.use_speaker_embedding and args.num_speakers > 1:
            embedded_speaker_dim = args.speaker_embedding_channels
            self.emb_g = nn.Embedding(args.num_speakers, embedded_speaker_dim)
        elif args.use_d_vector_file:
            embedded_speaker_dim = args.d_vector_dim or 512
        self.embedded_speaker_dim = embedded_speaker_dim
        self.lang_dim = args.embedded_language_dim if args.use_language_embedding else 0
        if self.lang_dim:
            self.emb_l = nn.Embedding(args.num_languages, self.lang_dim)
        self.interp_factor = 1
        if args.encoder_sample_rate:
            rate = output_sample_rate or args.encoder_sample_rate
            self.interp_factor = max(int(round(rate / args.encoder_sample_rate)), 1)

        self.text_encoder = VitsTextEncoder(
            n_vocab=args.num_chars,
            out_channels=args.hidden_channels,
            hidden_channels=args.hidden_channels,
            hidden_channels_ffn=args.hidden_channels_ffn_text_encoder,
            num_heads=args.num_heads_text_encoder,
            num_layers=args.num_layers_text_encoder,
            kernel_size=args.kernel_size_text_encoder,
            language_emb_dim=self.lang_dim,
        )
        self.flow = ResidualCouplingBlocks(
            channels=args.hidden_channels,
            hidden_channels=args.hidden_channels,
            kernel_size=args.kernel_size_flow,
            dilation_rate=args.dilation_rate_flow,
            num_layers=args.num_layers_flow,
            cond_channels=embedded_speaker_dim,
        )
        # the encoder's output h is hidden + language channels wide
        width = args.hidden_channels + self.lang_dim
        dp_cond = embedded_speaker_dim if args.condition_dp_on_speaker else 0
        if args.use_sdp:
            self.duration_predictor = StochasticDurationPredictor(
                width, 192, 3, num_flows=4, cond_channels=dp_cond, language_emb_dim=self.lang_dim
            )
        else:
            self.duration_predictor = DurationPredictor(
                width, 256, 3, cond_channels=dp_cond, language_emb_dim=self.lang_dim
            )
        self.waveform_decoder = HifiganGenerator(
            in_channels=args.hidden_channels,
            out_channels=1,
            resblock_type=str(args.resblock_type_decoder),
            resblock_dilation_sizes=args.resblock_dilation_sizes_decoder,
            resblock_kernel_sizes=args.resblock_kernel_sizes_decoder,
            upsample_kernel_sizes=args.upsample_kernel_sizes_decoder,
            upsample_initial_channel=args.upsample_initial_channel_decoder,
            upsample_factors=args.upsample_rates_decoder,
            cond_channels=embedded_speaker_dim,
        )

    def cond_embeddings(self, speaker_ids=None, d_vectors=None, language_ids=None):
        """(g, lang_emb), each `[B, C, 1]` or None: the speaker embedding of
        `speaker_ids` `[B]` (or the d-vectors `[B, D]`) and the language
        embedding of `language_ids` `[B]`. Ids on a model without the table
        they index are ignored."""
        g = None
        if speaker_ids is not None and hasattr(self, "emb_g"):
            g = self.emb_g(speaker_ids)[:, :, None]
        elif d_vectors is not None and self.args.use_d_vector_file:
            g = d_vectors[:, :, None]
        lang_emb = None
        if language_ids is not None and self.lang_dim:
            lang_emb = self.emb_l(language_ids)[:, :, None]
        return g, lang_emb

    def upsample_z(self, z):
        """z `[B, C, T]` → `[B, C, T·interp_factor]`: linear with half-pixel
        centres (edge frames held), or nearest, as `jax.image.resize`."""
        if self.interp_factor == 1:
            return z
        if self.args.interpolate_z:
            return F.interpolate(z, scale_factor=self.interp_factor, mode="linear", align_corners=False)
        return F.interpolate(z, scale_factor=self.interp_factor, mode="nearest")

    def infer_durations(self, x, x_lengths, length_scale: float = None, sdp_noise_scale: float = None,
                        generator: torch.Generator = None, speaker_ids=None, d_vectors=None,
                        language_ids=None) -> Dict:
        """Stage 1: text encoder + duration predictor → frame counts per token."""
        a = self.args
        length_scale = a.length_scale if length_scale is None else length_scale
        sdp_noise_scale = a.inference_noise_scale_dp if sdp_noise_scale is None else sdp_noise_scale
        g, lang_emb = self.cond_embeddings(speaker_ids, d_vectors, language_ids)
        h_text, m_p, logs_p, x_mask = self.text_encoder(x, x_lengths, lang_emb=lang_emb)
        dp_g = g if a.condition_dp_on_speaker else None
        if a.use_sdp:
            noise = torch.randn(x.shape[0], 2, x.shape[1], generator=generator, device=x.device)
            logw = self.duration_predictor.reverse(h_text, x_mask, noise, noise_scale=sdp_noise_scale, g=dp_g,
                                                   lang_emb=lang_emb)
        else:
            logw = self.duration_predictor(h_text, x_mask, g=dp_g, lang_emb=lang_emb)
        w = torch.exp(logw) * x_mask * length_scale
        w_ceil = torch.ceil(w) * x_mask
        y_lengths = torch.clamp(torch.sum(w_ceil, dim=(1, 2)), min=1).long()
        return {"w_ceil": w_ceil[:, 0], "y_lengths": y_lengths, "m_p": m_p, "logs_p": logs_p, "x_mask": x_mask}

    def infer_decode(self, w_ceil, y_lengths, m_p, logs_p, x_mask, y_max_length: int, noise_scale: float = None,
                     generator: torch.Generator = None, speaker_ids=None, d_vectors=None,
                     language_ids=None) -> Dict:
        """Stage 2: expand, reverse flow, decode at `y_max_length` frames (×
        `interp_factor` at the decoder). Returns `model_outputs`
        `[B, T·hop, 1]`, `alignments` `[B, T_de, T_en]` and `y_lengths` at the
        decoder's rate."""
        noise_scale = self.args.inference_noise_scale if noise_scale is None else noise_scale
        g, _ = self.cond_embeddings(speaker_ids, d_vectors, language_ids)
        y_lengths = torch.clamp(y_lengths, max=y_max_length)
        y_mask = sequence_mask(y_lengths, y_max_length).to(x_mask.dtype)[:, None, :]  # [B, 1, T_de]
        attn = generate_path(w_ceil, x_mask.transpose(1, 2) * y_mask)  # [B, T_en, T_de]
        m_p_ex = torch.matmul(m_p, attn)  # [B, C, T_de]
        logs_p_ex = torch.matmul(logs_p, attn)
        noise = torch.randn(m_p_ex.shape, generator=generator, device=m_p_ex.device)
        z_p = m_p_ex + noise * torch.exp(logs_p_ex) * noise_scale
        z = self.flow.reverse(z_p * y_mask, y_mask, g=g)
        o = self.waveform_decoder(self.upsample_z(z * y_mask), g=g)
        return {"model_outputs": o.transpose(1, 2), "alignments": attn.transpose(1, 2),
                "y_lengths": y_lengths * self.interp_factor}


class Vits(BaseTTSModel):
    # text ids are right-padded to this grid, as in the JAX model
    TEXT_BUCKET = 32

    def __init__(self, config, ap=None, tokenizer=None, device=None, speaker_manager=None, language_manager=None):
        super().__init__(config, ap, tokenizer, device, speaker_manager, language_manager)
        args = config.model_args
        if tokenizer is not None and tokenizer.characters is not None:
            args.num_chars = tokenizer.characters.num_chars
        if speaker_manager is not None and args.use_speaker_embedding:
            args.num_speakers = max(args.num_speakers, speaker_manager.num_speakers)
        if language_manager is not None:
            args.num_languages = max(args.num_languages, language_manager.num_languages)
        self.args = args
        self.net = VitsNet(args, output_sample_rate=config.audio.sample_rate).to(self.device).eval()

    def _long(self, v) -> torch.Tensor:
        v = v if isinstance(v, torch.Tensor) else torch.as_tensor(np.asarray(v))
        return v.to(device=self.device, dtype=torch.long)

    @torch.no_grad()
    def inference(self, x, aux_input=None, bucket: int = 128) -> Dict:
        """Two-stage bucketed inference. x: token ids `[T]` or `[B, T]`.
        aux_input: `x_lengths`, `seed`, and per row `speaker_ids` `[B]`,
        `d_vectors` `[B, D]`, `language_ids` `[B]`."""
        aux_input = aux_input or {}
        cond = {key: aux_input.get(key) for key in ("speaker_ids", "language_ids")}
        cond = {key: None if v is None else self._long(v).reshape(-1) for key, v in cond.items()}
        d = aux_input.get("d_vectors")
        if d is not None:
            d = d if isinstance(d, torch.Tensor) else torch.as_tensor(np.asarray(d, dtype=np.float32))
            cond["d_vectors"] = d.to(device=self.device, dtype=torch.float32).reshape(-1, d.shape[-1])
        x = self._long(x)
        if x.ndim == 1:
            x = x[None]
        x_lengths = aux_input.get("x_lengths")
        x_lengths = self._long([x.shape[1]] * x.shape[0] if x_lengths is None else x_lengths)
        T_pad = bucket_len(x.shape[1], self.TEXT_BUCKET)
        if T_pad != x.shape[1]:
            x = torch.nn.functional.pad(x, (0, T_pad - x.shape[1]))
        gen = torch.Generator(device=self.device).manual_seed(int(aux_input.get("seed", 0)))

        s1 = self.net.infer_durations(x, x_lengths, generator=gen, **cond)
        true_max = int(s1["y_lengths"].max())
        y_max = max(bucket, int(np.ceil(true_max / bucket)) * bucket)
        if self.args.max_inference_len:
            y_max = min(y_max, self.args.max_inference_len)
        out = self.net.infer_decode(
            s1["w_ceil"], s1["y_lengths"], s1["m_p"], s1["logs_p"], s1["x_mask"], y_max, generator=gen, **cond
        )
        out["durations"] = s1["w_ceil"]
        return out

    @staticmethod
    def init_from_config(config, device=None):
        from tpu_tts_torch.managers import LanguageManager, SpeakerManager
        from tpu_tts_torch.text.tokenizer import TTSTokenizer

        upsample_rate = int(np.prod(config.model_args.upsample_rates_decoder))
        if upsample_rate != config.audio.hop_length:
            raise ValueError(
                f" [!] Product of upsample rates must equal the hop length - {upsample_rate} vs {config.audio.hop_length}"
            )
        ap = AudioProcessor.init_from_config(config)
        tokenizer, new_config = TTSTokenizer.init_from_config(config)
        speaker_manager = SpeakerManager.init_from_config(new_config.model_args)
        language_manager = LanguageManager.init_from_config(new_config)
        return Vits(new_config, ap, tokenizer, device=device, speaker_manager=speaker_manager,
                    language_manager=language_manager)
