"""VITS, channels-first inside, on the port's modules: inference and training.

Counterpart of `tpu_tts/models/vits.py`: `VitsNet` (`setup`:73,
`_cond_embeddings`:156, `_duration_loss_and_attn`:167, `__call__`:197 as
`forward`, `infer_durations`:303, `infer_decode`:326) and `Vits`
(`_spec_from_wav`/`_mel_from_spec`/`_mel_from_wav`:441-464, `_forward_g`:466,
`loss_fn`:499, `get_optimizer`:593, `inference`:614 with its two-stage
bucketing, `get_data_loader`:768). Stage 1 runs the text
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

Training (`Vits.init_training`, then `loss_fn` per optimizer: D = 0, G = 1)
adds the posterior encoder to the net (`posterior_encoder.*`) and the
discriminator beside it (`disc.*`), Coqui's state-dict names. A training
forward takes three draws: the posterior's ε, the SDP posterior's noise and
the segment offsets' uniforms. They come from the `torch.Generator` it is
given, or ready-made in `draws` (the tests hand it JAX's). Dropout draws from
torch's default generator. MAS runs on the host (`ops/mas.py`). The D step's
generator forward runs without gradients; the G step's discriminator passes
run with its parameters frozen, the real half without gradients. A batch's
`speaker_ids`, `d_vectors` and `language_ids` condition the training
forward as they condition inference (multi-speaker, multilingual and
d-vector training).

Mixed precision (`mixed_precision`, `tpu_tts/models/vits.py`:100,149-152,
373,389,400; `handles_mixed_precision`): `init_training` gives the
posterior encoder's `pre` and WN, the couplings' `pre` and WN, the decoder
(but its `conv_post` and tanh) and the discriminator's convs a bfloat16
compute dtype, on float32 parameters; the text encoder and the duration
predictor stay float32, and the losses read float32. A model loaded for
serving keeps float32 throughout, K1 included.

With `encoder_sample_rate` (`:466-477`, `:225-233`) the posterior's
spectrogram comes from the waveform resized to the encoder's rate
(`audio.torch_transforms.resize_linear`, JAX's antialiased
`jax.image.resize`), with `spec_lengths // f`; the decoder reads the
segment of z upsampled ×f at ×f the offsets, and the G step's mel target is
the mel of the real waveform's segment.

The speaker-consistency loss (`use_speaker_encoder_as_loss`, `:564-594`):
minus the mean cosine of the frozen speaker encoder's embeddings of the real
and the generated segments (centred log-mels at the encoder's audio
settings), × `speaker_encoder_loss_alpha`. The encoder is the speaker
manager's (`SpeakerManager(encoder_model_path=...)` or `init_encoder`);
without one `init_training` raises, where JAX silently drops the term.

Voice conversion (`voice_conversion`:357 and :747 in JAX) takes a source
waveform through the posterior encoder and the forward flow with the source
speaker's g, back through the reverse flow and the decoder (K1 on the card)
with the target's. Loading a checkpoint that holds `posterior_encoder.*`
(a trained one) builds the encoder for it.
"""

import math
from typing import Dict, Optional

import numpy as np
import torch
import torch.nn as nn
import torch.nn.functional as F

from tpu_tts_torch.audio import AudioProcessor
from tpu_tts_torch.audio import torch_transforms as tt
from tpu_tts_torch.layers.common import DurationPredictor, frozen as _frozen, set_compute_dtype
from tpu_tts_torch.layers.losses import discriminator_loss, feature_loss, generator_loss, kl_loss
from tpu_tts_torch.layers.vits import (
    ResidualCouplingBlocks,
    StochasticDurationPredictor,
    VitsDiscriminator,
    VitsPosteriorEncoder,
    VitsTextEncoder,
    paired_disc_apply,
)
from tpu_tts_torch.models.base_tts import BaseTTSModel
from tpu_tts_torch.ops.helpers import bucket_len, generate_path, rand_segments, segment, sequence_mask
from tpu_tts_torch.ops.mas import maximum_path
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
            dropout_p=args.dropout_p_text_encoder,
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
                width, 192, 3, num_flows=4, cond_channels=dp_cond, language_emb_dim=self.lang_dim,
                dropout_p=args.dropout_p_duration_predictor,
            )
        else:
            self.duration_predictor = DurationPredictor(
                width, 256, 3, cond_channels=dp_cond, language_emb_dim=self.lang_dim,
                dropout_p=args.dropout_p_duration_predictor,
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

    def add_posterior_encoder(self):
        """The linear-spectrogram encoder of training, as `posterior_encoder`."""
        a = self.args
        self.posterior_encoder = VitsPosteriorEncoder(
            a.out_channels, a.hidden_channels, a.hidden_channels, a.kernel_size_posterior_encoder,
            a.dilation_rate_posterior_encoder, a.num_layers_posterior_encoder, cond_channels=self.embedded_speaker_dim,
        )

    def duration_loss_and_attn(self, z_p, m_p, logs_p, h_text, x_mask, y_mask, sdp_noise, g, lang_emb):
        """MAS alignment `[B, T_en, T_de]` of the prior to z_p, and the
        duration predictor's loss on its frame counts."""
        a = self.args
        attn_mask = x_mask.transpose(1, 2) * y_mask  # [B, T_en, T_de]
        with torch.no_grad():
            o_scale = torch.exp(-2 * logs_p)  # [B, C, T_en]
            logp1 = torch.sum(-0.5 * math.log(2 * math.pi) - logs_p, dim=1)[:, :, None]
            logp2 = torch.matmul(o_scale.transpose(1, 2), -0.5 * z_p**2)
            logp3 = torch.matmul((m_p * o_scale).transpose(1, 2), z_p)
            logp4 = torch.sum(-0.5 * m_p**2 * o_scale, dim=1)[:, :, None]
            attn = maximum_path(logp1 + logp2 + logp3 + logp4, attn_mask)
        dr = torch.sum(attn, dim=2)[:, None, :]  # [B, 1, T_en]
        dp_in = h_text.detach() if a.detach_dp_input else h_text
        dp_g = g.detach() if g is not None and a.detach_dp_input else g
        if not a.condition_dp_on_speaker:
            dp_g = None
        if a.use_sdp:
            nll = self.duration_predictor(dp_in, x_mask, dr, sdp_noise, g=dp_g, lang_emb=lang_emb)
            loss_duration = torch.sum(nll.float()) / torch.sum(x_mask)
        else:
            log_durations = self.duration_predictor(dp_in, x_mask, g=dp_g, lang_emb=lang_emb)
            attn_log_durations = torch.log(dr + 1) * x_mask
            loss_duration = torch.sum((log_durations - attn_log_durations) ** 2) / torch.sum(x_mask)
        return attn, loss_duration

    def forward(self, x, x_lengths, spec, spec_lengths, speaker_ids=None, d_vectors=None, language_ids=None,
                generator: Optional[torch.Generator] = None, draws: Optional[Dict] = None) -> Dict:
        """The training forward: x `[B, T_en]` token ids, spec `[B, C_spec,
        T_de]` with their lengths. `draws` may hold `posterior` `[B, C, T_de]`
        and `sdp` `[B, 2, T_en]` standard normals and `segments` `[B]`
        uniforms; what it lacks is drawn from `generator`. Returns the
        decoded segments `model_outputs` `[B, 1, spec_segment_size · hop]`
        and what the losses read."""
        draws = draws or {}
        dev = spec.device
        g, lang_emb = self.cond_embeddings(speaker_ids, d_vectors, language_ids)
        h_text, m_p, logs_p, x_mask = self.text_encoder(x, x_lengths, lang_emb=lang_emb)
        eps = draws.get("posterior")
        if eps is None:
            eps = torch.randn(spec.shape[0], self.args.hidden_channels, spec.shape[2], generator=generator, device=dev)
        z, m_q, logs_q, y_mask = self.posterior_encoder(spec, spec_lengths, eps, g=g)
        z_p = self.flow(z, y_mask, g=g)
        sdp_noise = draws.get("sdp")
        if sdp_noise is None and self.args.use_sdp:
            sdp_noise = torch.randn(x.shape[0], 2, x.shape[1], generator=generator, device=dev)
        attn, loss_duration = self.duration_loss_and_attn(z_p, m_p, logs_p, h_text, x_mask, y_mask, sdp_noise, g,
                                                          lang_emb)
        m_p_ex = torch.matmul(m_p, attn)  # [B, C, T_de]
        logs_p_ex = torch.matmul(logs_p, attn)
        z_slice, slice_ids = rand_segments(z, spec_lengths, self.args.spec_segment_size, let_short_samples=True,
                                           pad_short=True, u=draws.get("segments"), generator=generator)
        f = self.interp_factor
        if f > 1:  # the segment of z at the decoder's rate
            slice_ids = slice_ids * f
            z_slice = segment(self.upsample_z(z), slice_ids, self.args.spec_segment_size * f, pad_short=True)
        o = self.waveform_decoder(z_slice, g=g)
        return {"model_outputs": o, "alignments": attn.transpose(1, 2), "m_p": m_p_ex, "logs_p": logs_p_ex, "z": z,
                "z_p": z_p, "m_q": m_q, "logs_q": logs_q, "y_mask": y_mask, "loss_duration": loss_duration,
                "slice_ids": slice_ids}

    def voice_conversion(self, spec, spec_lengths, g_src, g_tgt, noise):
        """Source spectrogram `[B, C_spec, T]` → waveform `[B, 1, T·hop]` in
        the target's voice: the posterior encoder and the forward flow with
        g_src, the reverse flow with g_tgt, then the decoder with g_tgt.
        `noise` `[B, C, T]` is the posterior's ε."""
        z, _, _, y_mask = self.posterior_encoder(spec, spec_lengths, noise, g=g_src)
        z_p = self.flow(z, y_mask, g=g_src)
        z_hat = self.flow.reverse(z_p, y_mask, g=g_tgt)
        return self.waveform_decoder(self.upsample_z(z_hat * y_mask), g=g_tgt)

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
    # mixed precision through the modules' compute dtype, not the trainer's generic cast
    handles_mixed_precision = True

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
        self.disc = None  # built by `init_training`

    # ------------------------------------------------------------ training
    def init_training(self):
        """Build what training adds to the inference net: the posterior
        encoder (in the net) and the discriminator (`self.disc`), and with
        `mixed_precision` set the bfloat16 compute dtype. Idempotent."""
        a = self.args
        if a.use_speaker_encoder_as_loss and getattr(self.speaker_manager, "encoder", None) is None:
            raise ValueError("use_speaker_encoder_as_loss needs a speaker encoder: build the speaker manager with "
                             "encoder_model_path/encoder_config_path or call its init_encoder()")
        if not hasattr(self.net, "posterior_encoder"):
            self.net.add_posterior_encoder()
            self.net.posterior_encoder.to(self.device)
        if self.disc is None:
            self.disc = VitsDiscriminator(tuple(a.periods_multi_period_discriminator),
                                          a.use_spectral_norm_disriminator).to(self.device)
        if getattr(self.config, "mixed_precision", False):
            for part in (self.net.posterior_encoder, self.net.flow, self.net.waveform_decoder, self.disc):
                set_compute_dtype(part, torch.bfloat16)
            self.net.waveform_decoder.conv_post.compute_dtype = None  # conv_post and the tanh stay float32

    def num_optimizers(self) -> int:
        return 2

    def optimizer_params(self, optimizer_idx: int):
        """The parameters optimizer `optimizer_idx` trains: D = 0, G = 1."""
        return list(self.disc.parameters()) if optimizer_idx == 0 else list(self.net.parameters())

    def train(self, mode: bool = True):
        self.net.train(mode)
        if self.disc is not None:
            self.disc.train(mode)

    def training_state_dict(self) -> Dict[str, torch.Tensor]:
        """Generator and discriminator under Coqui's names (`disc.*`)."""
        sd = dict(self.net.state_dict())
        sd.update({f"disc.{k}": v for k, v in self.disc.state_dict().items()})
        return sd

    def load_training_state(self, state: Dict[str, torch.Tensor], strict: bool = True):
        """Load `training_state_dict`'s keys (a Coqui VITS `.pth`'s `model`)."""
        from tpu_tts_torch.utils.checkpoint import rename_old_weight_norm

        state = {rename_old_weight_norm(k): v for k, v in state.items() if isinstance(v, torch.Tensor)}
        self.net.load_state_dict({k: v for k, v in state.items() if not k.startswith("disc.")}, strict=strict)
        self.disc.load_state_dict({k[5:]: v for k, v in state.items() if k.startswith("disc.")}, strict=strict)

    def load_checkpoint(self, config, checkpoint_path: str, eval: bool = True, strict: bool = True):
        """As `BaseTTSModel.load_checkpoint`; a checkpoint that holds the
        posterior encoder (a trained one) builds it first, for voice
        conversion, so a strict load takes its keys."""
        from tpu_tts_torch.utils.checkpoint import load_net_checkpoint, read_checkpoint

        ckpt = read_checkpoint(checkpoint_path)
        sd = ckpt["model"] if isinstance(ckpt.get("model"), dict) else ckpt
        if not hasattr(self.net, "posterior_encoder") and any(k.startswith("posterior_encoder.") for k in sd):
            self.net.add_posterior_encoder()
            self.net.posterior_encoder.to(self.device)
        load_net_checkpoint(self.net, ckpt, strict=strict)
        if eval:
            self.net.eval()
        return ckpt

    def _speaker_cond(self, cond) -> torch.Tensor:
        """g `[1, C, 1]` of a speaker id (a row of `emb_g`) or a d-vector."""
        if isinstance(cond, (int, np.integer)):
            return self.net.emb_g(self._long([int(cond)]))[:, :, None]
        d = cond if isinstance(cond, torch.Tensor) else torch.as_tensor(np.asarray(cond, dtype=np.float32))
        return d.to(device=self.device, dtype=torch.float32).reshape(1, -1, 1)

    @torch.no_grad()
    def voice_conversion(self, source_wav, speaker_cond_src, speaker_cond_tgt, seed: int = 0,
                         noise: Optional[torch.Tensor] = None) -> np.ndarray:
        """A source waveform spoken by `speaker_cond_src` → the same speech in
        `speaker_cond_tgt`'s voice, float32 `[T_spec · hop]`. Each condition
        is a speaker id or a d-vector. The posterior's ε is `noise` `[1, C,
        T_spec]`, or drawn from a `torch.Generator` seeded with `seed` (JAX
        draws it from `PRNGKey(0)`). The decoder runs through K1 on the card."""
        if not hasattr(self.net, "posterior_encoder"):
            raise ValueError("voice conversion needs the posterior encoder: load a trained checkpoint that holds it")
        wav = source_wav if isinstance(source_wav, torch.Tensor) else torch.as_tensor(
            np.asarray(source_wav, dtype=np.float32))
        spec = self.spec_from_wav(wav.to(device=self.device, dtype=torch.float32).reshape(1, 1, -1))
        if noise is None:
            gen = torch.Generator(device=self.device).manual_seed(int(seed))
            noise = torch.randn(1, self.args.hidden_channels, spec.shape[2], generator=gen, device=self.device)
        o = self.net.voice_conversion(spec, self._long([spec.shape[2]]), self._speaker_cond(speaker_cond_src),
                                      self._speaker_cond(speaker_cond_tgt), noise.to(self.device))
        return o[0, 0].float().cpu().numpy()

    def spec_from_wav(self, wav: torch.Tensor) -> torch.Tensor:
        """`[B, 1, T]` → the linear spectrogram `[B, C, T / hop]` (VITS framing)."""
        a = self.config.audio
        return tt.wav_to_spec(wav[:, 0], fft_size=a.fft_size, hop_length=a.hop_length, win_length=a.win_length,
                              center=False)

    def mel_from_spec(self, spec: torch.Tensor) -> torch.Tensor:
        a = self.config.audio
        return tt.spec_to_mel(spec, fft_size=a.fft_size, num_mels=a.num_mels, sample_rate=a.sample_rate,
                              fmin=a.mel_fmin, fmax=a.mel_fmax)

    def mel_from_wav(self, wav: torch.Tensor) -> torch.Tensor:
        return self.mel_from_spec(self.spec_from_wav(wav))

    def forward_g(self, batch: Dict, generator=None, draws=None):
        """The generator's training forward on a batch; also returns its
        spectrogram (at the encoder's rate with `encoder_sample_rate`)."""
        wav, spec_lengths = batch["waveform"], batch["mel_lengths"]
        f = self.net.interp_factor
        if f > 1:
            wav, spec_lengths = tt.resize_linear(wav, wav.shape[-1] // f), spec_lengths // f
        spec = self.spec_from_wav(wav)
        outputs = self.net(batch["text_input"], batch["text_lengths"], spec, spec_lengths,
                           speaker_ids=batch.get("speaker_ids"), d_vectors=batch.get("d_vectors"),
                           language_ids=batch.get("language_ids"), generator=generator, draws=draws)
        return outputs, spec

    def loss_fn(self, batch: Dict, optimizer_idx: int, generator: Optional[torch.Generator] = None,
                draws: Optional[Dict] = None):
        """(loss, logs) of one sub-step: the discriminator's (0) or the
        generator's (1), on the modules' current parameters. Each call runs
        its own generator forward with its own draws."""
        c = self.config
        hop = int(np.prod(self.args.upsample_rates_decoder))
        if optimizer_idx == 0:
            with torch.no_grad():
                outputs, _ = self.forward_g(batch, generator, draws)
            y_hat = outputs["model_outputs"]
            wav_seg = segment(batch["waveform"], outputs["slice_ids"] * hop, y_hat.shape[2], pad_short=True)
            scores_real, scores_fake, _, _ = paired_disc_apply(self.disc, wav_seg, y_hat)
            loss = discriminator_loss(scores_real, scores_fake) * c.disc_loss_alpha
            return loss, {"loss_disc": loss}

        outputs, spec = self.forward_g(batch, generator, draws)
        y_hat = outputs["model_outputs"]
        wav_seg = segment(batch["waveform"], outputs["slice_ids"] * hop, y_hat.shape[2], pad_short=True)
        with _frozen(self.disc):
            scores_fake, feats_fake = self.disc(y_hat)
            with torch.no_grad():
                _, feats_real = self.disc(wav_seg)
        mel_hat = self.mel_from_wav(y_hat)
        if self.net.interp_factor > 1:  # the spectrogram's frames are at the encoder's rate
            mel_seg = self.mel_from_wav(wav_seg)
        else:
            mel_seg = segment(self.mel_from_spec(spec), outputs["slice_ids"], self.args.spec_segment_size,
                              pad_short=True)
        T = min(mel_hat.shape[2], mel_seg.shape[2])
        logs = {
            "loss_mel": torch.mean(torch.abs(mel_seg[..., :T] - mel_hat[..., :T])) * c.mel_loss_alpha,
            "loss_kl": kl_loss(outputs["z_p"], outputs["logs_q"], outputs["m_p"], outputs["logs_p"],
                               outputs["y_mask"]) * c.kl_loss_alpha,
            "loss_feat": feature_loss(feats_real, feats_fake) * c.feat_loss_alpha,
            "loss_gen": generator_loss(scores_fake) * c.gen_loss_alpha,
            "loss_duration": outputs["loss_duration"] * c.dur_loss_alpha,
        }
        loss = sum(logs.values())
        if self.args.use_speaker_encoder_as_loss:
            logs["loss_spk_encoder"] = self.speaker_consistency_loss(wav_seg, y_hat)
            loss = loss + logs["loss_spk_encoder"] * getattr(c, "speaker_encoder_loss_alpha", 9.0)
        logs["loss_gen_total"] = loss
        return loss, logs

    def speaker_consistency_loss(self, wav_real, wav_fake) -> torch.Tensor:
        """Minus the mean cosine of the frozen encoder's L2-normalised
        embeddings of the real and generated segments `[B, 1, T]`; the
        gradient reaches the generator through the fake side's mel."""
        enc = self.speaker_manager.encoder
        a = enc.audio
        wavs = torch.cat([wav_real, wav_fake], dim=0)[:, 0].float()
        mel = tt.wav_to_mel(wavs, fft_size=a["fft_size"], num_mels=a["num_mels"], sample_rate=a["sample_rate"],
                            hop_length=a["hop_length"], win_length=a["win_length"], fmin=a.get("mel_fmin", 0.0),
                            fmax=a.get("mel_fmax"), center=True)
        with _frozen(enc.net):
            gt, syn = torch.chunk(enc.net(mel, l2_norm=True), 2, dim=0)
        return -torch.mean(torch.sum(gt * syn, dim=-1))

    def get_optimizer(self):
        """[D, G] optimizers (`train/optimizers.py`), each with its own lr
        schedule and its entry of `grad_clip`."""
        from tpu_tts_torch.train.optimizers import get_optimizer, get_scheduler

        c = self.config
        scheds = (get_scheduler(c.lr_scheduler_disc, c.lr_scheduler_disc_params, c.lr_disc),
                  get_scheduler(c.lr_scheduler_gen, c.lr_scheduler_gen_params, c.lr_gen))
        return [get_optimizer(c.optimizer, c.optimizer_params, self.optimizer_params(i), c, schedule=scheds[i],
                              optimizer_idx=i) for i in range(2)]

    def get_data_loader(self, config, assets, is_eval, samples, verbose, num_gpus=1, rank=0):
        """The waveform loader: VITS computes its spectrograms from the
        waveform on the device."""
        config.return_wav = True
        config.compute_linear_spec = False  # computed on the device
        return super().get_data_loader(config, assets, is_eval, samples, verbose, num_gpus, rank)

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
    def init_from_config(config, device=None, samples=None):
        """The model a config describes; a multi-speaker model's speaker ids
        come from the training `samples` when given, else from its files."""
        from tpu_tts_torch.managers import LanguageManager, SpeakerManager
        from tpu_tts_torch.text.tokenizer import TTSTokenizer

        upsample_rate = int(np.prod(config.model_args.upsample_rates_decoder))
        if upsample_rate != config.audio.hop_length:
            raise ValueError(
                f" [!] Product of upsample rates must equal the hop length - {upsample_rate} vs {config.audio.hop_length}"
            )
        ap = AudioProcessor.init_from_config(config)
        tokenizer, new_config = TTSTokenizer.init_from_config(config)
        speaker_manager = SpeakerManager.init_from_config(new_config.model_args, samples)
        language_manager = LanguageManager.init_from_config(new_config)
        return Vits(new_config, ap, tokenizer, device=device, speaker_manager=speaker_manager,
                    language_manager=language_manager)

