"""DelightfulTTS, channels-last inside, on the port's modules: inference and training.

Counterpart of `tpu_tts/models/delightful_tts.py`: `DelightfulTtsArgs`:61
(in `configs/delightful_tts_config.py`), `AcousticModelNet`:106 with
`_speaker_embedding`:210, `_forward_aligner`:219, `_expand`:229, the
teacher-forced `forward`:236 and `infer`:316, `DelightfulNet`:358 with
`forward`:393, `infer`:427 and `infer_spec`:441, and `DelightfulTTS`:448
with its constructor, `_mel_from_wav`:513, `_energy_from_wav`:521,
`_forward_g`:531, `loss_fn`:571, `get_optimizer`:690, `inference`:704,
`get_data_loader`:775 and `init_from_config`:782. Module names are the flax
tree's, so the state dict keeps its paths (`models/delightful_convert.py`
maps a `tpu_tts` param tree onto it).

`inference` buckets as JAX does: the tokens are zero-padded to a multiple
of 32, the mel buffer `y_max` is a multiple of 128 of at least 8 frames a
token, and the positional table has length max(T_src, y_max). Durations
are round(max((exp(log_dur) − 1)·length_scale, 1)) on valid tokens, the mel
length their sum clipped to [1, y_max]. The mel is zeroed past its length
and the HiFi-GAN decoder runs on the whole `y_max` buffer; only then is the
waveform cut to the first row's n_frames · hop (`conv_pre` has a bias, so a
trimmed mel would end differently).

The decoder is the port's `HifiganGenerator`, built as
`tpu_tts/models/delightful_tts.py:377-391` builds it (no bias on
`conv_post`, no inference padding, `cond_channels` the speaker width). In
`eval()` mode every ResBlock1 stage goes through the MRF kernel K1
(`ops/hifigan_mrf.py`) on the card and its plain version on the CPU; JAX
sends stages to its Pallas kernel only when asked
(`TPU_TTS_PALLAS_DECODER`, `aux_input["use_pallas_decoder"]`) and only at
C ≤ 128 (ROADMAP.md, divergence 5). ResBlock2 runs in plain torch.

Speakers: `use_speaker_embedding` takes a row of `emb_g` per `speaker_ids`,
`use_d_vector_file` the `d_vectors`; either is L2-normalised into g, which
conditions every conformer block (`Conv1dGLU`) and enters the decoder's
`cond_layer`. A speaker id on a model without a speaker table, or a
d-vector on a model without `use_d_vector_file`, is ignored where JAX
fails or mixes them up (ROADMAP.md, divergence 9).

Training (`DelightfulTTS.init_training`, then `loss_fn` per optimizer: D =
0, G = 1) adds VITS's discriminator beside the net (`disc.*`, periods
`vocoder.periods_discriminator`). `_forward_g` computes the mel and the
energy from the batch's waveform on the device (`torch.stft`, VITS
framing): the energy is each frame's linear-spectrum L2 norm, standardised
over the batch's valid frames (`e_std` clamped at 1e-8 under the root),
where Coqui keeps a running BatchNorm; the pitch (pyin) and the aligner's
beta-binomial priors come from the data loader, the priors padded or cut to
the device's mel frames. The teacher-forced forward aligns tokens to frames
with the `AlignmentNetwork` and MAS on the host (`ops/mas.py`; JAX runs it
on the device, ROADMAP.md divergence 17) over the aligner's log-probs with
−inf replaced by −1e9; the durations drive the pitch and energy targets and
the expansion; the duration predictor reads the encoder output detached.
The decoder gets one window of `spec_segment_size` frames a row of the
detached mel (`rand_segments`, short rows padded), its start drawn from the
`torch.Generator` given (the trainer's, seeded with `training_seed`) or
ready-made in `draws["segments"]` (divergence 18). The D step's generator
forward runs without gradients; the G step's discriminator runs on the fake
half with its parameters frozen and on the real half without gradients
(divergence 20). In `train()` mode the decoder runs ResBlock1 in plain
torch (K1 has no backward); the trained run directory serves through K1.
"""

from typing import Dict, Optional

import numpy as np
import torch
import torch.nn as nn
import torch.nn.functional as F

from tpu_tts_torch.audio import AudioProcessor
from tpu_tts_torch.audio import torch_transforms as tt
from tpu_tts_torch.layers.common import frozen
from tpu_tts_torch.layers.delightful import (
    Conformer,
    EmbeddingPadded,
    EnergyAdaptor,
    PhonemeLevelProsodyEncoder,
    PhonemeProsodyPredictor,
    PitchAdaptor,
    UtteranceLevelProsodyEncoder,
    VariancePredictor,
    _norm_last,
    positional_encoding,
)
from tpu_tts_torch.layers.feed_forward import AlignmentNetwork
from tpu_tts_torch.layers.losses import forward_sum_loss, wide
from tpu_tts_torch.layers.vits import VitsDiscriminator, paired_disc_apply
from tpu_tts_torch.models.base_tts import BaseTTSModel
from tpu_tts_torch.ops.helpers import bucket_len, generate_path, rand_segments, segment, sequence_mask
from tpu_tts_torch.ops.mas import maximum_path
from tpu_tts_torch.vocoder.layers.losses import feature_matching_loss, mse_D_loss, mse_G_loss, multi_scale_stft_loss
from tpu_tts_torch.vocoder.models.hifigan_generator import HifiganGenerator


def speaker_dim(a: dict) -> int:
    """The width of g: the speaker table's, the d-vectors', or 0."""
    if a["use_speaker_embedding"]:
        return a["speaker_embedding_channels"]
    if a["use_d_vector_file"]:
        return a["d_vector_dim"]
    return 0


class AcousticModelNet(nn.Module):
    """Tokens → mel `[B, T_mel, num_mels]`, channels-last."""

    def __init__(self, a: dict):
        super().__init__()
        self.a = a
        self.emb_dim = a["n_hidden_conformer_encoder"]
        self.spk_dim = spk_dim = speaker_dim(a)
        if a["use_speaker_embedding"]:
            self.emb_g = nn.Embedding(max(a["num_speakers"], 1), spk_dim)
        self.src_word_emb = EmbeddingPadded(a["num_chars"], self.emb_dim, padding_idx=a.get("_pad_id", 0))
        self.encoder = Conformer(
            dim=self.emb_dim,
            n_layers=a["n_layers_conformer_encoder"],
            n_heads=a["n_heads_conformer_encoder"],
            speaker_embedding_dim=spk_dim,
            p_dropout=a["dropout_conformer_encoder"],
            kernel_size_conv_mod=a["kernel_size_conv_mod_conformer_encoder"],
            lrelu_slope=a["lrelu_slope"],
        )
        va = dict(kernel_size=a["kernel_size_variance_adaptor"], emb_kernel_size=a["emb_kernel_size_variance_adaptor"],
                  lrelu_slope=a["lrelu_slope"])
        self.pitch_adaptor = PitchAdaptor(self.emb_dim, a["n_hidden_variance_adaptor"],
                                          p_dropout=a["dropout_variance_adaptor"], **va)
        self.energy_adaptor = EnergyAdaptor(self.emb_dim, a["n_hidden_variance_adaptor"],
                                            dropout=a["dropout_variance_adaptor"], **va)
        self.aligner = AlignmentNetwork(in_query_channels=a["num_mels"], in_key_channels=self.emb_dim)
        self.duration_predictor = VariancePredictor(
            self.emb_dim, a["n_hidden_variance_adaptor"], 1, a["kernel_size_variance_adaptor"],
            a["dropout_variance_adaptor"], a["lrelu_slope"],
        )
        ref_kw = dict(
            num_mels=a["num_mels"],
            ref_enc_filters=tuple(a["ref_enc_filters_reference_encoder"]),
            ref_enc_size=a["ref_enc_size_reference_encoder"],
            ref_enc_strides=tuple(a["ref_enc_strides_reference_encoder"]),
            ref_enc_gru_size=a["ref_enc_gru_size_reference_encoder"],
            dropout=a["dropout_conformer_encoder"],
            n_hidden=self.emb_dim,
        )
        self.utterance_prosody_encoder = UtteranceLevelProsodyEncoder(
            bottleneck_size_u=a["bottleneck_size_u_reference_encoder"], token_num=a["token_num_reference_encoder"],
            **ref_kw,
        )
        self.utterance_prosody_predictor = PhonemeProsodyPredictor(
            self.emb_dim, a["predictor_kernel_size_reference_encoder"], a["dropout_conformer_encoder"],
            a["bottleneck_size_u_reference_encoder"], a["lrelu_slope"],
        )
        self.phoneme_prosody_encoder = PhonemeLevelProsodyEncoder(
            n_heads=a["n_heads_conformer_encoder"], bottleneck_size_p=a["bottleneck_size_p_reference_encoder"],
            **ref_kw,
        )
        self.phoneme_prosody_predictor = PhonemeProsodyPredictor(
            self.emb_dim, a["predictor_kernel_size_reference_encoder"], a["dropout_conformer_encoder"],
            a["bottleneck_size_p_reference_encoder"], a["lrelu_slope"],
        )
        self.u_bottle_out = nn.Linear(a["bottleneck_size_u_reference_encoder"], self.emb_dim)
        self.p_bottle_out = nn.Linear(a["bottleneck_size_p_reference_encoder"], self.emb_dim)
        self.decoder = Conformer(
            dim=a["n_hidden_conformer_decoder"],
            n_layers=a["n_layers_conformer_decoder"],
            n_heads=a["n_heads_conformer_decoder"],
            speaker_embedding_dim=spk_dim,
            p_dropout=a["dropout_conformer_decoder"],
            kernel_size_conv_mod=a["kernel_size_conv_mod_conformer_decoder"],
            lrelu_slope=a["lrelu_slope"],
        )
        self.to_mel = nn.Linear(a["n_hidden_conformer_decoder"], a["num_mels"])

    def _speaker_embedding(self, speaker_ids=None, d_vectors=None):
        """g `[B, spk_dim]`, L2-normalised, or None."""
        if d_vectors is not None and self.a["use_d_vector_file"]:
            return F.normalize(d_vectors, dim=-1, eps=1e-12)
        if speaker_ids is not None and self.a["use_speaker_embedding"]:
            return F.normalize(self.emb_g(speaker_ids), dim=-1, eps=1e-12)
        return None

    @staticmethod
    def _expand(o_en, dr, src_valid, mel_valid):
        """Each token's frame repeated by its duration → (`[B, T_mel, C]`, attn `[B, T_mel, T_src]`)."""
        attn = generate_path(dr, src_valid.to(o_en.dtype)[:, :, None] * mel_valid.to(o_en.dtype)[:, None, :])
        return torch.einsum("bst,bsc->btc", attn, o_en), attn.transpose(1, 2)

    def _forward_aligner(self, x_emb, mels, src_valid, mel_valid, attn_priors):
        """(durations `[B, T_src]`, soft attention `[B, T_mel, T_src]`, its
        log-probs `[B, 1, T_mel, T_src]` (−inf on masked tokens), the MAS path
        `[B, T_mel, T_src]`)."""
        attn_soft, attn_logp = self.aligner(mels, x_emb, mask=src_valid, attn_prior=attn_priors)
        attn_mask = src_valid.float()[:, :, None] * mel_valid.float()[:, None, :]
        logp = torch.where(torch.isfinite(attn_logp), attn_logp, torch.full_like(attn_logp, -1e9))
        mas = maximum_path(logp.detach().float().transpose(1, 2), attn_mask)  # [B, T_src, T_mel], on the host
        return mas.sum(-1), attn_soft, attn_logp[:, None], mas.transpose(1, 2)

    def forward(self, tokens, src_lens, mels, mel_lens, pitches, energies, attn_priors=None, d_vectors=None,
                speaker_ids=None) -> Dict:
        """The teacher-forced forward: tokens `[B, T_src]`, mels `[B, T_mel,
        C]`, pitches and energies `[B, T_mel]`, attn_priors `[B, T_mel,
        T_src]` → the mel `model_outputs` `[B, T_mel, C]` and what the losses
        read; the prosody references condition the encoder output, the
        predictions are trained towards them (JAX's `use_ground_truth`,
        which no caller turns off)."""
        T_src, T_mel = tokens.shape[1], mels.shape[1]
        src_valid = sequence_mask(src_lens, T_src)
        mel_valid = sequence_mask(mel_lens, T_mel)
        token_emb = self.src_word_emb(tokens)
        dr, aligner_soft, aligner_logprob, aligner_mas = self._forward_aligner(token_emb, mels, src_valid, mel_valid,
                                                                               attn_priors)
        g = self._speaker_embedding(speaker_ids, d_vectors)
        encoding = positional_encoding(self.emb_dim, max(T_src, T_mel), device=tokens.device,
                                       dtype=torch.promote_types(token_emb.dtype, torch.float32))
        o_en = self.encoder(token_emb, src_valid, g, encoding)
        src_f = src_valid.to(o_en.dtype)

        u_prosody_ref = _norm_last(self.utterance_prosody_encoder(mels, mel_lens))
        u_pred = self.utterance_prosody_predictor(o_en, src_valid)
        u_prosody_pred = _norm_last(u_pred.sum(1, keepdim=True) / src_valid.float().sum(1)[:, None, None])
        o_en = o_en + self.u_bottle_out(u_prosody_ref)
        p_prosody_ref = _norm_last(self.phoneme_prosody_encoder(o_en, src_valid, mels, mel_lens, encoding))
        p_prosody_pred = _norm_last(self.phoneme_prosody_predictor(o_en, src_valid))
        o_en = o_en + self.p_bottle_out(p_prosody_ref)

        o_en_res = o_en
        pitch_pred, pitch_target, pitch_emb = self.pitch_adaptor.get_pitch_embedding_train(o_en, pitches, dr, src_f)
        energy_pred, energy_target, energy_emb = self.energy_adaptor.get_energy_embedding_train(o_en, energies, dr,
                                                                                                src_f)
        o_en = o_en + pitch_emb + energy_emb
        log_duration_pred = self.duration_predictor(o_en_res.detach(), src_f)
        o_ex, alignments = self._expand(o_en, dr, src_valid, mel_valid)
        x = self.to_mel(self.decoder(o_ex, mel_valid, g, encoding))
        return {"model_outputs": x, "pitch_pred": pitch_pred, "pitch_target": pitch_target,
                "energy_pred": energy_pred, "energy_target": energy_target, "u_prosody_pred": u_prosody_pred,
                "u_prosody_ref": u_prosody_ref, "p_prosody_pred": p_prosody_pred, "p_prosody_ref": p_prosody_ref,
                "alignments": alignments, "aligner_soft": aligner_soft, "aligner_mas": aligner_mas,
                "aligner_durations": dr, "aligner_logprob": aligner_logprob, "dr_log_pred": log_duration_pred,
                "dr_log_target": torch.log(dr + 1), "spk_emb": g}

    def infer(self, tokens, src_lens, y_max_length: int, d_vectors=None, speaker_ids=None) -> Dict:
        """Durations from the predictor, then the mel in a `y_max_length` buffer, zero past `mel_lens`."""
        T_src = tokens.shape[1]
        src_valid = sequence_mask(src_lens, T_src)
        token_emb = self.src_word_emb(tokens)
        src_f = src_valid.to(token_emb.dtype)
        g = self._speaker_embedding(speaker_ids, d_vectors)
        encoding = positional_encoding(self.emb_dim, max(T_src, y_max_length), device=tokens.device)
        o_en = self.encoder(token_emb, src_valid, g, encoding)

        u_pred = self.utterance_prosody_predictor(o_en, src_valid)
        u_prosody_pred = _norm_last(u_pred.sum(1, keepdim=True) / src_f.sum(1)[:, None, None])
        o_en = o_en + self.u_bottle_out(u_prosody_pred)
        p_prosody_pred = _norm_last(self.phoneme_prosody_predictor(o_en, src_valid))
        o_en = o_en + self.p_bottle_out(p_prosody_pred)

        o_en_res = o_en
        pitch_emb, pitch_pred = self.pitch_adaptor.get_pitch_embedding(o_en, src_f)
        energy_emb, energy_pred = self.energy_adaptor.get_energy_embedding(o_en, src_f)
        o_en = o_en + pitch_emb + energy_emb

        log_dur = self.duration_predictor(o_en_res, src_f)
        dur = (torch.exp(log_dur) - 1) * src_f * self.a["length_scale"]
        dur = torch.round(torch.clamp(dur, min=1.0)) * src_f
        mel_lens = torch.clamp(dur.sum(1).long(), 1, y_max_length)
        mel_valid = sequence_mask(mel_lens, y_max_length)
        o_ex, alignments = self._expand(o_en, dur, src_valid, mel_valid)
        x = self.decoder(o_ex, mel_valid, g, encoding)
        x = self.to_mel(x) * mel_valid[:, :, None].to(x.dtype)
        return {"model_outputs": x, "alignments": alignments, "durations": dur, "pitch": pitch_pred,
                "energy": energy_pred, "spk_emb": g, "mel_lens": mel_lens}


class DelightfulNet(nn.Module):
    """The acoustic model and its HiFi-GAN waveform decoder."""

    def __init__(self, a: dict, vocoder: dict):
        super().__init__()
        self.spec_segment_size = a["spec_segment_size"]
        self.acoustic_model = AcousticModelNet(a)
        self.waveform_decoder = HifiganGenerator(
            in_channels=a["num_mels"],
            out_channels=1,
            resblock_type=str(vocoder["resblock_type_decoder"]),
            resblock_dilation_sizes=[tuple(d) for d in vocoder["resblock_dilation_sizes_decoder"]],
            resblock_kernel_sizes=tuple(vocoder["resblock_kernel_sizes_decoder"]),
            upsample_kernel_sizes=tuple(vocoder["upsample_kernel_sizes_decoder"]),
            upsample_initial_channel=vocoder["upsample_initial_channel_decoder"],
            upsample_factors=tuple(vocoder["upsample_rates_decoder"]),
            inference_padding=0,
            cond_channels=speaker_dim(a),
            conv_pre_weight_norm=False,
            conv_post_weight_norm=False,
            conv_post_bias=False,
        )

    def forward(self, tokens, src_lens, mels, mel_lens, pitches, energies, attn_priors=None, d_vectors=None,
                speaker_ids=None, generator: Optional[torch.Generator] = None,
                segments: Optional[torch.Tensor] = None) -> Dict:
        """The acoustic model's teacher-forced forward, then the decoder on
        one window a row of its detached mel: `model_outputs` `[B, 1,
        spec_segment_size · hop]`, the mel as `acoustic_model_outputs`, the
        windows' starts as `slice_ids`. The starts take the uniforms
        `segments` `[B]`, else draws from `generator`."""
        outputs = self.acoustic_model(tokens, src_lens, mels, mel_lens, pitches, energies, attn_priors=attn_priors,
                                      d_vectors=d_vectors, speaker_ids=speaker_ids)
        slices, slice_ids = rand_segments(outputs["model_outputs"].transpose(1, 2), mel_lens, self.spec_segment_size,
                                          let_short_samples=True, pad_short=True, u=segments, generator=generator)
        g = outputs["spk_emb"]
        outputs["acoustic_model_outputs"] = outputs["model_outputs"]
        outputs["model_outputs"] = self.waveform_decoder(slices.detach(), g=None if g is None else g[:, :, None])
        outputs["slice_ids"] = slice_ids
        return outputs

    def infer(self, tokens, src_lens, y_max_length: int, d_vectors=None, speaker_ids=None,
              decode: bool = True) -> Dict:
        """`decode`: the waveform `[B, y_max·hop, 1]` as `model_outputs`;
        else the mel as `mel` and the decoder's g `[B, C_g, 1]` (or 0) as `g`."""
        out = self.acoustic_model.infer(tokens, src_lens, y_max_length, d_vectors=d_vectors,
                                        speaker_ids=speaker_ids)
        g = out["spk_emb"]
        g_in = g[:, :, None] if g is not None else None
        if decode:
            out["model_outputs"] = self.waveform_decoder(out["model_outputs"].transpose(1, 2), g=g_in).transpose(1, 2)
        else:
            out["mel"] = out["model_outputs"]
            out["g"] = g_in if g_in is not None else 0
        return out

    def infer_spec(self, tokens, src_lens, y_max_length: int, d_vectors=None, speaker_ids=None) -> Dict:
        """The acoustic model alone: the mel as `model_outputs`."""
        return self.acoustic_model.infer(tokens, src_lens, y_max_length, d_vectors=d_vectors,
                                         speaker_ids=speaker_ids)


class DelightfulTTS(BaseTTSModel):
    TEXT_BUCKET = 32  # tokens are zero-padded to this grid
    FRAMES_PER_TOKEN = 8  # the mel buffer holds at least this many frames a token

    def __init__(self, config, ap=None, tokenizer=None, device=None, speaker_manager=None):
        super().__init__(config, ap, tokenizer, device, speaker_manager)
        args = config.model_args
        if tokenizer is not None and tokenizer.characters is not None:
            args.num_chars = tokenizer.characters.num_chars
        if speaker_manager is not None and args.use_speaker_embedding:
            args.num_speakers = max(args.num_speakers, speaker_manager.num_speakers)
        args.num_mels = config.audio.num_mels
        self.args = args
        a = args.to_dict()
        a["_pad_id"] = tokenizer.characters.pad_id if tokenizer is not None and tokenizer.characters else 0
        self.net = DelightfulNet(a, config.vocoder.to_dict()).to(self.device).eval()
        self.disc = None  # built by `init_training`
        self.binary_loss_weight = 1.0

    def _long(self, v) -> torch.Tensor:
        v = v if isinstance(v, torch.Tensor) else torch.as_tensor(np.asarray(v))
        return v.to(device=self.device, dtype=torch.long)

    @torch.no_grad()
    def inference(self, x, aux_input=None, bucket: int = 128) -> Dict:
        """Token ids `[T]` or `[B, T]` (every row `T` tokens long) → the
        waveform `[B, n_frames·hop, 1]` (n_frames: the first row's mel
        length), `alignments`, `durations` and `y_lengths` (the mel
        lengths). aux_input: `speaker_ids` `[B]` or `d_vectors` `[B, D]`."""
        aux_input = aux_input or {}
        x = self._long(x)
        if x.ndim == 1:
            x = x[None]
        n_tokens = x.shape[1]
        T_src = bucket_len(n_tokens, self.TEXT_BUCKET)
        y_max = bucket_len(n_tokens * self.FRAMES_PER_TOKEN, bucket)
        x = F.pad(x, (0, T_src - n_tokens))
        src_lens = torch.full((x.shape[0],), n_tokens, dtype=torch.long, device=self.device)
        cond = {}
        d = aux_input.get("d_vectors")
        if d is not None:
            d = d if isinstance(d, torch.Tensor) else torch.as_tensor(np.asarray(d, dtype=np.float32))
            cond["d_vectors"] = d.to(device=self.device, dtype=torch.float32).reshape(-1, d.shape[-1])
        if aux_input.get("speaker_ids") is not None:
            cond["speaker_ids"] = self._long(aux_input["speaker_ids"]).reshape(-1)
        out = self.net.infer(x, src_lens, y_max, **cond)
        n_frames = int(out["mel_lens"][0])
        return {
            "model_outputs": out["model_outputs"][:, : n_frames * self.config.audio.hop_length],
            "alignments": out["alignments"],
            "durations": out["durations"],
            "y_lengths": out["mel_lens"],
        }

    # ------------------------------------------------------------ training
    def init_training(self):
        """Build the discriminator (`self.disc`). Idempotent."""
        if self.disc is None:
            v = self.config.vocoder
            self.disc = VitsDiscriminator(tuple(v.periods_discriminator), v.use_spectral_norm_discriminator).to(
                self.device)

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
        """The net and the discriminator (`disc.*`)."""
        sd = dict(self.net.state_dict())
        sd.update({f"disc.{k}": v for k, v in self.disc.state_dict().items()})
        return sd

    def load_training_state(self, state: Dict[str, torch.Tensor], strict: bool = True):
        """Load `training_state_dict`'s keys."""
        state = {k: v for k, v in state.items() if isinstance(v, torch.Tensor)}
        self.net.load_state_dict({k: v for k, v in state.items() if not k.startswith("disc.")}, strict=strict)
        self.disc.load_state_dict({k[5:]: v for k, v in state.items() if k.startswith("disc.")}, strict=strict)

    def _mel_from_wav(self, wav: torch.Tensor) -> torch.Tensor:
        """`[B, 1, T]` → log-mel `[B, T / hop, num_mels]` (VITS framing)."""
        a = self.config.audio
        return tt.wav_to_mel(wav[:, 0], fft_size=a.fft_size, num_mels=a.num_mels, sample_rate=a.sample_rate,
                             hop_length=a.hop_length, win_length=a.win_length, fmin=a.mel_fmin, fmax=a.mel_fmax,
                             center=False).transpose(1, 2)

    def _energy_from_wav(self, wav: torch.Tensor) -> torch.Tensor:
        """`[B, 1, T]` → each frame's linear-spectrum L2 norm `[B, T / hop]`."""
        a = self.config.audio
        spec = tt.wav_to_spec(wav[:, 0], fft_size=a.fft_size, hop_length=a.hop_length, win_length=a.win_length,
                              center=False)
        return torch.linalg.vector_norm(spec, dim=1)

    def _forward_g(self, batch: Dict, generator=None, draws=None):
        """The net's training forward on a batch: (outputs, the mel `[B,
        T_mel, C]` zeroed past each row's length, the mel lengths)."""
        wav = batch["waveform"]
        mel = self._mel_from_wav(wav)
        T_mel = mel.shape[1]
        mel_lens = torch.clamp(batch["mel_lengths"], max=T_mel)
        mel_valid = sequence_mask(mel_lens, T_mel).to(mel.dtype)
        mel = mel * mel_valid[:, :, None]
        energy = self._energy_from_wav(wav)[:, :T_mel]
        e_n = torch.clamp(mel_valid.sum(), min=1.0)
        e_mean = (energy * mel_valid).sum() / e_n
        e_std = torch.sqrt(torch.clamp(((energy - e_mean) ** 2 * mel_valid).sum() / e_n, min=1e-8))
        energy = (energy - e_mean) / e_std * mel_valid
        pitch = batch.get("pitch")
        pitch = pitch[:, :T_mel] if pitch is not None else torch.zeros_like(energy)
        priors = batch.get("attn_priors")
        if priors is not None:  # sized on the host's mel frames
            priors = F.pad(priors, (0, 0, 0, max(T_mel - priors.shape[1], 0)))[:, :T_mel]
        outputs = self.net(batch["text_input"], batch["text_lengths"], mel, mel_lens, pitch, energy,
                           attn_priors=priors, d_vectors=batch.get("d_vectors"), speaker_ids=batch.get("speaker_ids"),
                           generator=generator, segments=(draws or {}).get("segments"))
        return outputs, mel, mel_lens

    def loss_fn(self, batch: Dict, optimizer_idx: int, generator: Optional[torch.Generator] = None,
                draws: Optional[Dict] = None):
        """(loss, logs) of one sub-step: the discriminator's (0) or the
        generator's (1), on the modules' current parameters. Each call runs
        its own generator forward with its own draws."""
        c = self.config
        hop = c.audio.hop_length
        seg = self.args.spec_segment_size
        if optimizer_idx == 0:
            with torch.no_grad():
                outputs, _, _ = self._forward_g(batch, generator, draws)
            wav_seg = segment(batch["waveform"], outputs["slice_ids"] * hop, seg * hop, pad_short=True)
            scores_real, scores_fake, _, _ = paired_disc_apply(self.disc, wav_seg, outputs["model_outputs"])
            loss = wide(mse_D_loss(scores_fake, scores_real)[0]) * c.disc_loss_alpha
            return loss, {"loss_disc": loss}

        outputs, mel, mel_lens = self._forward_g(batch, generator, draws)
        y_hat = outputs["model_outputs"]
        wav_seg = segment(batch["waveform"], outputs["slice_ids"] * hop, seg * hop, pad_short=True)
        with frozen(self.disc):
            scores_fake, feats_fake = self.disc(y_hat)
            with torch.no_grad():
                _, feats_real = self.disc(wav_seg)

        mel = wide(mel)
        src_valid = sequence_mask(batch["text_lengths"], batch["text_input"].shape[1]).to(mel.dtype)
        mel_w = sequence_mask(mel_lens, mel.shape[1]).to(mel.dtype)[:, :, None]
        o = {k: wide(v) for k, v in outputs.items() if torch.is_tensor(v) and v.is_floating_point()}
        p_w = src_valid[:, :, None]
        n_src = torch.clamp(src_valid.sum(), min=1.0)
        logs = {
            "loss_mel": torch.abs((o["acoustic_model_outputs"] - mel) * mel_w).sum() / torch.clamp(
                mel_w.sum() * mel.shape[-1], min=1.0),
            "loss_duration": torch.sum((o["dr_log_pred"] - o["dr_log_target"].detach()) ** 2 * src_valid) / n_src,
            "loss_u_prosody": 0.5 * torch.mean(torch.abs(o["u_prosody_ref"].detach() - o["u_prosody_pred"])),
            "loss_p_prosody": 0.5 * torch.abs((o["p_prosody_ref"].detach() - o["p_prosody_pred"]) * p_w).sum()
            / torch.clamp(p_w.sum() * o["p_prosody_ref"].shape[-1], min=1.0),
            "loss_pitch": torch.sum((o["pitch_pred"] - o["pitch_target"].detach()) ** 2 * src_valid) / n_src,
            "loss_energy": torch.sum((o["energy_pred"] - o["energy_target"].detach()) ** 2 * src_valid) / n_src,
            "loss_aligner": forward_sum_loss(o["aligner_logprob"], batch["text_lengths"], mel_lens),
        }
        loss = (logs["loss_mel"] * c.mel_loss_alpha + logs["loss_duration"] * c.dur_loss_alpha
                + logs["loss_u_prosody"] * c.u_prosody_loss_alpha + logs["loss_p_prosody"] * c.p_prosody_loss_alpha
                + logs["loss_pitch"] * c.pitch_loss_alpha + logs["loss_energy"] * c.energy_loss_alpha
                + logs["loss_aligner"] * c.aligner_loss_alpha)
        if c.binary_align_loss_alpha > 0:
            hard = o["aligner_mas"].detach()
            binary = -(torch.log(torch.clamp(o["aligner_soft"], min=1e-12)) * hard).sum() / torch.clamp(hard.sum(),
                                                                                                      min=1.0)
            loss = loss + c.binary_align_loss_alpha * binary * self.binary_loss_weight
            logs["loss_binary_alignment"] = binary

        mel_slice = segment(mel.transpose(1, 2), outputs["slice_ids"], seg, pad_short=True)
        mel_slice_hat = self._mel_from_wav(wide(y_hat)).transpose(1, 2)
        T = min(mel_slice.shape[-1], mel_slice_hat.shape[-1])
        p = c.multi_scale_stft_loss_params
        stft_mg, stft_sc = multi_scale_stft_loss(wide(y_hat[:, 0]), wide(wav_seg[:, 0]), n_ffts=tuple(p["n_ffts"]),
                                                 hop_lengths=tuple(p["hop_lengths"]),
                                                 win_lengths=tuple(p["win_lengths"]))
        voc = {
            "vocoder_loss_feat": feature_matching_loss(feats_fake, feats_real) * c.feat_loss_alpha,
            "vocoder_loss_gen": mse_G_loss(scores_fake) * c.gen_loss_alpha,
            "vocoder_loss_mel": torch.mean(torch.abs(mel_slice[..., :T] - mel_slice_hat[..., :T]))
            * c.vocoder_mel_loss_alpha,
            "vocoder_loss_stft_mg": stft_mg * c.multi_scale_stft_loss_alpha,
            "vocoder_loss_stft_sc": stft_sc * c.multi_scale_stft_loss_alpha,
        }
        loss = loss + sum(voc.values())
        logs.update(voc)
        logs["loss_gen_total"] = loss
        return loss, logs

    def get_optimizer(self):
        """[D, G] AdamW optimizers (`train/optimizers.py`), each with its own
        exponential lr schedule, clipped at `grad_clip`."""
        from tpu_tts_torch.train.optimizers import get_optimizer, get_scheduler

        c = self.config
        scheds = (get_scheduler(c.lr_scheduler_disc, c.lr_scheduler_disc_params, c.lr_disc),
                  get_scheduler(c.lr_scheduler_gen, c.lr_scheduler_gen_params, c.lr_gen))
        return [get_optimizer(c.optimizer, c.optimizer_params, self.optimizer_params(i), c, schedule=scheds[i],
                              optimizer_idx=i) for i in range(2)]

    def get_data_loader(self, config, assets, is_eval, samples, verbose, num_gpus=1, rank=0):
        """The waveform loader with pyin F0, as `tpu_tts`'s forces it; the
        mel and the energy come from the waveform on the device."""
        config.compute_f0 = True
        config.return_wav = True
        return super().get_data_loader(config, assets, is_eval, samples, verbose, num_gpus, rank)

    @staticmethod
    def init_from_config(config, device=None, samples=None) -> "DelightfulTTS":
        from tpu_tts_torch.managers import SpeakerManager
        from tpu_tts_torch.text.tokenizer import TTSTokenizer

        ap = AudioProcessor.init_from_config(config)
        tokenizer, new_config = TTSTokenizer.init_from_config(config)
        speaker_manager = SpeakerManager.init_from_config(new_config, samples)
        return DelightfulTTS(new_config, ap, tokenizer, device=device, speaker_manager=speaker_manager)
