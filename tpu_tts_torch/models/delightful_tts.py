"""DelightfulTTS inference, channels-last inside, on the port's modules.

Counterpart of `tpu_tts/models/delightful_tts.py`: `DelightfulTtsArgs`:61
(in `configs/delightful_tts_config.py`), `AcousticModelNet`:106 with
`_speaker_embedding`:210, `_expand`:229 and `infer`:316, `DelightfulNet`:358
with `infer`:427 and `infer_spec`:441, and `DelightfulTTS`:448 with its
constructor, `inference`:704 and `init_from_config`:782. Module names are
the flax tree's, so the state dict keeps its paths
(`models/delightful_convert.py` maps a `tpu_tts` param tree onto it).

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

Training is not ported yet: the teacher-forced forward, the aligner, the
featurizers, `loss_fn`, `get_optimizer` and `get_data_loader` raise and name
the ROADMAP item.
"""

from typing import Dict

import numpy as np
import torch
import torch.nn as nn
import torch.nn.functional as F

from tpu_tts_torch.audio import AudioProcessor
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
from tpu_tts_torch.models.base_tts import BaseTTSModel
from tpu_tts_torch.ops.helpers import bucket_len, generate_path, sequence_mask
from tpu_tts_torch.vocoder.models.hifigan_generator import HifiganGenerator

TRAINING = "DelightfulTTS training is not ported yet (ROADMAP.md, queue 1: DelightfulTTS training)"


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

    def forward(self, *args, **kwargs):
        raise NotImplementedError(TRAINING)

    def _forward_aligner(self, *args, **kwargs):
        raise NotImplementedError(TRAINING)

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

    def forward(self, *args, **kwargs):
        raise NotImplementedError(TRAINING)

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

    # training comes with its own slice
    def init_training(self):
        raise NotImplementedError(TRAINING)

    def _mel_from_wav(self, wav):
        raise NotImplementedError(TRAINING)

    def _energy_from_wav(self, wav):
        raise NotImplementedError(TRAINING)

    def loss_fn(self, *args, **kwargs):
        raise NotImplementedError(TRAINING)

    def get_optimizer(self):
        raise NotImplementedError(TRAINING)

    def get_data_loader(self, *args, **kwargs):
        raise NotImplementedError(TRAINING)

    @staticmethod
    def init_from_config(config, device=None, samples=None) -> "DelightfulTTS":
        from tpu_tts_torch.managers import SpeakerManager
        from tpu_tts_torch.text.tokenizer import TTSTokenizer

        ap = AudioProcessor.init_from_config(config)
        tokenizer, new_config = TTSTokenizer.init_from_config(config)
        speaker_manager = SpeakerManager.init_from_config(new_config, samples)
        return DelightfulTTS(new_config, ap, tokenizer, device=device, speaker_manager=speaker_manager)
