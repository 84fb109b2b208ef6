"""The ForwardTTS family (FastPitch, FastSpeech, FastSpeech2, SpeedySpeech),
channels-last inside, on the port's modules: inference and training.

Counterpart of `tpu_tts/models/forward_tts.py`: `_build_coder`:90,
`ForwardTTSNet`:140 with `_speaker`:185, `_encode`:192, `_decode`:200, the
teacher-forced `__call__`:210 and `inference`:277, and `ForwardTTS`:304
with `convert_torch_state_dict`:318, `loss_fn`:375, `inference`:446 and
`init_from_config`:470; `ForwardTTSArgs` is in
`configs/forward_tts_config.py`. One model covers the family through its
args: the encoder and decoder kinds (`fftransformer`,
`relative_position_transformer`, `residual_conv_bn` (SpeedySpeech),
`wavenet`) and the pitch and energy switches. Module names are the flax
tree's, so the state dict keeps its paths (`models/forward_convert.py`
maps a `tpu_tts` param tree, or a Coqui checkpoint, onto it).

`inference` sizes the mel buffer as JAX does: `y_max` is the smallest
multiple of 128 that holds 16 frames a token (at least 128). Durations are
round(max((exp(log_dur) − 1) · length_scale, 1)) on valid tokens; the mel
length is their sum clipped to `y_max`, silently, as in JAX (ROADMAP.md,
F21): speech slower than 16 frames a token is cut off. The mel is zeroed
past its length. ForwardTTS gives a mel, which the `Synthesizer` hands to a
vocoder (HiFi-GAN through the MRF kernel K1 on the card) or to Griffin-Lim.

Speakers: `use_speaker_embedding` adds a row of `emb_g` (a table of
`num_speakers` > 1 rows) to every token embedding, a d-vector is added as
it is (its width must be `hidden_channels`). A speaker id on a model
without a speaker table is ignored where JAX fails.

Training (`loss_fn`, one optimizer) follows `tpu_tts`: the aligner's
log-probs (−inf replaced by −1e9) go to MAS on the host (`ops/mas.py`; JAX
runs it on the device, ROADMAP.md divergence 17), the durations are clipped
to `max_duration`, the pitch and energy targets are the batch's per-frame
values averaged over each token's frames, fed raw (Hz and the spectral
norm; ROADMAP.md, F22). The terms are the spec loss (mse or l1), ssim, the
log-duration mse, pitch, energy, the forward-sum aligner loss and the
binary alignment loss, each times its config alpha, the targets detached.
With `norm_type="batch"` (SpeedySpeech's default) the BatchNorm layers
normalise by the batch in `train()` mode and move their running
statistics, which the checkpoints carry. No kernel runs in training:
ForwardTTS has no waveform decoder.
"""

import math
from typing import Dict, Optional

import numpy as np
import torch
import torch.nn as nn

from tpu_tts_torch.audio import AudioProcessor
from tpu_tts_torch.layers.common import DurationPredictor
from tpu_tts_torch.layers.delightful import Conv
from tpu_tts_torch.layers.feed_forward import (
    AlignmentNetwork,
    FFTransformerBlock,
    FlaxConv1d,
    PositionalEncoding,
    ResidualConv1dBNDecoder,
    ResidualConv1dBNEncoder,
    WaveNetDecoder,
)
from tpu_tts_torch.layers.losses import (
    binary_alignment_loss,
    forward_sum_loss,
    masked_l1_loss,
    masked_mse_loss,
    ssim_loss,
)
from tpu_tts_torch.layers.transformer import RelativePositionTransformer
from tpu_tts_torch.models.base_tts import BaseTTSModel
from tpu_tts_torch.ops.helpers import average_over_durations, generate_path, sequence_mask
from tpu_tts_torch.ops.mas import maximum_path


class _ChannelsLastRPT(RelativePositionTransformer):
    """The port's channels-first relative-position transformer on `[B, T, C]`."""

    def forward(self, x, x_mask):
        return super().forward(x.transpose(1, 2), x_mask.transpose(1, 2)).transpose(1, 2)


def build_coder(kind: str, params: dict, channels: int, out_channels: int, name: str, norm_type: str = "layer"):
    """The encoder (`name` "encoder") or decoder of `kind`, with JAX's
    defaults; SpeedySpeech's encoder and decoder take different dilations."""
    params = dict(params or {})
    if kind == "fftransformer":
        return FFTransformerBlock(channels, params.get("num_heads", 1), params.get("hidden_channels_ffn", 1024),
                                  params.get("num_layers", 6), params.get("dropout_p", 0.1))
    if kind == "relative_position_transformer":
        if out_channels != channels:
            raise NotImplementedError("a relative-position coder whose width changes is not ported")
        return _ChannelsLastRPT(channels, params.get("hidden_channels_ffn", 1024), params.get("num_heads", 2),
                                params.get("num_layers", 6), kernel_size=params.get("kernel_size", 3),
                                rel_attn_window_size=params.get("rel_attn_window_size", 4),
                                dropout_p=params.get("dropout_p", 0.1))
    if kind in ("residual_conv_bn", "residual_conv_bn_encoder", "residual_conv_bn_decoder"):
        hidden = params.get("hidden_channels", channels)
        common = dict(kernel_size=params.get("kernel_size", 4), num_conv_blocks=params.get("num_conv_blocks", 2),
                      norm_type=norm_type)
        if name == "encoder":
            return ResidualConv1dBNEncoder(channels, hidden, out_channels,
                                           dilations=tuple(params.get("dilations", (1, 2, 4) * 4 + (1,))), **common)
        return ResidualConv1dBNDecoder(hidden, out_channels,
                                       dilations=tuple(params.get("dilations", (1, 2, 4, 8) * 4 + (1,))), **common)
    if kind == "wavenet":
        return WaveNetDecoder(params.get("hidden_channels", channels), out_channels,
                              kernel_size=params.get("kernel_size", 3), dilation_rate=params.get("dilation_rate", 1),
                              num_layers=params.get("num_layers", 10))
    raise ValueError(f" [!] Unknown encoder/decoder type {kind}")


class ForwardTTSNet(nn.Module):
    """Tokens → mel `[B, T_mel, out_channels]`, channels-last."""

    def __init__(self, a: dict):
        super().__init__()
        self.a = a
        C = a["hidden_channels"]
        norm_type = a.get("norm_type") or "batch"
        self.emb = nn.Embedding(a["num_chars"], C)
        self.encoder = build_coder(a["encoder_type"], a["encoder_params"], C, C, "encoder", norm_type)
        self.decoder = build_coder(a["decoder_type"], a["decoder_params"], C, C, "decoder", norm_type)
        self.proj = Conv(C, a["out_channels"], 1)
        if a["positional_encoding"]:
            self.pos_encoder = PositionalEncoding(C, use_scale=a["poisitonal_encoding_use_scale"])
        self.duration_predictor = DurationPredictor(C, a["duration_predictor_hidden_channels"],
                                                    a["duration_predictor_kernel_size"],
                                                    dropout_p=a["duration_predictor_dropout_p"])
        if a["use_pitch"]:
            self.pitch_predictor = DurationPredictor(C, a["pitch_predictor_hidden_channels"],
                                                     a["pitch_predictor_kernel_size"],
                                                     dropout_p=a["pitch_predictor_dropout_p"])
            self.pitch_emb = FlaxConv1d(1, C, a["pitch_embedding_kernel_size"])
        if a["use_energy"]:
            self.energy_predictor = DurationPredictor(C, a["energy_predictor_hidden_channels"],
                                                      a["energy_predictor_kernel_size"],
                                                      dropout_p=a["energy_predictor_dropout_p"])
            self.energy_emb = FlaxConv1d(1, C, a["energy_embedding_kernel_size"])
        if a["use_aligner"]:
            self.aligner = AlignmentNetwork(in_query_channels=a["out_channels"], in_key_channels=C)
        if a["use_speaker_embedding"] and a["num_speakers"] > 1:
            self.emb_g = nn.Embedding(a["num_speakers"], C)

    @staticmethod
    def _predict(predictor, x, x_mask):
        """A (channels-first) duration-style predictor on `[B, T, C]` → `[B, T]`."""
        return predictor(x.transpose(1, 2), x_mask.transpose(1, 2))[:, 0]

    def _speaker(self, speaker_ids=None, d_vectors=None):
        if speaker_ids is not None and hasattr(self, "emb_g"):
            return self.emb_g(speaker_ids)[:, None, :]
        if d_vectors is not None:
            return d_vectors[:, None, :]
        return None

    def _encode(self, x, x_lengths, g):
        h = self.emb(x)
        x_mask = sequence_mask(x_lengths, x.shape[1]).to(torch.promote_types(h.dtype, torch.float32))[:, :, None]
        if g is not None:
            h = h + g
        return self.encoder(h * x_mask, x_mask), x_mask

    def _decode(self, o_en, dr, x_mask, y_lengths, y_max: int):
        """Each token's encoding repeated by its duration, the positional
        encoding, the decoder, `proj`: (mel, path `[B, T_en, T_de]`, y_mask)."""
        y_mask = sequence_mask(y_lengths, y_max).to(x_mask.dtype)[:, :, None]
        attn = generate_path(dr, x_mask * y_mask.transpose(1, 2))
        o_ex = torch.einsum("bet,bec->btc", attn, o_en)
        if self.a["positional_encoding"]:
            o_ex = self.pos_encoder(o_ex, y_mask)
        return self.proj(self.decoder(o_ex, y_mask)) * y_mask, attn, y_mask

    def forward(self, x, x_lengths, y, y_lengths, dr=None, pitch=None, energy=None, attn_prior=None,
                speaker_ids=None, d_vectors=None) -> Dict:
        """The teacher-forced forward: tokens `[B, T_en]`, the mel `y` `[B,
        T_de, C]`, pitch and energy `[B, T_de]`, attn_prior `[B, T_de, T_en]`;
        `dr` `[B, T_en]` is read only without the aligner."""
        a = self.a
        g = self._speaker(speaker_ids, d_vectors)
        o_en, x_mask = self._encode(x, x_lengths, g)
        y_max = y.shape[1]
        alignment_soft = alignment_logprob = alignment_mas = None
        if a["use_aligner"]:
            attn_soft, attn_logp = self.aligner(y, o_en, mask=x_mask[:, :, 0], attn_prior=attn_prior)
            y_mask = sequence_mask(y_lengths, y_max).to(x_mask.dtype)[:, :, None]
            logp = torch.where(torch.isfinite(attn_logp), attn_logp, torch.full_like(attn_logp, -1e9))
            alignment_mas = maximum_path(logp.detach().float().transpose(1, 2), x_mask * y_mask.transpose(1, 2))
            alignment_mas = alignment_mas.to(x_mask.dtype)  # [B, T_en, T_de]
            dr = alignment_mas.sum(-1)
            alignment_soft, alignment_logprob = attn_soft, attn_logp[:, None]
        dr = torch.clamp(dr, 0, a["max_duration"])
        dp_in = o_en.detach() if a["detach_duration_predictor"] else o_en
        o_dr_log = self._predict(self.duration_predictor, dp_in, x_mask)
        o_pitch = avg_pitch = o_energy = avg_energy = None
        if a["use_pitch"]:
            o_pitch = self._predict(self.pitch_predictor, o_en, x_mask)
            avg_pitch = average_over_durations(pitch[:, None, :], dr.long())[:, 0]
            o_en = o_en + self.pitch_emb(avg_pitch[:, :, None])
        if a["use_energy"]:
            o_energy = self._predict(self.energy_predictor, o_en, x_mask)
            avg_energy = average_over_durations(energy[:, None, :], dr.long())[:, 0]
            o_en = o_en + self.energy_emb(avg_energy[:, :, None])
        o_de, attn, _ = self._decode(o_en, dr, x_mask, y_lengths, y_max)
        return {"model_outputs": o_de, "durations_log": o_dr_log, "durations_log_target": torch.log(dr + 1),
                "durations": dr, "pitch_avg": o_pitch, "pitch_avg_gt": avg_pitch, "energy_avg": o_energy,
                "energy_avg_gt": avg_energy, "alignments": attn.transpose(1, 2), "alignment_soft": alignment_soft,
                "alignment_mas": alignment_mas, "alignment_logprob": alignment_logprob}

    def inference(self, x, x_lengths, y_max_length: int, speaker_ids=None, d_vectors=None) -> Dict:
        a = self.a
        g = self._speaker(speaker_ids, d_vectors)
        o_en, x_mask = self._encode(x, x_lengths, g)
        o_dr_log = self._predict(self.duration_predictor, o_en, x_mask)
        o_dr = (torch.exp(o_dr_log) - 1.0) * a["length_scale"]
        o_dr = torch.round(torch.clamp(o_dr, min=1.0)) * x_mask[:, :, 0]
        if a["use_pitch"]:
            o_en = o_en + self.pitch_emb(self._predict(self.pitch_predictor, o_en, x_mask)[:, :, None])
        if a["use_energy"]:
            o_en = o_en + self.energy_emb(self._predict(self.energy_predictor, o_en, x_mask)[:, :, None])
        y_lengths = torch.clamp(o_dr.sum(1), max=y_max_length).long()
        o_de, attn, _ = self._decode(o_en, o_dr, x_mask, y_lengths, y_max_length)
        return {"model_outputs": o_de, "alignments": attn.transpose(1, 2), "durations_log": o_dr_log,
                "durations": o_dr, "y_lengths": y_lengths}


class ForwardTTS(BaseTTSModel):
    MEL_BUCKET = 128
    FRAMES_PER_TOKEN = 16  # the mel buffer holds at least this many frames a token

    def __init__(self, config, ap=None, tokenizer=None, device=None, speaker_manager=None):
        super().__init__(config, ap, tokenizer, device, speaker_manager)
        args = config.model_args
        if tokenizer is not None and tokenizer.characters is not None:
            args.num_chars = tokenizer.characters.num_chars
        if args.num_chars is None:
            args.num_chars = 130
        if speaker_manager is not None and args.use_speaker_embedding:
            args.num_speakers = max(args.num_speakers, speaker_manager.num_speakers)
        self.args = args
        self.net = ForwardTTSNet(args.to_dict()).to(self.device).eval()

    def _long(self, v) -> torch.Tensor:
        v = v if isinstance(v, torch.Tensor) else torch.as_tensor(np.asarray(v))
        return v.to(device=self.device, dtype=torch.long)

    def load_checkpoint(self, config, checkpoint_path, eval: bool = True, strict: bool = True):
        """A `.pth` of the port's state dict, or a Coqui ForwardTTS checkpoint
        (`{"model": ...}` or flat, Coqui's key names), mapped by
        `forward_convert.state_dict_from_coqui`. A Coqui SpeedySpeech
        checkpoint carries BatchNorm statistics: its net is rebuilt with
        `norm_type="frozen_batch"` first, as `tpu_tts` does."""
        from tpu_tts_torch.models import forward_convert
        from tpu_tts_torch.utils.checkpoint import load_net_checkpoint, read_checkpoint

        ckpt = read_checkpoint(checkpoint_path) if isinstance(checkpoint_path, str) else checkpoint_path
        sd = ckpt["model"] if isinstance(ckpt.get("model"), dict) else ckpt
        if forward_convert.is_coqui_state_dict(sd):
            if "residual_conv_bn" in (self.args.encoder_type, self.args.decoder_type) and \
                    self.args.norm_type != "frozen_batch":
                self.args.norm_type = "frozen_batch"
                self.net = ForwardTTSNet(self.args.to_dict()).to(self.device)
            ckpt = forward_convert.state_dict_from_coqui(sd, self.net.state_dict())
        load_net_checkpoint(self.net, ckpt, strict=strict)
        if eval:
            self.net.eval()
        return ckpt

    @torch.no_grad()
    def inference(self, x, aux_input=None, bucket: int = MEL_BUCKET) -> Dict:
        """Token ids `[T]` or `[B, T]` → the mel `model_outputs` `[B, y_max,
        C]` (zero past `y_lengths`), `alignments` `[B, y_max, T]`,
        `durations_log`, `durations` and `y_lengths`. aux_input: `x_lengths`,
        `speaker_ids` `[B]` or `d_vectors` `[B, D]`."""
        aux_input = aux_input or {}
        x = self._long(x)
        if x.ndim == 1:
            x = x[None]
        x_lengths = aux_input.get("x_lengths")
        x_lengths = self._long([x.shape[1]] * x.shape[0] if x_lengths is None else x_lengths)
        y_max = max(bucket, int(math.ceil(x.shape[1] * self.FRAMES_PER_TOKEN / bucket)) * bucket)
        cond = {}
        d = aux_input.get("d_vectors")
        if d is not None:
            d = d if isinstance(d, torch.Tensor) else torch.as_tensor(np.asarray(d, dtype=np.float32))
            cond["d_vectors"] = d.to(device=self.device, dtype=torch.float32).reshape(-1, d.shape[-1])
        if aux_input.get("speaker_ids") is not None:
            cond["speaker_ids"] = self._long(aux_input["speaker_ids"]).reshape(-1)
        return self.net.inference(x, x_lengths, y_max, **cond)

    # ------------------------------------------------------------ training
    def init_training(self):
        """Nothing to build: one net, one optimizer."""

    def num_optimizers(self) -> int:
        return 1

    def optimizer_params(self, optimizer_idx: int = 0):
        return list(self.net.parameters())

    def train(self, mode: bool = True):
        self.net.train(mode)

    def training_state_dict(self) -> Dict[str, torch.Tensor]:
        """The net's parameters and buffers (the BatchNorm running statistics)."""
        return dict(self.net.state_dict())

    def load_training_state(self, state: Dict[str, torch.Tensor], strict: bool = True):
        self.net.load_state_dict({k: v for k, v in state.items() if isinstance(v, torch.Tensor)}, strict=strict)

    def loss_fn(self, batch: Dict, optimizer_idx: int = 0, generator: Optional[torch.Generator] = None):
        """(loss, logs): every term `tpu_tts`'s `loss_fn` logs and `loss`.
        No term draws from `generator`; dropout draws from torch's default
        generators, which the trainer seeds."""
        a, c = self.args, self.config
        o = self.net(batch["text_input"], batch["text_lengths"], batch["mel_input"], batch["mel_lengths"],
                     dr=batch.get("durations"), pitch=batch.get("pitch") if a.use_pitch else None,
                     energy=batch.get("energy") if a.use_energy else None, attn_prior=batch.get("attn_priors"),
                     speaker_ids=batch.get("speaker_ids"), d_vectors=batch.get("d_vectors"))
        x_lens, y_lens = batch["text_lengths"], batch["mel_lengths"]
        spec_fn = masked_mse_loss if getattr(c, "spec_loss_type", "mse") == "mse" else masked_l1_loss
        logs = {"loss_spec": spec_fn(o["model_outputs"], batch["mel_input"], y_lens)}
        loss = c.spec_loss_alpha * logs["loss_spec"]
        if getattr(c, "use_ssim_loss", False):
            logs["loss_ssim"] = ssim_loss(o["model_outputs"], batch["mel_input"], y_lens)
            loss = loss + c.ssim_loss_alpha * logs["loss_ssim"]
        logs["loss_dur"] = masked_mse_loss(o["durations_log"][:, :, None], o["durations_log_target"].detach()[:, :, None],
                                           x_lens)
        loss = loss + c.dur_loss_alpha * logs["loss_dur"]
        if a.use_pitch:
            logs["loss_pitch"] = masked_mse_loss(o["pitch_avg"][:, :, None], o["pitch_avg_gt"].detach()[:, :, None],
                                                 x_lens)
            loss = loss + c.pitch_loss_alpha * logs["loss_pitch"]
        if a.use_energy:
            logs["loss_energy"] = masked_mse_loss(o["energy_avg"][:, :, None],
                                                  o["energy_avg_gt"].detach()[:, :, None], x_lens)
            loss = loss + c.energy_loss_alpha * logs["loss_energy"]
        if a.use_aligner and o["alignment_logprob"] is not None:
            logs["loss_aligner"] = forward_sum_loss(o["alignment_logprob"], x_lens, y_lens)
            loss = loss + c.aligner_loss_alpha * logs["loss_aligner"]
            if getattr(c, "binary_align_loss_alpha", 0) > 0:
                logs["loss_binary_alignment"] = binary_alignment_loss(o["alignment_mas"].transpose(1, 2),
                                                                      o["alignment_soft"])
                loss = loss + c.binary_align_loss_alpha * logs["loss_binary_alignment"]
        logs["loss"] = loss
        return loss, logs

    def get_optimizer(self):
        """[one optimizer] (`train/optimizers.py`) over the net, at the
        config's lr schedule, clipped at `grad_clip`."""
        from tpu_tts_torch.train.optimizers import get_optimizer, get_scheduler

        c = self.config
        sched = get_scheduler(c.lr_scheduler, c.lr_scheduler_params or {}, c.lr)
        return [get_optimizer(c.optimizer, c.optimizer_params, self.optimizer_params(0), c, schedule=sched)]

    @staticmethod
    def init_from_config(config, device=None, samples=None) -> "ForwardTTS":
        from tpu_tts_torch.managers import SpeakerManager
        from tpu_tts_torch.text.tokenizer import TTSTokenizer

        ap = AudioProcessor.init_from_config(config)
        tokenizer, new_config = TTSTokenizer.init_from_config(config)
        speaker_manager = SpeakerManager.init_from_config(new_config, samples)
        return ForwardTTS(new_config, ap, tokenizer, device=device, speaker_manager=speaker_manager)
