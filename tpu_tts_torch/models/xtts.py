"""XTTS-v2 inference and streaming on the port's modules.

Counterpart of `tpu_tts/models/xtts.py`: `XttsNet` (`compute_conditioning`
:133, `generate_latents`:214, `stream_prefill`:267, `stream_chunk`:289,
`decode_latents`:357) and `Xtts` (`_bundled_speakers`:409, `synthesize`
:431, `get_conditioning_latents`:507, `inference`:706, `_bucket_text`:754,
`_n_samples`:766, `inference_stream`:778).

The decode is a Python loop over steps with the KV cache written in place
(`layers/xtts/gpt.py`); JAX's one-scan programs, its program cache and its
donated buffers have no counterpart, their results do. Each step divides
the logits by the temperature, keeps every logit ≥ the k-th largest (ties
at the k-th value survive, as JAX's `logits < kth` rule) and draws by
Gumbel-argmax from an explicit `torch.Generator` seeded from `seed`; the
generator is carried across chunks, so a chunked stream draws what the
one-loop `generate_latents` draws. With `top_k=1` the draw is the argmax
and the codes are JAX's up to near-ties; sampled codes are draws of
another stream than JAX's (ROADMAP.md, queue 3).

`decode_latents` interpolates the latent track ×(gpt_code_stride /
output_hop_length), then ×(output_sr / input_sr), as `F.interpolate`
(linear, half-pixel, the given scale) and JAX's `_torch_linear_interp`:69
do, and runs the HiFi-GAN decoder with g on `cond_layer` and on each `conds.{i}`;
every stage's MRF stack goes through K1 on the card (72 launches a call).

`inference_stream` raises when a chunk is shorter than `overlap_latents`:
JAX's overlap tail then shrinks (`tpu_tts/models/xtts.py`:854), so the
next chunk's context and crop misalign.

The speaker embedding comes from `speaker_proj` of the mean latent, or,
for a Coqui checkpoint, from Coqui's decoder-side ResNet speaker encoder
(`hifigan_decoder.speaker_encoder`, `tpu_tts/models/xtts.py`:107-117,
141-147: input 64 mels, 512 wide, its batch norms frozen). Its input
(`get_conditioning_latents`, `:517-527`) is the cloning wav resized to
16 kHz (JAX's antialiased linear resize), preemphasised by 0.97, as a
centred 64-band log-mel (fft 512, win 400, hop 160).

Fine-tuning the GPT (`tpu_tts/models/xtts.py`: `train_forward`:156,
`load_dvae`:540, `_style_mel`/`_dvae_mel`:572-591, `loss_fn`:593,
`on_init_start`:653, `get_data_loader`:659, `get_optimizer`:684): the
weighted text CE plus the mel-code CE over Coqui's framing, one optimizer
(AdamW) over the GPT with its conditioning encoder and perceiver. The
HiFi-GAN decoder and `speaker_proj` are frozen and never run in a step,
so K1 is never asked for a gradient. The targets come from the frozen
DVAE's codes of the batch's wavs, computed on the device under `no_grad`,
or ready-made (`audio_codes`). Without a `dvae.pth` the DVAE is drawn
from seed 0, and without `mel_stats.pth` the mels are not normalised, as
in JAX when no path is given.
"""

import math
import os
from typing import Dict, Iterator

import numpy as np
import torch
import torch.nn as nn
import torch.nn.functional as F

from tpu_tts_torch.audio.torch_transforms import resize_linear, torchaudio_mel, wav_to_mel
from tpu_tts_torch.configs.xtts_config import XttsArgs
from tpu_tts_torch.encoder.models import ResNetSpeakerEncoder
from tpu_tts_torch.layers.xtts.gpt import XttsGPT
from tpu_tts_torch.layers.xtts.tokenizer import VoiceBpeTokenizer
from tpu_tts_torch.models.base_tts import BaseTTSModel
from tpu_tts_torch.ops.helpers import bucket_len
from tpu_tts_torch.vocoder.models.hifigan_generator import HifiganGenerator

def linear_interp(x: torch.Tensor, scale: float) -> torch.Tensor:
    """`F.interpolate(x, scale_factor=scale, mode="linear",
    align_corners=False, recompute_scale_factor=False)` on the time axis of
    `[B, C, T]`: floor(T·scale) outputs at half-pixel source positions from
    the given scale. Where floor(T·scale) == T, `F.interpolate` returns its
    input unchanged and JAX's `_torch_linear_interp`:69 still resamples;
    this follows JAX (ROADMAP.md, queue 3, F6)."""
    T = x.shape[-1]
    pos = (torch.arange(math.floor(T * scale), device=x.device, dtype=torch.float32) + 0.5) / scale - 0.5
    pos = pos.clamp(0.0, T - 1)
    lo = pos.floor().long()
    hi = (lo + 1).clamp(max=T - 1)
    w = (pos - lo).to(x.dtype)
    return x[..., lo] * (1 - w) + x[..., hi] * w


def sample_codes(logits: torch.Tensor, temperature: float, top_k: int, generator: torch.Generator) -> torch.Tensor:
    """One draw per row of `logits` `[B, V]`: temperature, JAX's top-k rule
    (drop a logit only when it is below the k-th largest), Gumbel-argmax."""
    logits = logits / temperature
    if top_k:
        kth = torch.topk(logits, min(int(top_k), logits.shape[-1]), dim=-1).values[:, -1:]
        logits = logits.masked_fill(logits < kth, -1e9)
    u = torch.rand(logits.shape, generator=generator, device=logits.device, dtype=torch.float32)
    gumbel = -torch.log(-torch.log(u.clamp_min(torch.finfo(torch.float32).tiny)))
    return torch.argmax(logits.float() + gumbel, dim=-1)


def _check_room(cache, rows: int):
    """JAX clamps a cache write past the end onto the last rows; the port
    refuses a decode that would need more rows than `kv_cache_len`."""
    if rows > cache.shape[2]:
        raise ValueError(f"the prompt and the decode steps need {rows} KV-cache rows, kv_cache_len is "
                         f"{cache.shape[2]}: ask for fewer tokens")


def _masked_ce(logits, targets, mask):
    """Cross-entropy over the positions `mask` keeps, their mean."""
    nll = -torch.gather(torch.log_softmax(logits.float(), dim=-1), -1, targets[..., None])[..., 0]
    return torch.sum(nll * mask) / torch.clamp(torch.sum(mask), min=1.0)


class XttsNet(nn.Module):
    """The inference modules of XTTS-v2; attribute names are the Coqui
    state-dict prefixes (`gpt.*`, `hifigan_decoder.waveform_decoder.*`,
    `hifigan_decoder.speaker_encoder.*`), and `speaker_proj` the port's and
    JAX's speaker projection, which a net with Coqui's speaker encoder
    lacks."""

    def __init__(self, args: XttsArgs, ref_speaker_encoder: bool = False):
        super().__init__()
        self.args = args
        a = args
        self.gpt = XttsGPT(
            n_layer=a.gpt_layers, n_head=a.gpt_n_heads, n_embd=a.gpt_n_model_channels,
            num_text_tokens=a.gpt_number_text_tokens, num_audio_tokens=a.gpt_num_audio_tokens,
            max_text_tokens=a.gpt_max_text_tokens, max_audio_tokens=a.gpt_max_audio_tokens,
            num_cond_latents=a.num_cond_latents,
        )
        self.use_ref_speaker_encoder = ref_speaker_encoder
        if not ref_speaker_encoder:
            self.speaker_proj = nn.Linear(a.gpt_n_model_channels, a.d_vector_dim)
        rates = tuple(a.decoder_upsample_rates)
        self.hifigan_decoder = nn.ModuleDict({"waveform_decoder": HifiganGenerator(
            in_channels=a.decoder_input_dim, out_channels=1, upsample_factors=rates,
            upsample_kernel_sizes=tuple(2 * r for r in rates), upsample_initial_channel=512,
            resblock_kernel_sizes=(3, 7, 11), resblock_dilation_sizes=((1, 3, 5), (1, 3, 5), (1, 3, 5)),
            cond_channels=a.d_vector_dim, cond_in_each_up_layer=True,
        )})
        if ref_speaker_encoder:  # proj_dim 512 whatever d_vector_dim, as Coqui's HifiDecoder hard-codes it
            self.hifigan_decoder["speaker_encoder"] = ResNetSpeakerEncoder(input_dim=64, proj_dim=512,
                                                                           norm_type="frozen_batch")

    # ---------------------------------------------------------- conditioning
    def cond_latents(self, mel):
        """Reference mel `[B, C_mel, T]` → gpt cond latents `[B, n, C]`."""
        return self.gpt.conditioning_perceiver(self.gpt.conditioning_encoder(mel).transpose(1, 2))

    @torch.no_grad()
    def compute_conditioning(self, mel, spk_mel=None):
        """Reference mel `[B, C_mel, T]` → (gpt cond latents `[B, n, C]`,
        L2-normalised speaker embedding `[B, d]`): the speaker encoder's of
        `spk_mel` `[B, 64, T']` (its first 64 mel bands without one), or
        `speaker_proj` of the mean latent."""
        latents = self.cond_latents(mel)
        if self.use_ref_speaker_encoder:
            enc = self.hifigan_decoder["speaker_encoder"]
            return latents, enc(spk_mel if spk_mel is not None else mel[:, :64], l2_norm=True)
        spk = self.speaker_proj(latents.mean(dim=1))
        return latents, spk / torch.clamp(torch.linalg.vector_norm(spk, dim=-1, keepdim=True), min=1e-12)

    # -------------------------------------------------------------- training
    def train_forward(self, mel_cond, text_tokens, text_lengths, audio_codes, code_lengths) -> Dict:
        """The teacher-forced pass with Coqui's framing: the text gets the
        stop token from `text_lengths` on, then `[start] + x` inputs and
        `x + [stop]` targets; the codes past `code_lengths - 3` (the lengths
        carry Coqui's +3) become the stop audio token before the same
        framing; keys are masked over `[cond | text_in | code_in]` past each
        segment's start + l tokens; the CE masks keep positions ≤ l.
        Returns the text and mel logits, targets and masks."""
        a = self.args
        B, Tt = text_tokens.shape
        Tm = audio_codes.shape[1]
        dev = text_tokens.device
        text_lengths, code_lengths = text_lengths[:, None], code_lengths[:, None]
        text_ext = torch.where(torch.arange(Tt + 1, device=dev)[None] < text_lengths, F.pad(text_tokens, (0, 1)),
                               a.gpt_stop_text_token)
        text_in = F.pad(text_ext, (1, 0), value=a.gpt_start_text_token)
        text_tar = F.pad(text_ext, (0, 1), value=a.gpt_stop_text_token)
        code_ext = torch.where(torch.arange(Tm + 1, device=dev)[None] < code_lengths - 3, F.pad(audio_codes, (0, 1)),
                               a.gpt_stop_audio_token)
        code_in = F.pad(code_ext, (1, 0), value=a.gpt_start_audio_token)
        code_tar = F.pad(code_ext, (0, 1), value=a.gpt_stop_audio_token)
        text_keep = torch.arange(Tt + 2, device=dev)[None] <= text_lengths
        code_keep = torch.arange(Tm + 2, device=dev)[None] <= code_lengths
        attn_mask = torch.cat([torch.ones(B, a.num_cond_latents, dtype=torch.bool, device=dev), text_keep, code_keep],
                              dim=1)
        out = self.gpt(self.cond_latents(mel_cond), text_in, code_in, attn_mask=attn_mask)
        return {"text_logits": out["text_logits"], "mel_logits": out["mel_logits"], "text_targets": text_tar,
                "mel_targets": code_tar, "text_mask": text_keep.float(), "mel_mask": code_keep.float()}

    # ------------------------------------------------------------- inference
    def _step(self, cache, prompt_len: int, code, stopped, generator, i: int, temperature: float, top_k: int,
              key_valid=None, audio_start=None):
        pos = i if audio_start is None else i - audio_start
        logits, latent, cache = self.gpt.decode_step(code, pos, cache, prompt_len + i, key_valid=key_valid)
        nxt = sample_codes(logits, temperature, top_k, generator)
        return nxt, latent, stopped | (nxt == self.args.gpt_stop_audio_token), ~stopped

    @torch.no_grad()
    def generate_latents(self, cond_latents, text_tokens, generator: torch.Generator, max_new_tokens: int,
                         temperature: float = 0.75, top_k: int = 50, text_lengths=None):
        """Sampled autoregressive decode of `max_new_tokens` steps. Returns
        (codes `[B, T]`, latents `[B, T, C]`, valid `[B, T]`)."""
        a = self.args
        cache, prompt_len, code = self.stream_prefill(cond_latents, text_tokens, text_lengths=text_lengths)
        _check_room(cache, prompt_len + max_new_tokens)
        key_valid = None
        if text_lengths is not None:
            key_valid = self.gpt.key_valid_mask(cond_latents.shape[1], prompt_len, text_lengths, a.kv_cache_len)
        stopped = torch.zeros(text_tokens.shape[0], dtype=torch.bool, device=text_tokens.device)
        codes, latents, valid = [], [], []
        for i in range(max_new_tokens):
            code, latent, stopped, ok = self._step(cache, prompt_len, code, stopped, generator, i, temperature,
                                                   top_k, key_valid)
            codes.append(code)
            latents.append(latent)
            valid.append(ok)
        return torch.stack(codes, 1), torch.stack(latents, 1), torch.stack(valid, 1)

    @torch.no_grad()
    def stream_prefill(self, cond_latents, text_tokens, text_lengths=None, cond_lengths=None, cache_len: int = None):
        """Build the KV cache over the prompt: (cache, prompt_len, start
        codes `[B]`). `cache_len` allocates only that many cache rows (the
        pool's admission prefill: the prompt rows alone)."""
        B = text_tokens.shape[0]
        cache = self.gpt.init_cache(B, cache_len or self.args.kv_cache_len)
        cache, prompt_len, _ = self.gpt.prefill(cond_latents, text_tokens, cache, text_lengths=text_lengths,
                                                cond_lengths=cond_lengths)
        start = torch.full((B,), self.args.gpt_start_audio_token, dtype=torch.long, device=text_tokens.device)
        return cache, prompt_len, start

    @torch.no_grad()
    def stream_chunk(self, cache, prompt_len: int, code, stopped, generator: torch.Generator, i0: int,
                     chunk_len: int, temperature: float = 0.75, top_k: int = 50, text_lengths=None,
                     n_cond: int = None, cond_lengths=None, audio_start=None):
        """`chunk_len` decode steps from absolute step `i0`, the same
        per-step math as `generate_latents`. `n_cond` is the padded
        conditioning width the prefill saw, `cond_lengths` each row's real
        latent count; `audio_start` `[B]` the step at which each row joined
        the shared timeline (its audio positions count from there, its
        cache writes share the absolute index). Returns ((cache, code,
        stopped), (codes, latents, valid))."""
        a = self.args
        _check_room(cache, prompt_len + i0 + chunk_len)
        key_valid = None
        if text_lengths is not None:
            key_valid = self.gpt.key_valid_mask(a.num_cond_latents if n_cond is None else n_cond, prompt_len,
                                                text_lengths, cache.shape[2], cond_lengths=cond_lengths,
                                                audio_start=audio_start)
        codes, latents, valid = [], [], []
        for i in range(i0, i0 + chunk_len):
            code, latent, stopped, ok = self._step(cache, prompt_len, code, stopped, generator, i, temperature,
                                                   top_k, key_valid, audio_start)
            codes.append(code)
            latents.append(latent)
            valid.append(ok)
        return (cache, code, stopped), (torch.stack(codes, 1), torch.stack(latents, 1), torch.stack(valid, 1))

    @torch.no_grad()
    def decode_latents(self, latents, spk_embedding):
        """GPT latents `[B, T, C]` → waveform `[B, T_wav]` through the HiFi-GAN
        decoder, after the two linear interpolations of Coqui's HifiDecoder."""
        a = self.args
        x = linear_interp(latents.transpose(1, 2), a.gpt_code_stride / a.output_hop_length)
        if a.output_sample_rate != a.input_sample_rate:
            x = linear_interp(x, a.output_sample_rate / a.input_sample_rate)
        return self.hifigan_decoder["waveform_decoder"](x, g=spk_embedding[:, :, None])[:, 0]


class Xtts(BaseTTSModel):
    # serving text-length grid: prompts are right-padded to a multiple of
    # this and the pad rows are key-masked
    TEXT_BUCKET = 32

    def __init__(self, config, ap=None, tokenizer=None, device=None):
        super().__init__(config, ap, tokenizer, device)
        args = config.model_args
        if isinstance(args, dict):
            args = XttsArgs.from_dict(args)
            config.model_args = args
        self.args = args
        if isinstance(tokenizer, VoiceBpeTokenizer):
            self.bpe = tokenizer
        else:
            # a `vocab.json` of the model directory is read if there is one
            vocab = config.model_dir and os.path.join(str(config.model_dir), "vocab.json")
            self.bpe = VoiceBpeTokenizer(args.tokenizer_file or (vocab if vocab and os.path.exists(vocab) else None))
        if self.bpe.is_loaded:  # the [START]/[STOP] framing ids of the vocab
            for attr, token in (("gpt_start_text_token", "[START]"), ("gpt_stop_text_token", "[STOP]")):
                tid = self.bpe.tokenizer.token_to_id(token)
                if tid is not None:
                    setattr(self.args, attr, int(tid))
        self.net = XttsNet(self.args).to(self.device).eval()
        self._speakers = None  # lazy speakers_xtts.pth (name → cloning latents)
        self.dvae = None  # fine-tuning's code tokenizer (`load_dvae`)
        self.mel_norms = None

    @property
    def output_sample_rate(self) -> int:
        return int(self.args.output_sample_rate)

    def _float(self, x) -> torch.Tensor:
        x = x if isinstance(x, torch.Tensor) else torch.as_tensor(np.asarray(x, dtype=np.float32))
        return x.to(device=self.device, dtype=torch.float32)

    def load_checkpoint(self, config, checkpoint_path: str, eval: bool = True, strict: bool = True):
        """A `.pth` of the port's `state_dict` or a Coqui XTTS-v2 checkpoint
        (`models/xtts_convert.py`); one that carries Coqui's speaker encoder
        rebuilds the net without `speaker_proj`. Without a `model_dir` in the
        config, the checkpoint's directory is the model directory (its
        `speakers_xtts.pth`)."""
        from tpu_tts_torch.models.xtts_convert import load_xtts_checkpoint

        if not getattr(self.config, "model_dir", None):
            self.config.model_dir = os.path.dirname(os.path.abspath(checkpoint_path))
            self._speakers = None
        ckpt = load_xtts_checkpoint(self, checkpoint_path, strict=strict)
        if eval:
            self.net.eval()
        return ckpt

    # ----------------------------------------------------------- fine-tuning
    def load_dvae(self, checkpoint_path: str = "", mel_norms_path: str = ""):
        """The frozen DVAE that turns the target wavs into codes: a released
        `dvae.pth` when a path is given (here or `dvae_checkpoint`), else
        drawn from seed 0 (flax's initialisers: LeCun-normal kernels, zero
        biases, a N(0, 1) codebook); and the per-bin `mel_stats.pth`
        divisors when that file exists."""
        from tpu_tts_torch.layers.xtts.dvae import DiscreteVAE, load_dvae_state
        from tpu_tts_torch.utils.checkpoint import read_checkpoint

        with torch.random.fork_rng(devices=[]):
            torch.manual_seed(0)
            dvae = DiscreteVAE(num_tokens=self.args.gpt_num_audio_tokens - 2)
            with torch.no_grad():
                for m in dvae.modules():
                    if isinstance(m, nn.Conv1d):
                        m.weight.normal_(0.0, (m.weight.shape[1] * m.weight.shape[2]) ** -0.5)
                        m.bias.zero_()
        path = checkpoint_path or self.args.dvae_checkpoint
        if path:
            load_dvae_state(dvae, read_checkpoint(path))
        self.dvae = dvae.to(self.device).eval().requires_grad_(False)
        self.mel_norms = None
        mp = mel_norms_path or self.args.mel_norm_file
        if mp and os.path.exists(str(mp)):
            self.mel_norms = self._float(torch.load(mp, map_location="cpu", weights_only=True))

    def _style_mel(self, wav):
        """The conditioning mel `[B, 80, T / 256 + 1]`: fft 2048, hop 256, win 1024, fmax 8000."""
        return torchaudio_mel(wav, fft_size=2048, hop_length=256, win_length=1024,
                              sample_rate=self.args.input_sample_rate, num_mels=80, fmin=0.0, fmax=8000.0,
                              mel_norms=self.mel_norms)

    def _dvae_mel(self, wav):
        """The DVAE's mel: fft 1024, hop 256, win 1024, fmax 8000."""
        return torchaudio_mel(wav, fft_size=1024, hop_length=256, win_length=1024,
                              sample_rate=self.args.dvae_sample_rate, num_mels=80, fmin=0.0, fmax=8000.0,
                              mel_norms=self.mel_norms)

    def targets(self, batch: Dict):
        """(conditioning mel, codes, code lengths with Coqui's +3) of a batch:
        ready-made (`cond_mel`, `audio_codes`, `code_lengths`), or from the
        raw wavs through the mels and the frozen DVAE."""
        if "audio_codes" in batch:
            codes = batch["audio_codes"]
            code_lengths = batch.get("code_lengths")
            if code_lengths is None:
                code_lengths = torch.full(codes.shape[:1], codes.shape[1] + 3, dtype=torch.long, device=codes.device)
            return batch["cond_mel"], codes, code_lengths
        if self.dvae is None:
            raise RuntimeError("call load_dvae() before fine-tuning from raw wavs")
        with torch.no_grad():
            cond_mel = self._style_mel(batch["cond_wav"])
            codes = self.dvae.get_codebook_indices(self._dvae_mel(batch["wav"]))
        stride = self.args.gpt_code_stride
        return cond_mel, codes, (batch["wav_lengths"] + stride - 1) // stride + 3

    def loss_fn(self, batch: Dict, optimizer_idx: int = 0, generator: torch.Generator = None):
        """(loss, logs): `gpt_loss_text_ce_weight` × the text CE plus
        `gpt_loss_mel_ce_weight` × the mel-code CE, each a mean over its
        kept positions. Nothing is drawn, so `generator` is unused."""
        a = self.args
        if not 0 <= a.gpt_start_text_token < a.gpt_number_text_tokens:
            raise ValueError(f"gpt_start_text_token={a.gpt_start_text_token} is outside the text vocab "
                             f"({a.gpt_number_text_tokens}): set it (or load a vocab with [START]/[STOP]); an "
                             "out-of-range id would index past the text embedding")
        cond_mel, codes, code_lengths = self.targets(batch)
        codes = F.pad(codes, (0, 3))  # room for Coqui's +3 past the real codes
        code_lengths = torch.clamp(code_lengths, max=codes.shape[1])
        out = self.net.train_forward(cond_mel, batch["text_tokens"], batch["text_lengths"], codes, code_lengths)
        ce_t = _masked_ce(out["text_logits"], out["text_targets"], out["text_mask"])
        ce_c = _masked_ce(out["mel_logits"], out["mel_targets"], out["mel_mask"])
        loss = a.gpt_loss_text_ce_weight * ce_t + a.gpt_loss_mel_ce_weight * ce_c
        return loss, {"loss_text_ce": ce_t, "loss_mel_ce": ce_c}

    def init_training(self):
        """Nothing to build: with `mixed_precision` the trainer's generic cast
        runs the net in bfloat16 (`train/precision.py`), as `tpu_tts` does,
        while the DVAE, outside the net, stays float32 on the cast waveform."""

    def on_init_start(self, trainer):
        """Before the first step: the frozen DVAE, and the base model
        directory's `speakers_xtts.pth` and `vocab.json` copied beside the
        run's checkpoints, so the run directory serves as a model directory."""
        import shutil

        if self.dvae is None:
            self.load_dvae()
        src = getattr(self.config, "model_dir", None)
        if src and os.path.abspath(str(src)) != os.path.abspath(trainer.output_path):
            for name in ("speakers_xtts.pth", "vocab.json"):
                if os.path.exists(os.path.join(str(src), name)):
                    shutil.copy(os.path.join(str(src), name), os.path.join(trainer.output_path, name))

    def num_optimizers(self) -> int:
        return 1

    def optimizer_params(self, optimizer_idx: int = 0):
        """The trained parameters: the GPT with its conditioning encoder and
        perceiver (JAX's `optax.masked` set); the decoder and `speaker_proj`
        stay frozen."""
        return list(self.net.gpt.parameters())

    def get_optimizer(self):
        """[AdamW] at `lr` and `lr_scheduler`, betas, eps and weight decay
        from `optimizer_params` (JAX's defaults 0.9/0.96, 1e-8, 1e-2)."""
        from tpu_tts_torch.train.optimizers import get_optimizer, get_scheduler

        c = self.config
        params = dict(c.optimizer_params or {})
        params = {"betas": params.get("betas", [0.9, 0.96]), "eps": params.get("eps", 1e-8),
                  "weight_decay": params.get("weight_decay", 1e-2)}
        schedule = get_scheduler(c.lr_scheduler, c.lr_scheduler_params or {}, c.lr)
        return [get_optimizer("adamw", params, self.optimizer_params(0), c, schedule=schedule)]

    def train(self, mode: bool = True):
        self.net.train(mode)

    def training_state_dict(self) -> Dict[str, torch.Tensor]:
        return dict(self.net.state_dict())

    def load_training_state(self, state: Dict[str, torch.Tensor], strict: bool = True):
        """A port or Coqui XTTS-v2 state dict (a checkpoint's `model`)."""
        from tpu_tts_torch.models.xtts_convert import load_xtts_state

        load_xtts_state(self, state, strict=strict)

    def get_data_loader(self, config, assets, is_eval, samples, verbose=True, num_gpus=1, rank=0):
        """The fixed-shape fine-tuning loader over `samples`, tokenised by `self.bpe`."""
        from tpu_tts_torch.layers.xtts.dataset import XttsDataLoader, XttsDataset

        if num_gpus > 1:
            raise NotImplementedError("per-process data sharding comes with the data-parallel trainer (ROADMAP.md, M10)")
        a = self.args
        seed = getattr(config, "training_seed", 0)
        dataset = XttsDataset(samples=samples, tokenizer=self.bpe, sample_rate=a.input_sample_rate,
                              max_text_length=a.max_text_length, max_wav_length=a.max_wav_length,
                              min_conditioning_length=a.min_conditioning_length,
                              max_conditioning_length=a.max_conditioning_length, is_eval=is_eval, seed=seed)
        return XttsDataLoader(dataset, batch_size=config.eval_batch_size if is_eval else config.batch_size,
                              shuffle=not is_eval, drop_last=not is_eval, seed=seed,
                              num_workers=getattr(config, "num_eval_loader_workers" if is_eval else
                                                  "num_loader_workers", 0))

    # ----------------------------------------------------- bundled speakers
    def _bundled_speakers(self) -> Dict:
        """`speakers_xtts.pth` of the model directory: speaker name →
        {gpt_cond_latent, speaker_embedding}, on the model's device."""
        if self._speakers is None:
            self._speakers = {}
            model_dir = getattr(self.config, "model_dir", None)
            path = os.path.join(str(model_dir), "speakers_xtts.pth") if model_dir else None
            if path and os.path.exists(path):
                data = torch.load(path, map_location="cpu", weights_only=True)
                for name, d in data.items():
                    self._speakers[name] = {k: self._float(v) for k, v in d.items()}
        return self._speakers

    def speaker_latents(self, speaker_id: str):
        """(cond `[1, n, C]`, spk `[1, d]`) of a bundled speaker."""
        d = self._bundled_speakers()[speaker_id]
        cond = d["gpt_cond_latent"].reshape(1, -1, self.args.gpt_n_model_channels)
        return cond, d["speaker_embedding"].reshape(1, -1)

    def synthesize(self, text: str, config=None, speaker_wav=None, language: str = "en", speaker_id: str = None,
                   voice_dirs=None, **kwargs) -> Dict:
        """The Synthesizer's entry: cloning latents from a bundled
        `speaker_id` or from `speaker_wav` (file paths or arrays), then
        `inference`."""
        cfg = config or self.config
        if speaker_id and speaker_id != "random" and speaker_id in self._bundled_speakers():
            cond, spk = self.speaker_latents(speaker_id)
        elif speaker_wav is not None:
            from tpu_tts_torch.audio.numpy_transforms import load_wav

            files = speaker_wav if isinstance(speaker_wav, (list, tuple)) else [speaker_wav]
            sr = self.args.input_sample_rate
            arrs = [w if isinstance(w, np.ndarray) else load_wav(filename=w, sample_rate=sr, resample=True)
                    for w in files]
            cond, spk = self.get_conditioning_latents(np.concatenate(arrs), sr=sr)
        else:
            raise ValueError(" [!] XTTS needs `speaker_wav` (cloning audio) or a bundled `speaker_id`.")
        return self.inference(text=text, language=language, gpt_cond_latent=cond, speaker_embedding=spk,
                              temperature=kwargs.pop("temperature", getattr(cfg, "temperature", 0.75)),
                              top_k=kwargs.pop("top_k", getattr(cfg, "top_k", 50)) or 50, **kwargs)

    # ---------------------------------------------------------- conditioning
    def get_conditioning_latents(self, audio: np.ndarray, sr: int = 22050):
        """Cloning audio → (gpt_cond_latent `[1, n, C]`, speaker_embedding `[1, d]`)."""
        wav = self._float(audio).reshape(1, -1)
        mel = wav_to_mel(wav, fft_size=1024, num_mels=80, sample_rate=sr, hop_length=256, win_length=1024, fmin=0,
                         fmax=None, center=False)
        spk_mel = None
        if self.net.use_ref_speaker_encoder:
            wav16 = resize_linear(wav, int(wav.shape[1] * 16000 / sr))
            wav16 = torch.cat([wav16[:, :1], wav16[:, 1:] - 0.97 * wav16[:, :-1]], dim=1)
            spk_mel = wav_to_mel(wav16, fft_size=512, num_mels=64, sample_rate=16000, hop_length=160, win_length=400,
                                 fmin=0, fmax=None, center=True)
        return self.net.compute_conditioning(mel, spk_mel)

    # ------------------------------------------------------------- inference
    def _text_ids(self, text, language, text_tokens) -> torch.Tensor:
        if text_tokens is None:
            text_tokens = [self.bpe.encode(text, language)]
        ids = text_tokens if isinstance(text_tokens, torch.Tensor) else torch.as_tensor(np.asarray(text_tokens))
        ids = ids.to(device=self.device, dtype=torch.long)
        return ids[None] if ids.ndim == 1 else ids

    def _bucket_text(self, text_tokens: torch.Tensor):
        """Right-pad `[B, T]` ids to the bucket grid (capped at the text
        position table): (padded `[B, T_pad]`, lengths `[B]`)."""
        B, T = text_tokens.shape
        T_pad = bucket_len(T, self.TEXT_BUCKET, cap=self.args.gpt_max_text_tokens + 2)
        lengths = torch.full((B,), T, dtype=torch.long, device=text_tokens.device)
        return F.pad(text_tokens, (0, T_pad - T)), lengths

    def _n_samples(self, n_tokens: int) -> int:
        """Output samples of `n_tokens` GPT tokens through `decode_latents`:
        1024 × 24000/22050 ≈ 1114.56 a token for XTTS-v2."""
        a = self.args
        spf = (a.gpt_code_stride / a.output_hop_length * (a.output_sample_rate / a.input_sample_rate)
               * int(np.prod(a.decoder_upsample_rates)))
        return int(n_tokens * spf)

    def inference(self, text: str = None, language: str = "en", gpt_cond_latent=None, speaker_embedding=None,
                  max_new_tokens: int = 256, temperature: float = 0.75, top_k: int = 50, seed: int = 0,
                  text_tokens=None, **kwargs) -> Dict:
        """Whole-utterance synthesis: {"wav": float32 `[T]`, "gpt_codes": `[1, max_new_tokens]`}."""
        ids, lengths = self._bucket_text(self._text_ids(text, language, text_tokens))
        gen = torch.Generator(device=self.device).manual_seed(int(seed))
        codes, latents, valid = self.net.generate_latents(self._float(gpt_cond_latent), ids, gen, max_new_tokens,
                                                          temperature, top_k, lengths)
        wav = self.net.decode_latents(latents, self._float(speaker_embedding))
        n_valid = int(valid[0].sum())
        return {"wav": wav[0, : self._n_samples(n_valid)].cpu().numpy(), "gpt_codes": codes.cpu().numpy()}

    def inference_stream(self, text: str = None, language: str = "en", gpt_cond_latent=None, speaker_embedding=None,
                         stream_chunk_size: int = 20, first_chunk_size: int = 8, overlap_latents: int = 4,
                         max_new_tokens: int = 256, temperature: float = 0.75, top_k: int = 50, seed: int = 0,
                         text_tokens=None, **kwargs) -> Iterator[np.ndarray]:
        """Incremental streaming: one prefill, then a chunk of decode steps at
        a time (the first `first_chunk_size`, then `stream_chunk_size`), each
        chunk's valid latents decoded with `overlap_latents` of left context
        from the one before and yielded as float32 audio."""
        ovl = int(overlap_latents)
        if min(stream_chunk_size, first_chunk_size) < ovl:
            raise ValueError(f"stream_chunk_size ({stream_chunk_size}) and first_chunk_size ({first_chunk_size}) "
                             f"must be >= overlap_latents ({ovl}): a shorter chunk leaves less overlap context "
                             "than the next chunk's crop assumes")
        ids, lengths = self._bucket_text(self._text_ids(text, language, text_tokens))
        cond, spk = self._float(gpt_cond_latent), self._float(speaker_embedding)
        cache, prompt_len, code = self.net.stream_prefill(cond, ids, lengths)
        stopped = torch.zeros(ids.shape[0], dtype=torch.bool, device=self.device)
        gen = torch.Generator(device=self.device).manual_seed(int(seed))
        tail = None  # [B, ovl, C]: the previous chunk's last latents
        i0 = 0
        while i0 < max_new_tokens:
            first = i0 == 0
            size = min(first_chunk_size if first else stream_chunk_size, max_new_tokens)
            n_steps = min(size, max_new_tokens - i0)
            (cache, code, stopped), (_, lats, valid) = self.net.stream_chunk(
                cache, prompt_len, code, stopped, gen, i0, size, temperature, top_k, lengths, cond.shape[1])
            mask = valid & (torch.arange(size, device=self.device)[None] < n_steps)
            lats = lats * mask[:, :, None].to(lats.dtype)
            x = lats if (first or not ovl) else torch.cat([tail, lats], dim=1)
            tail = lats[:, lats.shape[1] - ovl :]
            nv = int(mask[0].sum())
            if nv > 0:
                wav = self.net.decode_latents(x, spk)
                lead = 0 if (first or not ovl) else self._n_samples(ovl)
                yield wav[0, lead : lead + self._n_samples(nv)].cpu().numpy()
            if bool(stopped.all()) or nv < n_steps:
                break
            i0 += size

    @staticmethod
    def init_from_config(config, device=None):
        return Xtts(config, device=device)
