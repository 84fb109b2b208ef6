"""XTTS weights into the port: JAX `XttsNet` params and Coqui XTTS-v2 checkpoints.

`params_from_flax(tree)` takes the JAX model's params as a nested dict of
numpy arrays and returns the tensors `XttsNet.load_state_dict` takes. It is
the inverse of `tpu_tts/models/xtts_convert.py::convert_xtts_torch_state_dict`
on the modules inference runs (a Coqui state dict → the JAX tree): Dense
kernels `[in, out]` become `nn.Linear`/1×1-conv weights `[out, in(, 1)]`,
except GPT-2's `Conv1D`, which keeps `[in, out]`; embeddings become
`.weight`; LayerNorm `scale` becomes `.weight`, GroupNorm's too; the decoder
goes through the VITS bridge's weight-norm rules. `dvae_params_from_flax`
does the same for the fine-tuning DVAE (`tpu_tts/layers/xtts/dvae.py`):
conv kernels `[k, in, out]` become `[out, in, k]`, Dense kernels 1×1 convs,
under Coqui's `dvae.pth` names.

`load_xtts_checkpoint(model, path)` loads a `.pth` of the port's state dict
or a Coqui XTTS-v2 checkpoint (`{"model": ...}` or flat; the key names are
the port's): weight-norm pairs in either form, a plain `conv_pre.weight`
or `conv_post.weight` (Coqui's HifiDecoder has no weight norm there) split
into g and v, a missing `conv_post.bias` zero-filled (Coqui has none, JAX
and the port add zero), GPT-2's attention buffers and the mel spectrogram
of Coqui's speaker encoder (`.torch_spec.`) skipped. A checkpoint with
`hifigan_decoder.speaker_encoder.*` and no `speaker_proj` rebuilds the net
with Coqui's ResNet speaker encoder in its place, whose weights and batch
norm statistics load by name (`tpu_tts/models/xtts_convert.py`:108-114).
The legacy (non-perceiver) XTTS raises.
"""

import re
from typing import Dict

import numpy as np
import torch

from tpu_tts_torch.models.vits_convert import _flatten, flax_to_state_dict
from tpu_tts_torch.utils.checkpoint import net_state_dict, read_checkpoint

_DECODER_RULES = [  # on `waveform_decoder/...` paths
    (r"^waveform_decoder/ups_(\d+)/", r"waveform_decoder/ups/\1/"),
    (r"^waveform_decoder/resblocks_(\d+)/convs([12])_(\d+)/", r"waveform_decoder/resblocks/\1/convs\2/\3/"),
    (r"^waveform_decoder/conds_(\d+)/", r"waveform_decoder/conds/\1/"),
]

_GPT_RULES = [
    (r"^gpt/h_(\d+)/attn/qkv$", r"gpt.gpt.h.\1.attn.c_attn"),
    (r"^gpt/h_(\d+)/attn/proj$", r"gpt.gpt.h.\1.attn.c_proj"),
    (r"^gpt/h_(\d+)/mlp_fc$", r"gpt.gpt.h.\1.mlp.c_fc"),
    (r"^gpt/h_(\d+)/mlp_proj$", r"gpt.gpt.h.\1.mlp.c_proj"),
    (r"^gpt/h_(\d+)/ln([12])$", r"gpt.gpt.h.\1.ln_\2"),
    (r"^gpt/ln_f$", r"gpt.gpt.ln_f"),
    (r"^gpt/final_norm$", r"gpt.final_norm"),
    (r"^gpt/text_head$", r"gpt.text_head"),
    (r"^gpt/mel_head$", r"gpt.mel_head"),
    (r"^gpt/text_embedding$", r"gpt.text_embedding"),
    (r"^gpt/audio_embedding$", r"gpt.mel_embedding"),
    (r"^gpt/text_pos_embedding$", r"gpt.text_pos_embedding.emb"),
    (r"^gpt/audio_pos_embedding$", r"gpt.mel_pos_embedding.emb"),
    (r"^conditioning_encoder/init$", r"gpt.conditioning_encoder.init"),
    (r"^conditioning_encoder/attn_(\d+)/(norm|qkv|proj_out)$", r"gpt.conditioning_encoder.attn.\1.\2"),
    (r"^conditioning_perceiver/attn_(\d+)/(to_q|to_kv|to_out)$", r"gpt.conditioning_perceiver.layers.\1.0.\2"),
    (r"^conditioning_perceiver/ff_(\d+)/fc$", r"gpt.conditioning_perceiver.layers.\1.1.0"),
    (r"^conditioning_perceiver/ff_(\d+)/proj$", r"gpt.conditioning_perceiver.layers.\1.1.2"),
    (r"^speaker_proj$", r"speaker_proj"),
]
# 1×1 convs of the conditioning encoder: Dense [in, out] → Conv1d [out, in, 1]
_CONV_1X1 = re.compile(r"^gpt\.conditioning_encoder\.(init|attn\.\d+\.(qkv|proj_out))$")
_GPT2_CONV1D = re.compile(r"^gpt\.gpt\.h\.\d+\.(attn|mlp)\.")


def params_from_flax(tree) -> Dict[str, torch.Tensor]:
    """JAX `XttsNet` params → the port's `state_dict` (the speaker_proj route)."""
    flat = _flatten(tree)
    prefix = "hifigan_decoder/"
    dec = {"waveform_decoder/" + k[len(prefix):]: v for k, v in flat.items() if k.startswith(prefix)}
    sd = {f"hifigan_decoder.{k}": v for k, v in flax_to_state_dict(
        dec, _DECODER_RULES, lambda module: re.search(r"waveform_decoder/ups_\d+$", module)).items()}
    for path, arr in flat.items():
        if path.startswith(prefix):
            continue
        if path == "conditioning_perceiver/latents":
            sd["gpt.conditioning_perceiver.latents"] = arr
            continue
        if path == "conditioning_perceiver/norm_gamma":
            sd["gpt.conditioning_perceiver.norm.gamma"] = arr
            continue
        module, leaf = path.rsplit("/", 1)
        name = None
        for pat, rep in _GPT_RULES:
            if re.match(pat, module):
                name = re.sub(pat, rep, module)
                break
        if name is None:
            raise KeyError(f"no rule maps the JAX XTTS param {path}")
        if leaf == "kernel":
            if _GPT2_CONV1D.match(name):
                w = arr  # GPT-2 Conv1D keeps [in, out]
            elif _CONV_1X1.match(name):
                w = arr.T[:, :, None]
            else:
                w = arr.T
            sd[f"{name}.weight"] = w
        elif leaf in ("scale", "embedding"):
            sd[f"{name}.weight"] = arr
        else:
            sd[f"{name}.{leaf}"] = arr
    return {k: torch.from_numpy(np.ascontiguousarray(v)) for k, v in sd.items()}


def dvae_params_from_flax(tree) -> Dict[str, torch.Tensor]:
    """JAX `DiscreteVAE` params → the port's `DiscreteVAE` state dict."""
    flat = _flatten(tree)
    n_layers = len({k.split("/")[0] for k in flat if k.startswith("enc_conv_")})
    n_res = len({k.split("/")[0] for k in flat if k.startswith("enc_res_")})
    rules = [(r"^enc_conv_(\d+)/conv$", lambda m: f"encoder.{m[1]}.0"),
             (r"^enc_res_(\d+)/c(\d)$", lambda m: f"encoder.{n_layers + int(m[1])}.net.{m[2]}"),
             (r"^enc_out$", lambda m: f"encoder.{n_layers + n_res}"),
             (r"^dec_in$", lambda m: "decoder.0"),
             (r"^dec_res_(\d+)/c(\d)$", lambda m: f"decoder.{1 + int(m[1])}.net.{m[2]}"),
             (r"^dec_up_(\d+)/conv$", lambda m: f"decoder.{1 + n_res + int(m[1])}.0.conv"),
             (r"^dec_out$", lambda m: f"decoder.{1 + n_res + n_layers}")]
    sd = {}
    for path, arr in flat.items():
        if path == "embed":
            sd["codebook.embed"] = arr
            continue
        module, leaf = path.rsplit("/", 1)
        name = next((fn(m) for pat, fn in rules for m in [re.match(pat, module)] if m), None)
        if name is None:
            raise KeyError(f"no rule maps the JAX DVAE param {path}")
        if leaf == "kernel":
            sd[f"{name}.weight"] = arr.T[:, :, None] if arr.ndim == 2 else np.transpose(arr, (2, 1, 0))
        else:
            sd[f"{name}.{leaf}"] = arr
    return {k: torch.from_numpy(np.ascontiguousarray(v)) for k, v in sd.items()}


def _split_plain_weight_norm(sd: Dict[str, torch.Tensor], wanted) -> None:
    """A plain `X.weight` where the net wants a weight-norm pair → (g, v),
    g the norm over every dim but 0, so g·v/‖v‖ is the weight."""
    for key in [k for k in sd if k.endswith(".weight")]:
        base = key[: -len(".weight")]
        if f"{base}.parametrizations.weight.original0" in wanted and f"{base}.weight_g" not in sd:
            w = sd.pop(key)
            sd[f"{base}.parametrizations.weight.original0"] = torch.sqrt(
                torch.sum(w.double() ** 2, dim=tuple(range(1, w.ndim)), keepdim=True)).to(w.dtype)
            sd[f"{base}.parametrizations.weight.original1"] = w


def load_xtts_checkpoint(model, checkpoint_path: str, strict: bool = True) -> Dict:
    """Load a port or Coqui XTTS-v2 `.pth` into `model.net` (`load_xtts_state`)."""
    ckpt = read_checkpoint(checkpoint_path)
    load_xtts_state(model, ckpt["model"] if isinstance(ckpt.get("model"), dict) else ckpt, strict=strict)
    return ckpt


def load_xtts_state(model, state: Dict, strict: bool = True) -> None:
    """Load a port or Coqui XTTS-v2 state dict into `model.net`, rebuilding
    the net with Coqui's speaker encoder in place of `speaker_proj` when the
    state dict carries it."""
    from tpu_tts_torch.models.xtts import XttsNet

    sd = {k: v for k, v in state.items() if isinstance(v, torch.Tensor)}
    if "gpt.conditioning_perceiver.latents" not in sd:
        raise NotImplementedError("this checkpoint is the legacy (non-perceiver) XTTS variant: only XTTS-v2 "
                                  "checkpoints (gpt_use_perceiver_resampler=True) are supported")
    ref_encoder = "speaker_proj.weight" not in sd and any(k.startswith("hifigan_decoder.speaker_encoder.") for k in sd)
    if ref_encoder != model.net.use_ref_speaker_encoder:
        gpt = model.net.gpt  # kept, so an optimizer over its parameters stays valid
        model.net = XttsNet(model.args, ref_speaker_encoder=ref_encoder).to(model.device)
        model.net.gpt = gpt
    net = model.net
    wanted = net.state_dict()
    _split_plain_weight_norm(sd, wanted)
    bias = "hifigan_decoder.waveform_decoder.conv_post.bias"
    if bias not in sd:
        sd[bias] = torch.zeros(wanted[bias].shape, dtype=wanted[bias].dtype)
    net.load_state_dict(net_state_dict(sd, net), strict=strict)
