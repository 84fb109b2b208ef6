"""ForwardTTS weights → the port's `state_dict`: from a `tpu_tts` param tree
or from a Coqui checkpoint.

`params_from_flax(tree, batch_stats)` takes the `ForwardTTSNet` param tree
of the JAX model (and, with `norm_type="batch"`, its `batch_stats`) as
nested dicts of arrays and returns what `ForwardTTSNet.load_state_dict`
takes. The port's modules carry the flax names, so the paths change `/` to
`.` and the leaves take torch's layout (`vits_convert.flax_to_state_dict`):

- Dense `[in, out]` → a 1×1 conv `[out, in, 1]`, but `[out, in]` inside a
  `FlaxConv1d` (`…/conv`, an `nn.Linear` at kernel size 1); conv `[k, in,
  out]` → `[out, in, k]`; weight norm `(v, g)` → `parametrizations`;
- flax's attention kernels `query`/`key`/`value` `[C, H, D]` → `[H·D, C]`,
  `out` `[H, D, C]` → `[C, H·D]`, biases flattened;
- LayerNorm and BatchNorm `scale` → `weight` (the positional encoding's
  `scale` keeps its name), `mean`/`var` (of `frozen_batch` params or of
  `batch_stats`) → `running_mean`/`running_var`, with a zero
  `num_batches_tracked`;
- the WN decoder's `in_{i}`/`res_skip_{i}`, the relative-position coder's
  `attn_{i}`/`norm{1,2}_{i}`/`ffn_{i}` and the predictors' `conv_{n}/conv`
  take the Glow-TTS bridge's renames.

`coqui_state_dict(sd)` is its inverse: the port's state dict under Coqui's
names and layouts (the packed `in_proj_*`, 1×1 aligner convs `[out, in,
1]`), as a Coqui `ForwardTTS` would save it.

`state_dict_from_coqui(sd, target)` is the port's reading of a Coqui
`ForwardTTS` state dict, the counterpart of `tpu_tts`'s
`convert_forward_tts_torch_state_dict` (`tpu_tts/models/forward_convert.py`
:58) with `map_speedy_speech`:138, for the FFT and residual-conv coders:
torch's packed `in_proj_*` splits into `query`/`key`/`value` (the same
per-head layout), the FFT decoder's `postnet` and SpeedySpeech's last
`postnet.1` are the model's `proj`, the aligner's `Sequential` convs
become `key_conv{1,2}`/`query_conv{1,2,3}`. `target` (the net's
`state_dict`) gives each tensor's shape (singleton axes only differ) and
the entries a Coqui file may lack: `pos_encoder.scale` (read when present;
`tpu_tts` keeps its init value) and `num_batches_tracked`.
"""

import re
from typing import Dict

import numpy as np
import torch

from tpu_tts_torch.models.vits_convert import _flatten, flax_to_state_dict

_RULES = [
    (r"(^|/)wn/in_(\d+)/", r"\1wn/in_layers/\2/"),
    (r"(^|/)wn/res_skip_(\d+)/", r"\1wn/res_skip_layers/\2/"),
    (r"^(encoder|decoder)/attn_(\d+)/", r"\1/attn_layers/\2/"),
    (r"^(encoder|decoder)/norm([12])_(\d+)/", r"\1/norm_layers_\2/\3/"),
    (r"^(encoder|decoder)/ffn_(\d+)/conv_([12])/conv/", r"\1/ffn_layers/\2/conv_\3/"),
    (r"^(duration|pitch|energy)_predictor/conv_([12])/conv/", r"\1_predictor/conv_\2/"),
]
_ATTN = re.compile(r"^(.*/self_attn)/(query|key|value|out)/(kernel|bias)$")


def _norm_leaves(sd: Dict[str, np.ndarray]) -> Dict[str, np.ndarray]:
    out = {}
    for k, v in sd.items():
        if k.endswith(".scale") and not k.endswith("pos_encoder.scale"):
            k = k[: -len("scale")] + "weight"
        elif k.endswith(".mean") or k.endswith(".var"):
            k = k.rsplit(".", 1)[0] + (".running_mean" if k.endswith(".mean") else ".running_var")
            out[k.rsplit(".", 1)[0] + ".num_batches_tracked"] = np.zeros((), np.int64)
        out[k] = v
    return out


def params_from_flax(tree, batch_stats=None) -> Dict[str, torch.Tensor]:
    """JAX `ForwardTTSNet` params (+ `batch_stats`) → the port's `state_dict`."""
    flat = _flatten(tree)
    sd: Dict[str, np.ndarray] = {}
    for path in [p for p in flat if _ATTN.match(p)]:
        module, proj, leaf = _ATTN.match(path).groups()
        arr = flat.pop(path)
        name = f"{module.replace('/', '.')}.{proj}.{'weight' if leaf == 'kernel' else 'bias'}"
        if leaf == "bias":
            sd[name] = arr.reshape(-1)
        elif proj == "out":
            sd[name] = arr.reshape(-1, arr.shape[-1]).T
        else:
            sd[name] = arr.reshape(arr.shape[0], -1).T
    sd.update({p: flat.pop(p) for p in [p for p in flat if "/" not in p]})  # the leaves of a root module
    linear = {path.rsplit("/", 1)[0] for path, arr in flat.items()
              if path.endswith("/conv/kernel") and arr.ndim == 2}
    for k, v in flax_to_state_dict(flat, _RULES).items():
        module = k.rsplit(".", 1)[0].replace(".", "/")
        sd[k] = v[:, :, 0] if module in linear and k.endswith(".weight") else v
    if batch_stats:
        sd.update(flax_to_state_dict(_flatten(batch_stats), _RULES))
    return {k: torch.from_numpy(np.ascontiguousarray(v)) for k, v in _norm_leaves(sd).items()}


# ------------------------------------------------------------------ Coqui checkpoints
_COQUI_RULES = [
    (r"^encoder\.encoder\.fft_layers\.(\d+)\.", r"encoder.fft_\1."),
    (r"^decoder\.decoder\.transformer_block\.fft_layers\.(\d+)\.", r"decoder.fft_\1."),
    (r"\.self_attn\.out_proj\.", r".self_attn.out."),
    (r"\.(fft_\d+)\.conv([12])\.", r".\1.conv\2.conv."),
    (r"^decoder\.decoder\.postnet\.(weight|bias)$", r"proj.\1"),
    (r"^(pitch|energy)_emb\.(weight|bias)$", r"\1_emb.conv.\2"),
    (r"^encoder\.encoder\.prenet\.0\.", r"encoder.prenet."),
    (r"^encoder\.encoder\.postnet\.0\.", r"encoder.postnet_0."),
    (r"^encoder\.encoder\.postnet\.2\.", r"encoder.postnet_norm."),
    (r"^encoder\.encoder\.postnet\.3\.", r"encoder.postnet_1."),
    (r"^(encoder|decoder)\.\1\.res_conv_block\.res_blocks\.(\d+)\.conv_bn_blocks\.(\d+)\.",
     r"\1.res_conv_block.res_block_\2.conv_bn_\3."),
    (r"^decoder\.decoder\.post_conv\.", r"decoder.post_conv."),
    (r"^decoder\.decoder\.postnet\.0\.conv_bn_blocks\.(\d+)\.", r"decoder.postnet_block.conv_bn_\1."),
    (r"^decoder\.decoder\.postnet\.1\.", r"proj."),
]


def is_coqui_state_dict(sd: Dict) -> bool:
    """Whether a checkpoint's keys are Coqui's ForwardTTS names."""
    return any(isinstance(k, str) and k.startswith(("encoder.encoder.", "decoder.decoder.", "aligner.key_layer."))
               for k in sd)


def state_dict_from_coqui(sd: Dict, target: Dict[str, torch.Tensor]) -> Dict[str, torch.Tensor]:
    """A Coqui `ForwardTTS` state dict → the port's names and shapes."""
    out: Dict[str, torch.Tensor] = {}
    for prefix in ("key", "query"):  # the aligner's Sequential keeps its convs at even indices
        idx = sorted({int(m.group(1)) for k in sd if (m := re.match(rf"aligner\.{prefix}_layer\.(\d+)\.weight$", k))})
        for j, i in enumerate(idx):
            for leaf in ("weight", "bias"):
                out[f"aligner.{prefix}_conv{j + 1}.conv.{leaf}"] = sd[f"aligner.{prefix}_layer.{i}.{leaf}"]
    for k, v in sd.items():
        if not isinstance(v, torch.Tensor) or k.startswith("aligner.") or k == "pos_encoder.pe":
            continue
        for pat, rep in _COQUI_RULES:
            k = re.sub(pat, rep, k)
        m = re.match(r"^(.*\.self_attn)\.in_proj_(weight|bias)$", k)
        if m:
            for name, part in zip(("query", "key", "value"), v.chunk(3, dim=0)):
                out[f"{m.group(1)}.{name}.{m.group(2)}"] = part
            continue
        out[k] = v
    for k, v in target.items():
        if k not in out and (k == "pos_encoder.scale" or k.endswith("num_batches_tracked")):
            out[k] = v.detach().cpu()
    return {k: v.reshape(target[k].shape) if k in target and v.numel() == target[k].numel() else v
            for k, v in out.items()}


_TO_COQUI = [
    (r"^encoder\.fft_(\d+)\.", r"encoder.encoder.fft_layers.\1."),
    (r"^decoder\.fft_(\d+)\.", r"decoder.decoder.transformer_block.fft_layers.\1."),
    (r"\.self_attn\.out\.", ".self_attn.out_proj."),
    (r"\.conv([12])\.conv\.", r".conv\1."),
    (r"^(pitch|energy)_emb\.conv\.", r"\1_emb."),
    (r"^aligner\.(key|query)_conv(\d)\.conv\.", lambda m: f"aligner.{m.group(1)}_layer.{2 * int(m.group(2)) - 2}."),
    (r"^encoder\.prenet\.", "encoder.encoder.prenet.0."),
    (r"^encoder\.postnet_0\.", "encoder.encoder.postnet.0."),
    (r"^encoder\.postnet_norm\.", "encoder.encoder.postnet.2."),
    (r"^encoder\.postnet_1\.", "encoder.encoder.postnet.3."),
    (r"^(encoder|decoder)\.res_conv_block\.res_block_(\d+)\.conv_bn_(\d+)\.",
     r"\1.\1.res_conv_block.res_blocks.\2.conv_bn_blocks.\3."),
    (r"^decoder\.post_conv\.", "decoder.decoder.post_conv."),
    (r"^decoder\.postnet_block\.conv_bn_(\d+)\.", r"decoder.decoder.postnet.0.conv_bn_blocks.\1."),
]


def coqui_state_dict(sd: Dict[str, torch.Tensor]) -> Dict[str, torch.Tensor]:
    """The port's ForwardTTS state dict (FFT or residual-conv coders) under
    Coqui's names and layouts."""
    speedy = any(".res_conv_block." in k for k in sd)
    out: Dict[str, torch.Tensor] = {}
    for k, v in sd.items():
        for pat, rep in _TO_COQUI:
            k = re.sub(pat, rep, k)
        if k.startswith("proj."):
            k = ("decoder.decoder.postnet.1." if speedy else "decoder.decoder.postnet.") + k[len("proj."):]
        out[k] = v[:, :, None] if k.startswith("aligner.") and v.ndim == 2 else v
    for k in [k for k in out if ".self_attn.query." in k]:
        base, leaf = k.split(".self_attn.query.")
        out[f"{base}.self_attn.in_proj_{leaf}"] = torch.cat(
            [out.pop(f"{base}.self_attn.{n}.{leaf}") for n in ("query", "key", "value")])
    return out
