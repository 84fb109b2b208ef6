"""JAX VITS params → the port's `state_dict`.

`params_from_flax(tree)` takes the `generator` tree of the JAX model as a
nested dict of numpy arrays and returns the tensors `VitsNet.load_state_dict`
takes; `training_params_from_flax({"generator", "discriminator"})` returns
those of `Vits.load_training_state`, the discriminator under `disc.*`. It is
the inverse of the JAX package's `convert_vits_torch_state_dict`
(tpu_tts/models/vits_convert.py:195):

- flax path names → Coqui state-dict names (rules below);
- Dense `[in, out]` → 1×1 conv `[out, in, 1]`; conv `[k, in, out]` → `[out, in, k]`;
- weight-norm `(v, g)` (g per output channel) → the folded kernel, laid out
  for torch and split again into torch's `(original0 = g, original1 = v)`
  with g per dim-0 slice. For a transposed conv dim 0 is the input channel
  and the kernel is flipped in time (flax's fractionally strided conv
  correlates with the reversed kernel);
- the SDP's ElementwiseAffine `[C]` → `[C, 1]`;
- embeddings (`emb_g`, `emb_l`, the text encoder's) → `.weight`.

The speaker and language modules need no rule of their own: the
embeddings, every `cond`/`cond_lang` Dense, the WN `cond_layer` and the
decoder's `cond_layer` keep their flax names. ResBlock2's `convs_{j}` and the
deterministic duration predictor's `conv_{n}/conv` are renamed below. The
posterior encoder (`pre`, a WN `enc`, `proj`) takes the rules of the flow's.
The discriminator's `disc_s` and `disc_p{p}` become `nets.0` and
`nets.{1 + index of p}`; their 2-D kernels `[kh, kw, in, out]` become
`[out, in, kh, kw]`, each weight-normalised over all but its output axis.
"""

import re
from typing import Dict

import numpy as np
import torch

_RULES = [
    (r"^text_encoder/encoder/attn_(\d+)/", r"text_encoder/encoder/attn_layers/\1/"),
    (r"^text_encoder/encoder/norm([12])_(\d+)/", r"text_encoder/encoder/norm_layers_\1/\2/"),
    (r"^text_encoder/encoder/ffn_(\d+)/conv_([12])/conv/", r"text_encoder/encoder/ffn_layers/\1/conv_\2/"),
    (r"^flow/coupling_(\d+)/", r"flow/flows/\1/"),
    (r"/enc/in_(\d+)/", r"/enc/in_layers/\1/"),
    (r"/enc/res_skip_(\d+)/", r"/enc/res_skip_layers/\1/"),
    (r"/enc/cond/", r"/enc/cond_layer/"),
    (r"^duration_predictor/(post_)?flows_(\d+)/", r"duration_predictor/\1flows/\2/"),
    (r"convs/sep_(\d+)/", r"convs/convs_sep/\1/"),
    (r"convs/conv1x1_(\d+)/", r"convs/convs_1x1/\1/"),
    (r"convs/norm([12])_(\d+)/", r"convs/norms_\1/\2/"),
    (r"^waveform_decoder/ups_(\d+)/", r"waveform_decoder/ups/\1/"),
    (r"^waveform_decoder/resblocks_(\d+)/convs([12])_(\d+)/", r"waveform_decoder/resblocks/\1/convs\2/\3/"),
    (r"^waveform_decoder/resblocks_(\d+)/convs_(\d+)/", r"waveform_decoder/resblocks/\1/convs/\2/"),
    (r"^duration_predictor/conv_([12])/conv/", r"duration_predictor/conv_\1/"),
]


def _flatten(tree, prefix="") -> Dict[str, np.ndarray]:
    out = {}
    for k, v in tree.items():
        path = f"{prefix}/{k}" if prefix else str(k)
        if isinstance(v, dict) or hasattr(v, "items"):
            out.update(_flatten(v, path))
        else:
            out[path] = np.asarray(v, dtype=np.float32)
    return out


def _rename(module: str, rules) -> str:
    path = module + "/"
    for pat, rep in rules:
        path = re.sub(pat, rep, path)
    return path.rstrip("/").replace("/", ".")


def _wn_split(w: np.ndarray):
    g = np.sqrt(np.sum(w.astype(np.float64) ** 2, axis=tuple(range(1, w.ndim)), keepdims=True)).astype(np.float32)
    return g, w


def flax_to_state_dict(flat: Dict[str, np.ndarray], rules, is_transposed_conv=lambda module: False
                       ) -> Dict[str, np.ndarray]:
    """Flattened flax params (`module/path/leaf` → array) → torch state-dict
    entries: module paths renamed by `rules` (regex, replacement) in order,
    leaves laid out for torch as the module docstring says. Shared by the
    VITS and Glow-TTS bridges."""
    sd: Dict[str, np.ndarray] = {}
    for path, arr in flat.items():
        module, leaf = path.rsplit("/", 1)
        name = _rename(module, rules)
        if leaf == "g":
            continue  # handled with its `v`
        if leaf == "v":
            g = flat[f"{module}/g"]
            norm = np.sqrt(np.sum(arr.astype(np.float64) ** 2, axis=(0, 1), keepdims=True) + 1e-12)
            kernel = (arr / norm * g[None, None, :]).astype(np.float32)  # flax [k, in, out]
            if is_transposed_conv(module):
                w = np.transpose(kernel[::-1], (1, 2, 0))  # torch ConvTranspose1d [in, out, k]
            else:
                w = np.transpose(kernel, (2, 1, 0))  # torch Conv1d [out, in, k]
            g_t, v_t = _wn_split(np.ascontiguousarray(w))
            sd[f"{name}.parametrizations.weight.original0"] = g_t
            sd[f"{name}.parametrizations.weight.original1"] = v_t
        elif leaf == "kernel":
            w = arr.T[:, :, None] if arr.ndim == 2 else np.transpose(arr, (2, 1, 0))
            sd[f"{name}.weight"] = w
        elif leaf in ("translation", "log_scale"):
            sd[f"{name}.{leaf}"] = arr.reshape(-1, 1)
        elif leaf == "embedding":
            sd[f"{name}.weight"] = arr
        else:
            sd[f"{name}.{leaf}"] = arr
    return sd


def params_from_flax(tree) -> Dict[str, torch.Tensor]:
    """JAX `VitsNet` params (the `generator` tree) → the port's `state_dict`
    (with `posterior_encoder.*` when the tree holds it)."""
    sd = flax_to_state_dict(_flatten(tree), _RULES, lambda module: re.search(r"waveform_decoder/ups_\d+$", module))
    return {k: torch.from_numpy(np.ascontiguousarray(v)) for k, v in sd.items()}


def disc_params_from_flax(tree, periods) -> Dict[str, torch.Tensor]:
    """JAX `VitsDiscriminator` params → the port's `VitsDiscriminator`
    `state_dict`, for its `periods` in order."""
    nets = {"disc_s": "nets.0", **{f"disc_p{p}": f"nets.{i + 1}" for i, p in enumerate(periods)}}

    def name_of(module: str) -> str:
        net, conv = module.split("/")
        return f"{nets[net]}.{conv.replace('convs_', 'convs.')}"

    return norm_convs_from_flax(_flatten(tree), name_of)


def norm_convs_from_flax(flat: Dict[str, np.ndarray], name_of) -> Dict[str, torch.Tensor]:
    """Flattened flax `NormConv` params (a discriminator's) → torch
    state-dict entries under `name_of(module path)`: weight norm as
    `(original0, original1)`, spectral norm as the raw `weight`."""
    sd = {}
    for path, arr in flat.items():
        module, leaf = path.rsplit("/", 1)
        name = name_of(module)
        if leaf == "bias":
            sd[f"{name}.bias"] = arr
        elif leaf == "v":
            axes = tuple(range(arr.ndim - 1))
            perm = (arr.ndim - 1, arr.ndim - 2) + tuple(range(arr.ndim - 2))  # [..k.., in, out] → [out, in, ..k..]
            g = flat.get(f"{module}/g")
            if g is None:  # spectral norm: the raw kernel
                sd[f"{name}.weight"] = np.ascontiguousarray(np.transpose(arr, perm))
                continue
            norm = np.sqrt(np.sum(arr.astype(np.float64) ** 2, axis=axes, keepdims=True) + 1e-12)
            w = np.ascontiguousarray(np.transpose((arr / norm * g).astype(np.float32), perm))
            g_t, v_t = _wn_split(w)
            sd[f"{name}.parametrizations.weight.original0"] = g_t
            sd[f"{name}.parametrizations.weight.original1"] = v_t
    return {k: torch.from_numpy(np.ascontiguousarray(v)) for k, v in sd.items()}


def training_params_from_flax(params, periods) -> Dict[str, torch.Tensor]:
    """JAX `{"generator", "discriminator"}` → `Vits.load_training_state`'s dict."""
    sd = params_from_flax(params["generator"])
    sd.update({f"disc.{k}": v for k, v in disc_params_from_flax(params["discriminator"], periods).items()})
    return sd
