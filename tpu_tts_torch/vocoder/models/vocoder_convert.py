"""GAN vocoder weights into the port: Coqui `.pth` state dicts and the JAX package's trees.

Counterpart of `tpu_tts/vocoder/models/vocoder_convert.py`
(`convert_gan_torch_state_dict`:119, with `convert_hifigan_discriminator_
state_dict`:53, `map_melgan_generator`:79 and `map_univnet_generator`:223).
The port's modules carry Coqui's names (`model_g.*`, `model_d.*`), so
`coqui_gan_state_dict` only reconciles layouts:

- a generator-only checkpoint (a released inference model) has no
  `model_g.` prefix; its discriminator stays as the model built it;
- old-style weight norm `X.weight_g`/`X.weight_v` →
  `X.parametrizations.weight.original0/1`;
- a plain `X.weight` where the port has weight norm (Coqui's
  `conv_pre_weight_norm=False`, or weight norm removed) → g = the norm of
  each dim-0 slice, v = the weight;
- spectral norm (`X.parametrizations.weight.original` or `X.weight_orig`) →
  the raw `X.weight` the port's stateless spectral norm reads; the power
  iteration's `u`/`v` vectors are dropped;
- a `conv_post.bias` the port has and the file lacks is zero, as the JAX
  converter fills it.

`GAN.load_state` loads the discriminator only from a file that holds every
tensor of the port's: a Coqui HiFi-GAN's, or the port's own checkpoints.
As in the JAX converter, a Coqui MelGAN-family or UnivNet discriminator is
not converted (Coqui's MelGAN discriminator pads by reflection where the
flax one pads by zeros, and names its layers otherwise); the model keeps
its own.

`gan_state_dict_from_flax` is the other bridge: `tpu_tts`'s
`{"generator", "discriminator"}` tree (numpy leaves) → the port's state
dict, for the tests that hold the port to `tpu_tts` on the same weights.
"""

import re
from typing import Dict, Optional, Set

import numpy as np
import torch

from tpu_tts_torch.models.vits_convert import _flatten, flax_to_state_dict, norm_convs_from_flax
from tpu_tts_torch.utils.checkpoint import rename_old_weight_norm

_PERIODS = (2, 3, 5, 7, 11)
_SPECTRAL = ((re.compile(r"\.parametrizations\.weight\.original$"), ".weight"),
             (re.compile(r"\.weight_orig$"), ".weight"))
_DROP = re.compile(r"(\.parametrizations\.weight\.\d+\._[uv]|\.weight_u)$")


def family(generator_model: str) -> str:
    """`hifigan`, `melgan` (full-band and multi-band too) or `univnet`."""
    base = generator_model.lower().replace("_generator", "")
    return "melgan" if base in ("fullband_melgan", "multiband_melgan") else base


def _rename(key: str) -> str:
    key = rename_old_weight_norm(key)
    for pat, rep in _SPECTRAL:
        key = pat.sub(rep, key)
    return key


def coqui_gan_state_dict(state_dict: Dict[str, torch.Tensor], wanted: Set[str]) -> Dict[str, torch.Tensor]:
    """A Coqui GAN vocoder state dict → the entries of the port's GAN net
    (keys in `wanted`) it provides, under the port's names."""
    out: Dict[str, torch.Tensor] = {}
    for key, value in state_dict.items():
        if not isinstance(value, torch.Tensor) or _DROP.search(key):
            continue
        if key.endswith(".weight_v") and key[: -len("_v")] + "_orig" in state_dict:
            continue  # old-style spectral norm's v vector, not weight norm's v
        if not key.startswith(("model_g.", "model_d.")):
            key = "model_g." + key  # a generator-only checkpoint
        out[_rename(key)] = value
    for key in list(out):
        base = key[: -len(".weight")] if key.endswith(".weight") else None
        if base is not None and key not in wanted and f"{base}.parametrizations.weight.original0" in wanted:
            w = out.pop(key)
            g = torch.sqrt(torch.sum(w.double() ** 2, dim=tuple(range(1, w.dim())), keepdim=True)).to(w.dtype)
            out[f"{base}.parametrizations.weight.original0"] = g
            out[f"{base}.parametrizations.weight.original1"] = w
    for key in wanted:
        if key.endswith("conv_post.bias") and key not in out and key.startswith("model_g."):
            ref = out.get(key.replace(".bias", ".parametrizations.weight.original0"))
            if ref is not None:
                out[key] = torch.zeros(ref.shape[0], dtype=ref.dtype)
    return out


# ------------------------------------------------------------ flax → port

_HIFIGAN_G = [
    (r"^ups_(\d+)/", r"ups/\1/"),
    (r"^resblocks_(\d+)/convs([12])_(\d+)/", r"resblocks/\1/convs\2/\3/"),
    (r"^resblocks_(\d+)/convs_(\d+)/", r"resblocks/\1/convs/\2/"),
]
_UNIVNET_RES = {("0", "1"): 1, ("0", "2"): 3, ("1", "1"): 6, ("1", "2"): 8, ("2", "1"): 11, ("2", "2"): 13}


def _melgan_rules(n_stages: int):
    return [
        (r"^conv_pre/", "layers/1/"),
        (r"^up_(\d+)/", lambda m: f"layers/{3 + 3 * int(m.group(1))}/"),
        (r"^resstack_(\d+)/block_(\d+)_conv([12])/",
         lambda m: f"layers/{4 + 3 * int(m.group(1))}/blocks/{m.group(2)}/{2 if m.group(3) == '1' else 4}/"),
        (r"^resstack_(\d+)/shortcut_(\d+)/", lambda m: f"layers/{4 + 3 * int(m.group(1))}/shortcuts/{m.group(2)}/"),
        (r"^conv_post/", f"layers/{3 * n_stages + 4}/"),
    ]


_UNIVNET_G = [
    (r"^conv_pre/", "first_conv/"),
    (r"^conv_post/", "last_conv_layers/0/"),
    (r"^lvc_(\d+)/convt_pre/", r"lvc_blocks/\1/upsample/"),
    (r"^lvc_(\d+)/conv_(\d+)/", r"lvc_blocks/\1/convs/\2/"),
    (r"^lvc_(\d+)/kernel_predictor/input_conv/", r"lvc_blocks/\1/kernel_predictor/input_conv/0/"),
    (r"^lvc_(\d+)/kernel_predictor/res(\d)_conv(\d)/",
     lambda m: f"lvc_blocks/{m.group(1)}/kernel_predictor/residual_conv/{_UNIVNET_RES[m.group(2), m.group(3)]}/"),
    (r"^lvc_(\d+)/kernel_predictor/", r"lvc_blocks/\1/kernel_predictor/"),
]


def _disc_name(fam: str, module: str) -> str:
    parts = module.split("/")
    if parts[0] == "mpd":  # hifigan and univnet: mpd/disc_p{p}/conv
        net = f"mpd.discriminators.{_PERIODS.index(int(parts[1][len('disc_p'):]))}"
    elif parts[0] == "msd":
        net = f"msd.discriminators.{int(parts[1][len('disc_s'):])}"
    elif fam == "melgan":  # disc_{i}/conv
        net = f"discriminators.{int(parts[0][len('disc_'):])}"
    else:  # univnet: spec_{i}/conv
        net = f"spec.{int(parts[0][len('spec_'):])}"
    conv = parts[-1]
    conv = re.sub(r"^(convs|down|conv)_(\d+)$", lambda m: f"{'down' if m.group(1) == 'down' else 'convs'}.{m.group(2)}",
                  conv)
    return f"{net}.{conv}"


def gan_state_dict_from_flax(params, generator_model: str, n_stages: Optional[int] = None
                             ) -> Dict[str, torch.Tensor]:
    """`tpu_tts`'s GAN params `{"generator", "discriminator"}` (either may be
    missing) → the port's GAN net `state_dict` (`model_g.*`, `model_d.*`).
    `n_stages`: the MelGAN generator's upsampling stages."""
    fam = family(generator_model)
    if fam == "hifigan":
        rules, transposed = _HIFIGAN_G, r"^ups_\d+$"
    elif fam == "melgan":
        rules, transposed = _melgan_rules(n_stages), r"^up_\d+$"
    elif fam == "univnet":
        rules, transposed = _UNIVNET_G, r"convt_pre$"
    else:
        raise NotImplementedError(f"no bridge for the {generator_model} generator")
    sd = {}
    if "generator" in params:
        gen = flax_to_state_dict(_flatten(params["generator"]), rules, lambda module: re.search(transposed, module))
        sd.update({f"model_g.{k}": torch.from_numpy(np.ascontiguousarray(v)) for k, v in gen.items()})
    if "discriminator" in params:
        disc = norm_convs_from_flax(_flatten(params["discriminator"]), lambda module: _disc_name(fam, module))
        sd.update({f"model_d.{k}": v for k, v in disc.items()})
    return sd
