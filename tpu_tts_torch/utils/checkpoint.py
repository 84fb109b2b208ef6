"""Checkpoint loading shared by the port's TTS models and vocoders.

Counterpart of `tpu_tts/models/base_tts.py` (`load_checkpoint`:228,
`load_torch_checkpoint`:240) and `tpu_tts/train/torch_convert.py`
(`load_torch_checkpoint`:13). The port's nets carry Coqui's state-dict
names, so a Coqui-format `.pth` loads without a converter: the file holds
`{"model": state_dict, ...}` (a training checkpoint, with optimizer state,
step and config beside the weights) or the state dict itself. Tensors the
net has no place for (the discriminator `disc.*`, the posterior encoder
and whatever else only training reads) are skipped by the net's own key
set; a key the net expects and the file lacks still raises. Old-style
weight-norm pairs `X.weight_g`/`X.weight_v` load as
`X.parametrizations.weight.original0/1`.
"""

import pickle
import re
from typing import Dict

import torch

_OLD_WEIGHT_NORM = ((re.compile(r"\.weight_g$"), ".parametrizations.weight.original0"),
                    (re.compile(r"\.weight_v$"), ".parametrizations.weight.original1"))


def read_checkpoint(path: str) -> Dict:
    """A `.pth` file as a dict, on the CPU. Tensors-only files load with
    `weights_only`; a Coqui training checkpoint also pickles its config and
    optimizer state, and loads as a full pickle."""
    try:
        return torch.load(path, map_location="cpu", weights_only=True)
    except pickle.UnpicklingError as e:
        # a full pickle can run code: load one only from a file you trust
        print(f" > WARNING: {path} holds more than tensors and plain containers ({str(e).splitlines()[0]}); "
              "loading it as a full pickle")
        return torch.load(path, map_location="cpu", weights_only=False)


def net_state_dict(ckpt: Dict, net: torch.nn.Module) -> Dict[str, torch.Tensor]:
    """The tensors of a checkpoint dict that `net` takes, under its names.
    Loading the result with `strict=True` still raises on a missing key."""
    sd = ckpt["model"] if isinstance(ckpt.get("model"), dict) else ckpt
    wanted = set(net.state_dict())
    out, skipped = {}, []
    for key, value in sd.items():
        if not isinstance(value, torch.Tensor):
            continue
        for pat, rep in _OLD_WEIGHT_NORM:
            key = pat.sub(rep, key)
        if key in wanted:
            out[key] = value
        else:
            skipped.append(key)
    if skipped:
        print(f" > Skipped {len(skipped)} checkpoint tensors the inference net has no place for "
              f"(e.g. {', '.join(sorted(skipped)[:3])})")
    return out


def load_net_checkpoint(net: torch.nn.Module, checkpoint_path: str, strict: bool = True) -> Dict:
    """Load a `.pth` file (the port's `state_dict` or Coqui's format) into `net`."""
    ckpt = read_checkpoint(checkpoint_path)
    net.load_state_dict(net_state_dict(ckpt, net), strict=strict)
    return ckpt
