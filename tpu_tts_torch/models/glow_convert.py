"""JAX Glow-TTS params → the port's `state_dict`.

`params_from_flax(tree)` takes the `GlowTTSNet` param tree of the JAX model
as a nested dict of arrays and returns what `GlowTTSNet.load_state_dict`
takes. It is the inverse of the JAX package's
`convert_glow_tts_torch_state_dict` (tpu_tts/models/glow_convert.py:23) for
the `rel_pos_transformer` encoder, with the layout rules of the VITS bridge
(`vits_convert.flax_to_state_dict`); flow block i becomes `decoder.flows`
3i (ActNorm, logs/bias `[1, C, 1]`), 3i+1 (InvConvNear) and 3i+2
(CouplingBlock).
"""

import re
from typing import Dict

import numpy as np
import torch

from tpu_tts_torch.models.vits_convert import _flatten, flax_to_state_dict


def _flow(offset: int):
    return lambda m: f"decoder/flows/{3 * int(m.group(1)) + offset}/"


_RULES = [
    (r"^encoder/prenet/conv_(\d+)/conv/", r"encoder/prenet/conv_layers/\1/"),
    (r"^encoder/prenet/norm_(\d+)/", r"encoder/prenet/norm_layers/\1/"),
    (r"^encoder/encoder/attn_(\d+)/", r"encoder/encoder/attn_layers/\1/"),
    (r"^encoder/encoder/norm([12])_(\d+)/", r"encoder/encoder/norm_layers_\1/\2/"),
    (r"^encoder/encoder/ffn_(\d+)/conv_([12])/conv/", r"encoder/encoder/ffn_layers/\1/conv_\2/"),
    (r"^encoder/duration_predictor/conv_([12])/conv/", r"encoder/duration_predictor/conv_\1/"),
    (r"^decoder/actnorm_(\d+)/", _flow(0)),
    (r"^decoder/invconv_(\d+)/", _flow(1)),
    (r"^decoder/coupling_(\d+)/", _flow(2)),
    (r"/wn/in_(\d+)/", r"/wn/in_layers/\1/"),
    (r"/wn/res_skip_(\d+)/", r"/wn/res_skip_layers/\1/"),
]


def params_from_flax(tree) -> Dict[str, torch.Tensor]:
    """JAX `GlowTTSNet` params → the port's `state_dict`."""
    sd = flax_to_state_dict(_flatten(tree), _RULES)
    for k in sd:
        if re.fullmatch(r"decoder\.flows\.\d+\.(logs|bias)", k):  # ActNorm
            sd[k] = sd[k].reshape(1, -1, 1)
    return {k: torch.from_numpy(np.ascontiguousarray(v)) for k, v in sd.items()}
