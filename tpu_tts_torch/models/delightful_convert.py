"""JAX DelightfulTTS params → the port's `state_dict`.

`training_params_from_flax({"generator", "discriminator"})` takes the whole
training tree of `tpu_tts`'s `DelightfulTTS` and returns what
`DelightfulTTS.load_training_state` takes: the generator's entries and the
VITS discriminator's under `disc.` (`vits_convert.disc_params_from_flax`).
`params_from_flax(tree)` takes the `generator` tree of `tpu_tts`'s
`DelightfulTTS` (`DelightfulNet` params: `acoustic_model`,
`waveform_decoder`) as a nested dict of numpy arrays and returns what
`DelightfulNet.load_state_dict` takes. The port's modules carry the flax
names, so the acoustic model's paths only change `/` to `.`; its leaves:

- Dense `[in, out]` → Linear `[out, in]`; conv `[k, in/groups, out]` →
  `[out, in/groups, k]`;
- LayerNorm, GroupNorm and `InstanceNorm1dAffine` `scale` → `weight`;
- embeddings (`src_word_emb/embeddings`, `emb_g`) → `.weight`;
- `u_bias`, `v_bias` and the style tokens' `embed` keep their names;
- each reference encoder's GRU cell (`GRUCell_0`: flax's `nn.RNN` binds
  the cell in the encoder's scope) → `gru`, through the WaveRNN bridge's
  `gru_from_flax`.

The aligner's convs (`acoustic_model/aligner`, flax `Conv1d`s: a Dense
`conv` at kernel size 1) follow the same two kernel rules. The decoder goes
through the VITS bridge's HiFi-GAN rules
(`vits_convert.params_from_flax`).
"""

from typing import Dict

import numpy as np
import torch

from tpu_tts_torch.models import vits_convert
from tpu_tts_torch.vocoder.models.wavernn_convert import gru_from_flax

_LEAF = {"scale": "weight", "embedding": "weight"}


def acoustic_params_from_flax(tree) -> Dict[str, np.ndarray]:
    """JAX `AcousticModelNet` params → `AcousticModelNet` state-dict entries (numpy)."""
    sd: Dict[str, np.ndarray] = {}

    def walk(node, path):
        for k, v in node.items():
            if k == "GRUCell_0":
                sd.update({f"{path}.gru.{n}": w for n, w in gru_from_flax(v).items()})
                continue
            name = f"{path}.{k}" if path else str(k)
            if hasattr(v, "items"):
                walk(v, name)
                continue
            arr = np.asarray(v, dtype=np.float32)
            if k == "kernel":
                sd[f"{path}.weight"] = arr.T if arr.ndim == 2 else np.transpose(arr, (2, 1, 0))
            else:
                sd[f"{path}.{_LEAF.get(k, k)}"] = arr

    walk(tree, "")
    return sd


def params_from_flax(tree) -> Dict[str, torch.Tensor]:
    """JAX `DelightfulNet` params (the `generator` tree) → `DelightfulNet`'s `state_dict`."""
    sd = {f"acoustic_model.{k}": torch.from_numpy(np.ascontiguousarray(v))
          for k, v in acoustic_params_from_flax(tree["acoustic_model"]).items()}
    sd.update(vits_convert.params_from_flax({"waveform_decoder": tree["waveform_decoder"]}))
    return sd


def training_params_from_flax(params, periods) -> Dict[str, torch.Tensor]:
    """JAX `{"generator", "discriminator"}` → `DelightfulTTS.load_training_state`'s
    dict; `periods` are the discriminator's (`vocoder.periods_discriminator`)."""
    sd = params_from_flax(params["generator"])
    sd.update({f"disc.{k}": v for k, v in vits_convert.disc_params_from_flax(params["discriminator"], periods).items()})
    return sd
