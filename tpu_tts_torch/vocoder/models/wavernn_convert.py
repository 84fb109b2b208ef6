"""JAX WaveRNN params → the port's `state_dict`.

`params_from_flax(params, model_state)` takes the `WavernnNet` param tree of
the JAX model and its non-param collections (`batch_stats`) as nested dicts
of arrays and returns what `WavernnNet.load_state_dict` takes. It is the
inverse of the JAX package's `convert_wavernn_state_dict`
(tpu_tts/vocoder/models/vocoder_convert.py:275):

- Dense `[in, out]` → Linear `[out, in]`; conv `[k, in, out]` → `[out, in, k]`;
- BatchNorm: `scale`/`bias` from the params, running `mean`/`var` from
  `batch_stats` (norm "batch") or from the params (norm "frozen_batch");
- flax GRUCell gates (`ir/iz/in` with bias, `hr/hz` without, `hn` with) →
  torch GRU rows r | z | n, with `bias_hh` = (0, 0, b_hn);
- the shared smoothing kernel `smooth_{j}_kernel` `[k]` → the Conv2d of
  `up_layers.{2j+1}` `[1, 1, 1, k]`.
"""

import re
from typing import Dict, Optional

import numpy as np
import torch


def _np(x) -> np.ndarray:
    return np.asarray(x, dtype=np.float32)


def params_from_flax(params, model_state: Optional[Dict] = None) -> Dict[str, torch.Tensor]:
    """JAX `WavernnNet` params (+ `model_state`) → the port's `state_dict`."""
    up, cell = params["upsample"], params["cell"]
    stats = (model_state or {}).get("batch_stats", {}).get("upsample", {}).get("resnet", {})
    sd: Dict[str, np.ndarray] = {}

    def conv(node, dst, bias=True):
        sd[f"{dst}.weight"] = np.transpose(_np(node["kernel"]), (2, 1, 0))
        if bias and "bias" in node:
            sd[f"{dst}.bias"] = _np(node["bias"])

    def bn(name, dst):
        node = up["resnet"][name]
        run = node if "mean" in node else stats[name]
        sd[f"{dst}.weight"], sd[f"{dst}.bias"] = _np(node["scale"]), _np(node["bias"])
        sd[f"{dst}.running_mean"], sd[f"{dst}.running_var"] = _np(run["mean"]), _np(run["var"])
        sd[f"{dst}.num_batches_tracked"] = np.array(0, dtype=np.int64)

    def dense(node, dst):
        sd[f"{dst}.weight"] = _np(node["kernel"]).T
        sd[f"{dst}.bias"] = _np(node["bias"])

    for key, kern in up.items():
        m = re.fullmatch(r"smooth_(\d+)_kernel", key)
        if m:
            sd[f"upsample.up_layers.{2 * int(m.group(1)) + 1}.weight"] = _np(kern).reshape(1, 1, 1, -1)
    res = up["resnet"]
    conv(res["conv_in"], "upsample.resnet.conv_in")
    bn("norm_in", "upsample.resnet.batch_norm")
    n_res = len([k for k in res if re.fullmatch(r"res\d+_conv1", k)])
    for i in range(n_res):
        for n in (1, 2):
            conv(res[f"res{i}_conv{n}"], f"upsample.resnet.layers.{i}.conv{n}")
            bn(f"res{i}_norm{n}", f"upsample.resnet.layers.{i}.batch_norm{n}")
    conv(res["conv_out"], "upsample.resnet.conv_out")

    dense(cell["I"], "I")
    for r in ("rnn1", "rnn2"):
        g = cell[r]
        sd[f"{r}.weight_ih_l0"] = np.concatenate([_np(g[k]["kernel"]).T for k in ("ir", "iz", "in")])
        sd[f"{r}.weight_hh_l0"] = np.concatenate([_np(g[k]["kernel"]).T for k in ("hr", "hz", "hn")])
        sd[f"{r}.bias_ih_l0"] = np.concatenate([_np(g[k]["bias"]) for k in ("ir", "iz", "in")])
        b_hn = _np(g["hn"]["bias"])
        sd[f"{r}.bias_hh_l0"] = np.concatenate([np.zeros(2 * b_hn.shape[0], np.float32), b_hn])
    for name in ("fc1", "fc2", "fc3"):
        dense(cell[name], name)
    return {k: torch.from_numpy(np.ascontiguousarray(v)) for k, v in sd.items()}
