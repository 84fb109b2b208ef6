"""Coqui speaker-encoder checkpoints into the port's encoders.

Counterpart of `tpu_tts/encoder/encoder_convert.py`
(`convert_lstm_encoder_state_dict`:26, `convert_resnet_encoder_state_dict`
:52), which maps Coqui's keys onto the flax trees. The port's modules keep
Coqui's names and layouts (`encoder/models.py`), so the map is by name:
the LSTM's `layers.{i}.lstm.*` and `layers.{i}.linear.weight`, whose
missing bias (the JAX and port models have one) loads as 0, as the JAX
converter sets it; the ResNet's convs, SE layers, batch norms with their
running statistics, attention and `fc`. Coqui's spectrogram front end
(`torch_spec.*`) has no place in the port, as in JAX, and is dropped.
"""

from typing import Dict

import torch
import torch.nn as nn


def state_dict_from_coqui(state_dict: Dict, net: nn.Module) -> Dict[str, torch.Tensor]:
    """The tensors of a Coqui (or port) encoder state dict that `net` takes.
    A missing `layers.{i}.linear.bias` and BN `num_batches_tracked` are
    zero-filled; a state dict that matches none of `net`'s keys raises."""
    wanted = net.state_dict()
    out = {k: v for k, v in state_dict.items() if isinstance(v, torch.Tensor) and k in wanted}
    if not any(k in out for k in wanted if not k.endswith("num_batches_tracked")):
        raise ValueError(f"no matching weights for {type(net).__name__} among {len(state_dict)} checkpoint tensors: "
                         "wrong encoder model_name for this checkpoint?")
    for k, v in wanted.items():
        if k not in out and (k.endswith(".linear.bias") or k.endswith("num_batches_tracked")):
            out[k] = torch.zeros_like(v)
    return out
