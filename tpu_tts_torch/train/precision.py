"""Mixed precision of the port's trainer: float32 masters, a bfloat16 forward.

Counterpart of `tpu_tts/train/precision.py` (`cast_floating`:34,
`autocast_args`:46, `autocast_enabled`:56). A model that does not handle
mixed precision itself (`handles_mixed_precision` false, XTTS's fine-tune)
gets the trainer's generic cast: its net's floating parameters and the
batch's floating tensors (but `mp_keep_fp32_batch_keys`) are cast to
bfloat16 for the forward by a differentiable `.to`, so the gradients come
back to the float32 masters in float32, the optimizer state stays float32,
and the loss is read in float32. VITS (`handles_mixed_precision = True`)
sets a compute dtype on its modules instead (`models/vits.py`).

This is not `torch.autocast`, which keeps softmax and norms in float32 and
runs every matmul in bfloat16 whatever its operands. The JAX forward
follows JAX's type promotion: an op on a bfloat16 and a float32 operand
computes in float32, one on two bfloat16 operands in bfloat16. Torch
promotes elementwise ops the same way, but its matmuls, convolutions and
norms refuse mixed operands; `jax_promotion` makes them promote as JAX
does while the forward runs.
"""

from functools import reduce
from typing import Callable, Dict, Iterable, Tuple

import torch
import torch.nn as nn
import torch.nn.functional as F
from torch.overrides import TorchFunctionMode
from torch.utils._pytree import tree_flatten, tree_map


def cast_floating(tree, dtype: torch.dtype):
    """Every floating tensor of `tree` cast to `dtype`; integer and boolean
    tensors (ids, lengths) and non-tensors pass through."""
    return tree_map(lambda x: x.to(dtype) if isinstance(x, torch.Tensor) and x.is_floating_point() else x, tree)


def autocast_args(params: Dict[str, torch.Tensor], batch: Dict, keep_keys: Iterable[str] = ()) -> Tuple[Dict, Dict]:
    """(params, batch) in bfloat16 for the forward; `keep_keys` name batch
    entries that stay float32."""
    keep = set(keep_keys or ())
    return (cast_floating(params, torch.bfloat16),
            {k: v if k in keep else cast_floating(v, torch.bfloat16) for k, v in batch.items()})


def autocast_enabled(config, model) -> bool:
    """Whether the trainer applies the generic cast: the config asks for mixed
    precision and the model does not handle it itself."""
    if not bool(getattr(config, "mixed_precision", False)):
        return False
    handles = getattr(model, "handles_mixed_precision", False)
    return not bool(handles() if callable(handles) else handles)


# the ops whose floating operands torch will not mix: JAX promotes them
_PROMOTED = {F.linear, F.conv1d, F.conv2d, F.conv_transpose1d, F.layer_norm, F.group_norm, torch.matmul, torch.mm,
             torch.bmm, torch.addmm, torch.baddbmm, torch.einsum, torch.Tensor.matmul, torch.Tensor.__matmul__}


class jax_promotion(TorchFunctionMode):
    """Within: the matmuls, convolutions and norms of `_PROMOTED` cast their
    floating tensor operands to the operands' common type first, as JAX
    promotes a bfloat16 and a float32 operand to float32."""

    def __torch_function__(self, func, types, args=(), kwargs=None):
        kwargs = kwargs or {}
        if func in _PROMOTED:
            floats = [t for t in tree_flatten((args, kwargs))[0] if isinstance(t, torch.Tensor) and t.is_floating_point()]
            if floats:
                dtype = reduce(torch.promote_types, (t.dtype for t in floats))
                args, kwargs = cast_floating((args, kwargs), dtype)
        return func(*args, **kwargs)


class _Call(nn.Module):
    def __init__(self, module: nn.Module, fn: Callable):
        super().__init__()
        self.module = module
        self.fn = fn

    def forward(self, *args, **kwargs):
        return self.fn(*args, **kwargs)


def call_cast(module: nn.Module, params: Dict[str, torch.Tensor], fn: Callable, *args, **kwargs):
    """`fn(*args, **kwargs)` with `module`'s parameters replaced by `params`
    (its bfloat16 casts from `autocast_args`, through which the gradients
    reach the float32 parameters) and JAX's promotion on."""
    with jax_promotion():
        return torch.func.functional_call(_Call(module, fn), {f"module.{k}": v for k, v in params.items()}, args,
                                          kwargs)
