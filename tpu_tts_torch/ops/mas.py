"""Monotonic Alignment Search: the path VITS training aligns text to frames with.

Counterpart of `tpu_tts/ops/mas.py`. Three versions, each taking log-probs
`value [B, T_x, T_y]` and a 0/1 `mask` of the same shape and returning the
0/1 path:

- `maximum_path_numpy`, a copy of the JAX package's numpy oracle;
- `maximum_path_torch`, a line-for-line torch translation of
  `maximum_path_jax` (its two `lax.scan`s become two Python loops over T_y);
  it runs on any device, at ≈ 6 small ops a mel frame, and is here for the
  tests;
- `maximum_path`, the training path on every device: one copy of
  `value · mask` to the host, the C++/OpenMP DP of `csrc/mas_cpp.cpp` (a copy
  of `tpu_tts/ops/mas_cpp.cpp`, built with g++ at first use into `_build/`),
  one copy of the path back; from and to a card both copies go through
  page-locked host buffers. JAX runs MAS on the device instead; a host
  round trip of two `[B, T_x, T_y]` copies costs less than the thousands of
  launches a loop over T_y would.

All three keep JAX's tie rule: a cell stays on its row when the two
predecessors are equal.
"""

import ctypes
import hashlib
import subprocess
import threading

import numpy as np
import torch
import torch.nn.functional as F

from tpu_tts_torch.ops.build import BUILD_DIR, CSRC_DIR

_MAX_NEG = -1e9
GXX_FLAGS = ["-O3", "-fopenmp", "-shared", "-fPIC"]


def maximum_path_numpy(value: np.ndarray, mask: np.ndarray, max_neg_val: float = -np.inf) -> np.ndarray:
    """Vectorized numpy MAS (semantics of Coqui's `maximum_path_numpy`)."""
    value = value * mask
    b, t_x, t_y = value.shape
    direction = np.zeros(value.shape, dtype=np.int64)
    v = np.zeros((b, t_x), dtype=np.float32)
    x_range = np.arange(t_x, dtype=np.float32).reshape(1, -1)
    for j in range(t_y):
        v0 = np.pad(v, [[0, 0], [1, 0]], mode="constant", constant_values=max_neg_val)[:, :-1]
        v1 = v
        max_mask = v1 >= v0
        v_max = np.where(max_mask, v1, v0)
        direction[:, :, j] = max_mask
        index_mask = x_range <= j
        v = np.where(index_mask, v_max + value[:, :, j], max_neg_val)
    direction = np.where(mask.astype(bool), direction, 1)

    path = np.zeros(value.shape, dtype=np.float32)
    index = mask[:, :, 0].sum(1).astype(np.int64) - 1
    index_range = np.arange(b)
    for j in reversed(range(t_y)):
        path[index_range, index, j] = 1
        index = index + direction[index_range, index, j] - 1
    return path * mask


@torch.no_grad()
def maximum_path_torch(value: torch.Tensor, mask: torch.Tensor) -> torch.Tensor:
    """`maximum_path_jax` in torch: a forward loop over the mel axis carrying
    the DP row `v [B, T_x]` and keeping each column's directions, then a
    backward loop carrying each row's path index."""
    mask = mask.to(value.dtype)
    value = value * mask
    B, t_x, t_y = value.shape
    x_range = torch.arange(t_x, dtype=torch.float32, device=value.device)[None, :]
    v = torch.zeros(B, t_x, dtype=value.dtype, device=value.device)
    directions = torch.empty(t_y, B, t_x, dtype=torch.long, device=value.device)
    for j in range(t_y):
        v0 = F.pad(v, (1, 0), value=_MAX_NEG)[:, :-1]
        stay = v >= v0
        directions[j] = stay.long()
        v = torch.where(x_range <= j, torch.where(stay, v, v0) + value[:, :, j], torch.full_like(v, _MAX_NEG))
    directions = torch.where(mask.permute(2, 0, 1) > 0, directions, torch.ones_like(directions))
    index = mask[:, :, 0].sum(1).long() - 1
    rows = torch.arange(B, device=value.device)
    path = torch.zeros_like(value)
    for j in reversed(range(t_y)):
        path[rows, index.clamp(min=0), j] = 1
        index = index + directions[j].gather(1, index.clamp(min=0)[:, None])[:, 0] - 1
    return path * mask


_lib = None
_lib_lock = threading.Lock()


def load_library() -> ctypes.CDLL:
    """The C++ DP, built from `csrc/mas_cpp.cpp` with g++ at first use into
    `_build/libmas_cpp-<hash>.so` and loaded once. A failed build raises with
    the compiler's output."""
    global _lib
    if _lib is None:
        with _lib_lock:
            if _lib is None:
                src = CSRC_DIR / "mas_cpp.cpp"
                digest = hashlib.sha256(src.read_bytes() + " ".join(GXX_FLAGS).encode()).hexdigest()[:16]
                so = BUILD_DIR / f"libmas_cpp-{digest}.so"
                if not so.exists():
                    BUILD_DIR.mkdir(parents=True, exist_ok=True)
                    tmp = so.with_suffix(f".{threading.get_ident()}.tmp")
                    out = subprocess.run(["g++", *GXX_FLAGS, str(src), "-o", str(tmp)], capture_output=True,
                                         text=True)
                    if out.returncode != 0:
                        raise RuntimeError(f"g++ failed for csrc/mas_cpp.cpp:\n{out.stdout}{out.stderr}")
                    tmp.replace(so)
                lib = ctypes.CDLL(str(so))
                i32 = ctypes.POINTER(ctypes.c_int32)
                lib.maximum_path_batch.argtypes = [i32, ctypes.POINTER(ctypes.c_float), i32, i32, ctypes.c_int,
                                                   ctypes.c_int, ctypes.c_int, ctypes.c_float]
                lib.maximum_path_batch.restype = None
                _lib = lib
    return _lib


def maximum_path_cpp(value: np.ndarray, t_xs: np.ndarray, t_ys: np.ndarray, out: np.ndarray = None) -> np.ndarray:
    """The C++ DP on host arrays: `value [B, T_x, T_y]` (already masked) and
    each row's valid lengths → the int32 0/1 path, written into `out` (zeros
    of value's shape, C-contiguous) when given."""
    lib = load_library()
    value = np.ascontiguousarray(value, dtype=np.float32)
    b, t_x, t_y = value.shape
    if t_xs.shape != (b,) or t_ys.shape != (b,):
        raise ValueError(f"lengths must be [{b}], got {t_xs.shape} and {t_ys.shape}")
    t_xs = np.ascontiguousarray(t_xs, dtype=np.int32)
    t_ys = np.ascontiguousarray(t_ys, dtype=np.int32)
    if (t_xs < 0).any() or (t_xs > t_x).any() or (t_ys < 0).any() or (t_ys > t_y).any():
        raise ValueError("MAS lengths out of range")
    paths = np.zeros((b, t_x, t_y), dtype=np.int32) if out is None else out
    if paths.shape != value.shape or paths.dtype != np.int32 or not paths.flags.c_contiguous:
        raise ValueError(f"out must be C-contiguous int32 {value.shape}")
    i32 = ctypes.POINTER(ctypes.c_int32)
    lib.maximum_path_batch(paths.ctypes.data_as(i32), value.ctypes.data_as(ctypes.POINTER(ctypes.c_float)),
                           t_xs.ctypes.data_as(i32), t_ys.ctypes.data_as(i32), b, t_x, t_y, np.float32(_MAX_NEG))
    return paths


@torch.no_grad()
def maximum_path(value: torch.Tensor, mask: torch.Tensor) -> torch.Tensor:
    """The training path: the C++ DP on a host copy of `value · mask`, the
    path copied back to `value`'s device. No gradient flows through it."""
    mask = mask.to(value.dtype)
    pin = value.device.type == "cuda"
    host = torch.empty(value.shape, dtype=torch.float32, pin_memory=pin)
    host.copy_(value * mask)
    t_xs, t_ys = torch.stack([mask[:, :, 0].sum(1), mask[:, 0, :].sum(1)]).int().cpu().numpy()
    paths = torch.zeros(value.shape, dtype=torch.int32, pin_memory=pin)
    maximum_path_cpp(host.numpy(), t_xs, t_ys, out=paths.numpy())
    return paths.to(value.device, non_blocking=pin).to(value.dtype) * mask
