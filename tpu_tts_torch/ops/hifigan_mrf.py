"""HiFi-GAN MRF stack: the CUDA kernel of `csrc/hifigan_mrf.cu` and its plain version.

Replaces `tpu_tts/ops/hifigan_pallas.py::_mrf_kernel` (launched by
`mrf_stack_pallas`). The function is the whole ResBlock1 stack of one
upsample stage: for each resblock (k, dilations) and each d,
`lrelu(0.1)` → dilated conv k·d → `lrelu` → conv k → residual add, then the
mean of the resblocks. Convolutions use zero SAME padding at the edges of
the (bucket-padded) tensor; sums are float32; the working type is float32 or
bfloat16, taken from the packed weights as the Pallas wrapper does.

What bounds it on the H100 and what the design does about it: see the note
at the top of the CUDA source. In short, it is bound by arithmetic (≈ 0.6
GFLOP per mel frame at the VITS widths); this first version runs float32
FMAs on the CUDA cores, one launch per dilation unit (9 per VITS stage),
because a whole resblock's halo in float32 at C = 256 does not fit in a
block's shared memory; a thread-block cluster of S blocks shares one time
tile when C is large and T short (`plan`). The stage mean is accumulated
inside the kernel.

Layout: channels-first `[B, C, T]`, the layout of the port's generator.
`mrf_stack` takes the kernel for a CUDA tensor and the plain version for a
CPU tensor; nothing else chooses between them.
"""

import ctypes
import math
from dataclasses import dataclass
from typing import List, Sequence

import torch
import torch.nn.functional as F

from tpu_tts_torch.ops.build import SMEM_LIMIT

LRELU_SLOPE = 0.1

# kernel launches made by `mrf_stack` on CUDA tensors; read and reset by
# whoever wants to know that a run went through the kernel
launches = 0


@dataclass
class MrfUnit:
    """One dilation unit; w1, w2 packed `[C_in, k, C_out]` in the working type."""

    w1: torch.Tensor
    b1: torch.Tensor
    w2: torch.Tensor
    b2: torch.Tensor
    k: int
    d: int


@dataclass
class MrfStage:
    """The weights of one stage's MRF stack, packed once per model load."""

    blocks: List[List[MrfUnit]]

    @property
    def dtype(self) -> torch.dtype:
        return self.blocks[0][0].w1.dtype

    @property
    def channels(self) -> int:
        return self.blocks[0][0].w1.shape[0]


def pack_stage(resblocks: Sequence[Sequence[tuple]], dtype: torch.dtype = torch.float32) -> MrfStage:
    """resblocks[b][u] = (w1 [C, C, k], b1 [C], w2 [C, C, k], b2 [C], d) with
    weight norm folded (torch layout `[C_out, C_in, k]`)."""
    blocks = []
    for units in resblocks:
        packed = []
        for w1, b1, w2, b2, d in units:
            packed.append(
                MrfUnit(
                    w1=w1.detach().permute(1, 2, 0).to(dtype).contiguous(),
                    b1=b1.detach().float().contiguous(),
                    w2=w2.detach().permute(1, 2, 0).to(dtype).contiguous(),
                    b2=b2.detach().float().contiguous(),
                    k=int(w1.shape[-1]),
                    d=int(d),
                )
            )
        blocks.append(packed)
    return MrfStage(blocks)


def _conv(h: torch.Tensor, w_packed: torch.Tensor, b: torch.Tensor, d: int) -> torch.Tensor:
    k = w_packed.shape[1]
    y = F.conv1d(h, w_packed.permute(2, 0, 1), padding=(k // 2) * d, dilation=d)
    return (y.float() + b[None, :, None]).to(h.dtype)


def mrf_stack_reference(x: torch.Tensor, stage: MrfStage) -> torch.Tensor:
    """Plain PyTorch version: x `[B, C, T]` → `[B, C, T]` in the working type."""
    x = x.to(stage.dtype)
    acc = None
    for units in stage.blocks:
        h = x
        for u in units:
            t = _conv(F.leaky_relu(h, LRELU_SLOPE), u.w1, u.b1, u.d)
            h = h + _conv(F.leaky_relu(t, LRELU_SLOPE), u.w2, u.b2, 1)
        acc = h.float() if acc is None else acc + h.float()
    return (acc / len(stage.blocks)).to(x.dtype)


def mrf_stack(x: torch.Tensor, stage: MrfStage) -> torch.Tensor:
    """The MRF stack of one stage: the CUDA kernel for a CUDA tensor, the
    plain version for a CPU tensor."""
    if x.device.type == "cpu":
        return mrf_stack_reference(x, stage)
    if x.device.type != "cuda":
        raise ValueError(f"mrf_stack runs on cuda or cpu tensors, got {x.device}")
    return _mrf_stack_cuda(x, stage)


WARP_TILE = 32  # a warp tile of the kernel is 32 channels × 32 samples
MAX_ITEMS = 2 * 8  # warp tiles a block holds at once (2 per warp); more take further passes


def plan(B: int, C: int, T: int, k: int, d: int, n_sm: int, smem_bytes) -> tuple:
    """(tile, S) of one launch. The tile is 32·m − (k − 1) samples, so the
    first conv's output (tile + k − 1) fills m warp tiles exactly; S is the
    cluster size sharing a tile. Takes the largest m (8 down to 1), then the
    smallest S, that gives every SM a block within one pass of warp tiles and
    a block's shared memory; failing that, the plan with the most blocks."""
    best = None
    for m in (8, 4, 2, 1):
        tile = WARP_TILE * m - (k - 1)
        if tile <= 0:
            continue
        for S in (1, 2, 4, 8):
            if C % (WARP_TILE * S):
                break
            if (C // S // WARP_TILE) * m > MAX_ITEMS or smem_bytes(tile, S) > SMEM_LIMIT:
                continue
            blocks = B * math.ceil(T / tile) * S
            if blocks >= n_sm:
                return tile, S
            if best is None or blocks > best[0]:
                best = (blocks, tile, S)
    if best is None:
        raise ValueError(f"MRF unit with C={C}, k={k}, d={d} does not fit in one block")
    return best[1], best[2]


_lib = None


def _kernel():
    global _lib
    if _lib is None:
        from tpu_tts_torch.ops.build import load

        lib = load("hifigan_mrf")
        p, i = ctypes.c_void_p, ctypes.c_int
        lib.hifigan_mrf_unit.argtypes = [p, p, p, p, p, p, p, p, i, i, i, i, i, i, i, i, ctypes.c_float, i, p]
        lib.hifigan_mrf_unit.restype = ctypes.c_int
        lib.hifigan_mrf_smem_bytes.argtypes = [i, i, i, i, i, i]
        lib.hifigan_mrf_smem_bytes.restype = ctypes.c_size_t
        _lib = lib
    return _lib


def _check(stage: MrfStage, x: torch.Tensor):
    C = stage.channels
    if x.dim() != 3 or x.shape[1] != C:
        raise ValueError(f"x must be [B, {C}, T], got {tuple(x.shape)}")
    if stage.dtype not in (torch.float32, torch.bfloat16):
        raise TypeError(f"MRF kernel takes float32 or bfloat16 weights, got {stage.dtype}")
    if C % 32:
        raise ValueError(f"MRF kernel needs C % 32 == 0, got C={C}")
    for units in stage.blocks:
        for u in units:
            if u.k % 2 == 0:
                raise ValueError(f"MRF kernel needs odd kernel sizes, got k={u.k}")
            for t, shape, dt in ((u.w1, (C, u.k, C), stage.dtype), (u.w2, (C, u.k, C), stage.dtype),
                                 (u.b1, (C,), torch.float32), (u.b2, (C,), torch.float32)):
                if t.device != x.device or tuple(t.shape) != shape or t.dtype != dt or not t.is_contiguous():
                    raise ValueError("MRF weights must be packed by pack_stage on the input's device")


def _mrf_stack_cuda(x: torch.Tensor, stage: MrfStage) -> torch.Tensor:
    global launches
    x = x.to(stage.dtype).contiguous()
    _check(stage, x)
    lib = _kernel()
    B, C, T = x.shape
    n_blocks = len(stage.blocks)
    bufs = [torch.empty_like(x), torch.empty_like(x)]
    acc = torch.empty(x.shape, dtype=torch.float32, device=x.device) if n_blocks > 1 else None
    y = torch.empty_like(x)
    n_sm = torch.cuda.get_device_properties(x.device).multi_processor_count
    stream = torch.cuda.current_stream(x.device).cuda_stream
    is_bf16 = int(stage.dtype == torch.bfloat16)
    for bi, units in enumerate(stage.blocks):
        cur = x
        for ui, u in enumerate(units):
            if ui < len(units) - 1:
                mode, h_out = 0, bufs[ui % 2]
            else:
                mode, h_out = (4 if n_blocks == 1 else 1 if bi == 0 else 3 if bi == n_blocks - 1 else 2), None
            tile, S = plan(B, C, T, u.k, u.d, n_sm,
                           lambda tile, S: lib.hifigan_mrf_smem_bytes(C, u.k, u.d, tile, S, is_bf16))
            err = lib.hifigan_mrf_unit(
                cur.data_ptr(), u.w1.data_ptr(), u.b1.data_ptr(), u.w2.data_ptr(), u.b2.data_ptr(),
                h_out.data_ptr() if h_out is not None else None,
                acc.data_ptr() if acc is not None else None,
                y.data_ptr(), B, C, T, u.k, u.d, tile, S, mode, 1.0 / n_blocks, is_bf16, stream,
            )
            if err != 0:
                raise RuntimeError(f"hifigan_mrf_unit launch failed: cudaError {err}")
            launches += 1
            cur = h_out
    return y
