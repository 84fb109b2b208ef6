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
GFLOP per mel frame at the VITS widths), so each conv is an implicit GEMM on
the tensor cores (M = time, N = C_out, K = taps × C_in). float32 runs three
TF32 passes (hi·hi + hi·lo + lo·hi, `tf32_split` below is the rounding bit
for bit), which keeps float32's accuracy; bfloat16 runs one. A dilation
unit is two launches (conv 1 into a float32 scratch, conv 2 with the
residual and the stage mean), 18 per VITS stage; `plan` picks the output
tile per stage shape. Each launch is a wgmma kernel: the weights reach
shared memory by TMA, the activations are the register operand.

Layout: channels-first `[B, C, T]`, the layout of the port's generator.
`mrf_stack` takes the kernel for a CUDA tensor and the plain version for a
CPU tensor; nothing else chooses between them.
"""

import ctypes
import math
import threading
from dataclasses import dataclass
from typing import List, Optional, Sequence, Tuple

import torch
import torch.nn.functional as F

LRELU_SLOPE = 0.1

# kernel launches made by `mrf_stack` on CUDA tensors; read and reset by
# whoever wants to know that a run went through the kernel
launches = 0


def tf32_split(x: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    """(hi, lo) of a float32 tensor as the kernel splits it: hi = x rounded to
    TF32 (10 mantissa bits, nearest, ties away from zero, the low 13 bits
    zero, as `cvt.rna.tf32.f32`), lo = x − hi rounded the same way."""

    def rna(v):
        bits = v.contiguous().view(torch.int32)
        # adding half of the dropped range to the magnitude bits rounds the
        # magnitude to nearest, ties away from zero; a carry moves the exponent
        r = ((bits + 0x1000) & ~0x1FFF).view(torch.float32)
        return torch.where(torch.isfinite(v), r, v)

    x = x.float()
    hi = rna(x)
    return hi, rna(x - hi)


@dataclass
class MrfUnit:
    """One dilation unit. w1, w2: torch layout `[C_out, C_in, k]` in the
    working type (the plain version's); w*_hi, w*_lo: the kernel's TF32 pair,
    float32 `[k, C_out, C_in]` (lo is zero for bfloat16 weights)."""

    w1: torch.Tensor
    b1: torch.Tensor
    w2: torch.Tensor
    b2: torch.Tensor
    k: int
    d: int
    w1_hi: torch.Tensor
    w1_lo: torch.Tensor
    w2_hi: torch.Tensor
    w2_lo: torch.Tensor


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


def _kernel_pair(w: torch.Tensor):
    hi, lo = tf32_split(w.permute(2, 0, 1))
    return hi.contiguous(), lo.contiguous()


def pack_stage(resblocks: Sequence[Sequence[tuple]], dtype: torch.dtype = torch.float32) -> MrfStage:
    """resblocks[b][u] = (w1 [C, C, k], b1 [C], w2 [C, C, k], b2 [C], d) with
    weight norm folded (torch layout `[C_out, C_in, k]`)."""
    blocks = []
    for units in resblocks:
        packed = []
        for w1, b1, w2, b2, d in units:
            w1 = w1.detach().to(dtype).contiguous()
            w2 = w2.detach().to(dtype).contiguous()
            w1_hi, w1_lo = _kernel_pair(w1)
            w2_hi, w2_lo = _kernel_pair(w2)
            packed.append(
                MrfUnit(
                    w1=w1, b1=b1.detach().float().contiguous(), w2=w2, b2=b2.detach().float().contiguous(),
                    k=int(w1.shape[-1]), d=int(d), w1_hi=w1_hi, w1_lo=w1_lo, w2_hi=w2_hi, w2_lo=w2_lo,
                )
            )
        blocks.append(packed)
    return MrfStage(blocks)


def _conv(h: torch.Tensor, w: torch.Tensor, b: torch.Tensor, d: int) -> torch.Tensor:
    k = w.shape[-1]
    y = F.conv1d(h, w, padding=(k // 2) * d, dilation=d)
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


# The kernel's output tile is BM time steps × BN output channels; a K step
# is BK input channels of one tap, and a ring of STAGES weight tiles is kept
# in shared memory (`Ring` in the CUDA source).
BM, BK, STAGES = 128, 32, 4
BN_CHOICES = (64, 32)


def smem_bytes(bn: int, bf16: bool) -> int:
    """Shared memory of one launch: 1 KB for alignment, the ring of weight
    tiles (BN rows × 32 floats, hi and lo for float32, each stage rounded up
    to 1 KB) and its 2 × STAGES mbarriers."""
    stage = (1 if bf16 else 2) * bn * BK * 4
    return 1024 + STAGES * (-(-stage // 1024) * 1024) + 2 * 8 * STAGES


def launches_per_stage(stage: MrfStage) -> int:
    return 2 * sum(len(units) for units in stage.blocks)


@dataclass
class Plan:
    bn: int
    grid: Tuple[int, int, int]

    @property
    def shape(self) -> Tuple[int, int]:
        """(BM, BN): time × output channels of a block."""
        return BM, self.bn

    @property
    def blocks(self) -> int:
        return self.grid[0] * self.grid[1] * self.grid[2]


def plan(B: int, C: int, T: int, n_sm: int) -> Plan:
    """The output tile of every launch of a stage. One block runs on an SM at
    a time, so an SM is busy for about ⌈blocks / n_sm⌉ × BM·BN; the plan takes
    the BN that makes that least, and of equal ones the wider (fewer re-reads
    of the activations)."""
    best = None
    for bn in BN_CHOICES:
        if C % bn:
            continue
        grid = (math.ceil(T / BM), C // bn, B)
        key = (math.ceil(grid[0] * grid[1] * grid[2] / n_sm) * bn, -bn)
        if best is None or key < best[0]:
            best = (key, Plan(bn, grid))
    if best is None:
        raise ValueError(f"MRF kernel needs C % 32 == 0, got C={C}")
    return best[1]


_lib = None
_lib_lock = threading.Lock()


def load_kernel():
    """The kernel's library, built from `csrc/hifigan_mrf.cu` at first use and
    loaded once; safe to call from several threads (a server's batching
    worker loads it before it serves)."""
    global _lib
    if _lib is None:
        with _lib_lock:
            if _lib is None:
                from tpu_tts_torch.ops.build import load

                lib = load("hifigan_mrf")
                p, i = ctypes.c_void_p, ctypes.c_int
                lib.hifigan_mrf_conv.argtypes = [p] * 9 + [i] * 7 + [ctypes.c_float, i, i, p]
                lib.hifigan_mrf_conv.restype = ctypes.c_int
                lib.hifigan_mrf_smem_bytes.argtypes = [i, i]
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
            want = [((C, C, u.k), stage.dtype, u.w1), ((C, C, u.k), stage.dtype, u.w2),
                    ((C,), torch.float32, u.b1), ((C,), torch.float32, u.b2)]
            want += [((u.k, C, C), torch.float32, t) for t in (u.w1_hi, u.w1_lo, u.w2_hi, u.w2_lo)]
            for shape, dt, t in want:
                if t.device != x.device or tuple(t.shape) != shape or t.dtype != dt or not t.is_contiguous():
                    raise ValueError("MRF weights must be packed by pack_stage on the input's device")


def _mrf_stack_cuda(x: torch.Tensor, stage: MrfStage) -> torch.Tensor:
    global launches
    x = x.to(stage.dtype).contiguous()
    _check(stage, x)
    lib = load_kernel()
    B, C, T = x.shape
    n_blocks = len(stage.blocks)
    bufs = [torch.empty_like(x), torch.empty_like(x)]
    mid = torch.empty(x.shape, dtype=torch.float32, device=x.device)
    acc = torch.empty(x.shape, dtype=torch.float32, device=x.device) if n_blocks > 1 else None
    y = torch.empty_like(x)
    pl = plan(B, C, T, torch.cuda.get_device_properties(x.device).multi_processor_count)
    stream = torch.cuda.current_stream(x.device).cuda_stream
    is_bf16 = int(stage.dtype == torch.bfloat16)
    inv_n = 1.0 / n_blocks

    def ptr(t: Optional[torch.Tensor]):
        return t.data_ptr() if t is not None else None

    for bi, units in enumerate(stage.blocks):
        cur = x
        for ui, u in enumerate(units):
            if ui < len(units) - 1:
                mode, h_out = 0, bufs[ui % 2]
            else:
                mode, h_out = (4 if n_blocks == 1 else 1 if bi == 0 else 3 if bi == n_blocks - 1 else 2), None
            for conv, src, w_hi, w_lo, bias, d in ((1, cur, u.w1_hi, u.w1_lo, u.b1, u.d),
                                                   (2, mid, u.w2_hi, u.w2_lo, u.b2, 1)):
                err = lib.hifigan_mrf_conv(ptr(src), ptr(cur), ptr(w_hi), ptr(w_lo), ptr(bias), ptr(mid), ptr(h_out),
                                           ptr(acc), ptr(y), B, C, T, u.k, d, conv, mode, inv_n, pl.bn, is_bf16,
                                           stream)
                if err != 0:
                    raise RuntimeError(f"hifigan_mrf_conv launch failed: error {err}")
                launches += 1
            cur = h_out
    return y
