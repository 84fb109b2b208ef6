"""WaveRNN sampling loop: the CUDA kernel of `csrc/wavernn_sampler.cu` and its plain version.

Replaces `tpu_tts/ops/wavernn_pallas.py::_kernel` (launched by
`PallasWavernnSampler._run`). The loop is the whole autoregressive decode of
one `Wavernn.inference` call in 'bits' mode with the aux net: per step the
I-layer, GRU1, GRU2 (flax gate order: `hr`/`hz` without bias, `hn` with its
bias inside r⊙(…)), fc1/fc2 with ReLU, fc3 logits, then a greedy or a
Gumbel-argmax draw. The conditioning streams are precomputed as large
matrix products and zero-padded to a multiple of the time chunk, as in
`_run`; the padded steps run too and are cut afterwards.

Random numbers are the JAX kernel's interpret-mode counter hash, keyed by
(seed, t // time_chunk, t % time_chunk, class, row of the whole batch), so
the plain version on the CPU draws what the JAX package draws in interpret
mode for the same seed; the TPU's on-core generator cannot be matched.

Weights are packed from the port's `WavernnNet` (torch GRU/Linear layout,
`[out, in]`) at each `Wavernn.inference` call; that layout is also the
kernel's: the dot product of one output column reads one contiguous row.
Each launch loads every block's share of the loop weights into that block's
shared memory once and keeps it there for the whole decode (`plan`); a batch
of more rows than fit beside them is split over launches. The kernel reads
rows as float4; other widths are zero-padded to a multiple of 4 on the way
in (`pad_to_float4`), which changes no draw. `sample` takes the
kernel for CUDA tensors and the plain version for CPU tensors; nothing else
chooses between them.
"""

import ctypes
import math
from dataclasses import dataclass, fields, replace
from typing import Optional, Tuple

import torch
import torch.nn.functional as F

from tpu_tts_torch.ops import build

TIME_CHUNK = 256  # as `PallasWavernnSampler`

# kernel launches made by `sample` on CUDA tensors; read and reset by whoever
# wants to know that a run went through the kernel
launches = 0


@dataclass
class WavernnWeights:
    """The sampler's weights, `[out, in]` layout, float32, contiguous."""

    # precompute (outside the loop)
    I_cond: torch.Tensor   # [R, mel + aux]  I-layer columns of (mel, a1)
    I_b: torch.Tensor      # [R]
    w2_ia: torch.Tensor    # [3R, aux]       GRU2 input columns of a2
    b2: torch.Tensor       # [3R]            GRU2 input biases (+ hr/hz biases)
    fc1_a: torch.Tensor    # [F, aux]
    fc1_b: torch.Tensor    # [F]
    fc2_a: torch.Tensor    # [F, aux]
    fc2_b: torch.Tensor    # [F]
    # loop
    w_s: torch.Tensor      # [R]             I-layer column of the previous sample
    w1_i: torch.Tensor     # [3R, R]
    b1: torch.Tensor       # [3R]
    w1_h: torch.Tensor     # [2R, R]
    w1_hn: torch.Tensor    # [R, R]
    b1_hn: torch.Tensor    # [R]
    w2_ix: torch.Tensor    # [3R, R]
    w2_h: torch.Tensor     # [2R, R]
    w2_hn: torch.Tensor    # [R, R]
    b2_hn: torch.Tensor    # [R]
    fc1: torch.Tensor      # [F, R]
    fc2: torch.Tensor      # [F, F]
    fc3: torch.Tensor      # [C, F]
    b3: torch.Tensor       # [C]

    @property
    def dims(self) -> Tuple[int, int, int]:
        """(R, F, C)."""
        return self.w1_hn.shape[0], self.fc2.shape[0], self.fc3.shape[0]


def _gru_pack(gru: torch.nn.GRU, n_x: int):
    """A torch GRU (gate rows r | z | n) → (w_i over the first n_x inputs,
    w_i over the rest, b_i, w_h (r, z), w_hn, b_hn). torch's b_hr/b_hz add to
    the input biases: both versions of the update are then flax's."""
    R = gru.hidden_size
    w_ih, w_hh = gru.weight_ih_l0.detach(), gru.weight_hh_l0.detach()
    b_ih, b_hh = gru.bias_ih_l0.detach(), gru.bias_hh_l0.detach()
    b_i = torch.cat([b_ih[: 2 * R] + b_hh[: 2 * R], b_ih[2 * R :]])
    return w_ih[:, :n_x], w_ih[:, n_x:], b_i, w_hh[: 2 * R], w_hh[2 * R :], b_hh[2 * R :]


def pack_weights(net) -> WavernnWeights:
    """Repack a port `WavernnNet` (counterpart of `from_flax_params`,
    wavernn_pallas.py:154-202)."""
    R = net.rnn1.hidden_size
    F_ = net.fc2.out_features
    w_I = net.I.weight.detach()  # [R, 1 + mel + aux]
    w1_i, _, b1, w1_h, w1_hn, b1_hn = _gru_pack(net.rnn1, R)
    w2_ix, w2_ia, b2, w2_h, w2_hn, b2_hn = _gru_pack(net.rnn2, R)
    fc1, fc2 = net.fc1.weight.detach(), net.fc2.weight.detach()
    w = WavernnWeights(
        I_cond=w_I[:, 1:], I_b=net.I.bias.detach(), w2_ia=w2_ia, b2=b2,
        fc1_a=fc1[:, R:], fc1_b=net.fc1.bias.detach(), fc2_a=fc2[:, F_:], fc2_b=net.fc2.bias.detach(),
        w_s=w_I[:, 0], w1_i=w1_i, b1=b1, w1_h=w1_h, w1_hn=w1_hn, b1_hn=b1_hn,
        w2_ix=w2_ix, w2_h=w2_h, w2_hn=w2_hn, b2_hn=b2_hn,
        fc1=fc1[:, :R], fc2=fc2[:, :F_], fc3=net.fc3.weight.detach(), b3=net.fc3.bias.detach(),
    )
    for f in fields(w):
        setattr(w, f.name, getattr(w, f.name).float().contiguous())
    return w


def precompute_streams(w: WavernnWeights, mels_up: torch.Tensor, aux: torch.Tensor,
                       time_chunk: int = TIME_CHUNK) -> Tuple[Tuple[torch.Tensor, ...], int]:
    """mels_up `[B, T, mel]`, aux `[B, T, 4·aux]` → the four streams
    `[B, T_pad, R | 3R | F | F]` zero-padded to a multiple of the chunk, and
    the chunk `min(time_chunk, T)` (wavernn_pallas.py:214-230)."""
    T = mels_up.shape[1]
    a1, a2, a3, a4 = torch.chunk(aux, 4, dim=-1)
    pre1 = torch.cat([mels_up, a1], dim=-1) @ w.I_cond.t() + w.I_b
    pre2 = a2 @ w.w2_ia.t() + w.b2
    pre3 = a3 @ w.fc1_a.t() + w.fc1_b
    pre4 = a4 @ w.fc2_a.t() + w.fc2_b
    tc = min(time_chunk, T)
    pad = (-T) % tc
    streams = tuple(F.pad(s, (0, 0, 0, pad)).contiguous() for s in (pre1, pre2, pre3, pre4))
    return streams, tc


def _mul32(h: torch.Tensor, m: int) -> torch.Tensor:
    """(h·m) mod 2³² for int64 tensors holding uint32 values, in 16-bit halves
    so no product leaves int64."""
    lo = (h & 0xFFFF) * m
    hi = ((h >> 16) * m) & 0xFFFF
    return (lo + (hi << 16)) & 0xFFFFFFFF


def gumbel_noise(seed: int, T: int, time_chunk: int, B: int, C: int, device, row0: int = 0) -> torch.Tensor:
    """`[B, T, C]` Gumbel noise of steps 0..T−1 for rows row0..row0+B−1 of
    the whole batch: the JAX kernel's portable hash (wavernn_pallas.py:116-130),
    then g = −log(−log(u + 1e-12) + 1e-12)."""
    t = torch.arange(T, dtype=torch.int64, device=device)[None, :, None]
    row = torch.arange(row0, row0 + B, dtype=torch.int64, device=device)[:, None, None]
    lane = torch.arange(C, dtype=torch.int64, device=device)[None, None, :]
    h = (seed + (t // time_chunk) * 65521 + (t % time_chunk) * 2654435761 + lane * 40503 + row * 69069) & 0xFFFFFFFF
    h = h ^ (h >> 16)
    h = _mul32(h, 2246822519)
    h = h ^ (h >> 13)
    h = _mul32(h, 3266489917)
    h = h ^ (h >> 16)
    u = ((h >> 9) | 0x3F800000).to(torch.int32).view(torch.float32) - 1.0
    return -torch.log(-torch.log(u + 1e-12) + 1e-12)


def _gru(h, xi, w_h, w_hn, b_hn):
    R = h.shape[1]
    hrz = h @ w_h.t()
    r = torch.sigmoid(xi[:, :R] + hrz[:, :R])
    z = torch.sigmoid(xi[:, R : 2 * R] + hrz[:, R:])
    n = torch.tanh(xi[:, 2 * R :] + r * (h @ w_hn.t() + b_hn))
    return (1.0 - z) * n + z * h


def sample_reference(w: WavernnWeights, streams, time_chunk: int, greedy: bool = False, seed: int = 0,
                     teacher: Optional[torch.Tensor] = None, return_scores: bool = False, row0: int = 0):
    """Plain PyTorch version of the loop: streams `[B, T_pad, ·]` → samples
    `[B, T_pad]` in [−1, 1]. The streams are rows row0..row0+B−1 of a
    larger batch (the noise is keyed by the row's index in that batch), so
    a batch split into consecutive chunks draws what it draws whole. With
    `teacher` `[B, T_pad]`, step t takes
    teacher[:, t−1] as the previous sample instead of its own draw (the
    draw is still returned); with `return_scores`, also the scores
    (logits + noise) `[B, T_pad, C]` of every step."""
    pre1, pre2, pre3, pre4 = streams
    B, T, R = pre1.shape
    C = w.fc3.shape[0]
    h1 = pre1.new_zeros(B, R)
    h2 = pre1.new_zeros(B, R)
    prev = pre1.new_zeros(B, 1)
    out = pre1.new_empty(B, T)
    scores = pre1.new_empty(B, T, C) if return_scores else None
    noise = None if greedy else gumbel_noise(seed, T, time_chunk, B, C, pre1.device, row0)
    for t in range(T):
        x = prev * w.w_s + pre1[:, t]
        h1 = _gru(h1, x @ w.w1_i.t() + w.b1, w.w1_h, w.w1_hn, w.b1_hn)
        x = x + h1
        h2 = _gru(h2, x @ w.w2_ix.t() + pre2[:, t], w.w2_h, w.w2_hn, w.b2_hn)
        x = x + h2
        x = torch.relu(x @ w.fc1.t() + pre3[:, t])
        x = torch.relu(x @ w.fc2.t() + pre4[:, t])
        s = x @ w.fc3.t() + w.b3
        if noise is not None:
            s = s + noise[:, t]
        if scores is not None:
            scores[:, t] = s
        out[:, t] = 2.0 * torch.argmax(s, dim=-1).float() / (C - 1.0) - 1.0
        prev = (out[:, t] if teacher is None else teacher[:, t])[:, None]
    return (out, scores) if return_scores else out


def score_gap(w: WavernnWeights, streams, time_chunk: int, samples: torch.Tensor, greedy: bool = False,
              seed: int = 0) -> torch.Tensor:
    """How far each draw of `samples` `[B, T_pad]` (from the kernel, say)
    falls below the best score at its step, `[B, T_pad]`: the plain version
    rerun with `samples` as the previous samples recomputes every step's
    scores (logits + the same noise). A free-running comparison could part
    after one near-tie flip; this one holds each step to its own scores."""
    C = w.fc3.shape[0]
    _, scores = sample_reference(w, streams, time_chunk, greedy, seed, teacher=samples, return_scores=True)
    idx = torch.round((samples + 1.0) * (C - 1) / 2.0).long().clamp(0, C - 1)
    return scores.max(dim=-1).values - scores.gather(-1, idx[..., None])[..., 0]


def sample(w: WavernnWeights, streams, time_chunk: int, greedy: bool = False, seed: int = 0) -> torch.Tensor:
    """The sampling loop: the CUDA kernel for CUDA streams (one launch for
    every `rows_per_launch` rows), the plain version for CPU streams. Returns
    `[B, T_pad]`."""
    dev = streams[0].device
    if dev.type == "cpu":
        return sample_reference(w, streams, time_chunk, greedy, seed)
    if dev.type != "cuda":
        raise ValueError(f"the WaveRNN sampler runs on cuda or cpu tensors, got {dev}")
    return _sample_cuda(w, streams, time_chunk, greedy, seed)


# Output columns a block takes in the widest phase: the grid is
# ⌈max(R, F, C) / COLS⌉ blocks (at most one a streaming multiprocessor).
COLS = 4


@dataclass(frozen=True)
class Plan:
    """How K2 runs at widths (R, F, C) on a card with a given number of SMs.

    Block g owns columns g·nR … of both GRUs, g·nF … of fc1 and fc2 and
    g·nC … of fc3 for the whole launch. With `weights_shared` it holds those
    columns' weight rows in shared memory (loaded once a launch) beside the
    staged input vectors of every row; else it reads them from global memory.
    `rows_per_launch` is the most batch rows whose staging fits beside them.
    The layout is `smem_bytes` of csrc/wavernn_sampler.cu."""

    R: int
    F: int
    C: int
    grid: int
    weights_shared: bool
    rows_per_launch: int

    @property
    def cols(self) -> Tuple[int, int, int]:
        """(nR, nF, nC): columns of each phase a block owns."""
        return tuple(-(-n // self.grid) for n in (self.R, self.F, self.C))

    def weight_floats(self) -> int:
        nR, nF, nC = self.cols
        return nR * 12 * self.R + nF * (self.R + self.F) + nC * self.F

    def smem_bytes(self, rows: int) -> int:
        """One block's dynamic shared memory for a launch of `rows` rows:
        the weights (when held), x and h staging `[rows, max(R, F)]` each,
        the previous samples (rounded up to whole float4)."""
        floats = 2 * rows * max(self.R, self.F) + -(-rows // 4) * 4
        return 4 * (floats + (self.weight_floats() if self.weights_shared else 0))


def plan(R: int, F: int, C: int, n_sm: int) -> Plan:
    """The launch plan (pure arithmetic; see `Plan`): weights in shared
    memory when a block's share fits beside at least one row of staging,
    else in global memory with the same dot products."""
    grid = min(-(-max(R, F, C) // COLS), n_sm)
    for shared in (True, False):
        p = Plan(R, F, C, grid, shared, 0)
        rows = (build.SMEM_LIMIT // 4 - (p.weight_floats() if shared else 0)) // (2 * max(R, F) + 1)
        while rows > 0 and p.smem_bytes(rows) > build.SMEM_LIMIT:
            rows -= 1
        if rows > 0:
            return Plan(R, F, C, grid, shared, rows)
    raise ValueError(f"R={R}, F={F}: not one batch row fits in a block's shared memory")


_lib = None


def _kernel():
    global _lib
    if _lib is None:
        lib = build.load("wavernn_sampler")
        p, i = ctypes.c_void_p, ctypes.c_int
        lib.wavernn_sample.argtypes = [p] * 24 + [i] * 7 + [ctypes.c_uint] + [i] * 3 + [p]
        lib.wavernn_sample.restype = ctypes.c_int
        lib.wavernn_smem_bytes.argtypes = [i] * 6
        lib.wavernn_smem_bytes.restype = ctypes.c_size_t
        lib.wavernn_barrier_probe.argtypes = [i, i, ctypes.c_size_t, p]
        lib.wavernn_barrier_probe.restype = ctypes.c_int
        lib.wavernn_error_string.argtypes = [i]
        lib.wavernn_error_string.restype = ctypes.c_char_p
        _lib = lib
    return _lib


def device_plan(w: WavernnWeights, device) -> Plan:
    """`plan` for `w`'s widths on the card `device`."""
    R, F_, C = w.dims
    return plan(R, F_, C, torch.cuda.get_device_properties(device).multi_processor_count)


def _raise_on(err: int, what: str):
    if err != 0:
        raise RuntimeError(f"{what} launch failed: cudaError {err} ({_kernel().wavernn_error_string(err).decode()})")


def _check(w: WavernnWeights, streams, time_chunk: int):
    R, F_, C = w.dims
    if len(streams) != 4:
        raise ValueError("the sampler takes the four streams of precompute_streams")
    pre1 = streams[0]
    if pre1.dim() != 3:
        raise ValueError(f"streams must be [B, T, ·], got {tuple(pre1.shape)}")
    B, T, _ = pre1.shape
    if T % time_chunk:
        raise ValueError(f"streams must be padded to a multiple of the time chunk {time_chunk}, got T={T}")
    for s, width in zip(streams, (R, 3 * R, F_, F_)):
        if s.dtype != torch.float32 or s.device != pre1.device or tuple(s.shape) != (B, T, width) or not s.is_contiguous():
            raise ValueError(f"stream {tuple(s.shape)} {s.dtype} on {s.device}: expected contiguous float32 "
                             f"[{B}, {T}, {width}] on {pre1.device}")
    for f in fields(w):
        t = getattr(w, f.name)
        if t.dtype != torch.float32 or t.device != pre1.device or not t.is_contiguous():
            raise ValueError(f"weight {f.name} must be contiguous float32 on {pre1.device} (pack_weights, then .to)")


def pad_to_float4(w: WavernnWeights, streams):
    """`w` and the streams with R and F zero-padded to multiples of 4, as the
    kernel reads its rows as float4. A padded unit has zero weights, biases
    and inputs, so its GRU state, x, f1 and f2 stay 0 and it adds nothing to
    any sum: the draws do not change."""
    R, F_, _ = w.dims
    dR, dF = -R % 4, -F_ % 4
    if not (dR or dF):
        return w, streams

    def grow(t, gates, d_out, d_in=None):  # [gates·n(, k)] → [gates·(n + d_out)(, k + d_in)]
        t = t.reshape(gates, -1, *t.shape[1:])
        t = F.pad(t, (0, d_out) if d_in is None else (0, d_in, 0, d_out))
        return t.reshape(-1, *t.shape[2:]).contiguous()

    loop = dict(
        w_s=grow(w.w_s, 1, dR), w1_i=grow(w.w1_i, 3, dR, dR), b1=grow(w.b1, 3, dR), w1_h=grow(w.w1_h, 2, dR, dR),
        w1_hn=grow(w.w1_hn, 1, dR, dR), b1_hn=grow(w.b1_hn, 1, dR), w2_ix=grow(w.w2_ix, 3, dR, dR),
        w2_h=grow(w.w2_h, 2, dR, dR), w2_hn=grow(w.w2_hn, 1, dR, dR), b2_hn=grow(w.b2_hn, 1, dR),
        fc1=grow(w.fc1, 1, dF, dR), fc2=grow(w.fc2, 1, dF, dF), fc3=grow(w.fc3, 1, 0, dF))
    B, T, _ = streams[0].shape
    padded = tuple(F.pad(s.reshape(B, T, gates, -1), (0, d)).reshape(B, T, -1).contiguous()
                   for s, gates, d in zip(streams, (1, 3, 1, 1), (dR, dR, dF, dF)))
    return replace(w, **loop), padded


def _sample_cuda(w: WavernnWeights, streams, time_chunk: int, greedy: bool, seed: int) -> torch.Tensor:
    """One cooperative launch for each chunk of at most `rows_per_launch`
    consecutive rows (chunks of equal size, give or take one), each on its
    rows' slices of the streams and of `out`, its noise keyed by the row's
    index in the whole batch."""
    global launches
    _check(w, streams, time_chunk)
    w, streams = pad_to_float4(w, streams)
    lib = _kernel()
    R, F_, C = w.dims
    B, T, _ = streams[0].shape
    dev = streams[0].device
    out = torch.empty(B, T, device=dev)
    if B == 0:
        return out
    pl = device_plan(w, dev)
    rows = math.ceil(B / math.ceil(B / pl.rows_per_launch))
    weights = [t.data_ptr() for t in (w.w_s, w.w1_i, w.b1, w.w1_h, w.w1_hn, w.b1_hn, w.w2_ix, w.w2_h, w.w2_hn,
                                      w.b2_hn, w.fc1, w.fc2, w.fc3, w.b3)]
    stream = torch.cuda.current_stream(dev).cuda_stream
    for b0 in range(0, B, rows):
        nb = min(rows, B - b0)
        h1 = torch.zeros(2, nb, R, device=dev)  # double-buffered state, buffer 0 zero on entry
        h2 = torch.zeros(2, nb, R, device=dev)
        scratch = [h1, h2, torch.empty(nb, F_, device=dev), torch.empty(nb, F_, device=dev),
                   torch.empty(nb, C, device=dev), out[b0 : b0 + nb]]
        err = lib.wavernn_sample(*[s[b0 : b0 + nb].data_ptr() for s in streams], *weights,
                                 *[t.data_ptr() for t in scratch], nb, T, R, F_, C, time_chunk, int(greedy),
                                 seed & 0xFFFFFFFF, b0, pl.grid, int(pl.weights_shared), stream)
        _raise_on(err, "wavernn_sample")
        launches += 1
    return out


def barrier_probe(w: WavernnWeights, B: int, T: int, device) -> None:
    """Launch the barrier probe of csrc/wavernn_sampler.cu: only the five
    grid barriers a step of K2, for T steps, at the grid, block size and
    shared memory K2 takes for B rows at `w`'s widths. Not counted in
    `launches`; it samples nothing."""
    pl = device_plan(w, device)
    stream = torch.cuda.current_stream(device).cuda_stream
    _raise_on(_kernel().wavernn_barrier_probe(T, pl.grid, pl.smem_bytes(min(B, pl.rows_per_launch)), stream),
              "wavernn_barrier_probe")
