#!/usr/bin/env python3
"""Smoke run of the PyTorch port on one NVIDIA GPU.

    python3 chip_smoke.py

Phases, each printing its own line; any failure exits non-zero without the
result line:

1. card: `nvidia-smi --query-gpu=name,power.limit --format=csv,noheader`;
2. build: every CUDA kernel of the port, from `tpu_tts_torch/csrc/`, one nvcc
   per source, all started together;
3. K1 (`hifigan_mrf`): the count of tensor-core instructions in its SASS
   (`kernel hifigan_mrf sass:`, cuobjdump; it fails without any), then the
   kernel against its plain PyTorch version at the four VITS stage shapes,
   in float32 and bfloat16, with the planned tile and launches of each
   shape, its time, the plain version's time and the least time the card
   could take on the kernel's route (3×TF32 for float32, bf16 tensor cores
   for bfloat16) and on the CUDA cores (CUDA events);
4. K2 (`wavernn_sampler`) against its plain version at the served shape
   (B = 5 folds, T = 11776 steps, R = F = C = 512), greedy and sampled: the
   plain version, teacher-forced with the kernel's samples, recomputes every
   step's scores and each draw of the kernel must score within 1e-4 of that
   step's best; the share of steps on which the free-running outputs agree;
   the kernel's time (and per step), the plain version's and the bound;
   the plan must hold the weights in shared memory; then a batch of
   more rows than one launch takes (T = 512), split over
   ⌈B / rows_per_launch⌉ launches and held to the same gap; then the
   barrier probe: the five grid barriers a step alone, at K2's grid, for
   the served T steps (`barrier_us_per_step`);
5. VITS slice: a full-width default VITS with random weights from a seed,
   saved as a state_dict + config.json, served by the port's `/api/tts`
   server on 127.0.0.1; three requests of about 20, 80 and 200 characters,
   each checked (HTTP 200, a WAV body, not silent, the expected length) and
   each required to launch K1; then the served model's waveform against the
   same model with the plain MRF version, on a short input, and a
   torch.profiler breakdown of one request;
6. Glow-TTS + WaveRNN slice: a full-width default Glow-TTS and a full-width
   WaveRNN (9-bit mu-law) with random weights from a seed, served the same
   way with `--vocoder_path`; the same three requests and checks, each
   sentence required to launch K2 once; a profile of one request;
7. K1 at B = 8: the four VITS stage shapes at BATCH_MEL_FRAMES mel frames a
   row, float32 against the plain version, with tile, blocks, launches,
   times and bound as in phase 3;
8. VITS batched serving: the full-width VITS with the English phoneme front
   end (`en_rules`), saved as a Coqui-format checkpoint, served through the
   micro-batcher: 8 concurrent requests of 15 sentences in all, each reply
   checked (HTTP 200, a WAV body, not silent, the length the batch's
   per-row `y_lengths` give), fewer batches than requests and 72 K1
   launches per inference call; then the same 8 requests one after another
   on the locked path; the seconds of audio per wall second of each mode;
   a batched inference of 4 mixed-length rows against the plain MRF; a
   profile of one batched call of 8 rows;
9. Glow-TTS without a vocoder: one request through Griffin-Lim (60
   iterations on the host) and the silence trim;
10. the kernels line, then `{"ok": true, "device": {...}}` as the last line.

Each serving phase's requests are a main path: the launch counts are set to
0 just before them and read just after. Phases 5 and 6 take the locked
path (the batcher detached), as before the batcher was ported.

It needs the repository beside it and a CUDA device; without either it exits
non-zero. It imports nothing of JAX or of the JAX package.
"""

import argparse
import io
import json
import os
import subprocess
import sys
import tempfile
import threading
import time
import traceback
import urllib.error
import urllib.parse
import urllib.request

# Published H100 SXM peaks (dense): float32 outside the tensor cores, TF32
# and bf16 tensor cores, HBM3 bandwidth.
PEAK_FLOPS = {"float32": 67e12, "tf32": 495e12, "bfloat16": 989e12}
PEAK_BYTES = 3.35e12

TEXTS = [
    "Be a voice, not echo.",
    "It took me quite a long time to develop a voice, and now I will not be silent.",
    "The birch canoe slid on the smooth planks. Glue the sheet to the dark blue background. It is easy to tell "
    "the depth of a well. These days a chicken leg is a rare dish. Rice is often served in round bowls.",
]
SEED = 0
MEL_FRAMES = 256  # mel frames of the kernel check; stage C has T = MEL_FRAMES · prod(upsample factors so far)
BATCH, BATCH_MEL_FRAMES = 8, 128  # K1's batched check: B rows of BATCH_MEL_FRAMES mel frames
# the batched phase's 8 concurrent requests: 15 distinct sentences, single and multi-sentence
BATCH_REQUESTS = [
    "Be a voice, not an echo.",
    "The birch canoe slid on the smooth planks. Glue the sheet to the dark blue background. It is easy to tell "
    "the depth of a well.",
    "A king ruled the state in the early days.",
    "These days a chicken leg is a rare dish. Rice is often served in round bowls.",
    "The juice of lemons makes fine punch.",
    "The box was thrown beside the parked truck. The hogs were fed chopped corn and garbage. Four hours of steady "
    "work faced us. A large size in stockings is hard to sell.",
    "The boy was there when the sun rose.",
    "A rod is used to catch pink salmon. The source of the huge river is the clear spring.",
]
GATHER_WINDOW_S = 0.05  # the batcher's gather window in the batched phase, so the 8 requests meet
F32_TOL = 2e-4  # the bar of tests/test_hifigan_pallas.py
K2_SHAPE = dict(B=5, T=11776, R=512, F=512, C=512)  # 46-frame folds of 256 samples: 5 for a 200-frame sentence
K2_TOL = 1e-4  # score of the kernel's draw below the plain version's best, teacher-forced
K2_SPLIT_T = 512  # steps of the split check: a batch of rows_per_launch + 3 rows
# bf16: the plain version rounds each of a unit's two conv outputs and its
# residual sum to bf16 (2^-9 relative each), the kernel keeps the conv
# outputs in float32; over three units and the mean that leaves a few bf16
# ulps of the output's scale apart.
BF16_REL_TOL = 2e-2


def log(msg: str):
    print(msg, flush=True)


def card_line() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60,
    )
    return out.stdout.strip().splitlines()[0]


def cuda_ms(fn, iters: int) -> float:
    import torch

    fn()
    torch.cuda.synchronize()
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / iters


def mrf_stage_inputs(C: int, T: int, dtype, gen, B: int = 1):
    """x [B, C, T] and a packed VITS MRF stage (k 3/7/11, d 1/3/5) of random weights."""
    import torch

    from tpu_tts_torch.ops.hifigan_mrf import pack_stage

    def rnd(*shape, scale=1.0):
        return torch.randn(*shape, generator=gen, device="cuda") * scale

    blocks = []
    for k in (3, 7, 11):
        blocks.append([
            (rnd(C, C, k, scale=(C * k) ** -0.5), rnd(C, scale=0.1), rnd(C, C, k, scale=(C * k) ** -0.5),
             rnd(C, scale=0.1), d)
            for d in (1, 3, 5)
        ])
    return rnd(B, C, T).to(dtype), pack_stage(blocks, dtype)


def mrf_work(stage, B: int, C: int, T: int, dtype) -> dict:
    """Operations and bytes of one MRF stack: 2·C² MACs per tap, input,
    weights and biases read once, output written once. `bound_ms` is for the
    kernel's route: float32 as three TF32 tensor-core passes, bfloat16 on the
    bf16 tensor cores; `bound_cuda_core_ms` is float32 on the CUDA cores."""
    import torch

    taps = sum(2 * u.k for units in stage.blocks for u in units)
    flops = 2.0 * B * T * C * C * taps
    item = torch.finfo(dtype).bits // 8
    weight_bytes = sum((u.w1.numel() + u.w2.numel()) * item + 8 * C for units in stage.blocks for u in units)
    nbytes = 2.0 * B * C * T * item + weight_bytes
    t_bytes = nbytes / PEAK_BYTES
    t_ops = flops / PEAK_FLOPS["bfloat16"] if dtype == torch.bfloat16 else 3 * flops / PEAK_FLOPS["tf32"]
    return {"flops": flops, "bytes": nbytes, "bound_ms": max(t_ops, t_bytes) * 1e3,
            "bound_by": "operations" if t_ops >= t_bytes else "bytes",
            "bound_cuda_core_ms": max(flops / PEAK_FLOPS["float32"], t_bytes) * 1e3}


def check_mrf_kernel() -> tuple:
    """K1's tensor-core instructions, then K1 against `mrf_stack_reference`
    at the four VITS stage shapes: (rows, sass counts)."""
    import torch

    from tpu_tts_torch.ops import build, hifigan_mrf

    sass = build.sass_counts("hifigan_mrf")
    log(f"kernel hifigan_mrf sass: {json.dumps(sass)}")
    if sass["HMMA.TF32"] + sass["HGMMA.TF32"] == 0:
        raise AssertionError(f"hifigan_mrf holds no TF32 tensor-core instruction: {sass}")
    n_sm = torch.cuda.get_device_properties(0).multi_processor_count
    gen = torch.Generator(device="cuda").manual_seed(SEED)
    rows = []
    for dtype in (torch.float32, torch.bfloat16):
        for C, up in ((256, 8), (128, 64), (64, 128), (32, 256)):
            T = MEL_FRAMES * up
            x, stage = mrf_stage_inputs(C, T, dtype, gen)
            pl = hifigan_mrf.plan(1, C, T, n_sm)
            before = hifigan_mrf.launches
            got = hifigan_mrf.mrf_stack(x, stage)
            n_launch = hifigan_mrf.launches - before
            ref = hifigan_mrf.mrf_stack_reference(x, stage)
            torch.cuda.synchronize()
            err = float((got.float() - ref.float()).abs().max())
            scale = float(ref.float().abs().max())
            tol = F32_TOL if dtype == torch.float32 else BF16_REL_TOL * scale
            ok = bool(torch.isfinite(got).all()) and err <= tol
            ms = cuda_ms(lambda: hifigan_mrf.mrf_stack(x, stage), 5)
            plain_ms = cuda_ms(lambda: hifigan_mrf.mrf_stack_reference(x, stage), 5)
            work = mrf_work(stage, 1, C, T, dtype)
            row = {"dtype": str(dtype).replace("torch.", ""), "C": C, "T": T, "max_abs_err": err, "tol": tol,
                   "max_abs_ref": scale, "tile": list(pl.shape), "grid": list(pl.grid), "launches": n_launch,
                   "ms": ms, "plain_ms": plain_ms, **work}
            rows.append(row)
            log(f"kernel hifigan_mrf {row['dtype']} C={C} T={T}: tile={pl.shape[0]}x{pl.shape[1]} "
                f"grid={pl.grid} launches={n_launch} max_abs_err={err:.3e} (tol {tol:.3e}) "
                f"ms={ms:.4f} plain_ms={plain_ms:.4f} bound_ms={work['bound_ms']:.4f} ({work['bound_by']}) "
                f"bound_cuda_core_ms={work['bound_cuda_core_ms']:.4f}")
            if n_launch != hifigan_mrf.launches_per_stage(stage):
                raise AssertionError(f"hifigan_mrf took {n_launch} launches for one stage")
            if not ok:
                raise AssertionError(f"hifigan_mrf disagrees with its plain version at {row['dtype']} C={C}: {err} > {tol}")
    log("kernel hifigan_mrf library_ms: none (no single PyTorch call computes the MRF stack)")
    return rows, sass


def check_mrf_kernel_batched() -> list:
    """K1 against `mrf_stack_reference` on the batch the micro-batcher sends:
    BATCH rows of each VITS stage shape at BATCH_MEL_FRAMES mel frames a row,
    float32, B on the grid's z axis."""
    import torch

    from tpu_tts_torch.ops import hifigan_mrf

    n_sm = torch.cuda.get_device_properties(0).multi_processor_count
    gen = torch.Generator(device="cuda").manual_seed(SEED + 1)
    rows = []
    for C, up in ((256, 8), (128, 64), (64, 128), (32, 256)):
        T = BATCH_MEL_FRAMES * up
        x, stage = mrf_stage_inputs(C, T, torch.float32, gen, B=BATCH)
        pl = hifigan_mrf.plan(BATCH, C, T, n_sm)
        before = hifigan_mrf.launches
        got = hifigan_mrf.mrf_stack(x, stage)
        n_launch = hifigan_mrf.launches - before
        ref = hifigan_mrf.mrf_stack_reference(x, stage)
        torch.cuda.synchronize()
        err = float((got - ref).abs().max())
        ms = cuda_ms(lambda: hifigan_mrf.mrf_stack(x, stage), 3)
        plain_ms = cuda_ms(lambda: hifigan_mrf.mrf_stack_reference(x, stage), 3)
        work = mrf_work(stage, BATCH, C, T, torch.float32)
        row = {"dtype": "float32", "B": BATCH, "C": C, "T": T, "max_abs_err": err, "tol": F32_TOL,
               "tile": list(pl.shape), "grid": list(pl.grid), "blocks": pl.blocks, "launches": n_launch,
               "ms": ms, "plain_ms": plain_ms, **work}
        rows.append(row)
        log(f"kernel hifigan_mrf float32 B={BATCH} C={C} T={T}: tile={pl.shape[0]}x{pl.shape[1]} grid={pl.grid} "
            f"blocks={pl.blocks} launches={n_launch} max_abs_err={err:.3e} (tol {F32_TOL:.0e}) ms={ms:.4f} "
            f"plain_ms={plain_ms:.4f} bound_ms={work['bound_ms']:.4f} ({work['bound_by']}) "
            f"bound_cuda_core_ms={work['bound_cuda_core_ms']:.4f}")
        if n_launch != hifigan_mrf.launches_per_stage(stage):
            raise AssertionError(f"hifigan_mrf took {n_launch} launches for one stage at B={BATCH}")
        if not bool(torch.isfinite(got).all()) or err > F32_TOL:
            raise AssertionError(f"hifigan_mrf disagrees with its plain version at B={BATCH} C={C}: {err} > {F32_TOL}")
    log(f"kernel hifigan_mrf B={BATCH} sum: ms={sum(r['ms'] for r in rows):.4f} "
        f"plain_ms={sum(r['plain_ms'] for r in rows):.4f} bound_ms={sum(r['bound_ms'] for r in rows):.4f}")
    return rows


def wavernn_work(w, B: int, T: int) -> dict:
    """Operations and bytes of one sampling loop: 2·(12R² + RF + F² + FC)
    per row and step; the four streams and the weights read once, the
    samples written once."""
    R, F, C = w.dims
    flops = 2.0 * B * T * (12 * R * R + R * F + F * F + F * C)
    loop = ("w_s", "w1_i", "b1", "w1_h", "w1_hn", "b1_hn", "w2_ix", "w2_h", "w2_hn", "b2_hn", "fc1", "fc2", "fc3", "b3")
    nbytes = 4.0 * B * T * (4 * R + 2 * F) + 4.0 * sum(getattr(w, n).numel() for n in loop) + 4.0 * B * T
    t_ops, t_bytes = flops / PEAK_FLOPS["float32"], nbytes / PEAK_BYTES
    return {"flops": flops, "bytes": nbytes, "bound_ms": max(t_ops, t_bytes) * 1e3,
            "bound_by": "operations" if t_ops >= t_bytes else "bytes"}


def wavernn_inputs(B: int, T: int, R: int, F: int, C: int):
    """A full-width WaveRNN cell with weights from SEED, packed on the card,
    and the streams of random conditioning for B rows of T steps."""
    import torch

    from tpu_tts_torch.ops import wavernn_sampler
    from tpu_tts_torch.vocoder.models.wavernn import WavernnArgs, WavernnNet

    torch.manual_seed(SEED)
    args = WavernnArgs(rnn_dims=R, fc_dims=F, mode=str(C.bit_length() - 1))
    w = wavernn_sampler.pack_weights(WavernnNet(args).cuda())
    gen = torch.Generator(device="cuda").manual_seed(SEED)
    mels_up = torch.randn(B, T, args.feat_dims, generator=gen, device="cuda")
    aux = torch.randn(B, T, args.res_out_dims, generator=gen, device="cuda")
    return w, *wavernn_sampler.precompute_streams(w, mels_up, aux)


def check_wavernn_split(R: int, F: int, C: int) -> dict:
    """A sampled batch of rows_per_launch + 3 rows at the served widths: it
    must take ⌈B / rows_per_launch⌉ launches and every draw must score within
    K2_TOL of the plain version's best, teacher-forced."""
    import math

    import torch

    from tpu_tts_torch.ops import wavernn_sampler

    pl = wavernn_sampler.plan(R, F, C, torch.cuda.get_device_properties(0).multi_processor_count)
    B = pl.rows_per_launch + 3
    w, streams, tc = wavernn_inputs(B, K2_SPLIT_T, R, F, C)
    before = wavernn_sampler.launches
    got = wavernn_sampler.sample(w, streams, tc, greedy=False, seed=SEED)
    torch.cuda.synchronize()
    n = wavernn_sampler.launches - before
    gap = float(wavernn_sampler.score_gap(w, streams, tc, got, seed=SEED).max())
    row = {"B": B, "T": streams[0].shape[1], "rows_per_launch": pl.rows_per_launch, "launches": n,
           "max_score_gap": gap}
    log(f"kernel wavernn_sampler split B={B} T={row['T']}: launches={n} (rows_per_launch {pl.rows_per_launch}) "
        f"max_score_gap={gap:.3e} (tol {K2_TOL:.0e})")
    if n != math.ceil(B / pl.rows_per_launch) or not math.isfinite(gap) or gap > K2_TOL:
        raise AssertionError(f"wavernn_sampler split over launches failed: {row}")
    return row


def check_wavernn_kernel() -> list:
    """K2 against `sample_reference` at the served shape, greedy and sampled,
    its weights held in shared memory; then the split check and the barrier
    probe."""
    import torch

    from tpu_tts_torch.ops import wavernn_sampler

    B, T, R, F, C = (K2_SHAPE[k] for k in "BTRFC")
    w, streams, tc = wavernn_inputs(B, T, R, F, C)
    pl = wavernn_sampler.device_plan(w, "cuda")
    if not pl.weights_shared:
        raise AssertionError(f"K2's plan reads its weights from global memory at the served widths: {pl}")
    work = wavernn_work(w, B, streams[0].shape[1])
    rows = []
    for greedy in (True, False):
        mode = "greedy" if greedy else "sampled"
        got = wavernn_sampler.sample(w, streams, tc, greedy=greedy, seed=SEED)
        gap = wavernn_sampler.score_gap(w, streams, tc, got, greedy=greedy, seed=SEED)
        start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        start.record()
        free = wavernn_sampler.sample_reference(w, streams, tc, greedy=greedy, seed=SEED)
        end.record()
        torch.cuda.synchronize()
        plain_ms = start.elapsed_time(end)
        ms = cuda_ms(lambda: wavernn_sampler.sample(w, streams, tc, greedy=greedy, seed=SEED), 3)
        row = {"mode": mode, "B": B, "T": streams[0].shape[1], "R": R, "F": F, "C": C,
               "max_score_gap": float(gap.max()), "tol": K2_TOL,
               "free_running_agree_share": float((got == free).float().mean()),
               "distinct_samples": int(torch.unique(got).numel()),
               "ms": ms, "ms_per_step": ms / streams[0].shape[1], "plain_ms": plain_ms, **work}
        rows.append(row)
        log(f"kernel wavernn_sampler {mode} B={B} T={row['T']} R={R} F={F} C={C}: max_score_gap={row['max_score_gap']:.3e} "
            f"(tol {K2_TOL:.0e}) free_running_agree_share={row['free_running_agree_share']:.4f} "
            f"ms={ms:.4f} ms_per_step={row['ms_per_step']:.6f} plain_ms={plain_ms:.4f} "
            f"bound_ms={work['bound_ms']:.4f} ({work['bound_by']})")
        if not torch.isfinite(gap).all() or row["max_score_gap"] > K2_TOL or row["distinct_samples"] < 10:
            raise AssertionError(f"wavernn_sampler disagrees with its plain version ({mode}): {row}")
    split = check_wavernn_split(R, F, C)
    T_pad = streams[0].shape[1]
    probe_ms = cuda_ms(lambda: wavernn_sampler.barrier_probe(w, B, T_pad, "cuda"), 3)
    for row in rows:
        row.update(rows_per_launch=pl.rows_per_launch, weights_in="shared" if pl.weights_shared else "global",
                   grid=pl.grid, barrier_us_per_step=probe_ms * 1e3 / T_pad, split=split)
    log(f"kernel wavernn_sampler plan: grid={pl.grid} weights_in={rows[0]['weights_in']} "
        f"rows_per_launch={pl.rows_per_launch}; barrier probe: {probe_ms:.4f} ms for {T_pad} steps = "
        f"{rows[0]['barrier_us_per_step']:.4f} us a step")
    log("kernel wavernn_sampler library_ms: none (no single PyTorch call computes the autoregressive sampling loop)")
    return rows


def save_model(tmp: str, device: str = "cuda", config=None, coqui: bool = False):
    """A full-width VITS (the default `VitsConfig` unless `config` is given)
    with seeded random weights → (checkpoint, config.json). The checkpoint is
    the net's state_dict, or with `coqui` a Coqui-format training checkpoint:
    `{"model": ..., "step": ...}` holding a discriminator tensor the
    inference net has no place for."""
    import torch

    from tpu_tts_torch.configs.vits_config import VitsConfig
    from tpu_tts_torch.layers.common import WeightNorm
    from tpu_tts_torch.models.vits import Vits

    torch.manual_seed(SEED)
    config = VitsConfig() if config is None else config
    model = Vits.init_from_config(config, device=device)
    # the decoder's convs are redrawn with unit gain (transposed convs over the
    # C_in·k/stride taps that reach an output, resblock convs at half that),
    # so the random decoder neither saturates its tanh nor fades to silence
    dec = model.net.waveform_decoder
    with torch.no_grad():
        for up in dec.ups:
            wn = up.parametrizations["weight"]
            c_in, _, k = wn.original1.shape
            wn.original1.normal_(0.0, (c_in * k / up.stride) ** -0.5)
            wn.original0.copy_(wn._norm(wn.original1))
        for wn in dec.resblocks.modules():
            if isinstance(wn, WeightNorm):
                _, c_in, k = wn.original1.shape
                wn.original1.normal_(0.0, 0.5 * (c_in * k) ** -0.5)
                wn.original0.copy_(wn._norm(wn.original1))
    model_path, config_path = os.path.join(tmp, "model.pth"), os.path.join(tmp, "config.json")
    if coqui:
        sd = {**model.net.state_dict(), "disc.nets.0.conv_post.bias": torch.zeros(1, device=device)}
        torch.save({"model": sd, "step": 0, "epoch": 0}, model_path)
    else:
        torch.save(model.net.state_dict(), model_path)
    model.config.save_json(config_path)
    return {"model_path": model_path, "config_path": config_path}


def save_glow_wavernn(tmp: str, device: str = "cuda") -> dict:
    """A full-width default Glow-TTS (graphemes, English cleaners) and a
    full-width WaveRNN (9-bit mu-law) with seeded random weights, each as a
    state_dict + config.json. The flows' ActNorms and coupling `end`
    projections are drawn nonzero (else the flows are identities), the
    InvConvNear weights as random rotations, and the duration predictor's
    bias gives about 4 frames a token."""
    import torch

    from tpu_tts_torch.configs import GlowTTSConfig
    from tpu_tts_torch.layers.glow import ActNorm, CouplingBlock, InvConvNear
    from tpu_tts_torch.models.glow_tts import GlowTTS
    from tpu_tts_torch.vocoder.configs import WavernnConfig
    from tpu_tts_torch.vocoder.models.wavernn import Wavernn, WavernnArgs

    torch.manual_seed(SEED)
    glow = GlowTTS.init_from_config(GlowTTSConfig(text_cleaner="english_cleaners"), device=device)
    net = glow.net
    with torch.no_grad():
        net.encoder.emb.weight.normal_(0.0, net.encoder.hidden_channels**-0.5)
        net.encoder.duration_predictor.proj.bias.fill_(1.6)
        for flow in net.decoder.flows:
            if isinstance(flow, ActNorm):
                flow.logs.normal_(0.0, 0.1)
                flow.bias.normal_(0.0, 0.1)
            elif isinstance(flow, InvConvNear):
                q = torch.linalg.qr(torch.randn(flow.num_splits, flow.num_splits))[0]
                if torch.det(q) < 0:
                    q[:, 0] = -q[:, 0]
                flow.weight.copy_(q)
            elif isinstance(flow, CouplingBlock):
                flow.end.weight.normal_(0.0, 0.02)
                flow.end.bias.normal_(0.0, 0.02)
    vocoder = Wavernn(WavernnConfig(model_args=WavernnArgs(mode="9", mulaw=True).to_dict()), device=device)
    paths = {k: os.path.join(tmp, f) for k, f in (("model_path", "glow.pth"), ("config_path", "glow.json"),
                                                  ("vocoder_path", "wavernn.pth"),
                                                  ("vocoder_config_path", "wavernn.json"))}
    torch.save(net.state_dict(), paths["model_path"])
    glow.config.save_json(paths["config_path"])
    torch.save(vocoder.net.state_dict(), paths["vocoder_path"])
    vocoder.config.save_json(paths["vocoder_config_path"])
    return paths


def post(url: str, text: str):
    return urllib.request.Request(url, data=json.dumps({"text": text}).encode(), method="POST",
                                  headers={"Content-Type": "application/json"})


def serve_and_check(paths: dict, kernel, per_sentence: bool = False, check=None, device: str = "cuda") -> int:
    """Three /api/tts requests through the port's server, each checked and
    each required to launch `kernel` (a wrapper module with a `launches`
    count) — once per sentence if `per_sentence`; then `check(model)` and a
    profile of one request. Returns the kernel's launches in the three
    requests (the main path)."""
    import numpy as np
    import scipy.io.wavfile

    from tpu_tts_torch.infer.synthesizer import SENTENCE_GAP
    from tpu_tts_torch.server.server import TTSHandler, create_server

    args = argparse.Namespace(**paths, device=device, host="127.0.0.1", port=0)
    server = create_server(args)
    if TTSHandler._batcher is not None:  # the locked path, as these phases ran before the batcher
        TTSHandler._batcher.close()
        TTSHandler._batcher = None
    thread = threading.Thread(target=server.serve_forever, daemon=True)
    thread.start()
    base = f"http://127.0.0.1:{server.server_address[1]}"
    name = kernel.__name__.rsplit(".", 1)[-1]
    try:
        synth = TTSHandler.synthesizer
        replies = []
        kernel.launches = 0
        for i, text in enumerate(TEXTS):
            before = kernel.launches
            req = post(f"{base}/api/tts", text) if i == 1 else f"{base}/api/tts?text={urllib.parse.quote(text)}"
            t0 = time.perf_counter()
            try:
                with urllib.request.urlopen(req, timeout=600) as r:
                    status, body = r.status, r.read()
            except urllib.error.HTTPError as e:
                raise AssertionError(f"/api/tts gave HTTP {e.code} for {text!r}: {e.read()[:2000]!r}") from None
            latency = time.perf_counter() - t0
            replies.append((text, status, body, latency, kernel.launches - before))
        launches = kernel.launches

        model = synth.tts_model
        for text, status, body, latency, n in replies:
            if status != 200 or body[:4] != b"RIFF" or body[8:12] != b"WAVE":
                raise AssertionError(f"/api/tts gave status {status} and no WAV body for {text!r}")
            sr, pcm = scipy.io.wavfile.read(io.BytesIO(body))
            sentences = synth.split_into_sentences(text)
            frames = [int(model.inference(model.tokenizer.text_to_ids(s))["y_lengths"][0]) for s in sentences]
            expected = sum(f * model.ap.hop_length for f in frames) + SENTENCE_GAP * len(sentences)
            wav = pcm.astype(np.float32)
            if not np.isfinite(wav).all() or np.abs(wav).max() == 0:
                raise AssertionError(f"silent or non-finite reply for {text!r}")
            # with do_trim_silence a sentence may end at ap.find_endpoint, which
            # keeps at least its first two quarter-windows of 0.8 s
            least = expected
            if getattr(synth.tts_config.audio, "do_trim_silence", False):
                keep = 2 * int(model.ap.sample_rate * 0.8 / 4)
                least = sum(min(f * model.ap.hop_length, keep) for f in frames) + SENTENCE_GAP * len(sentences)
            if not least <= len(pcm) <= expected or sr != synth.output_sample_rate:
                raise AssertionError(f"reply of {len(pcm)} samples at {sr} Hz, expected {least}..{expected} at "
                                     f"{synth.output_sample_rate}")
            if n <= 0 or (per_sentence and n != len(sentences)):
                raise AssertionError(f"request {text!r} of {len(sentences)} sentences launched {name} {n} times")
            log(f"request chars={len(text)} sentences={len(sentences)} frames={frames} samples={len(pcm)} "
                f"trimmed={expected - len(pcm)} latency_s={latency:.4f} {name}_launches={n}")
        with urllib.request.urlopen(f"{base}/details", timeout=60) as r:
            json.loads(r.read())
        if check is not None:
            check(model)
        profile_request(synth, TEXTS[1])
        return launches
    finally:
        server.shutdown()
        server.server_close()
        thread.join(timeout=30)


def profile_request(synth, text: str, top: int = 8):
    """Where one request's time goes: wall time of `Synthesizer.tts`, the
    device's busy time (sum of kernel times, one stream) and its idle share,
    and the kernels with the most device time (torch.profiler)."""
    profile_call(lambda: synth.tts(text), {
        "model": synth.tts_config.model, "vocoder": synth.vocoder_config.model if synth.vocoder_config else None,
        "chars": len(text)}, top)


def profile_call(fn, info: dict, top: int = 8) -> dict:
    """`fn()` once to warm up, then once under torch.profiler: its wall time,
    the device's busy time (sum of kernel times) and idle share, and the
    kernels with the most device time, printed as a `profile` line after
    `info`."""
    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        wall_ms = (time.perf_counter() - t0) * 1e3
    per_kernel = {}
    for e in prof.key_averages():
        if getattr(e, "device_type", None) != DeviceType.CUDA:
            continue  # host-side ops also carry the time of the kernels they launched
        us = getattr(e, "self_device_time_total", None)
        us = getattr(e, "self_cuda_time_total", 0) if us is None else us
        if us > 0:
            per_kernel[e.key] = per_kernel.get(e.key, 0.0) + us / 1e3
    busy_ms = sum(per_kernel.values())
    ranked = sorted(per_kernel.items(), key=lambda kv: -kv[1])[:top]
    result = {**info, "wall_ms": wall_ms, "device_busy_ms": busy_ms,
              "device_idle_share": 1.0 - busy_ms / wall_ms if busy_ms else None,
              "top_kernels_ms": [[name[:80], ms] for name, ms in ranked]}
    log("profile " + json.dumps(result))
    return result


def check_against_plain(model, tol: float = 1e-3):
    """The served model's waveform for a short input, kernel path against the
    same model with the plain MRF version (float32, TF32 off). The tolerance
    covers four stages of float32 sums taken in another order."""
    import torch

    from tpu_tts_torch.ops import hifigan_mrf
    from tpu_tts_torch.vocoder.models import hifigan_generator

    ids = model.tokenizer.text_to_ids(TEXTS[0])
    got = model.inference(ids)["model_outputs"]
    hifigan_generator.mrf_stack = hifigan_mrf.mrf_stack_reference
    try:
        ref = model.inference(ids)["model_outputs"]
    finally:
        hifigan_generator.mrf_stack = hifigan_mrf.mrf_stack
    err = float((got - ref).abs().max())
    saturated = float((ref.abs() > 0.999).float().mean())
    rms = float(ref.pow(2).mean().sqrt())
    log(f"slice waveform vs plain MRF: shape={tuple(got.shape)} max_abs_err={err:.3e} (tol {tol:.0e}) "
        f"rms={rms:.4f} saturated={saturated:.4f}")
    if not torch.isfinite(got).all() or err > tol:
        raise AssertionError(f"served waveform disagrees with the plain path: {err} > {tol}")
    if rms < 1e-3 or saturated > 0.5:
        raise AssertionError(f"served waveform is near silent or saturated (rms {rms}, saturated {saturated})")


def record_inference(model):
    """Wrap `model.inference` so that each call's rows are recorded: the
    token ids of each row (to its `x_lengths`), its `y_lengths`, and the
    call's padded `x` and `x_lengths` as given. Returns the list of calls and
    a function that takes the wrapper off."""
    import numpy as np

    calls = []
    orig = model.inference

    def recording(x, aux_input=None, **kwargs):
        out = orig(x, aux_input=aux_input, **kwargs)
        ids = np.asarray(x).reshape(-1, np.asarray(x).shape[-1])
        x_lengths = np.asarray((aux_input or {}).get("x_lengths", [ids.shape[1]] * ids.shape[0]))
        calls.append(([tuple(ids[i, : x_lengths[i]].tolist()) for i in range(len(ids))],
                      out["y_lengths"].cpu().numpy().tolist(), ids.copy(), x_lengths.copy()))
        return out

    model.inference = recording
    return calls, lambda: model.__dict__.pop("inference", None)


def check_replies(synth, replies, calls) -> int:
    """Each reply: HTTP 200, a WAV body at the synthesizer's rate, finite and
    not silent, of the length the recorded calls give its sentences (each
    sentence's row: `y_lengths · hop`, then the gap). Returns the samples of
    speech, the gaps left out."""
    import numpy as np
    import scipy.io.wavfile

    from tpu_tts_torch.infer.synthesizer import SENTENCE_GAP

    model, total = synth.tts_model, 0
    rows = {}
    for ids, y_lengths, *_ in calls:  # a sentence's own row comes before the pad rows that repeat it
        for row, y in zip(ids, y_lengths):
            rows.setdefault(row, y)
    for text, status, body in replies:
        if status != 200 or body[:4] != b"RIFF" or body[8:12] != b"WAVE":
            raise AssertionError(f"/api/tts gave status {status} and no WAV body for {text!r}")
        sr, pcm = scipy.io.wavfile.read(io.BytesIO(body))
        frames = [rows[tuple(int(t) for t in model.tokenizer.text_to_ids(s))] for s in synth.split_into_sentences(text)]
        expected = sum(f * model.ap.hop_length for f in frames) + SENTENCE_GAP * len(frames)
        wav = pcm.astype(np.float32)
        if not np.isfinite(wav).all() or np.abs(wav).max() == 0:
            raise AssertionError(f"silent or non-finite reply for {text!r}")
        if len(pcm) != expected or sr != synth.output_sample_rate:
            raise AssertionError(f"reply of {len(pcm)} samples at {sr} Hz for {text!r}, expected {expected} at "
                                 f"{synth.output_sample_rate}")
        total += len(pcm) - SENTENCE_GAP * len(frames)
    return total


def serve_batched(paths: dict, device: str = "cuda") -> dict:
    """The VITS batched serving phase: BATCH_REQUESTS sent together through the
    micro-batcher, then one after another on the locked path; then a batched
    call against the plain MRF and a profile of one batched call of 8 rows."""
    import numpy as np

    from tpu_tts_torch.ops import hifigan_mrf
    from tpu_tts_torch.server.server import TTSHandler, create_server

    server = create_server(argparse.Namespace(**paths, device=device, host="127.0.0.1", port=0, max_batch=16))
    batcher = TTSHandler._batcher
    if batcher is None:
        raise AssertionError("the server did not put VITS behind the micro-batcher")
    batcher.gather_window_s = GATHER_WINDOW_S
    thread = threading.Thread(target=server.serve_forever, daemon=True)
    thread.start()
    url = f"http://127.0.0.1:{server.server_address[1]}/api/tts"
    synth = TTSHandler.synthesizer
    model = synth.tts_model
    dec = model.net.waveform_decoder
    per_call = sum(hifigan_mrf.launches_per_stage(dec.mrf_stage(i)) for i in range(dec.num_upsamples))
    sentences = [synth.split_into_sentences(t) for t in BATCH_REQUESTS]
    n_sentences = sum(len(s) for s in sentences)

    def request(text):
        try:
            with urllib.request.urlopen(post(url, text), timeout=600) as r:
                return text, r.status, r.read()
        except urllib.error.HTTPError as e:
            raise AssertionError(f"/api/tts gave HTTP {e.code} for {text!r}: {e.read()[:2000]!r}") from None

    def concurrently():
        replies = [None] * len(BATCH_REQUESTS)
        errors = []

        def go(i):
            try:
                replies[i] = request(BATCH_REQUESTS[i])
            except Exception as e:  # raised below, in the main thread
                errors.append(e)

        threads = [threading.Thread(target=go, args=(i,)) for i in range(len(BATCH_REQUESTS))]
        for t in threads:
            t.start()
        for t in threads:
            t.join(timeout=600)
        if errors:
            raise errors[0]
        return replies

    try:
        concurrently()  # warm-up round, not counted
        calls, unwrap = record_inference(model)
        b0, r0, s0 = batcher.batches_run, batcher.rows_run, len(batcher.batch_sizes)
        hifigan_mrf.launches = 0
        t0 = time.perf_counter()
        replies = concurrently()
        wall_b = time.perf_counter() - t0
        launches_b = hifigan_mrf.launches
        samples_b = check_replies(synth, replies, calls)
        batches, rows, sizes = batcher.batches_run - b0, batcher.rows_run - r0, batcher.batch_sizes[s0:]
        if batches >= len(BATCH_REQUESTS) or batches != len(calls) or rows != n_sentences:
            raise AssertionError(f"{len(BATCH_REQUESTS)} concurrent requests of {n_sentences} sentences ran "
                                 f"{batches} batches of {rows} rows ({len(calls)} inference calls)")
        if launches_b != per_call * len(calls):
            raise AssertionError(f"the batched requests launched hifigan_mrf {launches_b} times for {len(calls)} "
                                 f"inference calls ({per_call} a call)")

        served_x, served_lengths = max(calls, key=lambda c: len(c[0]))[2:]  # the largest batch served

        TTSHandler._batcher = None  # the locked path
        for text in BATCH_REQUESTS:  # warm-up round at the B = 1 shapes, not counted
            request(text)
        calls.clear()
        hifigan_mrf.launches = 0
        t0 = time.perf_counter()
        serial = [request(text) for text in BATCH_REQUESTS]
        wall_s = time.perf_counter() - t0
        launches_s = hifigan_mrf.launches
        samples_s = check_replies(synth, serial, calls)
        unwrap()
        if launches_s != per_call * n_sentences or len(calls) != n_sentences:
            raise AssertionError(f"the serial requests launched hifigan_mrf {launches_s} times in {len(calls)} calls")
        sr = synth.output_sample_rate  # audio_s: the replies' speech, the gaps between sentences left out
        modes = {
            "batched": {"wall_s": wall_b, "audio_s": samples_b / sr, "audio_s_per_wall_s": samples_b / sr / wall_b,
                        "batches_run": batches, "rows_run": rows, "padded_B": sizes, "hifigan_mrf_launches": launches_b,
                        "gather_window_s": GATHER_WINDOW_S},
            "serial": {"wall_s": wall_s, "audio_s": samples_s / sr, "audio_s_per_wall_s": samples_s / sr / wall_s,
                       "batches_run": 0, "rows_run": n_sentences, "padded_B": [1] * n_sentences,
                       "hifigan_mrf_launches": launches_s},
        }
        for mode, m in modes.items():
            log(f"serving {mode}: requests={len(BATCH_REQUESTS)} sentences={n_sentences} wall_s={m['wall_s']:.4f} "
                f"audio_s={m['audio_s']:.4f} audio_s_per_wall_s={m['audio_s_per_wall_s']:.4f} "
                f"batches_run={m['batches_run']} rows_run={m['rows_run']} padded_B={m['padded_B']} "
                f"hifigan_mrf_launches={m['hifigan_mrf_launches']}")
        ratio = modes["batched"]["audio_s_per_wall_s"] / modes["serial"]["audio_s_per_wall_s"]
        log(f"serving batched/serial audio_s_per_wall_s ratio={ratio:.4f}")

        flat = [s for sents in sentences for s in sents]
        check_batch_against_plain(model, *pad_rows(model, [flat[i] for i in (0, 1, 5, 9)]), "4 rows")
        check_batch_against_plain(model, served_x, served_lengths, "the served batch")
        x, x_lengths = pad_rows(model, flat[:8])
        aux = {"x_lengths": x_lengths}
        prof = profile_call(lambda: model.inference(x, aux_input=aux),
                            {"model": "vits", "call": "batched inference", "rows": 8, "tokens": x_lengths.tolist()})
        return {"modes": modes, "ratio": ratio, "launches": launches_b, "launches_per_batch": launches_b // batches,
                "profile": prof}
    finally:
        server.shutdown()
        server.server_close()
        thread.join(timeout=30)
        batcher.close()
        TTSHandler._batcher = None


def pad_rows(model, texts):
    """The token ids of `texts` right-padded into one batch, and their lengths."""
    import numpy as np

    ids = [model.tokenizer.text_to_ids(t) for t in texts]
    x = np.zeros((len(ids), max(len(r) for r in ids)), dtype=np.int64)
    for i, r in enumerate(ids):
        x[i, : len(r)] = r
    return x, np.array([len(r) for r in ids])


def check_batch_against_plain(model, x, x_lengths, label: str, tol: float = 1e-3):
    """One batched inference of mixed-length rows, the kernel path against the
    same model with the plain MRF version (as `check_against_plain`)."""
    import torch

    from tpu_tts_torch.ops import hifigan_mrf
    from tpu_tts_torch.vocoder.models import hifigan_generator

    aux = {"x_lengths": x_lengths}
    got = model.inference(x, aux_input=aux)
    hifigan_generator.mrf_stack = hifigan_mrf.mrf_stack_reference
    try:
        ref = model.inference(x, aux_input=aux)
    finally:
        hifigan_generator.mrf_stack = hifigan_mrf.mrf_stack
    y = got["y_lengths"].tolist()
    err = float((got["model_outputs"] - ref["model_outputs"]).abs().max())
    log(f"batched waveform vs plain MRF ({label}): rows={len(x)} tokens={aux['x_lengths'].tolist()} y_lengths={y} "
        f"shape={tuple(got['model_outputs'].shape)} max_abs_err={err:.3e} (tol {tol:.0e})")
    if y != ref["y_lengths"].tolist() or len(set(y)) < 2 or not torch.isfinite(got["model_outputs"]).all() or err > tol:
        raise AssertionError(f"the batched waveform disagrees with the plain path: {err} > {tol} or y {y}")


def glow_griffin_lim(paths: dict, device: str = "cuda") -> dict:
    """Glow-TTS without a vocoder: one request through Griffin-Lim on the host
    and the silence trim, its length after the trim and its wall time."""
    import numpy as np

    from tpu_tts_torch.infer.synthesizer import SENTENCE_GAP, Synthesizer

    synth = Synthesizer(paths["model_path"], paths["config_path"], device=device)
    model, text = synth.tts_model, TEXTS[1]
    t0 = time.perf_counter()
    wav = np.asarray(synth.tts(text), dtype=np.float32)
    wall = time.perf_counter() - t0
    frames = int(model.inference(model.tokenizer.text_to_ids(text))["y_lengths"][0])
    untrimmed = (frames - 1) * model.ap.hop_length + SENTENCE_GAP  # the iSTFT gives frames − 1 hops
    least = min(untrimmed - SENTENCE_GAP, 2 * int(model.ap.sample_rate * 0.8 / 4)) + SENTENCE_GAP
    row = {"chars": len(text), "frames": frames, "samples": len(wav), "untrimmed_samples": untrimmed,
           "trim": bool(synth.tts_config.audio.do_trim_silence), "griffin_lim_iters": model.ap.griffin_lim_iters,
           "wall_s": wall}
    log("griffin_lim request " + json.dumps(row))
    if not np.isfinite(wav).all() or np.abs(wav).max() == 0 or not least <= len(wav) <= untrimmed:
        raise AssertionError(f"Griffin-Lim reply is silent, non-finite or of the wrong length: {row}")
    return row


def main() -> int:
    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: torch.cuda.is_available() is False", file=sys.stderr)
        return 2
    here = os.path.dirname(os.path.abspath(__file__))
    if not os.path.isdir(os.path.join(here, "tpu_tts_torch")):
        print("chip_smoke: the tpu_tts_torch package is not beside this script", file=sys.stderr)
        return 2
    sys.path.insert(0, here)
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False

    from tpu_tts_torch.ops import build, hifigan_mrf, wavernn_sampler

    card = card_line()
    log(card)
    t0 = time.perf_counter()
    build.build_all(["hifigan_mrf", "wavernn_sampler"])
    log(f"build: hifigan_mrf, wavernn_sampler in {time.perf_counter() - t0:.1f} s")
    rows, sass = check_mrf_kernel()
    k2_rows = check_wavernn_kernel()
    with tempfile.TemporaryDirectory() as tmp:
        mrf_launches = serve_and_check(save_model(tmp), hifigan_mrf, check=check_against_plain)
    with tempfile.TemporaryDirectory() as tmp:
        glow_paths = save_glow_wavernn(tmp)
        k2_launches = serve_and_check(glow_paths, wavernn_sampler, per_sentence=True)
        glow_griffin_lim(glow_paths)
    b8_rows = check_mrf_kernel_batched()
    with tempfile.TemporaryDirectory() as tmp:
        from tpu_tts_torch.configs.vits_config import VitsConfig

        config = VitsConfig(use_phonemes=True, phonemizer="en_rules", phoneme_language="en",
                            text_cleaner="phoneme_cleaners")
        batched = serve_batched(save_model(tmp, config=config, coqui=True))

    f32 = [r for r in rows if r["dtype"] == "float32"]
    served = next(r for r in k2_rows if r["mode"] == "sampled")  # the mode the vocoder serves
    kernels = [{
        "name": "hifigan_mrf",
        "route": "cuda",
        "source": "tpu_tts_torch/csrc/hifigan_mrf.cu",
        "replaces": "tpu_tts/ops/hifigan_pallas.py:61",
        "launches": mrf_launches,
        # float32, summed over the four VITS stage shapes at MEL_FRAMES mel frames
        "max_abs_err": max(r["max_abs_err"] for r in f32),
        "ms": sum(r["ms"] for r in f32),
        "plain_ms": sum(r["plain_ms"] for r in f32),
        "bound_ms": sum(r["bound_ms"] for r in f32),
        "bound_by": "operations" if all(r["bound_by"] == "operations" for r in f32) else "bytes",
        "bound_cuda_core_ms": sum(r["bound_cuda_core_ms"] for r in f32),
        "library_ms": None,  # no single PyTorch call computes the MRF stack
        "sass": sass,
        "shapes": rows,
        "shapes_b8": b8_rows,
        "batched_launches": batched["launches"],
        "launches_per_batch": batched["launches_per_batch"],
    }, {
        "name": "wavernn_sampler",
        "route": "cuda",
        "source": "tpu_tts_torch/csrc/wavernn_sampler.cu",
        "replaces": "tpu_tts/ops/wavernn_pallas.py:33",
        "launches": k2_launches,
        # the draw's score below the plain version's best, teacher-forced, over both modes
        "max_abs_err": max(r["max_score_gap"] for r in k2_rows),
        "ms": served["ms"],
        "ms_per_step": served["ms_per_step"],
        "rows_per_launch": served["rows_per_launch"],
        "weights_in": served["weights_in"],
        "barrier_us_per_step": served["barrier_us_per_step"],
        "plain_ms": served["plain_ms"],
        "bound_ms": served["bound_ms"],
        "bound_by": served["bound_by"],
        "library_ms": None,  # no single PyTorch call computes the autoregressive sampling loop
        "shapes": k2_rows,
    }]
    log(json.dumps({"kernels": kernels}))
    name = torch.cuda.get_device_name(0)
    print(json.dumps({"ok": True, "device": {"platform": "gpu", "kind": name, "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    try:
        code = main()
    except Exception:
        traceback.print_exc()
        code = 1
    sys.exit(code)
