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
10. multi-speaker multilingual VITS: the full-width VITS of the multilingual
   recipe (speaker and language embeddings, the deterministic duration
   predictor, 16 kHz, `multilingual_cleaners`) with its `speakers.json` and
   `language_ids.json`, saved as a Coqui-format checkpoint and served through
   the micro-batcher: 8 concurrent requests over 4 speakers and 3 languages
   in one batch of 72 K1 launches, each reply of its row's length; then
   serially (`serving multispeaker ...` lines); the served batch against the
   plain MRF; at noise scale 0 each row of the batch against the same row
   decoded alone with its ids at the batch's decode length; two speakers
   giving different waveforms; a profile of the batched call; then one
   request to a YourTTS-shaped VITS (512-wide d-vectors from a file,
   ResBlock2, 10 text-encoder layers), which launches K1 no time;
11. XTTS-v2 at full width (GPT 30 × 1024, 16 heads, KV cache 1100, the
   perceiver's 32 latents, the HiFi-GAN decoder with `conds` through K1),
   weights from seed 0, saved as a model directory (`config.json`, a
   Coqui-key checkpoint, `speakers_xtts.pth` of two speakers) and served
   with `--max_streams 8`, token ids from a character table (no vocab
   ships): one `/api/tts_stream` request (128 tokens, chunk 20, first chunk
   8), checked for HTTP 200, chunked PCM16, sound, the length its tokens
   give and 72 K1 launches a chunk (`xtts stream single`: first-chunk ms,
   chunk cadence, audio s); 8 concurrent streams, 4 at once and 4 once the
   first audio is out, which must share rounds and be admitted mid-round
   (`xtts stream concurrent`: audio s per wall s, first-chunk p50 and max);
   on the card the decoder through K1 against the plain MRF at B = 1 and 8,
   the incremental GPT against teacher-forced, and greedy pooled streams
   replayed teacher-forced (`xtts card checks`); one `/api/tts` request
   with `speaker_wav`; profiles of a stream's chunk and a pool emission and
   the GPT's ms per step at B = 1 and 8 (`profile` lines);
12. VITS training (M6): K1's gradient guard (an eval() generator on the card
   whose parameters require grad raises, as does a CUDA input that does;
   under no_grad it launches K1); one D and one G step of a tiny VITS on
   the card against the same step on the CPU (`train card vs cpu`); then
   the default full-width VITS (its decoder redrawn at unit gain, so that
   its tanh does not saturate) at batch 32, float32, TF32 off, on 64 clips
   of 2–10 s written from a seed in LJSpeech's layout (`en_rules`
   phonemes), trained through `Trainer.fit` for 5 epochs of 2 steps: the
   ms of a step split into the D sub-step, the G sub-step and the
   optimizer updates (CUDA events), clips and seconds of audio a wall
   second, the MAS host round trip, the peak allocated memory, the first
   and last losses, every loss finite and every parameter with a nonzero
   gradient at step 2, K1 launched no time (`train steps`, `train
   losses`); one more epoch uninterrupted against the same epoch resumed
   by a new model from the checkpoint (`train resume`); a profile of one
   step; 20 steps of a fresh model on one batch with the same draws and
   dropout masks, the median mel loss of the last 10 below the first's
   (`train overfit`);
   the trained checkpoint served by `/api/tts` through K1, 72 launches,
   within 1e-3 of the plain MRF (`train serve`);
12a. mixed precision (the recipes' `mixed_precision=True`, bfloat16 compute
   on float32 parameters): one D and one G step of the tiny VITS on the card
   against the CPU, losses within 2e-2 relative, every parameter float32
   (`train mixed card vs cpu`); the default full-width VITS at the LJSpeech
   recipe's settings on phase 12's clips for 2 epochs of 2 steps: ms a step
   (D, G, updates), peak memory, finite losses, every gradient nonzero at
   step 2, K1 launched no time, beside phase 12's float32 step (`train mixed
   steps`); 2 steps at the VCTK recipe's settings, a speaker embedding over
   10 speakers (`train mixed vctk`); the bfloat16-trained checkpoint served
   through K1, 72 launches, within 1e-3 of the plain MRF (`train mixed
   serve`); the phase's wall time;
13. K1 at the XTTS decoder's chunk shapes (34 and 104 decoder frames, at
   B = 1 and 8) against the plain MRF, with its time, the plain time and
   the bound (`kernel hifigan_mrf xtts chunk ...` lines);
14. XTTS-v2 GPT fine-tuning: the full-width DVAE (seed 0) on the card
   against the CPU, and one fine-tuning loss and backward of a tiny XTTS on
   the card against the CPU (`xtts train card vs cpu`), and the same at
   mixed precision through the trainer's generic bfloat16 cast from the raw
   wavs, losses within 2e-2 (`xtts train mixed card vs cpu`); then the default
   full-width XTTS-v2 (seed 0) saved as a model directory and fine-tuned
   through `Trainer.fit` (`restore_path` its checkpoint) at the recipe's
   batch 3 and settings on clips of 2–11.6 s written from a seed, token ids
   from the character table: ms a step split into the targets (mels, DVAE
   codes), forward + backward and the update, clips and seconds of audio a
   wall second, peak memory, the losses, every trained gradient nonzero at
   step 2, K1 launched no time, the decoder and `speaker_proj`
   bit-identical (`xtts train steps`, `xtts train losses`); one more epoch
   against the same epoch resumed (`xtts train resume`); 20 steps on one
   batch (`xtts train overfit`); the run directory served by
   `/api/tts_stream` as a model directory, 72 K1 launches a chunk, the
   decoder within 1e-3 of the plain MRF (`xtts train serve`);
15. multilingual VITS training: the multilingual recipe's full-width VITS
   (4 speakers, 3 languages, 16 kHz, the deterministic duration predictor,
   the language-weighted sampler) at batch 32 on clips in M-AILABS's layout
   written from a seed: losses finite, every parameter (`emb_g` and `emb_l`
   among them) with a nonzero gradient at step 2, K1 launched no time, the
   sampler's language shares (`train multispeaker`); then voice conversion
   from the trained checkpoint through `Synthesizer.tts(reference_wav=,
   reference_speaker_name=)`: 72 K1 launches, within 1e-3 of the plain MRF,
   the source's spectrogram frames × hop long, another target speaker
   another waveform (`vc serve`);
16. the speaker encoder: the VCTK ResNet recipe's encoder (64 → 512, layers
   (3, 4, 6, 3), filters 32–256, 16 kHz, 64 mels) trained through
   `bin/train_encoder` for 3 steps of 100 speakers × 4 crops of 2 s on
   clips in VCTK's layout, one seeded voice a speaker (`encoder train`);
   its step on one batch timed with CUDA events, peak memory, 20 steps on
   that batch lowering the loss (`encoder steps`); a tiny ResNet and LSTM
   on the card against the CPU within 1e-4 (`encoder card vs cpu`);
   `bin/compute_embeddings` over the 400 clips into a d-vector file and
   `bin/eval_encoder`'s intra/inter-speaker margin (`encoder embeddings`);
17. voice cloning through K1: a full-width XTTS-v2 from seed 0 in Coqui's
   layout (the decoder-side ResNet speaker encoder in place of
   `speaker_proj`) saved as a model directory and served with
   `--max_streams 8`: one `/api/tts_stream?speaker_wav=` stream, 72 K1
   launches a chunk, the decoder within 1e-3 of the plain MRF, two
   speakers' wavs giving other embeddings and waveforms, the ms to
   condition on a new wav (`xtts clone`); then a full-width d-vector VITS
   (ResBlock1, phase 16's d-vector file) with phase 16's encoder attached
   by `init_encoder`, one `/api/tts?speaker_wav=` request of 72 K1
   launches (`dvector vits speaker_wav`);
18. the GAN vocoders (M8): (a) K1 against its plain version at HiFi-GAN
   V2's stage shapes (C = 64/32/16/8 at 256 mel frames) and at C = 24 and
   48, float32 and bfloat16, with tile, launches, time, plain time and
   bound (`kernel hifigan_mrf v2|narrow` lines); (b) Glow-TTS (phase 6's)
   behind a default HiFi-GAN V1, then V2 (`upsample_initial_channel` 128),
   each a Coqui-format `.pth` + `config.json` from a seed, over three
   `/api/tts` requests: 72 K1 launches a sentence, the waveform within 1e-3
   of the plain MRF, latency and profile lines; then the default multiband
   MelGAN and UnivNet the same way, 0 K1 launches (`vocoder serve`); (c)
   the LJSpeech HiFi-GAN recipe's settings (batch 32, `seq_len` 8192,
   `pad_short` 2000, noise augmentation, lr 1e-4, float32) through
   `Trainer.fit` on 64 + 10 seeded clips for 2 epochs of 2 steps: ms a step
   (D, G, updates), peak memory, finite losses, every gradient nonzero, no
   K1 launch (`vocoder train steps`); one more epoch against the same epoch
   resumed (`vocoder train resume`); 20 steps on one batch lowering the G
   loss (`vocoder train overfit`); the run directory served behind Glow-TTS,
   72 launches a sentence, within 1e-3 of the plain MRF; (d) a tiny HiFi-GAN
   and a tiny multiband MelGAN D and G step on the card against the CPU
   (`vocoder train card vs cpu`); (e) two steps each of the multiband
   MelGAN and UnivNet recipes (batch 32 and 64, `seq_len` 8192): ms a step
   and peak memory;
19. DelightfulTTS (its serving path): the default `DelightfulTTSConfig`
   (512-wide 6 + 6-layer conformers, 100 mels, HiFi-GAN 512 → 32) with
   weights from a seed, its parameter count printed, saved as a state dict
   and `config.json` and served by `/api/tts` on the locked path (the
   batcher does not take it): the three requests, 72 K1 launches a
   sentence, replies of n_frames · hop samples, a profile of the
   78-character request, each served waveform within 1e-3 of the plain
   MRF (`delightful waveform vs plain MRF` lines); K1 against its plain
   version at the stage shapes of that request's mel bucket (`kernel
   hifigan_mrf delightful ...` lines); a 4-speaker `use_speaker_embedding`
   model, one request a speaker through `cond_layer` and K1, two speakers
   giving other waveforms (`delightful speaker ...` lines);
19a. DelightfulTTS training: one D and one G step of a tiny DelightfulTTS
   (aligner priors and the binary term on) on the card against the CPU, in
   float32 and float64: losses within 1e-4 relative and the MAS durations
   equal in both, gradients within 1e-3 of each tensor's max in float64
   (float32's printed: its STFT term's gradient measures rounding there)
   (`delightful train card vs cpu`); the default
   model (decoder at unit gain) at the LJSpeech recipe's settings (batch
   32, mixed precision, no priors, no binary term) on 32 + 4 seeded clips of
   2–10 s, the pyin F0 cache filled by 8 processes first (`delightful train
   data`), through `Trainer.fit` for 2 steps: ms a step (D, G, updates),
   peak memory, a profiled step, finite losses, every gradient nonzero, K1
   launched no time (`delightful train steps`); one more epoch against the
   same epoch resumed (`delightful train resume`); 5 steps on one batch
   lowering the acoustic mel loss (`delightful train overfit`); the run
   directory served by `/api/tts` through K1, 72 launches, within 1e-3 of
   the plain MRF, at most half its samples saturated (`delightful train
   serve`);
20. the kernels line, then `{"ok": true, "device": {...}}` as the last line.

Each serving phase's requests are a main path: the launch counts are set to
0 just before them and read just after. Phases 5 and 6 take the locked
path (the batcher detached), as before the batcher was ported.

It needs the repository beside it and a CUDA device; without either it exits
non-zero. It imports nothing of JAX or of the JAX package.
"""

import argparse
import contextlib
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
# the multi-speaker phase's 8 concurrent requests (text, speaker, language): 11 distinct sentences
SPEAKERS = {"spk_a": 0, "spk_b": 1, "spk_c": 2, "spk_d": 3}
LANGUAGES = {"en": 0, "fr": 1, "de": 2}
MULTISPEAKER_REQUESTS = [
    ("Be a voice, not an echo.", "spk_a", "en"),
    ("Le chat dort sur le lit. Il fait beau ce soir.", "spk_b", "fr"),
    ("The birch canoe slid on the smooth planks.", "spk_c", "en"),
    ("Der Hund spielt im Garten.", "spk_d", "de"),
    ("Glue the sheet to the dark blue background. It is easy to tell the depth of a well.", "spk_a", "en"),
    ("La mer est calme ce matin.", "spk_c", "fr"),
    ("These days a chicken leg is a rare dish.", "spk_b", "en"),
    ("Ich lese gern am Abend. Das Buch ist neu.", "spk_d", "de"),
]
# the multilingual recipe's character set (recipes/multilingual/vits_tts/train_vits_tts.py), its
# punctuation held once, in MULTILINGUAL_PUNCTUATIONS
MULTILINGUAL_PUNCTUATIONS = "!¡'(),-.:;¿? "
MULTILINGUAL_CHARACTERS = "".join(dict.fromkeys(
    c for c in "!¡'(),-.:;¿?abcdefghijklmnopqrstuvwxyzµßàáâäåæçèéêëìíîïñòóôöùúûüąćęłńœśşźżƒабвгдежзийклмнопрстуфхц"
               "чшщъыьэюяёєіїґӧ «°±µ»$%&‘’‚“`”„" if c not in MULTILINGUAL_PUNCTUATIONS))
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


def check_mrf_shapes(shapes, gen, label: str = "", iters: int = 5) -> list:
    """K1 against `mrf_stack_reference` at each (dtype, C, T) of `shapes`
    (B = 1): the planned tile, launches, error, time, plain time and bounds,
    one `kernel hifigan_mrf {label}...` line each."""
    import torch

    from tpu_tts_torch.ops import hifigan_mrf

    n_sm = torch.cuda.get_device_properties(0).multi_processor_count
    rows = []
    for dtype, C, T in shapes:
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
        ms = cuda_ms(lambda: hifigan_mrf.mrf_stack(x, stage), iters)
        plain_ms = cuda_ms(lambda: hifigan_mrf.mrf_stack_reference(x, stage), iters)
        work = mrf_work(stage, 1, C, T, dtype)
        row = {"dtype": str(dtype).replace("torch.", ""), "C": C, "T": T, "max_abs_err": err, "tol": tol,
               "max_abs_ref": scale, "tile": list(pl.shape), "grid": list(pl.grid), "launches": n_launch,
               "ms": ms, "plain_ms": plain_ms, **work}
        rows.append(row)
        log(f"kernel hifigan_mrf {label}{row['dtype']} C={C} T={T}: tile={pl.shape[0]}x{pl.shape[1]} "
            f"grid={pl.grid} launches={n_launch} max_abs_err={err:.3e} (tol {tol:.3e}) "
            f"ms={ms:.4f} plain_ms={plain_ms:.4f} bound_ms={work['bound_ms']:.4f} ({work['bound_by']}) "
            f"bound_cuda_core_ms={work['bound_cuda_core_ms']:.4f}")
        if n_launch != hifigan_mrf.launches_per_stage(stage):
            raise AssertionError(f"hifigan_mrf took {n_launch} launches for one stage")
        if not ok:
            raise AssertionError(f"hifigan_mrf disagrees with its plain version at {row['dtype']} C={C}: {err} > {tol}")
    return rows


def check_mrf_kernel() -> tuple:
    """K1's tensor-core instructions, then K1 against `mrf_stack_reference`
    at the four VITS stage shapes: (rows, sass counts)."""
    import torch

    from tpu_tts_torch.ops import build

    sass = build.sass_counts("hifigan_mrf")
    log(f"kernel hifigan_mrf sass: {json.dumps(sass)}")
    if sass["HMMA.TF32"] + sass["HGMMA.TF32"] == 0:
        raise AssertionError(f"hifigan_mrf holds no TF32 tensor-core instruction: {sass}")
    gen = torch.Generator(device="cuda").manual_seed(SEED)
    rows = check_mrf_shapes([(dtype, C, MEL_FRAMES * up) for dtype in (torch.float32, torch.bfloat16)
                             for C, up in ((256, 8), (128, 64), (64, 128), (32, 256))], gen)
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


@contextlib.contextmanager
def plain_mrf():
    """Every HiFi-GAN generator runs the plain MRF version
    (`mrf_stack_reference`) inside the block, and K1 again after it."""
    from tpu_tts_torch.ops import hifigan_mrf
    from tpu_tts_torch.vocoder.models import hifigan_generator

    hifigan_generator.mrf_stack = hifigan_mrf.mrf_stack_reference
    try:
        yield
    finally:
        hifigan_generator.mrf_stack = hifigan_mrf.mrf_stack


def unit_gain_decoder(dec):
    """Redraw a random HiFi-GAN generator's convs with unit gain (transposed
    convs over the C_in·k/stride taps that reach an output, resblock convs at
    half that), so that it neither saturates its tanh nor fades to silence."""
    import torch

    from tpu_tts_torch.layers.common import WeightNorm

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


def save_model(tmp: str, device: str = "cuda", config=None, coqui: bool = False):
    """A full-width VITS (the default `VitsConfig` unless `config` is given)
    with seeded random weights → (checkpoint, config.json). The checkpoint is
    the net's state_dict, or with `coqui` a Coqui-format training checkpoint:
    `{"model": ..., "step": ...}` holding a discriminator tensor the
    inference net has no place for."""
    import torch

    from tpu_tts_torch.configs.vits_config import VitsConfig
    from tpu_tts_torch.models.vits import Vits

    torch.manual_seed(SEED)
    config = VitsConfig() if config is None else config
    model = Vits.init_from_config(config, device=device)
    unit_gain_decoder(model.net.waveform_decoder)
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


def post(url: str, text: str, speaker: str = "", language: str = ""):
    body = {"text": text, **({"speaker_id": speaker} if speaker else {}), **({"language_id": language} if language else {})}
    return urllib.request.Request(url, data=json.dumps(body).encode(), method="POST",
                                  headers={"Content-Type": "application/json"})


def serve_and_check(paths: dict, kernel, launches_per_sentence=None, check=None, device: str = "cuda",
                    check_synth=None) -> int:
    """Three /api/tts requests through the port's server, each checked and
    each required to launch `kernel` (a wrapper module with a `launches`
    count) — exactly `launches_per_sentence` times a sentence if that is
    given (0 for a path without the kernel), else at least once; then
    `check(model)`, `check_synth(synth)` and a profile of one request.
    Returns the kernel's launches in the three requests (the main path)."""
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
            want = launches_per_sentence
            if n <= 0 if want is None else n != want * len(sentences):
                raise AssertionError(f"request {text!r} of {len(sentences)} sentences launched {name} {n} times")
            log(f"request chars={len(text)} sentences={len(sentences)} frames={frames} samples={len(pcm)} "
                f"trimmed={expected - len(pcm)} latency_s={latency:.4f} {name}_launches={n}")
        with urllib.request.urlopen(f"{base}/details", timeout=60) as r:
            json.loads(r.read())
        if check is not None:
            check(model)
        if check_synth is not None:
            check_synth(synth)
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

    ids = model.tokenizer.text_to_ids(TEXTS[0])
    got = model.inference(ids)["model_outputs"]
    with plain_mrf():
        ref = model.inference(ids)["model_outputs"]
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
    call's padded `x`, `x_lengths` and per-row speaker, language and
    d-vector inputs as given. Returns the list of calls and a function that
    takes the wrapper off."""
    import numpy as np

    calls = []
    orig = model.inference

    def recording(x, aux_input=None, **kwargs):
        out = orig(x, aux_input=aux_input, **kwargs)
        ids = np.asarray(x).reshape(-1, np.asarray(x).shape[-1])
        x_lengths = np.asarray((aux_input or {}).get("x_lengths", [ids.shape[1]] * ids.shape[0]))
        cond = {k: np.array(v) for k, v in (aux_input or {}).items()
                if k in ("speaker_ids", "language_ids", "d_vectors") and v is not None}
        calls.append(([tuple(ids[i, : x_lengths[i]].tolist()) for i in range(len(ids))],
                      out["y_lengths"].cpu().numpy().tolist(), ids.copy(), x_lengths.copy(), cond))
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


def serve_batched(paths: dict, requests=None, name: str = "", device: str = "cuda") -> dict:
    """A VITS batched serving phase: `requests` ((text, speaker, language)
    triples, BATCH_REQUESTS by default) sent together through the
    micro-batcher, then one after another on the locked path; then the
    served batch against the plain MRF. The lines read `serving
    {name}batched ...`; the result holds the served model and its largest
    batch (`x`, `x_lengths`, per-row ids) for the caller's checks."""
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
    requests = requests or [(t, "", "") for t in BATCH_REQUESTS]
    sentences = [synth.split_into_sentences(t) for t, _, _ in requests]
    n_sentences = sum(len(s) for s in sentences)

    def request(req):
        try:
            with urllib.request.urlopen(post(url, *req), timeout=600) as r:
                return req[0], r.status, r.read()
        except urllib.error.HTTPError as e:
            raise AssertionError(f"/api/tts gave HTTP {e.code} for {req!r}: {e.read()[:2000]!r}") from None

    def concurrently():
        replies = [None] * len(requests)
        errors = []

        def go(i):
            try:
                replies[i] = request(requests[i])
            except Exception as e:  # raised below, in the main thread
                errors.append(e)

        threads = [threading.Thread(target=go, args=(i,)) for i in range(len(requests))]
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
        if batches >= len(requests) or batches != len(calls) or rows != n_sentences:
            raise AssertionError(f"{len(requests)} concurrent requests of {n_sentences} sentences ran "
                                 f"{batches} batches of {rows} rows ({len(calls)} inference calls)")
        if launches_b != per_call * len(calls):
            raise AssertionError(f"the batched requests launched hifigan_mrf {launches_b} times for {len(calls)} "
                                 f"inference calls ({per_call} a call)")

        served = max(calls, key=lambda c: len(c[0]))[2:]  # x, x_lengths and ids of the largest batch served

        TTSHandler._batcher = None  # the locked path
        for req in requests:  # warm-up round at the B = 1 shapes, not counted
            request(req)
        calls.clear()
        hifigan_mrf.launches = 0
        t0 = time.perf_counter()
        serial = [request(req) for req in requests]
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
            log(f"serving {name}{mode}: requests={len(requests)} sentences={n_sentences} wall_s={m['wall_s']:.4f} "
                f"audio_s={m['audio_s']:.4f} audio_s_per_wall_s={m['audio_s_per_wall_s']:.4f} "
                f"batches_run={m['batches_run']} rows_run={m['rows_run']} padded_B={m['padded_B']} "
                f"hifigan_mrf_launches={m['hifigan_mrf_launches']}")
        ratio = modes["batched"]["audio_s_per_wall_s"] / modes["serial"]["audio_s_per_wall_s"]
        log(f"serving {name}batched/serial audio_s_per_wall_s ratio={ratio:.4f}")

        check_batch_against_plain(model, *served, label=f"the served {name}batch")
        return {"modes": modes, "ratio": ratio, "launches": launches_b, "launches_per_batch": launches_b // batches,
                "batches": batches, "model": model, "served": served,
                "sentences": [s for sents in sentences for s in sents]}
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


def profile_batch(model, x, x_lengths, cond, label: str) -> dict:
    """A profile line of one batched `inference` call of these rows."""
    aux = {"x_lengths": x_lengths, **cond}
    return profile_call(lambda: model.inference(x, aux_input=aux), {
        "model": "vits", "call": f"{label}batched inference", "rows": len(x), "tokens": x_lengths.tolist(),
        **{k: v.tolist() for k, v in cond.items() if k != "d_vectors"}})


def check_batch_against_plain(model, x, x_lengths, cond=None, label: str = "", tol: float = 1e-3):
    """One batched inference of mixed-length rows (with their speaker and
    language inputs `cond`), the kernel path against the same model with the
    plain MRF version (as `check_against_plain`)."""
    import torch

    aux = {"x_lengths": x_lengths, **(cond or {})}
    got = model.inference(x, aux_input=aux)
    with plain_mrf():
        ref = model.inference(x, aux_input=aux)
    y = got["y_lengths"].tolist()
    err = float((got["model_outputs"] - ref["model_outputs"]).abs().max())
    log(f"batched waveform vs plain MRF ({label}): rows={len(x)} tokens={aux['x_lengths'].tolist()} y_lengths={y} "
        f"shape={tuple(got['model_outputs'].shape)} max_abs_err={err:.3e} (tol {tol:.0e})")
    if y != ref["y_lengths"].tolist() or len(set(y)) < 2 or not torch.isfinite(got["model_outputs"]).all() or err > tol:
        raise AssertionError(f"the batched waveform disagrees with the plain path: {err} > {tol} or y {y}")


def save_multispeaker(tmp: str) -> dict:
    """The multilingual recipe's VITS at full width (hidden 192, 6 text-encoder
    layers, 4 flows, HiFi-GAN 512 → 32 with ResBlock1, 16 kHz, hop 256) with
    its speakers and language files in `tmp`, seeded random weights, saved as
    a Coqui-format checkpoint."""
    from tpu_tts_torch.configs.vits_config import VitsArgs, VitsAudioConfig, VitsConfig
    from tpu_tts_torch.text.characters import CharactersConfig

    files = {"speakers_file": os.path.join(tmp, "speakers.json"),
             "language_ids_file": os.path.join(tmp, "language_ids.json")}
    for key, ids in (("speakers_file", SPEAKERS), ("language_ids_file", LANGUAGES)):
        with open(files[key], "w", encoding="utf-8") as f:
            json.dump(ids, f)
    config = VitsConfig(
        model_args=VitsArgs(use_language_embedding=True, embedded_language_dim=4, use_speaker_embedding=True,
                            use_sdp=False, **files),
        audio=VitsAudioConfig(sample_rate=16000, win_length=1024, hop_length=256, num_mels=80, mel_fmin=0,
                              mel_fmax=None),
        use_speaker_embedding=True, text_cleaner="multilingual_cleaners", use_phonemes=False,
        characters=CharactersConfig(pad="<PAD>", eos="<EOS>", bos="<BOS>", blank="<BLNK>",
                                    characters=MULTILINGUAL_CHARACTERS, punctuations=MULTILINGUAL_PUNCTUATIONS, phonemes=None),
    )
    return save_model(tmp, config=config, coqui=True)


def check_rows_alone(model, served, tol: float = 1e-3) -> dict:
    """At noise scale 0: each row of the served batch against the same row
    decoded alone with its own ids at the batch's decode length; then row 0
    alone with another speaker, which must give another waveform."""
    import numpy as np
    import torch

    x, x_lengths, cond = served
    a = model.args
    scales = a.inference_noise_scale, a.inference_noise_scale_dp
    a.inference_noise_scale = a.inference_noise_scale_dp = 0.0
    try:
        batch = model.inference(x, aux_input={"x_lengths": x_lengths, **cond})
        T_de = batch["alignments"].shape[1]
        errs = []
        for i in range(len(x)):
            row = {k: v[i : i + 1] for k, v in cond.items()}
            alone = model.inference(x[i : i + 1, : x_lengths[i]], aux_input={"x_lengths": x_lengths[i : i + 1], **row},
                                    bucket=T_de)
            if alone["alignments"].shape[1] != T_de or int(alone["y_lengths"][0]) != int(batch["y_lengths"][i]):
                raise AssertionError(f"row {i} alone decoded {alone['alignments'].shape[1]} frames, "
                                     f"y {int(alone['y_lengths'][0])} against {T_de}, {int(batch['y_lengths'][i])}")
            errs.append(float((alone["model_outputs"][0] - batch["model_outputs"][i]).abs().max()))
        other = {**{k: v[:1] for k, v in cond.items()},
                 "speaker_ids": (cond["speaker_ids"][:1] + 1) % len(SPEAKERS)}
        moved = model.inference(x[:1, : x_lengths[0]], aux_input={"x_lengths": x_lengths[:1], **other}, bucket=T_de)
        n = int(min(moved["y_lengths"][0], batch["y_lengths"][0])) * model.ap.hop_length
        speaker_gap = float((moved["model_outputs"][0, :n] - batch["model_outputs"][0, :n]).abs().max())
    finally:
        a.inference_noise_scale, a.inference_noise_scale_dp = scales
    row = {"rows": len(x), "decode_frames": T_de, "speaker_ids": cond["speaker_ids"].tolist(),
           "language_ids": cond["language_ids"].tolist(), "max_abs_err": max(errs), "tol": tol,
           "other_speaker_max_abs_diff": speaker_gap}
    log("multispeaker rows alone vs batched " + json.dumps(row))
    if not np.isfinite(errs).all() or max(errs) > tol:
        raise AssertionError(f"a row decoded alone disagrees with its batched row: {row}")
    if not speaker_gap > tol or not torch.isfinite(batch["model_outputs"]).all():
        raise AssertionError(f"two speakers gave the same waveform: {row}")
    return row


def save_yourtts(tmp: str) -> dict:
    """A YourTTS-shaped VITS at full width: 512-wide d-vectors from a file
    (two speakers of three clips each), the stochastic duration predictor,
    10 text-encoder layers and a ResBlock2 decoder, 16 kHz; seeded random
    weights, saved as a Coqui-format checkpoint."""
    import numpy as np

    from tpu_tts_torch.configs.vits_config import VitsArgs, VitsAudioConfig, VitsConfig

    rng = np.random.default_rng(SEED)
    d_vector_file = os.path.join(tmp, "speakers_dvec.json")
    with open(d_vector_file, "w", encoding="utf-8") as f:
        json.dump({f"{spk}_{i}": {"name": spk, "embedding": (0.05 * rng.standard_normal(512)).tolist()}
                   for spk in ("vctk_p225", "vctk_p226") for i in range(3)}, f)
    config = VitsConfig(
        model_args=VitsArgs(d_vector_file=[d_vector_file], use_d_vector_file=True, d_vector_dim=512,
                            num_layers_text_encoder=10, resblock_type_decoder="2"),
        audio=VitsAudioConfig(sample_rate=16000, hop_length=256, win_length=1024, fft_size=1024, mel_fmin=0.0,
                              mel_fmax=None, num_mels=80),
        text_cleaner="multilingual_cleaners", use_speaker_embedding=False, use_d_vector_file=True,
        d_vector_file=[d_vector_file], d_vector_dim=512,
    )
    return save_model(tmp, config=config, coqui=True)


def serve_yourtts(paths: dict, device: str = "cuda") -> dict:
    """One request to the YourTTS-shaped model through the server: a finite
    reply of its row's length, and no K1 launch (ResBlock2 runs in plain
    PyTorch, as in the JAX package)."""
    from tpu_tts_torch.ops import hifigan_mrf
    from tpu_tts_torch.server.server import TTSHandler, create_server

    server = create_server(argparse.Namespace(**paths, device=device, host="127.0.0.1", port=0, max_batch=16))
    thread = threading.Thread(target=server.serve_forever, daemon=True)
    thread.start()
    url = f"http://127.0.0.1:{server.server_address[1]}/api/tts"
    synth = TTSHandler.synthesizer
    try:
        calls, unwrap = record_inference(synth.tts_model)
        text = MULTISPEAKER_REQUESTS[2][0]
        hifigan_mrf.launches = 0
        t0 = time.perf_counter()
        with urllib.request.urlopen(post(url, text, "vctk_p226"), timeout=600) as r:
            reply = (text, r.status, r.read())
        wall = time.perf_counter() - t0
        launches = hifigan_mrf.launches
        unwrap()
        samples = check_replies(synth, [reply], calls)
        d = calls[0][4]["d_vectors"]
        row = {"chars": len(text), "y_lengths": calls[0][1], "samples": samples, "wall_s": wall,
               "d_vector_dim": int(d.shape[-1]), "resblock_type": synth.tts_config.model_args.resblock_type_decoder,
               "hifigan_mrf_launches": launches}
        log("yourtts request " + json.dumps(row))
        if launches != 0 or d.shape != (1, 512):
            raise AssertionError(f"the ResBlock2 request launched hifigan_mrf or lost its d-vector: {row}")
        return row
    finally:
        server.shutdown()
        server.server_close()
        thread.join(timeout=30)
        if TTSHandler._batcher is not None:
            TTSHandler._batcher.close()
            TTSHandler._batcher = None


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


# the XTTS phase: one stream, then 8 concurrent ones (4 at once, 4 during the round), chunk 20, first chunk 8
XTTS_STREAM = dict(max_new_tokens=128, stream_chunk_size=20, first_chunk_size=8, overlap_latents=4)
XTTS_SPEAKERS = ("Ana Florence", "Claribel Dervla")
XTTS_TEXTS = [
    "It took me quite a long time to develop a voice.",
    "The birch canoe slid on the smooth planks.",
    "Glue the sheet to the dark blue background.",
    "It is easy to tell the depth of a well.",
    "These days a chicken leg is a rare dish.",
    "Rice is often served in round bowls.",
    "The juice of lemons makes fine punch.",
    "The box was thrown beside the parked truck.",
    "Four hours of steady work faced us.",
]
# no XTTS vocab ships with the repository: token ids come from this character table
XTTS_CHARS = " abcdefghijklmnopqrstuvwxyz0123456789.,;:!?'-"
XTTS_TOL = 1e-3  # the decoder against its plain MRF, and the incremental GPT against teacher-forced


def xtts_token_ids(text: str, lang: str = "en") -> list:
    return [XTTS_CHARS.index(c) + 1 for c in text.lower() if c in XTTS_CHARS]


def save_xtts(tmp: str, device: str = "cuda", config=None, stop_bias: bool = True, ref_encoder: bool = False) -> dict:
    """A full-width XTTS-v2 (default `XttsArgs`: GPT 30 × 1024, 16 heads,
    perceiver of 32 latents, HiFi-GAN 512 → 32 with `conds`) with weights
    from seed 0 on the card, saved as a model directory: `config.json`, a
    Coqui-key checkpoint `{"model": ...}` and a `speakers_xtts.pth` of two
    speakers whose latents the model computes from seeded 3 s wavs; plus a
    cloning wav for `speaker_wav`. The decoder is redrawn with unit gain
    (`unit_gain_decoder`), and with `stop_bias` the stop code's head bias is
    set to -1e4, so a random model runs every stream to its token budget.
    With `ref_encoder` the net is Coqui's layout: the decoder-side ResNet
    speaker encoder (`hifigan_decoder.speaker_encoder.*`) in place of
    `speaker_proj`."""
    import numpy as np
    import scipy.io.wavfile
    import torch

    from tpu_tts_torch.configs.xtts_config import XttsConfig
    from tpu_tts_torch.models.xtts import Xtts, XttsNet

    t0 = time.perf_counter()
    torch.manual_seed(SEED)
    config = XttsConfig() if config is None else config
    model = Xtts(config, device=device)
    if ref_encoder:
        model.net = XttsNet(model.args, ref_speaker_encoder=True).to(device).eval()
    unit_gain_decoder(model.net.hifigan_decoder["waveform_decoder"])
    if stop_bias:
        with torch.no_grad():
            model.net.gpt.mel_head.bias[model.args.gpt_stop_audio_token] = -1e4
    rng = np.random.default_rng(SEED)
    speakers = {}
    for name in XTTS_SPEAKERS:
        cond, spk = model.get_conditioning_latents((0.3 * rng.standard_normal(3 * 22050)).astype(np.float32))
        speakers[name] = {"gpt_cond_latent": cond[0].cpu(), "speaker_embedding": spk[0].cpu()}
    torch.save(speakers, os.path.join(tmp, "speakers_xtts.pth"))
    torch.save({"model": {k: v.cpu() for k, v in model.net.state_dict().items()}}, os.path.join(tmp, "model.pth"))
    config.save_json(os.path.join(tmp, "config.json"))
    wav_path = os.path.join(tmp, "speaker.wav")
    scipy.io.wavfile.write(wav_path, 22050, (0.3 * rng.standard_normal(3 * 22050) * 32767 / 4).astype(np.int16))
    n_params = sum(p.numel() for p in model.net.parameters())
    del model
    torch.cuda.empty_cache()
    log(f"xtts model directory: {n_params} parameters, built and saved in {time.perf_counter() - t0:.1f} s")
    return {"model_dir": tmp, "speaker_wav": wav_path}


def xtts_decoded_samples(model, n_latents: int) -> int:
    """Samples `decode_latents` gives for n latents (the two floors of the
    interpolations, then the decoder's upsampling)."""
    import math

    import numpy as np

    a = model.args
    frames = math.floor(n_latents * (a.gpt_code_stride / a.output_hop_length))
    if a.output_sample_rate != a.input_sample_rate:
        frames = math.floor(frames * (a.output_sample_rate / a.input_sample_rate))
    return frames * int(np.prod(a.decoder_upsample_rates))


def xtts_emissions(model, n_tokens: int, first: int, chunk: int, ovl: int) -> list:
    """The samples of each chunk a stream of n tokens emits: first `first`
    tokens, then `chunk` at a time with `ovl` latents of context, each
    `_n_samples(n)` long unless its decoded window is shorter."""
    out, done, is_first = [], 0, True
    while done < n_tokens:
        size = first if is_first else chunk
        n, ctx = min(size, n_tokens - done), 0 if is_first else ovl
        out.append(min(model._n_samples(n), xtts_decoded_samples(model, ctx + size) - model._n_samples(ctx)))
        done, is_first = done + n, False
    return out


def stream_request(base: str, query: str, first_bytes=None) -> dict:
    """One `/api/tts_stream` request read chunk by chunk: status, whether the
    reply is chunked, the PCM16 samples, the seconds to the first bytes and
    to the last, from the request's start; sets `first_bytes` on the first."""
    import http.client

    import numpy as np

    host, port = base.rsplit("//", 1)[1].split(":")
    conn = http.client.HTTPConnection(host, int(port), timeout=600)
    t0 = time.perf_counter()
    try:
        conn.request("GET", f"/api/tts_stream?{query}")
        resp = conn.getresponse()
        data, t_first = bytearray(), None
        while True:
            piece = resp.read1(1 << 20)
            if not piece:
                break
            if t_first is None:
                t_first = time.perf_counter() - t0
                if first_bytes is not None:
                    first_bytes.set()
            data += piece
        return {"status": resp.status, "chunked": resp.getheader("Transfer-Encoding") == "chunked",
                "rate": resp.getheader("X-Sample-Rate"), "pcm": np.frombuffer(bytes(data), dtype="<i2"),
                "first_s": t_first, "wall_s": time.perf_counter() - t0, "t0": t0}
    finally:
        conn.close()


def check_stream_reply(model, reply: dict, codes: list, label: str) -> list:
    """HTTP 200, chunked PCM16 at the model's rate, not silent, the length
    the stream's own token count gives; returns its emissions."""
    plan = xtts_emissions(model, len(codes), XTTS_STREAM["first_chunk_size"], XTTS_STREAM["stream_chunk_size"],
                          XTTS_STREAM["overlap_latents"])
    pcm = reply["pcm"]
    if reply["status"] != 200 or not reply["chunked"] or reply["rate"] != str(model.args.output_sample_rate):
        raise AssertionError(f"{label}: status {reply['status']}, chunked {reply['chunked']}, rate {reply['rate']}")
    if pcm.size != sum(plan) or not pcm.size or int(abs(pcm.astype("int32")).max()) == 0:
        raise AssertionError(f"{label}: {pcm.size} samples for {len(codes)} tokens ({sum(plan)} expected), or silent")
    return plan


def xtts_serve(paths: dict, device: str = "cuda") -> dict:
    """The XTTS phase: the model directory served by the port's server
    (`--max_streams 8`); one `/api/tts_stream` request with a bundled
    speaker, then 8 concurrent ones; the card checks of `xtts_card_checks`;
    one `/api/tts` request with `speaker_wav`; profiles. The stream route's
    pool is set on the handler here, at the server's `--max_streams` and
    `XTTS_STREAM`'s 128-token budget (the server's own `_get_pool` would
    build it at the 256-token default), so `_get_pool` itself does not run
    on the card. The launches per chunk and per pool emission are
    measured: K1's count over a stream's chunks and over the concurrent
    streams' decode calls."""
    import numpy as np

    from tpu_tts_torch.infer.xtts_pool import XttsStreamPool
    from tpu_tts_torch.ops import hifigan_mrf
    from tpu_tts_torch.server.server import TTSHandler, create_server

    t0 = time.perf_counter()
    server = create_server(argparse.Namespace(model_dir=paths["model_dir"], device=device, host="127.0.0.1", port=0,
                                              max_streams=8))
    log(f"xtts server: model directory loaded in {time.perf_counter() - t0:.1f} s")
    synth = TTSHandler.synthesizer
    model = synth.tts_model
    model.bpe.encode = xtts_token_ids
    pool = XttsStreamPool(model, max_streams=TTSHandler.pool_max_streams, **XTTS_STREAM)
    TTSHandler._pool = pool
    streams, submit = {}, pool.submit

    def recording_submit(**kwargs):  # each stream's codes, by its text
        stream = submit(**kwargs)
        streams[kwargs["text"]] = stream
        return stream

    pool.submit = recording_submit
    dec = model.net.hifigan_decoder["waveform_decoder"]
    per_call = sum(hifigan_mrf.launches_per_stage(dec.mrf_stage(i)) for i in range(dec.num_upsamples))
    thread = threading.Thread(target=server.serve_forever, daemon=True)
    thread.start()
    base = f"http://127.0.0.1:{server.server_address[1]}"

    def query(text, speaker=XTTS_SPEAKERS[0]):
        return f"text={urllib.parse.quote(text)}&speaker_id={urllib.parse.quote(speaker)}"

    try:
        cond, spk = model.speaker_latents(XTTS_SPEAKERS[0])  # a warm-up of both chunk sizes, not counted
        for _ in pool.submit(text="Warm up.", gpt_cond_latent=cond, speaker_embedding=spk, max_tokens=28):
            pass
        # ---- one stream
        calls0 = pool.decode_calls
        hifigan_mrf.launches = 0
        reply = stream_request(base, query(XTTS_TEXTS[0]))
        launches = hifigan_mrf.launches
        plan = check_stream_reply(model, reply, streams[XTTS_TEXTS[0]].codes, "single stream")
        calls = pool.decode_calls - calls0
        if calls != len(plan) or launches != per_call * len(plan):
            raise AssertionError(f"single stream: {len(plan)} chunks, {calls} decodes, {launches} K1 launches")
        sr = model.args.output_sample_rate
        cadence = (reply["wall_s"] - reply["first_s"]) / max(len(plan) - 1, 1)
        single = {"tokens": len(streams[XTTS_TEXTS[0]].codes), "chunks": len(plan), "samples": int(reply["pcm"].size),
                  "audio_s": reply["pcm"].size / sr, "first_chunk_ms": reply["first_s"] * 1e3,
                  "mean_chunk_cadence_ms": cadence * 1e3, "wall_s": reply["wall_s"],
                  "hifigan_mrf_launches": launches, "launches_per_chunk": launches // len(plan)}
        log("xtts stream single " + json.dumps(single))

        # ---- 8 concurrent streams: 4 at once, 4 once the first audio is out
        texts = XTTS_TEXTS[1:9]
        replies, errors, first_bytes = {}, [], threading.Event()

        def go(i):
            try:
                speaker = XTTS_SPEAKERS[i % 2]
                replies[texts[i]] = stream_request(base, query(texts[i], speaker), first_bytes if i == 0 else None)
            except Exception as e:  # raised below, in the main thread
                errors.append(e)
                first_bytes.set()

        r0, a0, calls0 = pool.rounds_served, pool.admissions, pool.decode_calls
        hifigan_mrf.launches = 0
        t0 = time.perf_counter()
        threads = [threading.Thread(target=go, args=(i,)) for i in range(8)]
        for t in threads[:4]:
            t.start()
        first_bytes.wait(timeout=600)
        for t in threads[4:]:
            t.start()
        for t in threads:
            t.join(timeout=600)
        wall = time.perf_counter() - t0
        if errors:
            raise errors[0]
        launches_8 = hifigan_mrf.launches
        rounds, admissions, calls = pool.rounds_served - r0, pool.admissions - a0, pool.decode_calls - calls0
        samples = 0
        for text in texts:
            check_stream_reply(model, replies[text], streams[text].codes, f"concurrent {text!r}")
            samples += replies[text]["pcm"].size
        firsts = sorted(replies[t]["first_s"] * 1e3 for t in texts)
        concurrent = {"requests": 8, "rounds_served": rounds, "admissions": admissions, "wall_s": wall,
                      "audio_s": samples / sr, "audio_s_per_wall_s": samples / sr / wall,
                      "first_chunk_ms_p50": float(np.percentile(firsts, 50)), "first_chunk_ms_max": firsts[-1],
                      "decode_calls": calls, "hifigan_mrf_launches": launches_8}
        log("xtts stream concurrent " + json.dumps(concurrent))
        if rounds >= 8 or admissions < 1 or launches_8 != per_call * calls:
            raise AssertionError(f"8 concurrent streams did not share rounds, or K1 missed decodes: {concurrent}")

        checks = xtts_card_checks(model, streams[XTTS_TEXTS[0]].codes)
        api = xtts_api_tts(base, synth, paths["speaker_wav"], per_call)
        xtts_profile(model)
        return {"single": single, "concurrent": concurrent, "checks": checks, "api_tts": api,
                "launches": launches + launches_8, "launches_per_chunk": single["launches_per_chunk"],
                "launches_per_emission": launches_8 // calls}
    finally:
        server.shutdown()
        server.server_close()
        thread.join(timeout=30)
        pool.close()
        TTSHandler._pool = None


def xtts_card_checks(model, codes: list) -> dict:
    """On the card: the decoder through K1 against the plain MRF on one
    chunk's latents (4 + 20) at B = 1 and B = 8; the incremental decode of a
    stream's codes against the teacher-forced GPT; greedy pooled streams
    replayed teacher-forced, each code within 1e-4 of its step's best logit."""
    import torch

    from tpu_tts_torch.infer.xtts_pool import XttsStreamPool

    net, a, dev = model.net, model.args, model.device
    conds = [model.speaker_latents(XTTS_SPEAKERS[i % 2]) for i in range(8)]
    cond, spk = torch.cat([c for c, _ in conds]), torch.cat([s for _, s in conds])
    ids = [torch.tensor(xtts_token_ids(t), device=dev) for t in XTTS_TEXTS[1:9]]
    text = torch.nn.utils.rnn.pad_sequence(ids, batch_first=True)
    text, _ = model._bucket_text(text)
    lengths = torch.tensor([len(i) for i in ids], device=dev)
    gen = torch.Generator(device=dev).manual_seed(SEED)
    _, lats, _ = net.generate_latents(cond, text, gen, 24, 0.75, 50, lengths)
    out = {}
    for B in (1, 8):
        got = net.decode_latents(lats[:B], spk[:B])
        with plain_mrf():
            ref = net.decode_latents(lats[:B], spk[:B])
        out[f"decoder_b{B}_max_abs_err"] = float((got - ref).abs().max())
        out[f"decoder_b{B}_rms"] = float(ref.pow(2).mean().sqrt())

    # incremental vs teacher-forced, 32 codes of the single stream
    c0, s0 = model.speaker_latents(XTTS_SPEAKERS[0])
    t0 = torch.tensor(xtts_token_ids(XTTS_TEXTS[0]), device=dev)[None]
    seq = torch.tensor(codes[:32], device=dev)[None]
    prev = torch.cat([torch.full((1, 1), a.gpt_start_audio_token, device=dev), seq[:, :-1]], 1)
    with torch.no_grad():
        tf = net.gpt(c0, t0, prev)
        cache, plen, _ = net.stream_prefill(c0, t0)
        logits, latents = [], []
        for t in range(prev.shape[1]):
            lg, lt, cache = net.gpt.decode_step(prev[:, t], t, cache, plen + t)
            logits.append(lg)
            latents.append(lt)
    out["incremental_logits_max_abs_err"] = float((torch.stack(logits, 1) - tf["mel_logits"]).abs().max())
    out["incremental_latents_max_abs_err"] = float((torch.stack(latents, 1) - tf["audio_latents"]).abs().max())

    # greedy pooled streams, 4 at once and 4 admitted, replayed teacher-forced
    pool = XttsStreamPool(model, max_streams=8, stream_chunk_size=20, first_chunk_size=8, max_new_tokens=48, top_k=1,
                          gather_window_s=0.05)
    try:
        streams = [pool.submit(text_tokens=ids[i], gpt_cond_latent=conds[i][0], speaker_embedding=conds[i][1])
                   for i in range(4)]
        first = next(streams[0])
        streams += [pool.submit(text_tokens=ids[i], gpt_cond_latent=conds[i][0], speaker_embedding=conds[i][1])
                    for i in range(4, 8)]
        n_chunks = [1 + len(list(streams[0]))] + [len(list(st)) for st in streams[1:]]
        del first
    finally:
        pool.close()
    gaps = []
    for i, st in enumerate(streams):
        seq = torch.tensor(st.codes, device=dev)[None]
        prev = torch.cat([torch.full((1, 1), a.gpt_start_audio_token, device=dev), seq[:, :-1]], 1)
        with torch.no_grad():
            lg = net.gpt(conds[i][0], ids[i][None], prev)["mel_logits"][0]
        gaps.append(float((lg.max(dim=-1).values - lg.gather(1, seq[0][:, None])[:, 0]).max()))
    out.update(greedy_streams=len(streams), greedy_tokens=[len(st.codes) for st in streams], greedy_chunks=n_chunks,
               greedy_rounds=pool.rounds_served, greedy_admissions=pool.admissions,
               greedy_max_score_gap=max(gaps), tol=XTTS_TOL, score_tol=K2_TOL)
    log("xtts card checks " + json.dumps(out))
    bad = [k for k in ("decoder_b1_max_abs_err", "decoder_b8_max_abs_err", "incremental_logits_max_abs_err",
                       "incremental_latents_max_abs_err") if not out[k] <= XTTS_TOL]
    if bad or not out["greedy_max_score_gap"] <= K2_TOL or min(out["greedy_tokens"]) < 1 \
            or min(out["decoder_b1_rms"], out["decoder_b8_rms"]) < 100 * XTTS_TOL:
        raise AssertionError(f"XTTS card checks failed ({bad}): {out}")
    return out


def xtts_api_tts(base: str, synth, speaker_wav: str, per_call: int) -> dict:
    """One `/api/tts` request with `speaker_wav`: `Synthesizer.tts` →
    `Xtts.synthesize` → `inference` (256 tokens), a WAV at 24 kHz of the
    decoded length plus the sentence gap, through K1 once (`per_call`
    launches, 72 at full width)."""
    import numpy as np
    import scipy.io.wavfile

    from tpu_tts_torch.infer.synthesizer import SENTENCE_GAP
    from tpu_tts_torch.ops import hifigan_mrf

    model = synth.tts_model
    hifigan_mrf.launches = 0
    t0 = time.perf_counter()
    url = f"{base}/api/tts?text={urllib.parse.quote(XTTS_TEXTS[0])}&speaker_wav={urllib.parse.quote(speaker_wav)}"
    try:
        with urllib.request.urlopen(url, timeout=600) as r:
            status, body = r.status, r.read()
    except urllib.error.HTTPError as e:
        raise AssertionError(f"/api/tts gave HTTP {e.code}: {e.read()[:2000]!r}") from None
    wall = time.perf_counter() - t0
    sr, pcm = scipy.io.wavfile.read(io.BytesIO(body))
    expected = min(model._n_samples(256), xtts_decoded_samples(model, 256)) + SENTENCE_GAP
    row = {"status": status, "sample_rate": sr, "samples": int(pcm.size), "expected": expected, "wall_s": wall,
           "hifigan_mrf_launches": hifigan_mrf.launches}
    log("xtts api_tts speaker_wav " + json.dumps(row))
    if status != 200 or sr != 24000 or pcm.size != expected or np.abs(pcm).max() == 0 \
            or row["hifigan_mrf_launches"] != per_call:
        raise AssertionError(f"/api/tts with speaker_wav: {row}")
    return row


def xtts_profile(model) -> dict:
    """torch.profiler over one chunk of a single stream (20 GPT steps at B = 1
    and the decode of 4 + 20 latents) and one pool emission (the same at
    B = 8); the GPT's ms per decode step at B = 1 and B = 8 (CUDA events
    around 20 steps, Python's launches included)."""
    import torch

    net, dev = model.net, model.device
    out = {}
    for B in (1, 8):
        conds = [model.speaker_latents(XTTS_SPEAKERS[i % 2]) for i in range(B)]
        cond, spk = torch.cat([c for c, _ in conds]), torch.cat([s for _, s in conds])
        text, lengths = model._bucket_text(torch.tensor([xtts_token_ids(XTTS_TEXTS[0])] * B, device=dev))
        cache, plen, code = net.stream_prefill(cond, text, lengths)
        stopped = torch.zeros(B, dtype=torch.bool, device=dev)
        gen = torch.Generator(device=dev).manual_seed(SEED)

        def chunk(cache=cache, plen=plen, code=code, stopped=stopped, gen=gen, lengths=lengths, width=cond.shape[1]):
            return net.stream_chunk(cache, plen, code, stopped, gen, 8, 20, 0.75, 50, lengths, width)

        lats = chunk()[1][1]
        x = torch.cat([lats[:, -4:], lats], 1)
        label = "single stream chunk" if B == 1 else "pool emission"
        profile_call(lambda: (chunk(), net.decode_latents(x, spk)),
                     {"model": "xtts", "call": f"{label}: 20 GPT steps + decode of 24 latents", "rows": B})
        out[f"gpt_ms_per_step_b{B}"] = cuda_ms(chunk, 3) / 20
        out[f"decode_ms_b{B}"] = cuda_ms(lambda: net.decode_latents(x, spk), 3)
    log("profile xtts " + json.dumps(out))
    return out


# The training phase: the default full-width VITS at batch 32 on 64 clips of LJSpeech's lengths
TRAIN_CLIPS, TRAIN_EVAL_CLIPS, TRAIN_BATCH = 64, 4, 32
TRAIN_EPOCHS = 5  # 2 steps an epoch; then one more epoch, resumed and uninterrupted
OVERFIT_STEPS = 20
TRAIN_STEP_TOL = (1e-4, 1e-3)  # tiny step, card against CPU: losses (relative), each gradient (of its max |g|)
RESUME_TOL = 1e-3  # the resumed run's next step against the uninterrupted run's, losses relative
TRAIN_WORDS = ("the birch canoe slid on smooth planks glue sheet to dark blue background it is easy tell depth of "
               "a well these days chicken leg rare dish rice often served in round bowls juice lemons makes fine "
               "punch box was thrown beside parked truck hogs were fed chopped corn and garbage four hours steady "
               "work faced us large size stockings hard sell").split()


def write_ljspeech(root: str, seed: int = SEED) -> dict:
    """TRAIN_CLIPS training clips (`metadata.csv`) and TRAIN_EVAL_CLIPS eval
    clips (`metadata_val.csv`) in LJSpeech's layout, drawn from a numpy seed:
    2–10 s of a voiced tone (a wandering f0 with harmonics and noise, an
    envelope per syllable) at 22050 Hz, texts of 40–180 characters."""
    return write_clips(root, seed, TRAIN_CLIPS, TRAIN_EVAL_CLIPS, (2.0, 10.0))


def voiced_clip(rng, sr: int, dur: float):
    """`dur` seconds of a voiced tone: a wandering f0 with harmonics and
    noise, an envelope per syllable, peak 0.4–0.9."""
    import numpy as np

    t = np.arange(int(sr * dur)) / sr
    f0 = 110 + 40 * rng.uniform() + 20 * np.sin(2 * np.pi * rng.uniform(0.2, 1.0) * t)
    phase = 2 * np.pi * np.cumsum(f0) / sr
    sig = sum(rng.uniform(0.1, 0.5) / h * np.sin(h * phase) for h in range(1, 8))
    sig = sig * (0.55 + 0.45 * np.sin(2 * np.pi * rng.uniform(2.0, 5.0) * t)) + 0.01 * rng.standard_normal(t.size)
    return sig / np.abs(sig).max() * rng.uniform(0.4, 0.9)


def random_text(rng, lo: int = 40, hi: int = 180) -> str:
    target, words = rng.integers(lo, hi + 1), []
    while len(" ".join(words)) < target:
        words.append(TRAIN_WORDS[rng.integers(len(TRAIN_WORDS))])
    return (" ".join(words)[:target].rstrip() + ".").capitalize()


def write_clips(root: str, seed: int, n_train: int, n_eval: int, seconds_range, sr: int = 22050,
                chars_per_s: float = None) -> dict:
    """n_train clips (`metadata.csv`) and n_eval (`metadata_val.csv`) in
    LJSpeech's layout from a numpy seed, each `voiced_clip` of a length
    uniform in `seconds_range`, with a `random_text` (of 0.8–1.2 ×
    `chars_per_s` characters a second when given, LJSpeech's rate being
    about 15)."""
    import numpy as np
    import scipy.io.wavfile

    rng = np.random.default_rng(seed)
    os.makedirs(os.path.join(root, "wavs"), exist_ok=True)
    seconds = []
    for meta, n in (("metadata.csv", n_train), ("metadata_val.csv", n_eval)):
        lines = []
        for i in range(n):
            name = f"{meta[:-4]}-{i:04d}"
            dur = rng.uniform(*seconds_range)
            sig = voiced_clip(rng, sr, dur)
            scipy.io.wavfile.write(os.path.join(root, "wavs", name + ".wav"), sr, (sig * 32767).astype(np.int16))
            text = random_text(rng) if chars_per_s is None else random_text(
                rng, int(0.8 * chars_per_s * dur), int(1.2 * chars_per_s * dur))
            lines.append(f"{name}|{text}|{text}")
            seconds.append(dur)
        with open(os.path.join(root, meta), "w", encoding="utf-8") as f:
            f.write("\n".join(lines) + "\n")
    return {"clips": len(seconds), "audio_s": float(sum(seconds)), "min_s": min(seconds), "max_s": max(seconds)}


def train_config(root: str, out: str, epochs: int):
    """The LJSpeech VITS recipe's settings (`recipes/ljspeech/vits_tts/
    train_vits.py`) at the default full width, in float32 (phase a sets the
    recipe's `mixed_precision`) and with the `en_rules` phonemes (no
    espeak on the card's machine)."""
    from tpu_tts_torch.config.shared_configs import BaseDatasetConfig
    from tpu_tts_torch.configs.vits_config import VitsConfig

    return VitsConfig(
        batch_size=TRAIN_BATCH, eval_batch_size=TRAIN_EVAL_CLIPS, batch_group_size=5, num_loader_workers=4,
        run_eval=True, test_delay_epochs=-1, epochs=epochs, print_step=1, save_step=0, save_n_checkpoints=10,
        output_path=out, use_phonemes=True, phonemizer="en_rules", phoneme_language="en",
        text_cleaner="phoneme_cleaners", training_seed=SEED + 1,
        datasets=[BaseDatasetConfig(formatter="ljspeech", dataset_name="smoke", path=root,
                                    meta_file_train="metadata.csv", meta_file_val="metadata_val.csv")])


class TrainProbe:
    """Watches a `Trainer` without changing what it computes: per step the
    wall time (host clock, synchronised), CUDA events around each sub-step's
    loss and backward and each optimizer update, the losses, the batch's
    clips and seconds of audio; the MAS host round trips (of a model whose
    module calls `maximum_path`: VITS, DelightfulTTS); at the second step,
    every parameter whose gradient is missing or zero."""

    def __init__(self, trainer):
        import torch

        model_module = sys.modules[type(trainer.model).__module__]

        self.steps, self.mas_ms, self.zero_grads, self.cur = [], [], None, None
        self.sr = trainer.model.config.audio.sample_rate
        model = trainer.model
        names = {id(p): n for part in (model.net, getattr(model, "disc", None)) if part is not None
                 for n, p in part.named_parameters()}
        orig_loss = model.loss_fn

        def loss_fn(batch, optimizer_idx, generator=None, draws=None):
            self._mark(f"loss{optimizer_idx}")
            loss, logs = orig_loss(batch, optimizer_idx, generator=generator,
                                   **({} if draws is None else {"draws": draws}))
            if self.cur is not None:
                self.cur["logs"].update({f"opt{optimizer_idx}_{k}": v.detach() for k, v in logs.items()})
            return loss, logs

        model.loss_fn = loss_fn
        for idx, opt in enumerate(trainer.optimizers):
            def step(orig=opt.step, idx=idx, opt=opt):
                self._mark(f"opt{idx}_start")
                if len(self.steps) == 1 and self.cur is not None:  # the second step
                    zero = [names.get(id(p), "?") for p in opt.params
                            if p.grad is None or not bool(p.grad.abs().max() > 0)]
                    self.zero_grads = (self.zero_grads or []) + zero
                applied = orig()
                self._mark(f"opt{idx}_end")
                return applied
            opt.step = step

        orig_step = trainer.train_step

        def train_step(batch):
            samples = batch["waveform_lengths"].sum() if "waveform_lengths" in batch else batch["waveform"].numel()
            self.cur = {"events": {}, "logs": {}, "clips": int(batch["waveform"].shape[0]),
                        "audio_s": float(samples) / self.sr}
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            out = orig_step(batch)
            torch.cuda.synchronize()
            self.cur["wall_s"] = time.perf_counter() - t0
            self.steps.append(self.cur)
            self.cur = None
            return out

        trainer.train_step = train_step
        orig_mas = getattr(model_module, "maximum_path", None)

        def maximum_path(value, mask):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            path = orig_mas(value, mask)
            torch.cuda.synchronize()
            if self.cur is not None:
                self.mas_ms.append((time.perf_counter() - t0) * 1e3)
            return path

        if orig_mas is None:
            self._restore = lambda: None
            return
        model_module.maximum_path = maximum_path
        self._restore = lambda: setattr(model_module, "maximum_path", orig_mas)

    def _mark(self, name: str):
        import torch

        if self.cur is not None:
            ev = torch.cuda.Event(enable_timing=True)
            ev.record()
            self.cur["events"][name] = ev

    def close(self):
        self._restore()

    def step_ms(self, step: dict) -> dict:
        ev = step["events"]
        ms = lambda a, b: ev[a].elapsed_time(ev[b])  # noqa: E731
        return {"d_substep_ms": ms("loss0", "opt0_start"), "g_substep_ms": ms("loss1", "opt1_start"),
                "optimizer_ms": ms("opt0_start", "opt0_end") + ms("opt1_start", "opt1_end"),
                "step_ms": ms("loss0", "opt1_end"), "wall_ms": step["wall_s"] * 1e3}

    @staticmethod
    def losses(step: dict) -> dict:
        return {k: float(v) for k, v in step["logs"].items()}


def randomize_module(module, gen):
    """Every parameter from a seeded generator: weight-norm gains and layer-norm
    scales ≈ 1 ± 0.1, the rest ~N(0, 0.1²), so that the zero-initialised
    flow and spline projections do work."""
    import torch

    with torch.no_grad():
        for name, p in module.named_parameters():
            if name.endswith(("original0", "gamma")):
                p.copy_(1 + 0.1 * (2 * torch.rand(p.shape, generator=gen) - 1))
            else:
                p.copy_(0.1 * torch.randn(p.shape, generator=gen))


def check_train_step_card_vs_cpu(mixed: bool = False) -> dict:
    """One D step and one G step at a tiny config (hidden 32, HiFi-GAN 32 →
    8 over ×4 ×4) on the card against the same step on the CPU: the same
    weights, batch and draws; losses within TRAIN_STEP_TOL[0] relative, each
    gradient within TRAIN_STEP_TOL[1] of its tensor's largest |gradient|
    (plus 1e-6 for gradients that are 0 analytically). Float32 with TF32 off
    on both; the rest is the order of the sums (cuDNN against the CPU's
    kernels). With `mixed` (bfloat16 compute on float32 parameters): losses
    within MP_LOSS_TOL relative, every parameter float32 on both devices;
    the gradients' relative L2 distance is printed, not bounded (bfloat16
    rounds cuDNN's sums and the CPU's differently, and a GAN step's
    gradients carry that noise, `tests/test_torch_port_precision.py`)."""
    import numpy as np
    import torch

    from tpu_tts_torch.configs.vits_config import VitsArgs, VitsAudioConfig, VitsConfig
    from tpu_tts_torch.models.vits import Vits

    args = dict(num_chars=40, hidden_channels=32, hidden_channels_ffn_text_encoder=48, num_heads_text_encoder=2,
                num_layers_text_encoder=2, num_layers_flow=2, out_channels=33, num_layers_posterior_encoder=1,
                spec_segment_size=4, upsample_rates_decoder=[4, 4], upsample_kernel_sizes_decoder=[8, 8],
                upsample_initial_channel_decoder=32, resblock_kernel_sizes_decoder=[3, 7],
                resblock_dilation_sizes_decoder=[[1, 3], [1, 3]], periods_multi_period_discriminator=[2],
                dropout_p_text_encoder=0.0, dropout_p_duration_predictor=0.0)
    config = VitsConfig(model_args=VitsArgs(**args), audio=VitsAudioConfig(fft_size=64, win_length=64, hop_length=16,
                                                                           num_mels=20), mixed_precision=mixed)
    models = {}
    for dev in ("cpu", "cuda"):
        m = Vits(config, device=dev)
        m.init_training()
        models[dev] = m
    gen = torch.Generator().manual_seed(SEED)
    randomize_module(models["cpu"].net, gen)
    randomize_module(models["cpu"].disc, gen)
    models["cuda"].load_training_state(models["cpu"].training_state_dict(), strict=True)
    rng = np.random.default_rng(SEED)
    B, T_x, T_spec, hop = 2, 11, 24, 16
    wav = np.zeros((B, 1, T_spec * hop), np.float32)
    for i, n in enumerate((T_spec, 18)):
        t = np.arange(n * hop)
        wav[i, 0, : n * hop] = 0.4 * np.sin(2 * np.pi * (0.03 + 0.01 * i) * t) + 0.05 * rng.standard_normal(n * hop)
    x = np.zeros((B, T_x), np.int64)
    x[0], x[1, :7] = rng.integers(1, 40, T_x), rng.integers(1, 40, 7)
    batch = {"text_input": x, "text_lengths": np.array([T_x, 7]), "mel_lengths": np.array([T_spec, 18]), "waveform": wav}
    draws = {"posterior": rng.standard_normal((B, 32, T_spec)).astype(np.float32),
             "sdp": rng.standard_normal((B, 2, T_x)).astype(np.float32), "segments": rng.uniform(size=B).astype(np.float32)}
    loss_tol = MP_LOSS_TOL if mixed else TRAIN_STEP_TOL[0]
    out = {"mixed_precision": mixed, "loss_tol": loss_tol, "grad_tol": None if mixed else TRAIN_STEP_TOL[1]}
    worst_loss, worst_grad, l2 = 0.0, 0.0, {}
    for idx in (0, 1):
        res = {}
        for dev, m in models.items():
            m.train(True)
            b = {k: torch.from_numpy(v).to(dev) for k, v in batch.items()}
            d = {k: torch.from_numpy(v).to(dev) for k, v in draws.items()}
            loss, logs = m.loss_fn(b, idx, draws=d)
            loss.backward()
            mod = m.disc if idx == 0 else m.net
            res[dev] = ({k: float(v) for k, v in logs.items()},
                        {n: p.grad.detach().cpu() for n, p in mod.named_parameters() if p.grad is not None})
            m.disc.zero_grad(set_to_none=True)
            m.net.zero_grad(set_to_none=True)
        (lc, gc), (lg, gg) = res["cpu"], res["cuda"]
        for k in lc:
            worst_loss = max(worst_loss, abs(lc[k] - lg[k]) / max(1.0, abs(lc[k])))
        if set(gc) != set(gg) or not gc:
            raise AssertionError(f"the card and the CPU gave gradients to different parameters ({idx})")
        for n in gc:
            scale = float(gc[n].abs().max())
            worst_grad = max(worst_grad, (float((gc[n] - gg[n]).abs().max()) - 1e-6) / max(scale, 1e-12))
        vc, vg = torch.cat([gc[n].flatten() for n in gc]), torch.cat([gg[n].flatten() for n in gc])
        l2[idx] = float((vc - vg).norm() / vc.norm())
        out[f"losses_{idx}"] = {k: [lc[k], lg[k]] for k in lc}
    dtypes = sorted({str(p.dtype) for m in models.values() for p in list(m.net.parameters()) + list(m.disc.parameters())})
    out.update(max_loss_rel_err=worst_loss, max_grad_err_of_max=worst_grad, grad_l2_rel_err=l2, param_dtypes=dtypes)
    log(("train mixed card vs cpu " if mixed else "train card vs cpu ") + json.dumps(out))
    if not worst_loss <= loss_tol or dtypes != ["torch.float32"] or not (mixed or worst_grad <= TRAIN_STEP_TOL[1]):
        raise AssertionError(f"the tiny train step on the card disagrees with the CPU: {out}")
    return out


def check_mrf_refuses_gradient() -> dict:
    """K1 has no backward: an eval()-mode generator on the card whose
    parameters require grad, or a CUDA input that does, raises; under
    no_grad the same call runs through the kernel."""
    import torch

    from tpu_tts_torch.ops import hifigan_mrf
    from tpu_tts_torch.vocoder.models.hifigan_generator import HifiganGenerator

    gen = HifiganGenerator(in_channels=16, upsample_initial_channel=128, upsample_factors=(2, 2),
                           upsample_kernel_sizes=(4, 4)).cuda().eval()
    x = torch.randn(1, 16, 20, device="cuda")
    raised = []
    for call in (lambda: gen(x), lambda: hifigan_mrf.mrf_stack(torch.randn(1, 64, 40, device="cuda",
                                                                            requires_grad=True), gen.mrf_stage(0))):
        try:
            call()
        except RuntimeError as e:
            raised.append("no backward" in str(e))
        else:
            raised.append(False)
    before = hifigan_mrf.launches
    with torch.no_grad():
        y = gen(x)
    torch.cuda.synchronize()
    out = {"raised": raised, "no_grad_launches": hifigan_mrf.launches - before, "no_grad_shape": list(y.shape)}
    log("train mrf guard " + json.dumps(out))
    if raised != [True, True] or out["no_grad_launches"] != 2 * 18:
        raise AssertionError(f"mrf_stack's gradient guard: {out}")
    return out


def serve_trained(paths: dict, device: str = "cuda", label: str = "train serve", max_saturated: float = None) -> dict:
    """The trained checkpoint through the port's `Synthesizer` and `/api/tts`
    (the locked path): one request of one sentence, its K1 launches counted
    (72 expected), its WAV checked; then the served model's waveform against
    the same model with the plain MRF version (≤ 1e-3), and with
    `max_saturated` at most that share of its samples at |x| > 0.999."""
    import numpy as np
    import scipy.io.wavfile
    import torch

    from tpu_tts_torch.ops import hifigan_mrf
    from tpu_tts_torch.server.server import TTSHandler, create_server

    args = argparse.Namespace(**paths, device=device, host="127.0.0.1", port=0)
    server = create_server(args)
    if TTSHandler._batcher is not None:
        TTSHandler._batcher.close()
        TTSHandler._batcher = None
    thread = threading.Thread(target=server.serve_forever, daemon=True)
    thread.start()
    try:
        hifigan_mrf.launches = 0
        t0 = time.perf_counter()
        url = f"http://127.0.0.1:{server.server_address[1]}/api/tts?text={urllib.parse.quote(TEXTS[1])}"
        with urllib.request.urlopen(url, timeout=600) as r:
            status, body = r.status, r.read()
        latency = time.perf_counter() - t0
        launches = hifigan_mrf.launches
        sr, pcm = scipy.io.wavfile.read(io.BytesIO(body))
        model = TTSHandler.synthesizer.tts_model
        ids = model.tokenizer.text_to_ids(TEXTS[1])
        got = model.inference(ids)["model_outputs"]
        with plain_mrf():
            ref = model.inference(ids)["model_outputs"]
        out = {"status": status, "sample_rate": sr, "samples": int(pcm.size), "latency_s": latency,
               "hifigan_mrf_launches": launches, "max_abs_err_vs_plain": float((got - ref).abs().max()),
               "rms": float(ref.pow(2).mean().sqrt()), "saturated": float((ref.abs() > 0.999).float().mean()),
               "tol": 1e-3}
    finally:
        server.shutdown()
        server.server_close()
        thread.join(timeout=30)
    log(f"{label} " + json.dumps(out))
    if status != 200 or launches != 72 or not np.isfinite(pcm).all() or pcm.size == 0 \
            or not torch.isfinite(got).all() or out["max_abs_err_vs_plain"] > 1e-3 or out["rms"] == 0 \
            or (max_saturated is not None and out["saturated"] > max_saturated):
        raise AssertionError(f"the trained checkpoint did not serve through K1: {out}")
    return out


def overfit_one_batch(config, train_samples, device: str = "cuda") -> dict:
    """OVERFIT_STEPS steps of a fresh model (seed 0, the decoder at unit
    gain as in `train_phase`) on one fixed batch, each with the same draws
    and dropout masks: the median mel loss of the last 10 steps must fall
    below the first step's."""
    import statistics

    import torch

    from tpu_tts_torch.models.vits import Vits
    from tpu_tts_torch.train import Trainer, TrainerArgs

    torch.manual_seed(SEED)
    model = Vits.init_from_config(config, device=device)
    unit_gain_decoder(model.net.waveform_decoder)
    trainer = Trainer(TrainerArgs(device=device), model.config, config.output_path, model=model,
                      train_samples=train_samples)
    batch = next(iter(model.get_data_loader(trainer.config, {}, is_eval=False, samples=train_samples, verbose=False)))
    mel, kl = [], []
    for _ in range(OVERFIT_STEPS):
        trainer.generator.manual_seed(SEED)
        torch.manual_seed(SEED)
        logs = trainer.train_step(batch)
        mel.append(float(logs["opt1_loss_mel"]))
        kl.append(float(logs["opt1_loss_kl"]))
    out = {"steps": len(mel), "loss_mel": mel, "loss_kl_first_last": [kl[0], kl[-1]],
           "first": mel[0], "median_last10": statistics.median(mel[-10:])}
    log("train overfit " + json.dumps(out))
    if not out["median_last10"] < out["first"]:
        raise AssertionError(f"{OVERFIT_STEPS} steps on one batch did not lower the mel loss: {out}")
    del trainer, model
    torch.cuda.empty_cache()
    return out


def train_phase(tmp: str, device: str = "cuda") -> dict:
    """The port's training path on the card: the default full-width VITS at
    batch 32, its decoder redrawn at unit gain (with the default He-normal
    init, which `tpu_tts` shares, the decoder's tanh saturates within ten
    steps of training from scratch and its mel loss sticks at ≈ 242), trained through `Trainer.fit` for TRAIN_EPOCHS epochs (2 steps
    each) on 64 clips written from a seed; then one more epoch uninterrupted
    and the same epoch resumed from the saved checkpoint by a new model and
    trainer (`continue_path`), whose first step must equal; a profile of one
    step; OVERFIT_STEPS steps of a fresh model on one fixed batch with fixed
    draws, which must lower the mel loss; and the trained checkpoint served
    through K1."""
    import math

    import torch

    from tpu_tts_torch.data import load_tts_samples
    from tpu_tts_torch.models.vits import Vits
    from tpu_tts_torch.ops import hifigan_mrf
    from tpu_tts_torch.train import Trainer, TrainerArgs
    from tpu_tts_torch.train.checkpoint import get_last_checkpoint

    guard = check_mrf_refuses_gradient()
    tiny = check_train_step_card_vs_cpu()
    root, out = os.path.join(tmp, "data"), os.path.join(tmp, "run")
    data = write_ljspeech(root)
    log("train data " + json.dumps(data))
    config = train_config(root, out, TRAIN_EPOCHS)
    train_samples, eval_samples = load_tts_samples(config.datasets, eval_split=True)
    torch.manual_seed(SEED)
    model = Vits.init_from_config(config, device=device)
    unit_gain_decoder(model.net.waveform_decoder)
    trainer = Trainer(TrainerArgs(device=device), model.config, out, model=model, train_samples=train_samples,
                      eval_samples=eval_samples)
    probe = TrainProbe(trainer)
    try:
        torch.cuda.empty_cache()
        torch.cuda.reset_peak_memory_stats()
        before_gb = torch.cuda.memory_allocated() / 2**30
        hifigan_mrf.launches = 0
        t0 = time.perf_counter()
        trainer.fit()
        fit_s = time.perf_counter() - t0
        train_launches = hifigan_mrf.launches
        peak_gb = torch.cuda.max_memory_allocated() / 2**30
        steps = list(probe.steps)
        checkpoint, _ = get_last_checkpoint(out)

        first, last = TrainProbe.losses(steps[0]), TrainProbe.losses(steps[-1])
        timed = [probe.step_ms(s) for s in steps[1:]]  # the first step warms cuDNN up
        mean = {k: sum(t[k] for t in timed) / len(timed) for k in timed[0]}
        wall = sum(s["wall_s"] for s in steps[1:])
        row = {"steps": len(steps), "epochs": TRAIN_EPOCHS, "batch": TRAIN_BATCH, "fit_s": fit_s, **mean,
               "clips_per_s": sum(s["clips"] for s in steps[1:]) / wall,
               "audio_s_per_s": sum(s["audio_s"] for s in steps[1:]) / wall,
               "mas_round_trip_ms": sum(probe.mas_ms) / len(probe.mas_ms), "mas_calls": len(probe.mas_ms),
               "peak_allocated_gb": peak_gb, "allocated_before_gb": before_gb, "hifigan_mrf_launches": train_launches,
               "params": sum(p.numel() for p in model.net.parameters()) + sum(p.numel() for p in model.disc.parameters())}
        log("train steps " + json.dumps(row))
        log("train losses " + json.dumps({"first": first, "last": last}))
        bad = [k for s in steps for k, v in TrainProbe.losses(s).items() if not math.isfinite(v)]
        if bad or probe.zero_grads is None or probe.zero_grads:
            raise AssertionError(f"non-finite losses {bad[:5]} or parameters without a gradient "
                                 f"{(probe.zero_grads or ['(none checked)'])[:8]}")
        if train_launches != 0:
            raise AssertionError(f"training launched K1 {train_launches} times; it has no backward")

        # one more epoch, uninterrupted, then the same epoch resumed from the checkpoint
        n0 = len(probe.steps)
        trainer.config.epochs = TRAIN_EPOCHS + 1
        trainer.fit()
        uninterrupted = TrainProbe.losses(probe.steps[n0])
        model_b = Vits.init_from_config(train_config(root, out, TRAIN_EPOCHS + 1), device=device)
        trainer_b = Trainer(TrainerArgs(device=device, continue_path=checkpoint), model_b.config,
                            os.path.join(tmp, "resumed"), model=model_b, train_samples=train_samples,
                            eval_samples=eval_samples)
        probe_b = TrainProbe(trainer_b)
        try:
            trainer_b.fit()
        finally:
            probe_b.close()
        resumed = TrainProbe.losses(probe_b.steps[0])
        rel = max(abs(resumed[k] - uninterrupted[k]) / max(1.0, abs(uninterrupted[k])) for k in uninterrupted)
        log("train resume " + json.dumps({"checkpoint": os.path.basename(checkpoint), "step": trainer_b.total_steps_done,
                                          "max_rel_err": rel, "tol": RESUME_TOL, "uninterrupted": uninterrupted,
                                          "resumed": resumed}))
        if set(resumed) != set(uninterrupted) or not rel <= RESUME_TOL:
            raise AssertionError(f"the resumed run's next step differs from the uninterrupted run's: {rel}")
        del trainer_b, model_b, probe_b
        serve_path = get_last_checkpoint(out)[0]

        profile_batch = next(iter(model.get_data_loader(trainer.config, {}, is_eval=False, samples=train_samples,
                                                         verbose=False)))
        profile_call(lambda: trainer.train_step(profile_batch), {"model": "vits", "call": "one training step (D then G)",
                                                                "batch": TRAIN_BATCH}, top=10)
    finally:
        probe.close()
    del trainer, model, profile_batch
    torch.cuda.empty_cache()
    overfit = overfit_one_batch(train_config(root, os.path.join(tmp, "overfit"), 1), train_samples, device)
    served = serve_trained({"model_path": serve_path, "config_path": os.path.join(out, "config.json")}, device)
    return {**row, "guard": guard, "tiny": tiny, "resume_max_rel_err": rel, "overfit": overfit, "served": served}


# ---------------------------------------------------------------- K1 at the XTTS chunk shapes
XTTS_CHUNK_FRAMES = (34, 104)  # decoder frames of a first chunk of 8 latents and of a chunk of 4 + 20


def check_mrf_kernel_xtts() -> list:
    """K1 against `mrf_stack_reference` at the XTTS decoder's stage shapes of
    a chunk (C = 256/128/64/32 at T = 8/64/128/256 × XTTS_CHUNK_FRAMES) at
    B = 1 and B = 8, float32: each shape's error, time, plain time and bound,
    and their sums per chunk shape."""
    import torch

    from tpu_tts_torch.ops import hifigan_mrf

    gen = torch.Generator(device="cuda").manual_seed(SEED + 2)
    rows = []
    for frames in XTTS_CHUNK_FRAMES:
        for B in (1, 8):
            group = []
            for C, up in ((256, 8), (128, 64), (64, 128), (32, 256)):
                T = frames * up
                x, stage = mrf_stage_inputs(C, T, torch.float32, gen, B=B)
                got = hifigan_mrf.mrf_stack(x, stage)
                ref = hifigan_mrf.mrf_stack_reference(x, stage)
                torch.cuda.synchronize()
                err = float((got - ref).abs().max())
                row = {"frames": frames, "B": B, "C": C, "T": T, "max_abs_err": err, "tol": F32_TOL,
                       "ms": cuda_ms(lambda: hifigan_mrf.mrf_stack(x, stage), 5),
                       "plain_ms": cuda_ms(lambda: hifigan_mrf.mrf_stack_reference(x, stage), 5),
                       **mrf_work(stage, B, C, T, torch.float32)}
                group.append(row)
                if not bool(torch.isfinite(got).all()) or err > F32_TOL:
                    raise AssertionError(f"hifigan_mrf disagrees with its plain version at the XTTS shape {row}")
            rows += group
            log(f"kernel hifigan_mrf xtts chunk frames={frames} B={B}: " + json.dumps({
                k: sum(r[k] for r in group) for k in ("ms", "plain_ms", "bound_ms", "bound_cuda_core_ms")}
                | {"max_abs_err": max(r["max_abs_err"] for r in group), "bound_by": "operations"
                   if all(r["bound_by"] == "operations" for r in group) else "bytes"}))
    return rows


# ---------------------------------------------------------------- XTTS fine-tuning
XTTS_TRAIN_CLIPS, XTTS_TRAIN_EVAL_CLIPS, XTTS_TRAIN_BATCH = 6, 3, 3  # the recipe's batch 3: 2 steps an epoch
XTTS_TRAIN_EPOCHS = 2  # then one more epoch, resumed and uninterrupted
XTTS_TINY = dict(gpt_layers=2, gpt_n_heads=2, gpt_n_model_channels=32, gpt_number_text_tokens=50,
                 gpt_num_audio_tokens=1026, num_cond_latents=4, d_vector_dim=16, decoder_input_dim=32,
                 gpt_start_text_token=48)
DVAE_CODE_SHARE = 0.999  # DVAE codes equal on the card and the CPU; the rest within 1e-4 of the best distance


def xtts_train_config(root: str, out: str, model_dir: str, epochs: int, args=None):
    """The XTTS-v2 GPT fine-tuning recipe (`recipes/ljspeech/xtts_v2/
    train_gpt_xtts.py`): batch 3, AdamW lr 5e-6, betas 0.9/0.96, eps 1e-8,
    weight decay 1e-2, the exponential schedule (gamma 0.5 over 50000
    steps), on the clips at `root` (LJSpeech's layout, English)."""
    from tpu_tts_torch.config.shared_configs import BaseDatasetConfig
    from tpu_tts_torch.configs.xtts_config import XttsArgs, XttsConfig

    return XttsConfig(
        model_args=args or XttsArgs(), model_dir=model_dir, batch_size=XTTS_TRAIN_BATCH,
        eval_batch_size=XTTS_TRAIN_BATCH, num_loader_workers=2, run_eval=True, test_delay_epochs=-1, epochs=epochs,
        print_step=1, save_step=0, save_n_checkpoints=1, optimizer="adamw",
        optimizer_params={"betas": [0.9, 0.96], "eps": 1e-8, "weight_decay": 1e-2}, lr=5e-6,
        lr_scheduler="exponential", lr_scheduler_params={"gamma": 0.5, "decay_steps": 50000},
        training_seed=SEED + 1, output_path=out,
        datasets=[BaseDatasetConfig(formatter="ljspeech", dataset_name="smoke", path=root, language="en",
                                    meta_file_train="metadata.csv", meta_file_val="metadata_val.csv")])


def xtts_batch(model, samples, seed: int = SEED) -> dict:
    """One collated fine-tuning batch of `samples` (the loader's first at epoch 0)."""
    loader = model.get_data_loader(model.config, {}, is_eval=False, samples=samples, verbose=False)
    loader.set_epoch(seed)
    return next(iter(loader))


class XttsTrainProbe:
    """Watches a fine-tuning `Trainer`: per step the wall time, CUDA events
    around the targets (mels and DVAE codes), the loss's forward and
    backward and the update; the losses; the batch's clips and seconds of
    audio; at the second step, every trained parameter whose gradient is
    missing or zero."""

    def __init__(self, trainer):
        import torch

        self.steps, self.zero_grads, self.cur = [], None, None
        model, (opt,) = trainer.model, trainer.optimizers
        names = {id(p): n for n, p in model.net.named_parameters()}
        orig_targets, orig_loss, orig_step, orig_train_step = model.targets, model.loss_fn, opt.step, trainer.train_step

        def targets(batch):
            self._mark("targets_start")
            out = orig_targets(batch)
            self._mark("targets_end")
            return out

        def loss_fn(batch, optimizer_idx=0, generator=None):
            self._mark("loss")
            loss, logs = orig_loss(batch, optimizer_idx, generator=generator)
            if self.cur is not None:
                self.cur["logs"] = {"loss": loss.detach(), **{k: v.detach() for k, v in logs.items()}}
            return loss, logs

        def step():
            self._mark("opt_start")
            if len(self.steps) == 1 and self.cur is not None:
                self.zero_grads = [names.get(id(p), "?") for p in opt.params
                                   if p.grad is None or not bool(p.grad.abs().max() > 0)]
            applied = orig_step()
            self._mark("opt_end")
            return applied

        def train_step(batch):
            self.cur = {"events": {}, "logs": {}, "clips": int(batch["wav"].shape[0]),
                        "audio_s": float(batch["wav_lengths"].sum()) / model.args.input_sample_rate}
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            out = orig_train_step(batch)
            torch.cuda.synchronize()
            self.cur["wall_s"] = time.perf_counter() - t0
            self.steps.append(self.cur)
            self.cur = None
            return out

        model.targets, model.loss_fn, opt.step, trainer.train_step = targets, loss_fn, step, train_step

    def _mark(self, name: str):
        import torch

        if self.cur is not None:
            ev = torch.cuda.Event(enable_timing=True)
            ev.record()
            self.cur["events"][name] = ev

    @staticmethod
    def step_ms(step: dict) -> dict:
        ev = step["events"]
        ms = lambda a, b: ev[a].elapsed_time(ev[b])  # noqa: E731
        return {"targets_ms": ms("targets_start", "targets_end"), "forward_backward_ms": ms("targets_end", "opt_start"),
                "update_ms": ms("opt_start", "opt_end"), "step_ms": ms("loss", "opt_end"), "wall_ms": step["wall_s"] * 1e3}

    @staticmethod
    def losses(step: dict) -> dict:
        return {k: float(v) for k, v in step["logs"].items()}


def tiny_xtts_pair(args):
    """A tiny `Xtts` (`args`) with seeded weights on the CPU and the same on the card."""
    import torch

    from tpu_tts_torch.configs.xtts_config import XttsConfig
    from tpu_tts_torch.models.xtts import Xtts

    models = {dev: Xtts(XttsConfig(model_args=args, batch_size=XTTS_TRAIN_BATCH), device=dev) for dev in ("cpu", "cuda")}
    randomize_module(models["cpu"].net.gpt, torch.Generator().manual_seed(SEED))
    models["cuda"].net.load_state_dict(models["cpu"].net.state_dict(), strict=True)
    return models


def check_xtts_train_card_vs_cpu(samples) -> dict:
    """On a batch of the smoke's clips: the full-width DVAE (seed 0) on the
    card against the CPU, the share of equal codes ≥ DVAE_CODE_SHARE and each
    other code's distance within 1e-4 (relative) of the best; then one step's
    loss and gradients of a tiny XTTS (XTTS_TINY) on the card against the
    CPU on the CPU's codes: losses within TRAIN_STEP_TOL[0] relative, each
    gradient within TRAIN_STEP_TOL[1] of its tensor's largest |gradient|."""
    import torch

    from tpu_tts_torch.configs.xtts_config import XttsArgs

    models = tiny_xtts_pair(XttsArgs(**XTTS_TINY))
    for m in models.values():
        m.load_dvae()
        m.bpe.encode = xtts_token_ids
    batch = xtts_batch(models["cpu"], samples)
    cpu = models["cpu"]
    mel = cpu._dvae_mel(batch["wav"])
    codes_cpu = cpu.dvae.get_codebook_indices(mel)
    codes_card = models["cuda"].dvae.get_codebook_indices(mel.cuda()).cpu()
    same = codes_cpu == codes_card
    z = cpu.dvae.encode_latents(mel).double().transpose(1, 2)
    embed = cpu.dvae.codebook.embed.double()
    dist = z.pow(2).sum(-1, keepdim=True) - 2 * z @ embed + embed.pow(2).sum(0)
    d_cpu, d_card = dist.gather(-1, codes_cpu[..., None])[..., 0], dist.gather(-1, codes_card[..., None])[..., 0]
    gap = float(((d_card - d_cpu) / d_cpu.abs().clamp_min(1.0)).abs().max())
    out = {"dvae_codes": int(same.numel()), "dvae_equal_share": float(same.float().mean()),
           "dvae_distinct_codes": int(codes_cpu.unique().numel()), "dvae_max_rel_distance_gap": gap}
    if out["dvae_equal_share"] < DVAE_CODE_SHARE or gap > 1e-4:
        raise AssertionError(f"the DVAE's codes on the card disagree with the CPU's: {out}")

    cond_mel = cpu._style_mel(batch["cond_wav"])
    stride = cpu.args.gpt_code_stride
    b = {"text_tokens": batch["text_tokens"], "text_lengths": batch["text_lengths"], "cond_mel": cond_mel,
         "audio_codes": codes_cpu, "code_lengths": (batch["wav_lengths"] + stride - 1) // stride + 3}
    res = {}
    for dev, m in models.items():
        m.train(True)
        loss, logs = m.loss_fn({k: v.to(m.device) for k, v in b.items()})
        loss.backward()
        res[dev] = ({"loss": float(loss), **{k: float(v) for k, v in logs.items()}},
                    {n: p.grad.cpu() for n, p in m.net.named_parameters() if p.grad is not None})
    (lc, gc), (lg, gg) = res["cpu"], res["cuda"]
    worst_loss = max(abs(lc[k] - lg[k]) / max(1.0, abs(lc[k])) for k in lc)
    if set(gc) != set(gg) or not gc or any(not n.startswith("gpt.") for n in gc):
        raise AssertionError("the card and the CPU gave gradients to different parameters, or to frozen ones")
    worst_grad = max((float((gc[n] - gg[n]).abs().max()) - 1e-6) / max(float(gc[n].abs().max()), 1e-12) for n in gc)
    out.update(losses={k: [lc[k], lg[k]] for k in lc}, max_loss_rel_err=worst_loss, max_grad_err_of_max=worst_grad,
               loss_tol=TRAIN_STEP_TOL[0], grad_tol=TRAIN_STEP_TOL[1])
    log("xtts train card vs cpu " + json.dumps(out))
    if not (worst_loss <= TRAIN_STEP_TOL[0] and worst_grad <= TRAIN_STEP_TOL[1]):
        raise AssertionError(f"the tiny fine-tune step on the card disagrees with the CPU: {out}")
    return out


def save_xtts_base(tmp: str, device: str = "cuda") -> dict:
    """The base model directory to fine-tune: `save_xtts`'s full-width
    XTTS-v2 from seed 0 with the stop code's head bias left as drawn."""
    return save_xtts(tmp, device=device, stop_bias=False)


def serve_finetuned(run_dir: str, device: str = "cuda") -> dict:
    """The fine-tuned run directory served as a model directory by
    `/api/tts_stream` (`--model_dir`): one stream of a bundled speaker,
    checked as the XTTS phase checks one (HTTP 200, chunked PCM16, the length
    its tokens give, 72 K1 launches a chunk); then the served model's decoder
    on a chunk's latents against the plain MRF (≤ XTTS_TOL)."""
    import torch

    from tpu_tts_torch.infer.xtts_pool import XttsStreamPool
    from tpu_tts_torch.ops import hifigan_mrf
    from tpu_tts_torch.server.server import TTSHandler, create_server

    server = create_server(argparse.Namespace(model_dir=run_dir, device=device, host="127.0.0.1", port=0,
                                              max_streams=1))
    model = TTSHandler.synthesizer.tts_model
    model.bpe.encode = xtts_token_ids
    pool = XttsStreamPool(model, max_streams=1, **XTTS_STREAM)
    TTSHandler._pool = pool
    streams, submit = {}, pool.submit

    def recording_submit(**kwargs):
        stream = submit(**kwargs)
        streams[kwargs["text"]] = stream
        return stream

    pool.submit = recording_submit
    dec = model.net.hifigan_decoder["waveform_decoder"]
    per_call = sum(hifigan_mrf.launches_per_stage(dec.mrf_stage(i)) for i in range(dec.num_upsamples))
    thread = threading.Thread(target=server.serve_forever, daemon=True)
    thread.start()
    try:
        cond, spk = model.speaker_latents(XTTS_SPEAKERS[0])
        for _ in pool.submit(text="Warm up.", gpt_cond_latent=cond, speaker_embedding=spk, max_tokens=28):
            pass
        hifigan_mrf.launches = 0
        query = f"text={urllib.parse.quote(XTTS_TEXTS[0])}&speaker_id={urllib.parse.quote(XTTS_SPEAKERS[0])}"
        reply = stream_request(f"http://127.0.0.1:{server.server_address[1]}", query)
        launches = hifigan_mrf.launches
        plan = check_stream_reply(model, reply, streams[XTTS_TEXTS[0]].codes, "fine-tuned stream")
        text, lengths = model._bucket_text(torch.tensor([xtts_token_ids(XTTS_TEXTS[0])], device=model.device))
        _, lats, _ = model.net.generate_latents(cond, text, torch.Generator(device=model.device).manual_seed(SEED), 24,
                                                0.75, 50, lengths)
        got = model.net.decode_latents(lats, spk)
        with plain_mrf():
            ref = model.net.decode_latents(lats, spk)
        out = {"files": sorted(os.listdir(run_dir)), "tokens": len(streams[XTTS_TEXTS[0]].codes), "chunks": len(plan), "samples": int(reply["pcm"].size),
               "first_chunk_ms": reply["first_s"] * 1e3, "wall_s": reply["wall_s"], "hifigan_mrf_launches": launches,
               "launches_per_chunk": launches // len(plan), "decoder_max_abs_err_vs_plain":
               float((got - ref).abs().max()), "tol": XTTS_TOL}
    finally:
        server.shutdown()
        server.server_close()
        thread.join(timeout=30)
        pool.close()
        TTSHandler._pool = None
    log("xtts train serve " + json.dumps(out))
    if launches != per_call * len(plan) or out["decoder_max_abs_err_vs_plain"] > XTTS_TOL:
        raise AssertionError(f"the fine-tuned model did not stream through K1: {out}")
    return out


def xtts_overfit(config, samples, base_ckpt: str, device: str = "cuda") -> dict:
    """OVERFIT_STEPS fine-tuning steps of the base model on one fixed batch:
    the median loss of the last 10 must fall below the first step's."""
    import statistics

    import torch

    from tpu_tts_torch.models.xtts import Xtts
    from tpu_tts_torch.train import Trainer, TrainerArgs

    model = Xtts(config, device=device)
    model.bpe.encode = xtts_token_ids
    trainer = Trainer(TrainerArgs(device=device, restore_path=base_ckpt), model.config, config.output_path,
                      model=model, train_samples=samples)
    batch = xtts_batch(model, samples)
    losses = [float(trainer.train_step(batch)["loss"]) for _ in range(OVERFIT_STEPS)]
    out = {"steps": len(losses), "loss": losses, "first": losses[0], "median_last10": statistics.median(losses[-10:])}
    log("xtts train overfit " + json.dumps(out))
    if not out["median_last10"] < out["first"]:
        raise AssertionError(f"{OVERFIT_STEPS} fine-tuning steps on one batch did not lower the loss: {out}")
    del trainer, model
    torch.cuda.empty_cache()
    return out


def xtts_train_phase(tmp: str, device: str = "cuda") -> dict:
    """XTTS-v2 GPT fine-tuning on the card: the DVAE and a tiny step on the
    card against the CPU; the full-width model (seed 0) saved as a model
    directory and fine-tuned through `Trainer.fit` (`restore_path` its
    checkpoint) at the recipe's batch 3 and settings on clips of 2–11.6 s
    written from a seed, XTTS_TRAIN_EPOCHS epochs of 2 steps: ms a step
    (targets, forward + backward, update), clips and seconds of audio a wall
    second, peak memory, losses, every trained gradient nonzero at step 2,
    K1 launched no time, the decoder and `speaker_proj` bit-identical; one
    more epoch uninterrupted against the same epoch resumed; OVERFIT_STEPS
    steps on one batch; the run directory served by `/api/tts_stream`."""
    import math

    import torch

    from tpu_tts_torch.data import load_tts_samples
    from tpu_tts_torch.models.xtts import Xtts
    from tpu_tts_torch.ops import hifigan_mrf
    from tpu_tts_torch.train import Trainer, TrainerArgs
    from tpu_tts_torch.train.checkpoint import get_last_checkpoint

    root, out, base = (os.path.join(tmp, d) for d in ("data", "run", "base"))
    os.makedirs(base)
    data = write_clips(root, SEED + 5, XTTS_TRAIN_CLIPS, XTTS_TRAIN_EVAL_CLIPS, (2.0, 11.6))
    log("xtts train data " + json.dumps(data))
    config = xtts_train_config(root, out, base, XTTS_TRAIN_EPOCHS)
    train_samples, eval_samples = load_tts_samples(config.datasets, eval_split=True)
    tiny = check_xtts_train_card_vs_cpu(train_samples)
    tiny_mixed = check_xtts_mixed_card_vs_cpu(train_samples)
    save_xtts_base(base, device)
    base_ckpt = os.path.join(base, "model.pth")

    model = Xtts(config, device=device)
    model.bpe.encode = xtts_token_ids
    trainer = Trainer(TrainerArgs(device=device, restore_path=base_ckpt), model.config, out, model=model,
                      train_samples=train_samples, eval_samples=eval_samples)
    frozen = {n: p.detach().clone() for n, p in model.net.named_parameters() if not n.startswith("gpt.")}
    probe = XttsTrainProbe(trainer)
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    hifigan_mrf.launches = 0
    t0 = time.perf_counter()
    trainer.fit()
    fit_s = time.perf_counter() - t0
    launches, peak_gb = hifigan_mrf.launches, torch.cuda.max_memory_allocated() / 2**30
    steps = list(probe.steps)
    timed = [XttsTrainProbe.step_ms(s) for s in steps[1:]]
    wall = sum(s["wall_s"] for s in steps[1:])
    row = {"steps": len(steps), "epochs": XTTS_TRAIN_EPOCHS, "batch": XTTS_TRAIN_BATCH, "fit_s": fit_s,
           **{k: sum(t[k] for t in timed) / len(timed) for k in timed[0]},
           "clips_per_s": sum(s["clips"] for s in steps[1:]) / wall,
           "audio_s_per_s": sum(s["audio_s"] for s in steps[1:]) / wall, "peak_allocated_gb": peak_gb,
           "trained_params": sum(p.numel() for p in model.optimizer_params(0)),
           "params": sum(p.numel() for p in model.net.parameters()), "hifigan_mrf_launches": launches}
    log("xtts train steps " + json.dumps(row))
    losses = [XttsTrainProbe.losses(s) for s in steps]
    log("xtts train losses " + json.dumps({"first": losses[0], "last": losses[-1]}))
    bad = [k for s in losses for k, v in s.items() if not math.isfinite(v)]
    moved = [n for n, p in model.net.named_parameters() if n in frozen and not torch.equal(p.detach(), frozen[n])]
    if bad or probe.zero_grads is None or probe.zero_grads or moved or launches:
        raise AssertionError(f"non-finite losses {bad[:4]}, trained parameters without a gradient "
                             f"{(probe.zero_grads or ['(none checked)'])[:6]}, frozen parameters moved {moved[:4]}, "
                             f"or {launches} K1 launches in training")

    # one more epoch uninterrupted, then the same epoch resumed from a copy of the checkpoint
    checkpoint = get_last_checkpoint(out)[0]
    resume_from = os.path.join(tmp, "resume_from.pth")
    os.link(checkpoint, resume_from)
    n0 = len(probe.steps)
    trainer.config.epochs = XTTS_TRAIN_EPOCHS + 1
    trainer.fit()
    uninterrupted = XttsTrainProbe.losses(probe.steps[n0])
    del probe, trainer
    torch.cuda.empty_cache()
    model_b = Xtts(xtts_train_config(root, os.path.join(tmp, "resumed"), base, XTTS_TRAIN_EPOCHS + 1), device=device)
    model_b.bpe.encode = xtts_token_ids
    trainer_b = Trainer(TrainerArgs(device=device, continue_path=resume_from), model_b.config,
                        os.path.join(tmp, "resumed"), model=model_b, train_samples=train_samples,
                        eval_samples=eval_samples)
    probe_b = XttsTrainProbe(trainer_b)
    trainer_b.fit()
    resumed = XttsTrainProbe.losses(probe_b.steps[0])
    rel = max(abs(resumed[k] - uninterrupted[k]) / max(1.0, abs(uninterrupted[k])) for k in uninterrupted)
    log("xtts train resume " + json.dumps({"step": trainer_b.total_steps_done, "max_rel_err": rel, "tol": RESUME_TOL,
                                           "uninterrupted": uninterrupted, "resumed": resumed}))
    if not rel <= RESUME_TOL:
        raise AssertionError(f"the resumed fine-tune's next step differs from the uninterrupted one: {rel}")
    del trainer_b, model_b, probe_b, model
    torch.cuda.empty_cache()
    for d in ("resumed",):
        subprocess.run(["rm", "-rf", os.path.join(tmp, d)], check=True)
    os.remove(resume_from)

    overfit = xtts_overfit(xtts_train_config(root, os.path.join(tmp, "overfit"), base, 1), train_samples, base_ckpt,
                           device)
    subprocess.run(["rm", "-rf", os.path.join(tmp, "overfit")], check=True)
    served = serve_finetuned(out, device)
    return {**row, "tiny": tiny, "tiny_mixed": tiny_mixed, "resume_max_rel_err": rel, "overfit": overfit,
            "served": served}


# ---------------------------------------------------------------- multilingual VITS training, voice conversion
ML_TRAIN_BATCH, ML_TRAIN_EPOCHS = 32, 2
ML_CLIPS = {"en": 40, "fr": 16, "de": 8}  # per language, over SPEAKERS' four speakers: unbalanced on purpose
ML_SPEAKER_LANGS = {"spk_a": "en", "spk_b": "en", "spk_c": "fr", "spk_d": "de"}


def write_mailabs(root: str, seed: int = SEED + 7) -> dict:
    """Clips in M-AILABS's layout (`<lang>/by_book/<gender>/<speaker>/<book>/
    metadata.csv` and `wavs/`), 2.2–9.5 s at 16 kHz (the recipe's length
    filter keeps 2.05–10 s), ML_CLIPS a language spread over the speakers
    of that language; spk_a and spk_b share English."""
    import numpy as np
    import scipy.io.wavfile

    rng = np.random.default_rng(seed)
    counts = {}
    for lang, n in ML_CLIPS.items():
        speakers = [s for s, lg in ML_SPEAKER_LANGS.items() if lg == lang]
        for j, spk in enumerate(speakers):
            folder = os.path.join(root, lang, "by_book", "female", spk, "book")
            os.makedirs(os.path.join(folder, "wavs"), exist_ok=True)
            lines = []
            for i in range(n // len(speakers)):
                sig = voiced_clip(rng, 16000, rng.uniform(2.2, 9.5))
                scipy.io.wavfile.write(os.path.join(folder, "wavs", f"{spk}_{i:03d}.wav"), 16000,
                                       (sig * 32767).astype(np.int16))
                text = random_text(rng, 30, 120)
                lines.append(f"{spk}_{i:03d}|{text}|{text}")
                counts[spk] = counts.get(spk, 0) + 1
            with open(os.path.join(folder, "metadata.csv"), "w", encoding="utf-8") as f:
                f.write("\n".join(lines) + "\n")
    return counts


def multilingual_train_config(root: str, out: str, epochs: int):
    """The multilingual recipe (`recipes/multilingual/vits_tts/train_vits_tts.py`):
    `save_multispeaker`'s model at batch 32 with the language-weighted
    sampler, float32, one dataset a language."""
    from tpu_tts_torch.config.shared_configs import BaseDatasetConfig
    from tpu_tts_torch.configs.vits_config import VitsArgs, VitsAudioConfig, VitsConfig
    from tpu_tts_torch.text.characters import CharactersConfig

    return VitsConfig(
        model_args=VitsArgs(use_language_embedding=True, embedded_language_dim=4, use_speaker_embedding=True,
                            use_sdp=False),
        audio=VitsAudioConfig(sample_rate=16000, win_length=1024, hop_length=256, num_mels=80, mel_fmin=0,
                              mel_fmax=None),
        use_speaker_embedding=True, batch_size=ML_TRAIN_BATCH, eval_batch_size=16, batch_group_size=0,
        num_loader_workers=4, run_eval=False, epochs=epochs, print_step=1, save_step=0, save_n_checkpoints=1,
        text_cleaner="multilingual_cleaners", use_phonemes=False, use_language_weighted_sampler=True,
        mixed_precision=False, min_audio_len=32 * 256 * 4, max_audio_len=160000, training_seed=SEED + 1,
        output_path=out,
        characters=CharactersConfig(pad="<PAD>", eos="<EOS>", bos="<BOS>", blank="<BLNK>",
                                    characters=MULTILINGUAL_CHARACTERS, punctuations=MULTILINGUAL_PUNCTUATIONS,
                                    phonemes=None),
        datasets=[BaseDatasetConfig(formatter="mailabs", path=os.path.join(root, lang), language=lang)
                  for lang in ML_CLIPS])


def multilingual_train_phase(tmp: str, device: str = "cuda") -> dict:
    """The multilingual recipe's full-width VITS trained on the card at batch
    32 for ML_TRAIN_EPOCHS epochs of 2 steps on M-AILABS-layout clips: ms a
    step, losses finite, every parameter (`emb_g`, `emb_l` among them) with a
    nonzero gradient at step 2, K1 launched no time; the language-weighted
    sampler's draws over 200 epochs against the languages' equal shares
    (`train multispeaker`); then voice conversion served from the trained
    checkpoint (`serve_voice_conversion`)."""
    import math

    import numpy as np
    import torch

    from tpu_tts_torch.data import load_tts_samples
    from tpu_tts_torch.models.vits import Vits
    from tpu_tts_torch.ops import hifigan_mrf
    from tpu_tts_torch.train import Trainer, TrainerArgs
    from tpu_tts_torch.train.checkpoint import get_last_checkpoint

    root, out = os.path.join(tmp, "mailabs"), os.path.join(tmp, "run")
    counts = write_mailabs(root)
    config = multilingual_train_config(root, out, ML_TRAIN_EPOCHS)
    train_samples, _ = load_tts_samples(config.datasets, eval_split=False)
    torch.manual_seed(SEED)
    model = Vits.init_from_config(config, device=device, samples=train_samples)
    unit_gain_decoder(model.net.waveform_decoder)
    trainer = Trainer(TrainerArgs(device=device), model.config, out, model=model, train_samples=train_samples)
    probe = TrainProbe(trainer)
    try:
        hifigan_mrf.launches = 0
        t0 = time.perf_counter()
        trainer.fit()
        fit_s = time.perf_counter() - t0
        launches = hifigan_mrf.launches
        steps = list(probe.steps)
    finally:
        probe.close()
    loader = model.get_data_loader(trainer.config, {}, is_eval=False, samples=train_samples, verbose=False)
    langs = np.array([s["language"] for s in loader.dataset.samples])
    drawn = []
    for epoch in range(200):
        loader.set_epoch(epoch)
        drawn += [langs[i] for b in loader._batch_indices() for i in b]
    share = {lang: float(np.mean(np.array(drawn) == lang)) for lang in ML_CLIPS}
    plain = {lang: float(np.mean(langs == lang)) for lang in ML_CLIPS}
    timed = [probe.step_ms(s) for s in steps[1:]]
    row = {"steps": len(steps), "batch": ML_TRAIN_BATCH, "fit_s": fit_s, "clips": counts,
           **{k: sum(t[k] for t in timed) / len(timed) for k in timed[0]},
           "speakers": model.speaker_manager.name_to_id, "languages": model.language_manager.name_to_id,
           "language_share_drawn": share, "language_share_unweighted": plain, "hifigan_mrf_launches": launches,
           "first": TrainProbe.losses(steps[0]), "last": TrainProbe.losses(steps[-1])}
    log("train multispeaker " + json.dumps(row))
    bad = [k for s in steps for k, v in TrainProbe.losses(s).items() if not math.isfinite(v)]
    names = {n for n, _ in model.net.named_parameters()}
    if bad or probe.zero_grads is None or probe.zero_grads or launches or not {"emb_g.weight", "emb_l.weight"} <= names:
        raise AssertionError(f"non-finite losses {bad[:4]}, parameters without a gradient "
                             f"{(probe.zero_grads or ['(none checked)'])[:6]}, or {launches} K1 launches in training")
    if max(abs(v - 1 / len(ML_CLIPS)) for v in share.values()) > 0.05:
        raise AssertionError(f"the language-weighted sampler's draws do not follow its weights: {share}")
    checkpoint = get_last_checkpoint(out)[0]
    del trainer, model
    torch.cuda.empty_cache()
    source = next(s for s in train_samples if s["speaker_name"] == "spk_a")["audio_file"]
    vc = serve_voice_conversion(checkpoint, os.path.join(out, "config.json"), source, device)
    return {**row, "vc": vc}


def serve_voice_conversion(checkpoint: str, config_path: str, source_wav: str, device: str = "cuda") -> dict:
    """The trained checkpoint through `Synthesizer.tts(reference_wav=,
    reference_speaker_name=)`: spk_a's clip in spk_c's voice, 72 K1
    launches, the reply the source's spectrogram frames × hop long; the
    model's conversion against the plain MRF (≤ 1e-3); spk_d as the target
    gives another waveform."""
    import numpy as np

    from tpu_tts_torch.infer.synthesizer import Synthesizer
    from tpu_tts_torch.ops import hifigan_mrf

    synth = Synthesizer(checkpoint, config_path, device=device)
    model, hop = synth.tts_model, synth.tts_config.audio.hop_length
    src = model.ap.load_wav(source_wav)
    ids = synth.speaker_manager.name_to_id
    synth.tts(reference_wav=source_wav, speaker_name="spk_c", reference_speaker_name="spk_a")  # warm-up
    hifigan_mrf.launches = 0
    t0 = time.perf_counter()
    wav = np.asarray(synth.tts(reference_wav=source_wav, speaker_name="spk_c", reference_speaker_name="spk_a"))
    latency = time.perf_counter() - t0
    launches = hifigan_mrf.launches
    got = model.voice_conversion(src, ids["spk_a"], ids["spk_c"])
    with plain_mrf():
        ref = model.voice_conversion(src, ids["spk_a"], ids["spk_c"])
    other = model.voice_conversion(src, ids["spk_a"], ids["spk_d"])
    out = {"source_samples": int(src.size), "frames": int(src.size // hop), "samples": int(wav.size),
           "latency_s": latency, "hifigan_mrf_launches": launches, "max_abs_err_vs_plain": float(np.abs(got - ref).max()),
           "served_vs_model_max_abs_err": float(np.abs(wav - got).max()), "rms": float(np.sqrt(np.mean(got**2))),
           "other_target_max_abs_diff": float(np.abs(other - got).max()), "tol": 1e-3}
    log("vc serve " + json.dumps(out))
    if launches != 72 or wav.size != (src.size // hop) * hop or not np.isfinite(wav).all() \
            or out["max_abs_err_vs_plain"] > 1e-3 or out["other_target_max_abs_diff"] <= 1e-4 or out["rms"] == 0:
        raise AssertionError(f"voice conversion did not serve through K1: {out}")
    return out


# ---------------------------------------------------------------- mixed precision (phases a, b)
MP_LOSS_TOL = 2e-2  # bfloat16 compute, card against CPU: the tiny steps' losses, relative
MP_TRAIN_EPOCHS = 2  # 2 steps an epoch at batch 32
MP_COMPARE = ("step_ms", "d_substep_ms", "g_substep_ms", "optimizer_ms", "wall_ms", "peak_allocated_gb")


def fit_and_probe(config, train_samples, eval_samples, out: str, device: str = "cuda", model=None,
                  profile: str = "", keep: bool = False):
    """`Trainer.fit` of `config` (its VITS from seed 0 with the decoder at
    unit gain unless a model is given) under `TrainProbe`: the mean of each
    timed quantity over the steps after the first, peak memory, K1's
    launches, the first and last losses; every loss must be finite and
    every parameter have a nonzero gradient at step 2. With `profile`, one
    more step is profiled under that name. With `keep`, returns (the row,
    the trainer, its probe) for more steps."""
    import math

    import torch

    from tpu_tts_torch.models.vits import Vits
    from tpu_tts_torch.ops import hifigan_mrf
    from tpu_tts_torch.train import Trainer, TrainerArgs

    if model is None:
        torch.manual_seed(SEED)
        model = Vits.init_from_config(config, device=device, samples=train_samples)
        unit_gain_decoder(model.net.waveform_decoder)
    trainer = Trainer(TrainerArgs(device=device), model.config, out, model=model, train_samples=train_samples,
                      eval_samples=eval_samples)
    probe = TrainProbe(trainer)
    try:
        torch.cuda.empty_cache()
        torch.cuda.reset_peak_memory_stats()
        hifigan_mrf.launches = 0
        t0 = time.perf_counter()
        trainer.fit()
        fit_s = time.perf_counter() - t0
        launches = hifigan_mrf.launches
        steps = list(probe.steps)
    finally:
        probe.close()
    if profile:
        batch = next(iter(model.get_data_loader(trainer.config, {}, is_eval=False, samples=train_samples,
                                                verbose=False)))
        profile_call(lambda: trainer.train_step(batch), {"model": config.model, "call": profile,
                                                         "batch": config.batch_size}, top=10)
    timed = [probe.step_ms(s) for s in steps[1:]]  # the first step warms cuDNN up
    row = {"steps": len(steps), "batch": config.batch_size, "fit_s": fit_s,
           **{k: sum(t[k] for t in timed) / len(timed) for k in timed[0]},
           "peak_allocated_gb": torch.cuda.max_memory_allocated() / 2**30, "hifigan_mrf_launches": launches,
           "losses_first": TrainProbe.losses(steps[0]), "losses_last": TrainProbe.losses(steps[-1]),
           "param_dtypes": sorted({str(p.dtype) for p in list(model.net.parameters()) + list(model.disc.parameters())}),
           "optimizer_state_dtypes": sorted({str(v.dtype) for opt in trainer.optimizers
                                             for st in opt.inner.state.values() for v in st.values()
                                             if torch.is_tensor(v)})}
    bad = [k for s in steps for k, v in TrainProbe.losses(s).items() if not math.isfinite(v)]
    if bad or probe.zero_grads is None or probe.zero_grads:
        raise AssertionError(f"non-finite losses {bad[:5]} or parameters without a gradient "
                             f"{(probe.zero_grads or ['(none checked)'])[:8]}")
    if launches != 0 or row["param_dtypes"] != ["torch.float32"] or row["optimizer_state_dtypes"] != ["torch.float32"]:
        raise AssertionError(f"training launched K1 or left float32: {row}")
    if keep:
        return row, trainer, probe
    del trainer, model
    torch.cuda.empty_cache()
    return row


def mixed_train_phase(tmp: str, f32: dict, device: str = "cuda") -> dict:
    """Phase a, mixed precision (the recipes' `mixed_precision=True`): the
    tiny D and G steps in bfloat16 on the card against the CPU; the default
    full-width VITS at the LJSpeech recipe's settings with the bfloat16
    compute dtype, on phase 12's 64 clips (decoder at unit gain), through
    `Trainer.fit` for MP_TRAIN_EPOCHS epochs of 2 steps: ms a step (D, G,
    updates), peak memory, finite losses, every gradient nonzero at step 2,
    no K1 launch, printed beside phase 12's float32 step of this run
    (`train mixed steps`); 2 steps at the VCTK recipe's settings (a speaker
    embedding over the clips' 10 round-robin speakers, `train mixed vctk`);
    the bfloat16-trained checkpoint served by `/api/tts` through K1, 72
    launches, within 1e-3 of the plain MRF (`train mixed serve`)."""
    from tpu_tts_torch.data import load_tts_samples
    from tpu_tts_torch.train.checkpoint import get_last_checkpoint

    t0 = time.perf_counter()
    tiny = check_train_step_card_vs_cpu(mixed=True)
    root, out = os.path.join(tmp, "data"), os.path.join(tmp, "run_mixed")
    config = train_config(root, out, MP_TRAIN_EPOCHS)
    config.mixed_precision = True
    train_samples, eval_samples = load_tts_samples(config.datasets, eval_split=True)
    row = fit_and_probe(config, train_samples, eval_samples, out, device,
                        profile="one bfloat16 training step (D then G)")
    log("train mixed steps " + json.dumps({"bfloat16": row, "float32": {k: f32[k] for k in MP_COMPARE}}))

    vctk = train_config(root, os.path.join(tmp, "run_vctk"), 1)
    vctk.mixed_precision = True
    vctk.use_speaker_embedding = vctk.model_args.use_speaker_embedding = True
    vctk.datasets[0].formatter = "ljspeech_test"
    vctk_train, vctk_eval = load_tts_samples(vctk.datasets, eval_split=True)
    vctk_row = fit_and_probe(vctk, vctk_train, vctk_eval, vctk.output_path, device)
    log("train mixed vctk " + json.dumps(vctk_row))
    subprocess.run(["rm", "-rf", vctk.output_path], check=True)

    served = serve_trained({"model_path": get_last_checkpoint(out)[0], "config_path": os.path.join(out, "config.json")},
                           device, label="train mixed serve")
    wall = time.perf_counter() - t0
    log(f"train mixed phase wall: {wall:.1f} s")
    return {**row, "tiny": tiny, "vctk": vctk_row, "served": served, "phase_wall_s": wall}


def check_xtts_mixed_card_vs_cpu(samples) -> dict:
    """Phase b: one fine-tuning loss and backward of a tiny XTTS (XTTS_TINY)
    through the trainer's generic bfloat16 cast, from the raw wavs (the
    DVAE float32 outside the cast) on the card against the CPU: losses
    within MP_LOSS_TOL relative, the parameters float32; the gradients'
    relative L2 distance printed."""
    import torch

    from tpu_tts_torch.configs.xtts_config import XttsArgs
    from tpu_tts_torch.train import precision

    models = tiny_xtts_pair(XttsArgs(**XTTS_TINY))
    for m in models.values():
        m.load_dvae()
        m.bpe.encode = xtts_token_ids
    batch = xtts_batch(models["cpu"], samples)
    res = {}
    for dev, m in models.items():
        m.train(True)
        b = {k: v.to(m.device) if torch.is_tensor(v) else v for k, v in batch.items()}
        params16, batch16 = precision.autocast_args(dict(m.net.named_parameters()), b)
        loss, logs = precision.call_cast(m.net, params16, m.loss_fn, batch16, 0)
        loss.float().backward()
        res[dev] = ({"loss": float(loss), **{k: float(v) for k, v in logs.items()}},
                    {n: p.grad.cpu() for n, p in m.net.named_parameters() if p.grad is not None})
    (lc, gc), (lg, gg) = res["cpu"], res["cuda"]
    worst = max(abs(lc[k] - lg[k]) / max(1.0, abs(lc[k])) for k in lc)
    vc, vg = torch.cat([gc[n].flatten() for n in gc]), torch.cat([gg[n].flatten() for n in gc])
    dtypes = sorted({str(p.dtype) for m in models.values() for p in m.net.parameters()})
    out = {"losses": {k: [lc[k], lg[k]] for k in lc}, "max_loss_rel_err": worst, "loss_tol": MP_LOSS_TOL,
           "grad_l2_rel_err": float((vc - vg).norm() / vc.norm()), "param_dtypes": dtypes}
    log("xtts train mixed card vs cpu " + json.dumps(out))
    if not worst <= MP_LOSS_TOL or dtypes != ["torch.float32"] or set(gc) != set(gg):
        raise AssertionError(f"the tiny mixed-precision fine-tune step on the card disagrees with the CPU: {out}")
    return out


# ---------------------------------------------------------------- the speaker encoder (phase c)
ENC_SPEAKERS, ENC_UTTERS, ENC_VOICE_S = 100, 4, 2.0  # the VCTK ResNet recipe's batch: 100 speakers × 4 crops of 2 s
ENC_CLIP_S = 2.5  # each clip; the crops start anywhere in it
ENC_EPOCHS = 3  # ENC_UTTERS clips a speaker: one batch an epoch
ENC_TIMED_STEPS = 5
ENC_OVERFIT_STEPS = 20
ENC_CARD_TOL = 1e-4  # a tiny encoder's embedding on the card against the CPU


def speaker_clip(rng, voice: dict, sr: int, dur: float):
    """`dur` seconds of one speaker's voice: 12 harmonics of an f0 that
    wanders ±8 % around the speaker's, amplitudes falling as h^-tilt and
    raised around the speaker's formant, a syllable envelope and noise."""
    import numpy as np

    t = np.arange(int(sr * dur)) / sr
    f0 = voice["f0"] * (1 + 0.08 * np.sin(2 * np.pi * rng.uniform(0.3, 1.5) * t + rng.uniform(0, 6.3)))
    phase = 2 * np.pi * np.cumsum(f0) / sr
    sig = sum(h ** -voice["tilt"] * (1 + 3 * np.exp(-(((h * voice["f0"]) - voice["formant"]) / 250.0) ** 2))
              * np.sin(h * phase + rng.uniform(0, 6.3)) for h in range(1, 13))
    sig = sig * (0.5 + 0.5 * np.sin(2 * np.pi * rng.uniform(2.0, 5.0) * t) ** 2) + 0.01 * rng.standard_normal(t.size)
    return sig / np.abs(sig).max() * rng.uniform(0.4, 0.9)


def write_vctk(root: str, n_speakers: int, n_clips: int, seconds: float, sr: int = 16000, seed: int = SEED + 11):
    """VCTK's layout (`txt/<spk>/<spk>_<id>.txt` and
    `wav48_silence_trimmed/<spk>/<spk>_<id>.wav`, the recipe's `vctk`
    formatter) at 16 kHz, as the recipe resamples it, from a numpy seed:
    each speaker one voice (its f0, tilt and formant), each clip a fresh
    draw of it."""
    import numpy as np
    import scipy.io.wavfile

    rng = np.random.default_rng(seed)
    clips = []
    for s in range(n_speakers):
        spk = f"p{225 + s}"
        voice = {"f0": rng.uniform(85, 255), "tilt": rng.uniform(0.6, 1.6), "formant": rng.uniform(400, 2600)}
        os.makedirs(os.path.join(root, "txt", spk))
        os.makedirs(os.path.join(root, "wav48_silence_trimmed", spk))
        for i in range(n_clips):
            name = f"{spk}_{i + 1:03d}"
            with open(os.path.join(root, "txt", spk, name + ".txt"), "w", encoding="utf-8") as f:
                f.write(random_text(rng, 20, 60) + "\n")
            path = os.path.join(root, "wav48_silence_trimmed", spk, name + ".wav")
            scipy.io.wavfile.write(path, sr, (speaker_clip(rng, voice, sr, seconds) * 32767).astype(np.int16))
            clips.append(path)
    return {"speakers": n_speakers, "clips": len(clips), "audio_s": len(clips) * seconds, "sample_rate": sr,
            "paths": clips}


def encoder_config(root: str, out: str, epochs: int):
    """The VCTK ResNet speaker-encoder recipe
    (`recipes/vctk/resnet_speaker_encoder/train_encoder.py`): 64 → 512,
    layers (3, 4, 6, 3), filters 32–256, 100 speakers × 4 crops of 2 s,
    `softmaxproto` (trained as angle-proto, as `tpu_tts` trains it), radam,
    16 kHz, 64 mels, fft 512, win 400, hop 160."""
    from tpu_tts_torch.config.shared_configs import BaseDatasetConfig
    from tpu_tts_torch.encoder.configs import SpeakerEncoderConfig

    cfg = SpeakerEncoderConfig(
        datasets=[BaseDatasetConfig(formatter="vctk", meta_file_train="", language="en-us", path=root)],
        num_classes_in_batch=ENC_SPEAKERS, num_utter_per_class=ENC_UTTERS, eval_num_classes_in_batch=ENC_SPEAKERS,
        eval_num_utter_per_class=ENC_UTTERS, num_loader_workers=8, epochs=epochs, loss="softmaxproto",
        run_eval=False, output_path=out, save_step=2000, print_step=1, voice_len=ENC_VOICE_S, training_seed=SEED,
        model_params={"model_name": "resnet", "input_dim": 64, "use_torch_spec": True, "log_input": True,
                      "proj_dim": 512})
    cfg.audio.update(dict(fft_size=512, win_length=400, hop_length=160, sample_rate=16000, preemphasis=0.97,
                          num_mels=64))
    return cfg


def check_encoder_card_vs_cpu() -> dict:
    """A tiny ResNet (layers (1, 1, 1, 1), filters 8–16, 16 mels, batch
    norm in eval) and a tiny LSTM with seeded weights: the embedding of the
    same mels on the card against the CPU, within ENC_CARD_TOL."""
    import torch

    from tpu_tts_torch.encoder.models import LSTMSpeakerEncoder, ResNetSpeakerEncoder

    out = {"tol": ENC_CARD_TOL}
    gen = torch.Generator().manual_seed(SEED)
    mel = torch.randn(3, 16, 120, generator=gen)
    for name, net in (("resnet", ResNetSpeakerEncoder(16, 8, (1, 1, 1, 1), (8, 8, 16, 16), norm_type="batch")),
                      ("lstm", LSTMSpeakerEncoder(16, 8, 24, 2))):
        with torch.no_grad():
            for k, v in net.state_dict().items():
                if v.is_floating_point():
                    v.copy_((1 + 0.3 * torch.rand(v.shape, generator=gen)) if k.endswith("running_var")
                            else 0.2 * torch.randn(v.shape, generator=gen))
        net.eval()
        with torch.no_grad():
            cpu = net(mel)
            card = net.cuda()(mel.cuda()).cpu()
        out[f"{name}_max_abs_err"] = float((cpu - card).abs().max())
    log("encoder card vs cpu " + json.dumps(out))
    if max(out["resnet_max_abs_err"], out["lstm_max_abs_err"]) > ENC_CARD_TOL:
        raise AssertionError(f"the encoder's embedding on the card disagrees with the CPU: {out}")
    return out


def encoder_steps(config, device: str = "cuda") -> dict:
    """On one batch of the recipe's shape (the sampler's first: 100 speakers
    × 4 crops of 2 s) the training step of `bin/train_encoder` (log-mels,
    the "batch"-norm ResNet, angle-proto with w and b, radam with clip 3):
    one warm-up, ENC_TIMED_STEPS steps timed with CUDA events, peak memory;
    then steps on the same batch up to ENC_OVERFIT_STEPS, which must lower
    the loss (the median of the last 5 below the first)."""
    import random
    import statistics

    import torch

    from tpu_tts_torch.audio import AudioProcessor
    from tpu_tts_torch.bin.train_encoder import encoder_loss
    from tpu_tts_torch.data import load_tts_samples
    from tpu_tts_torch.data.samplers import PerfectBatchSampler
    from tpu_tts_torch.encoder.dataset import EncoderDataset
    from tpu_tts_torch.encoder.models import setup_encoder_model
    from tpu_tts_torch.train.optimizers import get_optimizer

    random.seed(SEED)
    torch.manual_seed(SEED)
    items, _ = load_tts_samples(config.datasets, eval_split=False)
    dataset = EncoderDataset(config, AudioProcessor.init_from_config(config), items, voice_len=config.voice_len,
                             num_classes_in_batch=ENC_SPEAKERS, num_utter_per_class=ENC_UTTERS, seed=SEED)
    sampler = PerfectBatchSampler([{"class_name": it["speaker_name"]} for it in dataset.items],
                                  dataset.get_class_list(), batch_size=ENC_SPEAKERS * ENC_UTTERS,
                                  num_classes_in_batch=ENC_SPEAKERS, drop_last=True)
    wavs = torch.from_numpy(dataset.collate_fn([dataset[i] for i in next(iter(sampler))])["wavs"]).to(device)
    model = setup_encoder_model(config, device=device)
    net = model.net.train()
    w = torch.nn.Parameter(torch.tensor(10.0, device=device))
    b = torch.nn.Parameter(torch.tensor(-5.0, device=device))
    opt = get_optimizer(config.optimizer, config.optimizer_params, list(net.parameters()) + [w, b], config,
                        schedule=config.lr)
    losses, ms = [], []
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    for step in range(ENC_OVERFIT_STEPS):
        start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        start.record()
        loss = encoder_loss(config, net(model.features_from_wav(wavs)).reshape(ENC_SPEAKERS, ENC_UTTERS, -1), w, b)
        loss.backward()
        opt.step()
        end.record()
        torch.cuda.synchronize()
        losses.append(float(loss))
        if 1 <= step <= ENC_TIMED_STEPS:
            ms.append(start.elapsed_time(end))
    out = {"batch": [ENC_SPEAKERS, ENC_UTTERS], "crop_s": ENC_VOICE_S, "frames": int(model.features_from_wav(
        wavs[:1]).shape[-1]), "params": sum(p.numel() for p in net.parameters()), "optimizer": config.optimizer,
        "step_ms": sum(ms) / len(ms), "step_ms_each": ms, "peak_allocated_gb": torch.cuda.max_memory_allocated() / 2**30,
        "loss_first": losses[0], "loss_median_last5": statistics.median(losses[-5:]), "losses": losses}
    log("encoder steps " + json.dumps(out))
    profile_call(lambda: (encoder_loss(config, net(model.features_from_wav(wavs)).reshape(ENC_SPEAKERS, ENC_UTTERS, -1),
                                       w, b).backward(), opt.step()),
                 {"model": "speaker encoder", "call": "one training step", "batch": ENC_SPEAKERS * ENC_UTTERS}, top=10)
    if not all(map(lambda v: v == v and abs(v) < float("inf"), losses)) or not out["loss_median_last5"] < losses[0]:
        raise AssertionError(f"the encoder's loss is not finite or {ENC_OVERFIT_STEPS} steps did not lower it: {out}")
    del net, model, opt
    torch.cuda.empty_cache()
    return out


def encoder_phase(tmp: str, device: str = "cuda") -> dict:
    """Phase c, the speaker encoder: the VCTK ResNet recipe's encoder at full
    width trained through `bin/train_encoder` for ENC_EPOCHS steps on
    100 seeded voices × 4 clips (`encoder train`); its step timed and 20
    steps on one batch (`encoder steps`); a tiny encoder on the card against
    the CPU; `bin/compute_embeddings` over the clips into a d-vector file and
    `bin/eval_encoder`'s margin (`encoder embeddings`)."""
    import contextlib

    import numpy as np

    from tpu_tts_torch.bin import compute_embeddings, eval_encoder, train_encoder
    from tpu_tts_torch.train.checkpoint import get_last_checkpoint

    t_phase = time.perf_counter()
    root, out = os.path.join(tmp, "vctk"), os.path.join(tmp, "encoder")
    data = write_vctk(root, ENC_SPEAKERS, ENC_UTTERS, ENC_CLIP_S)
    config = encoder_config(root, out, ENC_EPOCHS)
    os.makedirs(out)
    config_path = os.path.join(out, "config_se.json")
    config.save_json(config_path)
    t0 = time.perf_counter()
    train_encoder.main(["--config_path", config_path, "--max_steps", str(ENC_EPOCHS), "--device", device])
    checkpoint, _ = get_last_checkpoint(out)
    train = {"steps": ENC_EPOCHS, "wall_s": time.perf_counter() - t0, "checkpoint": os.path.basename(checkpoint),
             "data": {k: v for k, v in data.items() if k != "paths"}}
    log("encoder train " + json.dumps(train))
    steps = encoder_steps(config, device)
    card = check_encoder_card_vs_cpu()
    d_vector_file = os.path.join(tmp, "speakers_dvec.json")
    t0 = time.perf_counter()
    compute_embeddings.compute_embeddings(checkpoint, os.path.join(out, "config.json"), d_vector_file,
                                          config_dataset_path=config_path, no_eval=True, device=device)
    embed_s = time.perf_counter() - t0
    with open(d_vector_file, encoding="utf-8") as f:
        embs = json.load(f)
    with contextlib.redirect_stdout(io.StringIO()):
        margin = eval_encoder.main([checkpoint, os.path.join(out, "config.json"), config_path, "--device", device])
    row = {"clips": len(embs), "dim": len(next(iter(embs.values()))["embedding"]), "wall_s": embed_s,
           "speakers": len({v["name"] for v in embs.values()}), **margin}
    log("encoder embeddings " + json.dumps(row))
    if row["clips"] != data["clips"] or row["dim"] != 512 or not all(
            np.isfinite(v["embedding"]).all() for v in embs.values()) or not np.isfinite(row["margin"]):
        raise AssertionError(f"compute_embeddings / eval_encoder: {row}")
    wall = time.perf_counter() - t_phase
    log(f"encoder phase wall: {wall:.1f} s")
    return {"train": train, "steps": steps, "card": card, "embeddings": row, "checkpoint": checkpoint,
            "config_path": os.path.join(out, "config.json"), "d_vector_file": d_vector_file,
            "clips": data["paths"], "phase_wall_s": wall}


# ---------------------------------------------------------------- voice cloning through K1 (phase d)
def xtts_clone_serve(paths: dict, clips: list, device: str = "cuda") -> dict:
    """The Coqui-layout XTTS-v2 model directory (the ResNet speaker encoder
    in place of `speaker_proj`) served with `--max_streams 8`: one
    `/api/tts_stream?speaker_wav=` stream (72 K1 launches a chunk); the
    decoder of a chunk through K1 against the plain MRF; two wavs of two
    speakers giving other speaker embeddings and waveforms; the ms to
    condition on a new wav (`get_conditioning_latents`, CUDA-synchronised,
    after a warm-up)."""
    import numpy as np
    import torch

    from tpu_tts_torch.audio.numpy_transforms import load_wav
    from tpu_tts_torch.infer.xtts_pool import XttsStreamPool
    from tpu_tts_torch.ops import hifigan_mrf
    from tpu_tts_torch.server.server import TTSHandler, create_server

    server = create_server(argparse.Namespace(model_dir=paths["model_dir"], device=device, host="127.0.0.1", port=0,
                                              max_streams=8))
    synth = TTSHandler.synthesizer
    model = synth.tts_model
    model.bpe.encode = xtts_token_ids
    pool = XttsStreamPool(model, max_streams=TTSHandler.pool_max_streams, **XTTS_STREAM)
    TTSHandler._pool = pool
    streams, submit = {}, pool.submit

    def recording_submit(**kwargs):
        stream = submit(**kwargs)
        streams[kwargs["text"]] = stream
        return stream

    pool.submit = recording_submit
    dec = model.net.hifigan_decoder["waveform_decoder"]
    per_call = sum(hifigan_mrf.launches_per_stage(dec.mrf_stage(i)) for i in range(dec.num_upsamples))
    thread = threading.Thread(target=server.serve_forever, daemon=True)
    thread.start()
    base = f"http://127.0.0.1:{server.server_address[1]}"
    sr = model.args.input_sample_rate
    try:
        wavs = [load_wav(filename=p, sample_rate=sr, resample=True) for p in clips[:3]]
        model.get_conditioning_latents(wavs[2], sr=sr)  # warm-up
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        (cond_a, spk_a) = model.get_conditioning_latents(wavs[0], sr=sr)
        torch.cuda.synchronize()
        cond_ms = (time.perf_counter() - t0) * 1e3
        cond_b, spk_b = model.get_conditioning_latents(wavs[1], sr=sr)
        text = XTTS_TEXTS[0]
        hifigan_mrf.launches = 0
        calls0 = pool.decode_calls
        reply = stream_request(base, f"text={urllib.parse.quote(text)}&speaker_wav={urllib.parse.quote(clips[0])}")
        launches = hifigan_mrf.launches
        plan = check_stream_reply(model, reply, streams[text].codes, "cloned stream")
        calls = pool.decode_calls - calls0
        lat = torch.randn(1, XTTS_STREAM["first_chunk_size"], model.args.gpt_n_model_channels, device=device,
                          generator=torch.Generator(device=device).manual_seed(SEED))
        with torch.no_grad():
            wav_a, wav_b = model.net.decode_latents(lat, spk_a), model.net.decode_latents(lat, spk_b)
            with plain_mrf():
                plain_a = model.net.decode_latents(lat, spk_a)
        out = {"tokens": len(streams[text].codes), "chunks": len(plan), "decode_calls": calls,
               "samples": int(reply["pcm"].size), "first_chunk_ms": reply["first_s"] * 1e3, "wall_s": reply["wall_s"],
               "hifigan_mrf_launches": launches, "launches_per_chunk": launches // max(len(plan), 1),
               "conditioning_ms": cond_ms, "cond_wav_s": len(wavs[0]) / sr, "speaker_embedding_dim": int(spk_a.shape[-1]),
               "speaker_cosine_a_b": float((spk_a * spk_b).sum()), "decoder_max_abs_err_vs_plain": float(
                   (wav_a - plain_a).abs().max()), "waveform_a_vs_b_max_abs": float((wav_a - wav_b).abs().max()),
               "tol": XTTS_TOL}
        log("xtts clone " + json.dumps(out))
        if launches != per_call * len(plan) or per_call != 72 or calls != len(plan) or spk_a.shape[-1] != 512 \
                or out["decoder_max_abs_err_vs_plain"] > XTTS_TOL or out["speaker_cosine_a_b"] > 0.9999 \
                or out["waveform_a_vs_b_max_abs"] <= 1e-3 or not np.isfinite(reply["pcm"]).all():
            raise AssertionError(f"XTTS voice cloning through the ResNet encoder and K1: {out}")
        return out
    finally:
        server.shutdown()
        server.server_close()
        thread.join(timeout=30)
        pool.close()
        TTSHandler._pool = None


def dvector_vits_serve(tmp: str, enc: dict, device: str = "cuda") -> dict:
    """A full-width d-vector VITS with ResBlock1 (its d-vector file the one
    phase c computed, 512 wide), served by `/api/tts`; the speaker encoder
    attached to the synthesizer's speaker manager by `init_encoder`; one
    request with `speaker_wav`: 72 K1 launches, a finite reply."""
    import numpy as np
    import scipy.io.wavfile

    from tpu_tts_torch.configs.vits_config import VitsArgs, VitsConfig
    from tpu_tts_torch.ops import hifigan_mrf
    from tpu_tts_torch.server.server import TTSHandler, create_server

    config = VitsConfig(model_args=VitsArgs(use_d_vector_file=True, d_vector_dim=512,
                                            d_vector_file=[enc["d_vector_file"]]),
                        use_d_vector_file=True, d_vector_file=[enc["d_vector_file"]], d_vector_dim=512)
    paths = save_model(tmp, device=device, config=config, coqui=True)
    server = create_server(argparse.Namespace(**paths, device=device, host="127.0.0.1", port=0))
    if TTSHandler._batcher is not None:
        TTSHandler._batcher.close()
        TTSHandler._batcher = None
    synth = TTSHandler.synthesizer
    synth.speaker_manager.init_encoder(enc["checkpoint"], enc["config_path"], device=device)
    thread = threading.Thread(target=server.serve_forever, daemon=True)
    thread.start()
    try:
        query = urllib.parse.urlencode({"text": TEXTS[1], "speaker_wav": enc["clips"][5]})
        hifigan_mrf.launches = 0
        t0 = time.perf_counter()
        with urllib.request.urlopen(f"http://127.0.0.1:{server.server_address[1]}/api/tts?{query}",
                                    timeout=600) as r:
            status, body = r.status, r.read()
        wall = time.perf_counter() - t0
        launches = hifigan_mrf.launches
        rate, pcm = scipy.io.wavfile.read(io.BytesIO(body))
        out = {"status": status, "samples": int(pcm.size), "sample_rate": rate, "wall_s": wall,
               "hifigan_mrf_launches": launches, "d_vector_dim": 512}
        log("dvector vits speaker_wav " + json.dumps(out))
        if status != 200 or launches != 72 or not pcm.size or not np.isfinite(pcm).all() \
                or int(np.abs(pcm.astype(np.int32)).max()) == 0:
            raise AssertionError(f"the d-vector VITS with speaker_wav: {out}")
        return out
    finally:
        server.shutdown()
        server.server_close()
        thread.join(timeout=30)


def cloning_phase(tmp: str, enc: dict, device: str = "cuda") -> dict:
    """Phase d: XTTS-v2 cloning a voice from a wav through its ResNet speaker
    encoder and K1 (`xtts clone`), then a d-vector VITS given a
    `speaker_wav` (`dvector vits speaker_wav`)."""
    import torch

    t0 = time.perf_counter()
    xtts_dir = os.path.join(tmp, "xtts")
    os.makedirs(xtts_dir)
    xtts = xtts_clone_serve(save_xtts(xtts_dir, ref_encoder=True, device=device), enc["clips"], device)
    subprocess.run(["rm", "-rf", xtts_dir], check=True)
    torch.cuda.empty_cache()
    vits_dir = os.path.join(tmp, "vits")
    os.makedirs(vits_dir)
    vits = dvector_vits_serve(vits_dir, enc, device)
    wall = time.perf_counter() - t0
    log(f"cloning phase wall: {wall:.1f} s")
    return {"xtts": xtts, "vits": vits, "phase_wall_s": wall}


# ---------------------------------------------------------------- GAN vocoders (M8)
V2_STAGES = ((64, 8), (32, 64), (16, 128), (8, 256))  # HiFi-GAN V2's stage widths and their upsampling so far
NARROW_T = 2048  # time steps of K1's check at C = 24 and 48
HIFIGAN_V2 = {"upsample_factors": [8, 8, 2, 2], "upsample_kernel_sizes": [16, 16, 4, 4],
              "upsample_initial_channel": 128, "resblock_kernel_sizes": [3, 7, 11],
              "resblock_dilation_sizes": [[1, 3, 5], [1, 3, 5], [1, 3, 5]], "resblock_type": "1"}
VOC_CLIPS = (64, 10)  # training and eval clips of the vocoder recipes, 1–3 s each
VOC_TRAIN_EPOCHS = 2  # 2 steps an epoch at batch 32; then one more epoch, resumed and uninterrupted
VOC_RECIPES = {  # recipes/ljspeech/{hifigan,multiband_melgan,univnet}/: their settings (the eval split is 10 clips)
    "HifiganConfig": dict(batch_size=32, seq_len=8192, pad_short=2000, use_noise_augment=True, lr_gen=1e-4,
                          lr_disc=1e-4, test_delay_epochs=5),
    "MultibandMelganConfig": dict(batch_size=32, seq_len=8192, pad_short=2000, use_noise_augment=True, lr_gen=1e-4,
                                  lr_disc=1e-4, test_delay_epochs=5),
    "UnivnetConfig": dict(batch_size=64, seq_len=8192, pad_short=2000, use_noise_augment=True, lr_gen=1e-4,
                          lr_disc=1e-4, test_delay_epochs=-1),
}


def check_mrf_kernel_narrow() -> list:
    """K1 against `mrf_stack_reference` at HiFi-GAN V2's stage shapes (C =
    64/32/16/8 at MEL_FRAMES mel frames) in float32 and bfloat16, and at
    C = 24 and 48 (T = NARROW_T): the planned tile, launches, time, plain
    time and bound of each (`kernel hifigan_mrf v2|narrow ...` lines)."""
    import torch

    gen = torch.Generator(device="cuda").manual_seed(SEED + 2)
    rows = []
    for dtype in (torch.float32, torch.bfloat16):
        for label, shapes in (("v2", [(dtype, C, MEL_FRAMES * up) for C, up in V2_STAGES]),
                              ("narrow", [(dtype, C, NARROW_T) for C in (24, 48)])):
            rows += [{"shapes": label, **r} for r in check_mrf_shapes(shapes, gen, f"{label} ", iters=10)]
    for dtype in ("float32", "bfloat16"):
        v2 = [r for r in rows if r["shapes"] == "v2" and r["dtype"] == dtype]
        log(f"kernel hifigan_mrf v2 {dtype} sum: ms={sum(r['ms'] for r in v2):.4f} "
            f"plain_ms={sum(r['plain_ms'] for r in v2):.4f} bound_ms={sum(r['bound_ms'] for r in v2):.4f} "
            f"flops={sum(r['flops'] for r in v2):.4e}")
    return rows


def save_gan_vocoder(tmp: str, name: str, config=None, device: str = "cuda") -> dict:
    """A GAN vocoder (the default config of class `name` unless `config` is
    given) with weights from SEED, a HiFi-GAN generator at unit gain, saved
    as a Coqui-format `.pth` (`{"model": ...}` with `model_g.*` and
    `model_d.*`) beside its `config.json`."""
    import torch

    from tpu_tts_torch.vocoder import configs
    from tpu_tts_torch.vocoder.models import setup_model

    torch.manual_seed(SEED)
    config = getattr(configs, name)() if config is None else config
    model = setup_model(config, device=device)
    if config.generator_model == "hifigan_generator":
        unit_gain_decoder(model.model_g)
    stem = os.path.join(tmp, name.replace("Config", "").lower())
    torch.save({"model": model.net.state_dict(), "step": 0}, stem + ".pth")
    config.save_json(stem + ".json")
    return {"vocoder_path": stem + ".pth", "vocoder_config_path": stem + ".json",
            "generator_params": sum(p.numel() for p in model.model_g.parameters())}


def check_vocoder_against_plain(synth, tol: float = 1e-3, label: str = "vocoder") -> dict:
    """The served vocoder's waveform for the TTS model's mel of TEXTS[0],
    K1 against the plain MRF version (float32, TF32 off)."""
    import numpy as np

    from tpu_tts_torch.infer.synthesis import synthesis

    mel = synthesis(synth.tts_model, TEXTS[0], synth.tts_config)["model_outputs"]
    got = synth.vocode(mel)
    with plain_mrf():
        ref = synth.vocode(mel)
    out = {"samples": int(got.size), "max_abs_err": float(np.abs(got - ref).max()), "tol": tol,
           "rms": float(np.sqrt(np.mean(ref**2))), "saturated": float(np.mean(np.abs(ref) > 0.999))}
    log(f"{label} waveform vs plain MRF " + json.dumps(out))
    if not np.isfinite(got).all() or out["max_abs_err"] > tol or out["rms"] < 1e-3 or out["saturated"] > 0.5:
        raise AssertionError(f"the served vocoder disagrees with the plain MRF or is silent/saturated: {out}")
    return out


def serve_gan_vocoders(tmp: str, glow: dict, device: str = "cuda") -> dict:
    """Glow-TTS (phase 6's) behind a HiFi-GAN V1 (the default `HifiganConfig`:
    22050 Hz, 80 mels, hop 256), then V2 (`upsample_initial_channel` 128),
    then the default multiband MelGAN and UnivNet, each over three
    `/api/tts` requests: 72 K1 launches a sentence for HiFi-GAN, each
    waveform within 1e-3 of the plain MRF, 0 for the others; latency and
    profile lines from `serve_and_check`."""
    from tpu_tts_torch.ops import hifigan_mrf
    from tpu_tts_torch.vocoder.configs import HifiganConfig

    out = {}
    for label, name, config, per_sentence in (
            ("hifigan_v1", "HifiganConfig", None, 72),
            ("hifigan_v2", "HifiganConfig", HifiganConfig(generator_model_params=dict(HIFIGAN_V2)), 72),
            ("multiband_melgan", "MultibandMelganConfig", None, 0), ("univnet", "UnivnetConfig", None, 0)):
        os.makedirs(os.path.join(tmp, label))
        voc = save_gan_vocoder(os.path.join(tmp, label), name, config, device)
        paths = {**glow, "vocoder_path": voc["vocoder_path"], "vocoder_config_path": voc["vocoder_config_path"]}
        log(f"vocoder serve {label}: generator_params={voc['generator_params']}")
        checked = {}
        launches = serve_and_check(paths, hifigan_mrf, launches_per_sentence=per_sentence, device=device,
                                   check_synth=(lambda synth, label=label: checked.update(
                                       check_vocoder_against_plain(synth, label=f"vocoder {label}")))
                                   if per_sentence else None)
        out[label] = {"hifigan_mrf_launches": launches, **checked}
    return out


def gan_train_config(name: str, data_path: str, out: str, epochs: int):
    """The LJSpeech recipe of vocoder `name` (VOC_RECIPES) in float32, its
    data our clips."""
    from tpu_tts_torch.vocoder import configs

    return getattr(configs, name)(eval_batch_size=16, num_loader_workers=4, num_eval_loader_workers=4, run_eval=True,
                                  epochs=epochs, eval_split_size=VOC_CLIPS[1], print_step=1, print_eval=False,
                                  save_step=0, mixed_precision=False, data_path=data_path, output_path=out,
                                  training_seed=SEED + 1, **VOC_RECIPES[name])


def gan_fit(config, train, eval_, out: str, device: str = "cuda", label: str = "") -> tuple:
    """`Trainer.fit` of a GAN vocoder from SEED (a HiFi-GAN generator at unit
    gain) under `TrainProbe`: ms a step (D, G, updates; CUDA events, the
    first step left out), peak memory, K1's launches (0 expected), finite
    losses, every parameter with a nonzero gradient at step 2. Returns (row,
    trainer, probe)."""
    import math

    import torch

    from tpu_tts_torch.ops import hifigan_mrf
    from tpu_tts_torch.train import Trainer, TrainerArgs
    from tpu_tts_torch.vocoder.models import setup_model

    torch.manual_seed(SEED)
    model = setup_model(config, device=device)
    if config.generator_model == "hifigan_generator":
        unit_gain_decoder(model.model_g)
    trainer = Trainer(TrainerArgs(device=device), config, out, model=model, train_samples=train, eval_samples=eval_)
    probe = TrainProbe(trainer)
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    hifigan_mrf.launches = 0
    t0 = time.perf_counter()
    trainer.fit()
    fit_s = time.perf_counter() - t0
    steps = list(probe.steps)
    timed = [probe.step_ms(s) for s in steps[1:]] or [probe.step_ms(steps[0])]
    row = {"model": config.model, "steps": len(steps), "batch": config.batch_size, "seq_len": config.seq_len,
           "fit_s": fit_s, **{k: sum(t[k] for t in timed) / len(timed) for k in timed[0]},
           "peak_allocated_gb": torch.cuda.max_memory_allocated() / 2**30, "hifigan_mrf_launches": hifigan_mrf.launches,
           "params_g": sum(p.numel() for p in model.model_g.parameters()),
           "params_d": sum(p.numel() for p in model.model_d.parameters()),
           "losses_first": TrainProbe.losses(steps[0]), "losses_last": TrainProbe.losses(steps[-1])}
    log(f"vocoder train {label}steps " + json.dumps(row))
    bad = [k for st in steps for k, v in TrainProbe.losses(st).items() if not math.isfinite(v)]
    if bad or probe.zero_grads is None or probe.zero_grads:
        raise AssertionError(f"non-finite losses {bad[:5]} or parameters without a gradient "
                             f"{(probe.zero_grads or ['(none checked)'])[:8]}")
    if row["hifigan_mrf_launches"] != 0:
        raise AssertionError(f"vocoder training launched K1 {row['hifigan_mrf_launches']} times; it has no backward")
    return row, trainer, probe


def tiny_gan_configs() -> dict:
    """The tiny GAN vocoders of the card-vs-CPU steps: a HiFi-GAN (16 → 1
    channels, the full-width discriminator) and a 4-band MelGAN."""
    from tpu_tts_torch.config.shared_configs import BaseAudioConfig
    from tpu_tts_torch.vocoder.configs import HifiganConfig, MultibandMelganConfig

    audio = dict(num_mels=20, fft_size=64, win_length=64, hop_length=16)
    return {
        "hifigan": HifiganConfig(audio=BaseAudioConfig(**audio), generator_model_params={
            **HIFIGAN_V2, "upsample_factors": [2, 2, 2, 2], "upsample_kernel_sizes": [4, 4, 4, 4],
            "upsample_initial_channel": 16}),
        "multiband_melgan": MultibandMelganConfig(
            audio=BaseAudioConfig(**audio), generator_model_params={"upsample_factors": [2, 2], "num_res_blocks": 2},
            discriminator_model_params={"base_channels": 4, "max_channels": 16, "downsample_factors": [2, 2]},
            stft_loss_params={"n_ffts": [64, 128, 32], "hop_lengths": [16, 32, 8], "win_lengths": [48, 96, 24]},
            # the subband STFT term's log magnitudes of near-empty bins make a float32 gradient stray from
            # float64's by up to 3e-3 of a tensor's max at most tiny settings (1.6e-3 at FFTs of 32/57/17);
            # at these FFT sizes and 64 frames it strays 1.5e-4 (the CPU's float32 against its float64)
            subband_stft_loss_params={"n_ffts": [64, 128, 32], "hop_lengths": [16, 32, 8],
                                      "win_lengths": [48, 96, 24]})}


def tiny_gan_batch() -> dict:
    """Their batch, numpy: 2 rows of 64 mel frames. At 32 frames the float32
    gradients themselves stray 5.6e-4 of a tensor's max from float64's (the
    scale discriminators' log-mel and STFT terms on a short waveform); the
    stray depends on the data, so the card tests use this batch too."""
    import numpy as np

    rng = np.random.default_rng(SEED)
    mel = rng.standard_normal((2, 64, 20)).astype(np.float32)
    wav = (0.4 * np.sin(2 * np.pi * 0.03 * np.arange(1024))[None] + 0.05 * rng.standard_normal((2, 1024)))
    return {"mel_input": mel, "waveform": wav.astype(np.float32)[:, :, None]}


def check_gan_steps_card_vs_cpu(devices=("cpu", "cuda")) -> dict:
    """One D and one G step of each `tiny_gan_configs()` on the card against
    the CPU, the same weights (`randomize_module`) and `tiny_gan_batch()`,
    float32 with TF32 off: losses within TRAIN_STEP_TOL[0] relative, each
    gradient within TRAIN_STEP_TOL[1] of its tensor's largest |gradient|
    (plus 1e-6)."""
    import torch

    from tpu_tts_torch.vocoder.models import setup_model

    configs, batch = tiny_gan_configs(), tiny_gan_batch()
    out = {}
    for label, config in configs.items():
        models = dict(zip(("cpu", "cuda"), (setup_model(config, device=dev) for dev in devices)))
        randomize_module(models["cpu"].net, torch.Generator().manual_seed(SEED))
        models["cuda"].net.load_state_dict(models["cpu"].net.state_dict())
        worst_loss, worst_grad = 0.0, 0.0
        for idx in (0, 1):
            res = {}
            for dev, m in models.items():
                m.train(True)
                loss, logs = m.loss_fn({k: torch.from_numpy(v).to(m.device) for k, v in batch.items()}, idx)
                loss.backward()
                part = m.model_d if idx == 0 else m.model_g
                res[dev] = ({k: float(v.detach()) for k, v in logs.items()},
                            {n: p.grad.detach().cpu() for n, p in part.named_parameters() if p.grad is not None})
                m.net.zero_grad(set_to_none=True)
            (lc, gc), (lg, gg) = res["cpu"], res["cuda"]
            worst_loss = max([worst_loss] + [abs(lc[k] - lg[k]) / max(1.0, abs(lc[k])) for k in lc])
            if set(gc) != set(gg) or not gc:
                raise AssertionError(f"the card and the CPU gave gradients to different parameters ({label}, {idx})")
            for n in gc:
                worst_grad = max(worst_grad, (float((gc[n] - gg[n]).abs().max()) - 1e-6) / max(float(gc[n].abs().max()),
                                                                                            1e-12))
            out[f"{label}_losses_{idx}"] = {k: [lc[k], lg[k]] for k in ("loss",)}
        out[label] = {"max_loss_rel_err": worst_loss, "max_grad_err_of_max": worst_grad}
        if not worst_loss <= TRAIN_STEP_TOL[0] or not worst_grad <= TRAIN_STEP_TOL[1]:
            raise AssertionError(f"the tiny {label} step on the card disagrees with the CPU: {out}")
    log("vocoder train card vs cpu " + json.dumps(out))
    return out


def gan_overfit(config, train, device: str = "cuda") -> dict:
    """OVERFIT_STEPS steps of a fresh HiFi-GAN (SEED, the generator at unit
    gain) on one batch: the median G loss of the last 10 below the first."""
    import statistics

    import torch

    from tpu_tts_torch.train import Trainer, TrainerArgs
    from tpu_tts_torch.vocoder.models import setup_model

    torch.manual_seed(SEED)
    model = setup_model(config, device=device)
    unit_gain_decoder(model.model_g)
    trainer = Trainer(TrainerArgs(device=device), config, config.output_path, model=model, train_samples=train)
    loader = model.get_data_loader(config, {}, is_eval=False, samples=train, verbose=False)
    batch = next(iter(loader))
    g_loss, l1 = [], []
    for _ in range(OVERFIT_STEPS):
        logs = trainer.train_step(batch)
        g_loss.append(float(logs["opt1_loss"]))
        l1.append(float(logs["opt1_G_l1_spec_loss"]))
    out = {"steps": len(g_loss), "g_loss": g_loss, "l1_spec_first_last": [l1[0], l1[-1]], "first": g_loss[0],
           "median_last10": statistics.median(g_loss[-10:])}
    log("vocoder train overfit " + json.dumps(out))
    if not out["median_last10"] < out["first"]:
        raise AssertionError(f"{OVERFIT_STEPS} steps on one batch did not lower the G loss: {out}")
    del trainer, model
    return out


def gan_vocoder_phase(tmp: str, glow: dict, device: str = "cuda") -> dict:
    """Phase 19, the GAN vocoders (M8): K1 at every width (a), Glow-TTS →
    HiFi-GAN V1 and V2, multiband MelGAN and UnivNet over `/api/tts` (b),
    `train_vocoder`'s path at the LJSpeech HiFi-GAN recipe's settings with a
    resumed epoch, 20 steps on one batch and the run directory served (c),
    tiny D and G steps card vs CPU (d), two steps each of the multiband
    MelGAN and UnivNet recipes (e)."""
    import torch

    from tpu_tts_torch.ops import hifigan_mrf
    from tpu_tts_torch.train import Trainer, TrainerArgs
    from tpu_tts_torch.train.checkpoint import get_last_checkpoint
    from tpu_tts_torch.vocoder.datasets import load_wav_data
    from tpu_tts_torch.vocoder.models import setup_model

    t0 = time.perf_counter()
    narrow = check_mrf_kernel_narrow()
    served = serve_gan_vocoders(tmp, glow, device)
    tiny = check_gan_steps_card_vs_cpu()
    root = os.path.join(tmp, "voc_data")
    log("vocoder train data " + json.dumps(write_clips(root, SEED + 13, sum(VOC_CLIPS), 0, (1.0, 3.0))))
    data_path, out = os.path.join(root, "wavs"), os.path.join(tmp, "voc_run")
    config = gan_train_config("HifiganConfig", data_path, out, VOC_TRAIN_EPOCHS)
    train, eval_ = load_wav_data(data_path, config.eval_split_size)
    row, trainer, probe = gan_fit(config, train, eval_, out, device)
    try:
        n0 = len(probe.steps)
        checkpoint = get_last_checkpoint(out)[0]
        trainer.config.epochs = VOC_TRAIN_EPOCHS + 1
        trainer.fit()
        uninterrupted = TrainProbe.losses(probe.steps[n0])
    finally:
        probe.close()
    del trainer
    model_b = setup_model(gan_train_config("HifiganConfig", data_path, out, VOC_TRAIN_EPOCHS + 1), device=device)
    trainer_b = Trainer(TrainerArgs(device=device, continue_path=checkpoint), model_b.config,
                        os.path.join(tmp, "voc_resumed"), model=model_b, train_samples=train, eval_samples=eval_)
    probe_b = TrainProbe(trainer_b)
    try:
        trainer_b.fit()
    finally:
        probe_b.close()
    resumed = TrainProbe.losses(probe_b.steps[0])
    rel = max(abs(resumed[k] - uninterrupted[k]) / max(1.0, abs(uninterrupted[k])) for k in uninterrupted)
    log("vocoder train resume " + json.dumps({"checkpoint": os.path.basename(checkpoint), "max_rel_err": rel,
                                               "tol": RESUME_TOL, "uninterrupted": uninterrupted, "resumed": resumed}))
    if set(resumed) != set(uninterrupted) or not rel <= RESUME_TOL:
        raise AssertionError(f"the resumed vocoder run's next step differs from the uninterrupted run's: {rel}")
    del trainer_b, model_b, probe_b
    torch.cuda.empty_cache()
    overfit = gan_overfit(gan_train_config("HifiganConfig", data_path, os.path.join(tmp, "voc_overfit"), 1), train,
                          device)
    torch.cuda.empty_cache()
    run_paths = {**glow, "vocoder_path": get_last_checkpoint(out)[0],
                 "vocoder_config_path": os.path.join(out, "config.json")}
    checked = {}
    run_launches = serve_and_check(run_paths, hifigan_mrf, launches_per_sentence=72, device=device,
                                   check_synth=lambda synth: checked
                                   .update(check_vocoder_against_plain(synth, label="vocoder train serve")))
    subprocess.run(["rm", "-rf", out, os.path.join(tmp, "voc_resumed"), os.path.join(tmp, "voc_overfit")], check=True)
    recipes = {}
    for name in ("MultibandMelganConfig", "UnivnetConfig"):
        r_out = os.path.join(tmp, f"voc_{name}")
        r_config = gan_train_config(name, data_path, r_out, 2 if name == "UnivnetConfig" else 1)
        r_row, r_trainer, r_probe = gan_fit(r_config, train, eval_, r_out, device, label=f"{r_config.model} ")
        r_probe.close()
        recipes[r_config.model] = r_row
        del r_trainer
        subprocess.run(["rm", "-rf", r_out], check=True)
        torch.cuda.empty_cache()
    wall = time.perf_counter() - t0
    log(f"vocoder phase wall: {wall:.1f} s")
    return {"narrow": narrow, "served": served, "tiny": tiny, "train": row, "resume_max_rel_err": rel,
            "overfit": overfit, "run_served": {"hifigan_mrf_launches": run_launches, **checked}, "recipes": recipes,
            "phase_wall_s": wall}


# ---------------------------------------------------------------- DelightfulTTS through K1
DELIGHTFUL_SPEAKERS = {"spk_a": 0, "spk_b": 1, "spk_c": 2, "spk_d": 3}


def save_delightful(tmp: str, device: str = "cuda", speakers: bool = False) -> dict:
    """The default `DelightfulTTSConfig` (512-wide 6 + 6-layer conformers, 100
    mels, HiFi-GAN 512 → 32) with weights from SEED, as a state dict and a
    `config.json`; with `speakers` a 4-speaker `use_speaker_embedding` model
    and its `speakers.json`. The decoder is redrawn at unit gain and the
    duration head's bias set to 1.8, so that a token lasts a few frames;
    the silence trim is off, so a reply is its sentences' n_frames · hop
    samples."""
    import torch

    from tpu_tts_torch.configs import DelightfulTTSConfig
    from tpu_tts_torch.models.delightful_tts import DelightfulTTS

    top = {}
    if speakers:
        speakers_file = os.path.join(tmp, "speakers.json")
        with open(speakers_file, "w", encoding="utf-8") as f:
            json.dump(DELIGHTFUL_SPEAKERS, f)
        top = dict(use_speaker_embedding=True, num_speakers=len(DELIGHTFUL_SPEAKERS), speakers_file=speakers_file)
    config = DelightfulTTSConfig(text_cleaner="english_cleaners", **top)
    config.audio.do_trim_silence = False
    torch.manual_seed(SEED + int(speakers))
    model = DelightfulTTS.init_from_config(config, device=device)
    net = model.net
    unit_gain_decoder(net.waveform_decoder)
    with torch.no_grad():
        net.acoustic_model.duration_predictor.linear_layer.bias.fill_(1.8)
    params = sum(p.numel() for p in net.parameters())
    name = "delightful_spk" if speakers else "delightful"
    paths = {"model_path": os.path.join(tmp, f"{name}.pth"), "config_path": os.path.join(tmp, f"{name}.json")}
    torch.save(net.state_dict(), paths["model_path"])
    model.config.save_json(paths["config_path"])
    log(f"delightful model: speakers={len(DELIGHTFUL_SPEAKERS) if speakers else 0} params={params} "
        f"acoustic_params={sum(p.numel() for p in net.acoustic_model.parameters())} "
        f"decoder_params={sum(p.numel() for p in net.waveform_decoder.parameters())}")
    return {**paths, "params": params}


def check_delightful_against_plain(synth, texts, speaker: str = "", tol: float = 1e-3) -> float:
    """Each of `texts` through `Synthesizer.tts` with K1 against the same
    model with the plain MRF version (float32, TF32 off): the largest
    difference of a served waveform. Fails on a waveform that is near
    silent or mostly saturated, where the comparison would show little."""
    import numpy as np

    worst = 0.0
    for text in texts:
        got = np.asarray(synth.tts(text, speaker_name=speaker), dtype=np.float32)
        with plain_mrf():
            ref = np.asarray(synth.tts(text, speaker_name=speaker), dtype=np.float32)
        err = float(np.abs(got - ref).max())
        rms = float(np.sqrt(np.mean(ref**2)))
        saturated = float(np.mean(np.abs(ref) > 0.999))
        log(f"delightful waveform vs plain MRF: chars={len(text)} speaker={speaker or None} samples={got.size} "
            f"max_abs_err={err:.3e} (tol {tol:.0e}) rms={rms:.4f} saturated={saturated:.4f}")
        if not np.isfinite(got).all() or err > tol or rms < 1e-3 or saturated > 0.5:
            raise AssertionError(f"the served DelightfulTTS waveform disagrees with the plain MRF or is silent/"
                                 f"saturated: max_abs_err {err}, rms {rms}, saturated {saturated}")
        worst = max(worst, err)
    return worst


def delightful_phase(tmp: str, device: str = "cuda") -> dict:
    """Phase 19, DelightfulTTS through K1: the default model from a seed over
    three `/api/tts` requests on the locked path (72 K1 launches a sentence,
    replies of n_frames · hop samples, a profile of the 78-character
    request), each served waveform within 1e-3 of the plain MRF; K1 alone at
    the stage shapes of the 78-character request's mel bucket; then a
    4-speaker model, one request a speaker through `cond_layer` and K1, two
    speakers giving other waveforms."""
    import numpy as np
    import torch

    from tpu_tts_torch.infer.synthesizer import Synthesizer
    from tpu_tts_torch.models.delightful_tts import DelightfulTTS
    from tpu_tts_torch.ops import hifigan_mrf
    from tpu_tts_torch.ops.helpers import bucket_len

    t0 = time.perf_counter()
    paths = save_delightful(tmp, device)
    checked = {}

    def check_synth(synth):
        # the 78-character request's mel bucket and the decoder's stage shapes
        n_tokens = len(synth.tts_model.tokenizer.text_to_ids(TEXTS[1]))
        checked.update(max_abs_err=check_delightful_against_plain(synth, TEXTS),
                       y_max=bucket_len(n_tokens * DelightfulTTS.FRAMES_PER_TOKEN, 128),
                       ups=np.cumprod(synth.tts_config.vocoder.upsample_rates_decoder))

    launches = serve_and_check({k: paths[k] for k in ("model_path", "config_path")}, hifigan_mrf,
                               launches_per_sentence=72, device=device, check_synth=check_synth)
    y_max = checked["y_max"]
    gen = torch.Generator(device="cuda").manual_seed(SEED + 21)
    k1 = check_mrf_shapes([(torch.float32, 256 >> i, y_max * int(u)) for i, u in enumerate(checked["ups"])], gen,
                          label=f"delightful y_max={y_max} ")
    torch.cuda.empty_cache()

    spk_paths = save_delightful(tmp, device, speakers=True)
    synth = Synthesizer(spk_paths["model_path"], spk_paths["config_path"], device=device)
    wavs = {}
    hifigan_mrf.launches = 0
    for name in DELIGHTFUL_SPEAKERS:
        before = hifigan_mrf.launches
        t1 = time.perf_counter()
        wavs[name] = np.asarray(synth.tts(TEXTS[0], speaker_name=name), dtype=np.float32)
        n = hifigan_mrf.launches - before
        log(f"delightful speaker request: speaker={name} id={synth.resolve_speaker(name)[0]} "
            f"samples={wavs[name].size} latency_s={time.perf_counter() - t1:.4f} hifigan_mrf_launches={n}")
        if n != 72:
            raise AssertionError(f"speaker {name}'s request launched K1 {n} times, not 72")
    spk_launches = hifigan_mrf.launches
    a, b = wavs["spk_a"], wavs["spk_b"]
    spk_diff = float(np.abs(a - b).max()) if a.size == b.size else None
    spk_err = check_delightful_against_plain(synth, TEXTS[:1], speaker="spk_c")
    log("delightful speakers " + json.dumps({"launches": spk_launches, "lengths": {k: int(v.size) for k, v in wavs.items()},
                                             "spk_a_vs_spk_b_max_abs_diff": spk_diff, "max_abs_err_vs_plain": spk_err}))
    if not (a.size != b.size or spk_diff > 1e-3):
        raise AssertionError("two speakers gave the same DelightfulTTS waveform")
    del synth
    torch.cuda.empty_cache()
    wall = time.perf_counter() - t0
    log(f"delightful phase wall: {wall:.1f} s")
    return {"hifigan_mrf_launches": launches, "max_abs_err": checked["max_abs_err"], "params": paths["params"],
            "shapes": k1, "y_max": y_max, "speaker_launches": spk_launches, "speaker_max_abs_err": spk_err,
            "phase_wall_s": wall}


# ---------------------------------------------------------------- DelightfulTTS training
DT_TRAIN_CLIPS, DT_TRAIN_EVAL_CLIPS = 32, 4  # one batch of the recipe's 32 an epoch; 2–10 s each
DT_TRAIN_EPOCHS = 2  # one step each; then one more epoch, resumed and uninterrupted
DT_OVERFIT_STEPS = 5
DT_F0_WORKERS = 8  # processes that fill the pyin cache before training (the card's machine has 8 cores)


def delightful_tiny_config():
    """The CPU test's tiny DelightfulTTS (`tests/test_torch_port_delightful_train.py`):
    hidden 32, one conformer layer of two heads, `spec_segment_size` 8,
    HiFi-GAN 16 channels up by 8·8·4, dropout 0, one period discriminator;
    the default losses (aligner priors and the binary term on)."""
    from tpu_tts_torch.configs import DelightfulTTSConfig

    config = DelightfulTTSConfig(text_cleaner="english_cleaners")
    ma, v = config.model_args, config.vocoder
    ma.n_hidden_conformer_encoder = ma.n_hidden_conformer_decoder = ma.n_hidden_variance_adaptor = 32
    ma.n_layers_conformer_encoder = ma.n_layers_conformer_decoder = 1
    ma.n_heads_conformer_encoder = ma.n_heads_conformer_decoder = 2
    ma.bottleneck_size_u_reference_encoder, ma.ref_enc_filters_reference_encoder = 32, [4, 4, 8, 8, 16, 16]
    ma.spec_segment_size = 8
    ma.dropout_conformer_encoder = ma.dropout_conformer_decoder = ma.dropout_variance_adaptor = 0.0
    v.upsample_rates_decoder, v.upsample_kernel_sizes_decoder = [8, 8, 4], [16, 16, 8]
    v.upsample_initial_channel_decoder = 16
    v.resblock_kernel_sizes_decoder, v.resblock_dilation_sizes_decoder = [3], [[1, 3]]
    v.periods_discriminator = [2]
    return config


def delightful_tiny_batch(config) -> dict:
    """Two rows of 11 and 7 tokens over 24 and 18 mel frames from a numpy
    seed: voiced tones with noise, a pyin-like pitch (0 on some frames), the
    beta-binomial priors, the decoder windows' uniforms (`segments`)."""
    import numpy as np

    from tpu_tts_torch.ops.helpers import compute_attn_prior

    rng = np.random.default_rng(SEED)
    B, T_x, T_mel, hop = 2, 11, 24, config.audio.hop_length
    x_lens, mel_lens = np.array([T_x, 7]), np.array([T_mel, 18])
    wav = np.zeros((B, 1, T_mel * hop), np.float32)
    pitch = np.zeros((B, T_mel), np.float32)
    priors = np.zeros((B, T_mel, T_x), np.float32)
    x = np.zeros((B, T_x), np.int64)
    for i in range(B):
        n = mel_lens[i] * hop
        t = np.arange(n)
        wav[i, 0, :n] = 0.4 * np.sin(2 * np.pi * (0.01 + 0.004 * i) * t) + 0.05 * rng.standard_normal(n)
        pitch[i, : mel_lens[i]] = (120 + 40 * rng.uniform(size=mel_lens[i])) * (rng.uniform(size=mel_lens[i]) > 0.2)
        priors[i, : mel_lens[i], : x_lens[i]] = compute_attn_prior(int(x_lens[i]), int(mel_lens[i]))
        x[i, : x_lens[i]] = rng.integers(1, 40, x_lens[i])
    return {"text_input": x, "text_lengths": x_lens, "mel_lengths": mel_lens, "waveform": wav, "pitch": pitch,
            "attn_priors": priors, "segments": rng.uniform(size=B).astype(np.float32)}


def check_delightful_train_card_vs_cpu(devices=("cpu", "cuda")) -> dict:
    """One D step and one G step of the tiny DelightfulTTS (torch's init from
    SEED, the decoder at unit gain) on the card against the same step on the
    CPU, the same weights, batch and window draws, in float32 and in float64
    (TF32 off): in both, the losses within TRAIN_STEP_TOL[0] relative and the
    aligner's MAS durations equal; in float64, each gradient within
    TRAIN_STEP_TOL[1] of its tensor's largest |gradient| plus 1e-6. The
    float32 gradients' distance is printed, not bounded: the multi-scale
    STFT term's log-magnitude gradient amplifies float32 rounding on this
    batch (the CPU's own float32 gradients, 1 thread against 4, part by up
    to 8e-4 of a tensor's max, and from float64's by up to 5e-2; float64's
    by 1e-9), so there float32 measures the rounding, not the devices."""
    import torch

    import tpu_tts_torch.models.delightful_tts as dtts

    config = delightful_tiny_config()
    batch = delightful_tiny_batch(config)
    seen, mas = [], dtts.maximum_path
    dtts.maximum_path = lambda v, mask: seen.append(mas(v, mask)) or seen[-1]
    out = {"tol": list(TRAIN_STEP_TOL)}
    try:
        for dtype in (torch.float32, torch.float64):
            models = {}
            for dev in devices:
                torch.manual_seed(SEED)
                m = dtts.DelightfulTTS.init_from_config(config, device=dev)
                m.init_training()
                unit_gain_decoder(m.net.waveform_decoder)
                models[dev] = m
            for dev in devices[1:]:
                models[dev].load_training_state(models[devices[0]].training_state_dict(), strict=True)
            worst_loss, worst_grad = 0.0, 0.0
            for idx in (0, 1):
                res = {}
                for dev, m in models.items():
                    m.net.to(dtype)
                    m.disc.to(dtype)
                    m.train(True)
                    b = {k: torch.from_numpy(v).to(dev) for k, v in batch.items()}
                    b.update({k: b[k].to(dtype) for k in ("waveform", "pitch", "attn_priors")})
                    seen.clear()
                    loss, logs = m.loss_fn(b, idx, draws={"segments": b.pop("segments")})
                    loss.backward()
                    mod = m.disc if idx == 0 else m.net
                    res[dev] = ({k: float(v) for k, v in logs.items()}, seen[0].sum(-1).cpu(),
                                {n: p.grad.detach().cpu() for n, p in mod.named_parameters() if p.grad is not None})
                    m.disc.zero_grad(set_to_none=True)
                    m.net.zero_grad(set_to_none=True)
                (lc, dc, gc), (lg, dg, gg) = res[devices[0]], res[devices[-1]]
                if set(lc) != set(lg) or not torch.equal(dc, dg) or set(gc) != set(gg) or not gc:
                    raise AssertionError(f"the card and the CPU gave other loss terms, MAS durations or gradient "
                                         f"sets ({dtype}, {idx})")
                for k in lc:
                    worst_loss = max(worst_loss, abs(lc[k] - lg[k]) / max(1.0, abs(lc[k])))
                for n in gc:
                    scale = float(gc[n].abs().max())
                    worst_grad = max(worst_grad, (float((gc[n] - gg[n]).abs().max()) - 1e-6) / max(scale, 1e-12))
                out[f"{str(dtype)[6:]}_losses_{idx}"] = {k: [lc[k], lg[k]] for k in lc}
                out["mas_durations"] = dc.tolist()
            out[str(dtype)[6:]] = {"max_loss_rel_err": worst_loss, "max_grad_err_of_max": worst_grad}
    finally:
        dtts.maximum_path = mas
    log("delightful train card vs cpu " + json.dumps(out))
    f32, f64 = out["float32"], out["float64"]
    if not (f32["max_loss_rel_err"] <= TRAIN_STEP_TOL[0] and f64["max_loss_rel_err"] <= TRAIN_STEP_TOL[0]
            and f64["max_grad_err_of_max"] <= TRAIN_STEP_TOL[1]):
        raise AssertionError(f"the tiny DelightfulTTS step on the card disagrees with the CPU: {out}")
    return out


def delightful_train_config(root: str, out: str, epochs: int):
    """The LJSpeech DelightfulTTS recipe's settings (`recipes/ljspeech/
    delightful_tts/train_delightful_tts.py`: the default model, batch 32,
    `mixed_precision`, no aligner priors, no binary alignment term, pyin F0
    cached) with the `en_rules` phonemes (no espeak on the card's machine)
    and 4 loader threads."""
    from tpu_tts_torch.config.shared_configs import BaseDatasetConfig
    from tpu_tts_torch.configs import DelightfulTTSConfig

    return DelightfulTTSConfig(
        batch_size=32, eval_batch_size=DT_TRAIN_EVAL_CLIPS, batch_group_size=2, num_loader_workers=4,
        run_eval=True, test_delay_epochs=-1, epochs=epochs, print_step=1, save_step=0, save_n_checkpoints=10,
        output_path=out, text_cleaner="english_cleaners", use_phonemes=True, phonemizer="en_rules",
        phoneme_language="en", compute_f0=True, f0_cache_path=os.path.join(root, "f0_cache"), mixed_precision=True,
        binary_align_loss_alpha=0.0, use_attn_priors=False, training_seed=SEED + 1,
        datasets=[BaseDatasetConfig(formatter="ljspeech", dataset_name="smoke", path=root,
                                    meta_file_train="metadata.csv", meta_file_val="metadata_val.csv")])


def clip_f0(job):
    """One clip's pyin F0, as the dataset computes it (a worker process's
    task; it imports numpy and the port's audio modules, not torch)."""
    import numpy as np

    from tpu_tts_torch.audio import AudioProcessor

    audio, wav_path = job
    ap = AudioProcessor(**audio)
    return ap.compute_f0(np.asarray(ap.load_wav(wav_path), dtype=np.float32)).astype(np.float32)


def prefill_f0_cache(config, samples) -> float:
    """The pyin F0 of every sample into `config.f0_cache_path`, computed by
    DT_F0_WORKERS spawned processes (the recipe's `precompute_num_workers`;
    the loader would compute them in its threads, under the GIL); seconds."""
    import multiprocessing

    from tpu_tts_torch.data.dataset import FeatureCache

    t0 = time.perf_counter()
    with multiprocessing.get_context("spawn").Pool(DT_F0_WORKERS) as pool:
        f0s = pool.map(clip_f0, [(config.audio.to_dict(), s["audio_file"]) for s in samples])
    cache = FeatureCache(config.f0_cache_path, "_f0.npy")
    for sample, f0 in zip(samples, f0s):
        cache.get(sample["audio_unique_name"], lambda f0=f0: f0)
    return time.perf_counter() - t0


def delightful_train_phase(tmp: str, device: str = "cuda") -> dict:
    """Phase 19a, DelightfulTTS training: (a) the tiny D and G steps on the
    card against the CPU, priors and the binary term on; (b) the default
    model (its decoder redrawn at unit gain, ROADMAP F7) at the LJSpeech
    recipe's settings on DT_TRAIN_CLIPS seeded clips of 2–10 s (texts of
    about 15 characters a second, so that no text outruns its frames), the
    pyin cache filled first, through `Trainer.fit` for DT_TRAIN_EPOCHS steps: ms a
    step (D, G, updates), peak memory, finite losses, every gradient nonzero
    at step 2, K1 launched no time (`delightful train steps`); one more
    epoch uninterrupted against the same epoch resumed by a new model and
    trainer from the checkpoint (`delightful train resume`); a profiled step
    (the device's idle share); DT_OVERFIT_STEPS steps on one batch with
    the same draws, the acoustic mel loss falling (`delightful train
    overfit`); (c) the trained run directory served by `/api/tts` through
    K1: 72 launches, within 1e-3 of the plain MRF, at most half its samples
    saturated (`delightful train serve`)."""
    import statistics

    import torch

    from tpu_tts_torch.data import load_tts_samples
    from tpu_tts_torch.models.delightful_tts import DelightfulTTS
    from tpu_tts_torch.ops import hifigan_mrf
    from tpu_tts_torch.train import Trainer, TrainerArgs
    from tpu_tts_torch.train.checkpoint import get_last_checkpoint

    t0 = time.perf_counter()
    parts = {}
    tiny = check_delightful_train_card_vs_cpu()
    parts["card_vs_cpu_s"] = time.perf_counter() - t0
    root, out = os.path.join(tmp, "data"), os.path.join(tmp, "run")
    data = write_clips(root, SEED + 13, DT_TRAIN_CLIPS, DT_TRAIN_EVAL_CLIPS, (2.0, 10.0), chars_per_s=15.0)
    config = delightful_train_config(root, out, DT_TRAIN_EPOCHS)
    train_samples, eval_samples = load_tts_samples(config.datasets, eval_split=True)
    data["f0_prefill_s"] = prefill_f0_cache(config, train_samples + eval_samples)
    log("delightful train data " + json.dumps(data))
    parts["data_s"] = time.perf_counter() - t0 - sum(parts.values())
    torch.manual_seed(SEED)
    model = DelightfulTTS.init_from_config(config, device=device, samples=train_samples)
    unit_gain_decoder(model.net.waveform_decoder)
    params = sum(p.numel() for p in model.net.parameters())
    row, trainer, probe = fit_and_probe(config, train_samples, eval_samples, out, device, model=model, keep=True)
    row["mas_round_trip_ms"] = statistics.mean(probe.mas_ms) if probe.mas_ms else None
    log("delightful train steps " + json.dumps({**row, "generator_params": params,
                                                "disc_params": sum(p.numel() for p in model.disc.parameters())}))
    parts["fit_s"] = time.perf_counter() - t0 - sum(parts.values())

    # one more epoch, uninterrupted, then the same epoch resumed from the checkpoint
    checkpoint, _ = get_last_checkpoint(out)
    n0 = len(probe.steps)
    trainer.config.epochs = DT_TRAIN_EPOCHS + 1
    trainer.fit()
    uninterrupted = TrainProbe.losses(probe.steps[n0])
    model_b = DelightfulTTS.init_from_config(delightful_train_config(root, out, DT_TRAIN_EPOCHS + 1), device=device,
                                             samples=train_samples)
    trainer_b = Trainer(TrainerArgs(device=device, continue_path=checkpoint), model_b.config,
                        os.path.join(tmp, "resumed"), model=model_b, train_samples=train_samples,
                        eval_samples=eval_samples)
    probe_b = TrainProbe(trainer_b)
    try:
        trainer_b.fit()
    finally:
        probe_b.close()
    resumed = TrainProbe.losses(probe_b.steps[0])
    rel = max(abs(resumed[k] - uninterrupted[k]) / max(1.0, abs(uninterrupted[k])) for k in uninterrupted)
    log("delightful train resume " + json.dumps({"checkpoint": os.path.basename(checkpoint), "max_rel_err": rel,
                                                 "tol": RESUME_TOL, "uninterrupted": uninterrupted,
                                                 "resumed": resumed}))
    if set(resumed) != set(uninterrupted) or not rel <= RESUME_TOL:
        raise AssertionError(f"the resumed DelightfulTTS run's next step differs from the uninterrupted run's: {rel}")
    del trainer_b, model_b, probe_b
    torch.cuda.empty_cache()
    parts["resume_s"] = time.perf_counter() - t0 - sum(parts.values())

    # a profiled step, then fixed-batch steps with the same draws: the acoustic mel loss must fall
    batch = next(iter(model.get_data_loader(trainer.config, {}, is_eval=False, samples=train_samples, verbose=False)))
    profile_call(lambda: trainer.train_step(batch), {"model": config.model, "batch": config.batch_size,
                                                     "call": "one bfloat16 training step (D then G)"}, top=10)
    mel = []
    for _ in range(DT_OVERFIT_STEPS):
        trainer.generator.manual_seed(SEED)
        torch.manual_seed(SEED)
        mel.append(float(trainer.train_step(batch)["opt1_loss_mel"]))
    overfit = {"steps": len(mel), "loss_mel": mel, "first": mel[0], "median_last3": statistics.median(mel[-3:])}
    log("delightful train overfit " + json.dumps(overfit))
    launches = hifigan_mrf.launches  # every step since `fit_and_probe` zeroed the count: fit, profile, resume, overfit
    if not overfit["median_last3"] < overfit["first"] or launches != 0:
        raise AssertionError(f"fixed-batch steps did not lower the mel loss, or training launched K1 {launches} times: "
                             f"{overfit}")
    del trainer, model, probe, batch
    torch.cuda.empty_cache()
    parts["profile_overfit_s"] = time.perf_counter() - t0 - sum(parts.values())

    served = serve_trained({"model_path": get_last_checkpoint(out)[0], "config_path": os.path.join(out, "config.json")},
                           device, label="delightful train serve", max_saturated=0.5)
    wall = time.perf_counter() - t0
    parts["serve_s"] = wall - sum(parts.values())
    log(f"delightful train phase wall: {wall:.1f} s " + json.dumps(parts))
    return {**row, "hifigan_mrf_launches": launches, "tiny": tiny, "resume_max_rel_err": rel, "overfit": overfit,
            "served": served, "phase_wall_s": wall}


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
        k2_launches = serve_and_check(glow_paths, wavernn_sampler, launches_per_sentence=1)
        glow_griffin_lim(glow_paths)
    b8_rows = check_mrf_kernel_batched()
    with tempfile.TemporaryDirectory() as tmp:
        from tpu_tts_torch.configs.vits_config import VitsConfig

        config = VitsConfig(use_phonemes=True, phonemizer="en_rules", phoneme_language="en",
                            text_cleaner="phoneme_cleaners")
        batched = serve_batched(save_model(tmp, config=config, coqui=True))
        model, flat = batched.pop("model"), batched["sentences"]
        check_batch_against_plain(model, *pad_rows(model, [flat[i] for i in (0, 1, 5, 9)]), label="4 rows")
        profile_batch(model, *pad_rows(model, flat[:8]), {}, "")
        del model
    with tempfile.TemporaryDirectory() as tmp:
        multi = serve_batched(save_multispeaker(tmp), MULTISPEAKER_REQUESTS, "multispeaker ")
        if multi["batches"] != 1 or multi["launches_per_batch"] != 72:
            raise AssertionError(f"the multi-speaker requests ran {multi['batches']} batches of "
                                 f"{multi['launches_per_batch']} K1 launches (1 of 72 expected)")
        profile_batch(multi["model"], *multi["served"], "multispeaker ")
        rows_alone = check_rows_alone(multi.pop("model"), multi["served"])
    with tempfile.TemporaryDirectory() as tmp:
        yourtts = serve_yourtts(save_yourtts(tmp))
    with tempfile.TemporaryDirectory() as tmp:
        xtts = xtts_serve(save_xtts(tmp))
        if xtts["launches_per_chunk"] != 72 or xtts["launches_per_emission"] != 72:
            raise AssertionError(f"the XTTS decoder took {xtts['launches_per_chunk']} K1 launches a chunk and "
                                 f"{xtts['launches_per_emission']} a pool emission, not 72")
    torch.cuda.empty_cache()
    with tempfile.TemporaryDirectory() as tmp:
        train = train_phase(tmp)
        torch.cuda.empty_cache()
        mixed = mixed_train_phase(tmp, train)
    torch.cuda.empty_cache()
    xtts_k1 = check_mrf_kernel_xtts()
    with tempfile.TemporaryDirectory() as tmp:
        xtts_train = xtts_train_phase(tmp)
    torch.cuda.empty_cache()
    with tempfile.TemporaryDirectory() as tmp:
        multilingual = multilingual_train_phase(tmp)
    torch.cuda.empty_cache()
    with tempfile.TemporaryDirectory() as tmp:
        encoder = encoder_phase(tmp)
        cloning = cloning_phase(tmp, encoder)
    torch.cuda.empty_cache()
    with tempfile.TemporaryDirectory() as tmp:
        glow = save_glow_wavernn(tmp)
        vocoder = gan_vocoder_phase(tmp, {k: glow[k] for k in ("model_path", "config_path")})
    torch.cuda.empty_cache()
    with tempfile.TemporaryDirectory() as tmp:
        delightful = delightful_phase(tmp)
    torch.cuda.empty_cache()
    with tempfile.TemporaryDirectory() as tmp:
        delightful_train = delightful_train_phase(tmp)

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
        "multispeaker_launches": multi["launches"],
        "launches_per_multispeaker_batch": multi["launches_per_batch"],
        "multispeaker_rows_alone_max_abs_err": rows_alone["max_abs_err"],
        "yourtts_launches": yourtts["hifigan_mrf_launches"],
        # the XTTS phase's streams (1 alone, then 8 concurrent): 72 a decoded chunk or pool emission
        "xtts_launches": xtts["launches"],
        "xtts_launches_per_chunk": xtts["launches_per_chunk"],
        "xtts_launches_per_emission": xtts["launches_per_emission"],
        "xtts_decoder_b8_max_abs_err": xtts["checks"]["decoder_b8_max_abs_err"],
        # training runs the plain ResBlock1 modules (0 launches); the trained checkpoint serves through K1
        "train_launches": train["hifigan_mrf_launches"],
        "train_serve_launches": train["served"]["hifigan_mrf_launches"],
        "train_serve_max_abs_err": train["served"]["max_abs_err_vs_plain"],
        # XTTS fine-tuning (the decoder frozen, never run) and multilingual VITS training: 0; the fine-tuned
        # model's stream and VITS voice conversion: 72 a chunk, 72 a conversion
        "xtts_train_launches": xtts_train["hifigan_mrf_launches"],
        "xtts_finetuned_serve_launches": xtts_train["served"]["hifigan_mrf_launches"],
        "xtts_finetuned_launches_per_chunk": xtts_train["served"]["launches_per_chunk"],
        "xtts_finetuned_decoder_max_abs_err": xtts_train["served"]["decoder_max_abs_err_vs_plain"],
        "multilingual_train_launches": multilingual["hifigan_mrf_launches"],
        "vc_launches": multilingual["vc"]["hifigan_mrf_launches"],
        "vc_max_abs_err": multilingual["vc"]["max_abs_err_vs_plain"],
        "shapes_xtts_chunks": xtts_k1,
        # mixed-precision VITS training (LJSpeech and VCTK settings): 0; its checkpoint served: 72; XTTS-v2
        # cloning a wav through the ResNet encoder: 72 a chunk; a d-vector VITS given a speaker_wav: 72
        "train_mixed_launches": mixed["hifigan_mrf_launches"] + mixed["vctk"]["hifigan_mrf_launches"],
        "train_mixed_serve_launches": mixed["served"]["hifigan_mrf_launches"],
        "train_mixed_serve_max_abs_err": mixed["served"]["max_abs_err_vs_plain"],
        "xtts_clone_launches": cloning["xtts"]["hifigan_mrf_launches"],
        "xtts_clone_launches_per_chunk": cloning["xtts"]["launches_per_chunk"],
        "xtts_clone_decoder_max_abs_err": cloning["xtts"]["decoder_max_abs_err_vs_plain"],
        "dvector_speaker_wav_launches": cloning["vits"]["hifigan_mrf_launches"],
        # Glow-TTS → HiFi-GAN V1 / V2 / the trained run directory: 72 a sentence; multiband MelGAN, UnivNet and
        # vocoder training: 0; K1 at V2's stage shapes (and C = 24, 48), float32 and bfloat16
        "vocoder_launches": {k: v["hifigan_mrf_launches"] for k, v in vocoder["served"].items()},
        "vocoder_max_abs_err": {k: v.get("max_abs_err") for k, v in vocoder["served"].items()},
        "vocoder_train_launches": vocoder["train"]["hifigan_mrf_launches"],
        "vocoder_train_serve_launches": vocoder["run_served"]["hifigan_mrf_launches"],
        "vocoder_train_serve_max_abs_err": vocoder["run_served"]["max_abs_err"],
        "shapes_v2_narrow": vocoder["narrow"],
        "v2_f32": {k: sum(r[k] for r in vocoder["narrow"] if r["shapes"] == "v2" and r["dtype"] == "float32")
                   for k in ("ms", "plain_ms", "bound_ms")},
        # DelightfulTTS over /api/tts (72 a sentence) and its 4-speaker model (72 a request); K1 at the stage
        # shapes of the 78-character request's mel bucket, float32
        "delightful_launches": delightful["hifigan_mrf_launches"],
        "delightful_max_abs_err": delightful["max_abs_err"],
        "delightful_speaker_launches": delightful["speaker_launches"],
        "delightful_speaker_max_abs_err": delightful["speaker_max_abs_err"],
        "shapes_delightful": delightful["shapes"],
        "delightful_f32": {k: sum(r[k] for r in delightful["shapes"]) for k in ("ms", "plain_ms", "bound_ms")},
        # DelightfulTTS training (the generator in train() mode runs plain ResBlock1): 0; its run directory: 72
        "delightful_train_launches": delightful_train["hifigan_mrf_launches"],
        "delightful_train_serve_launches": delightful_train["served"]["hifigan_mrf_launches"],
        "delightful_train_serve_max_abs_err": delightful_train["served"]["max_abs_err_vs_plain"],
        "launches_all_phases": (mrf_launches + batched["launches"] + multi["launches"] + yourtts["hifigan_mrf_launches"]
                                + xtts["launches"] + train["hifigan_mrf_launches"]
                                + train["served"]["hifigan_mrf_launches"] + xtts_train["hifigan_mrf_launches"]
                                + xtts_train["served"]["hifigan_mrf_launches"] + multilingual["hifigan_mrf_launches"]
                                + multilingual["vc"]["hifigan_mrf_launches"] + mixed["hifigan_mrf_launches"]
                                + mixed["vctk"]["hifigan_mrf_launches"] + mixed["served"]["hifigan_mrf_launches"]
                                + cloning["xtts"]["hifigan_mrf_launches"] + cloning["vits"]["hifigan_mrf_launches"]
                                + sum(v["hifigan_mrf_launches"] for v in vocoder["served"].values())
                                + vocoder["run_served"]["hifigan_mrf_launches"]
                                + delightful["hifigan_mrf_launches"] + delightful["speaker_launches"]
                                + delightful_train["hifigan_mrf_launches"]
                                + delightful_train["served"]["hifigan_mrf_launches"]),
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
