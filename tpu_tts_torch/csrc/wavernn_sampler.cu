// WaveRNN autoregressive sampling loop for Hopper (sm_90a), plain C interface for ctypes.
//
// Replaces the Pallas kernel `_kernel` of tpu_tts/ops/wavernn_pallas.py
// (launched by `PallasWavernnSampler._run`). One launch runs the whole loop
// of one `Wavernn.inference` call, or of a chunk of its batch rows: for every
// step t of T, for every batch row b (a fold of the utterance),
//
//   x   = sample·w_s + pre1[b, t]                     (I-layer)
//   h1  = GRU(h1, x @ w1_i + b1)                      (flax gate order, hn bias inside r⊙(…))
//   x  += h1
//   h2  = GRU(h2, x @ w2_ix + pre2[b, t])
//   x  += h2
//   f1  = relu(x @ fc1 + pre3[b, t]);  f2 = relu(f1 @ fc2 + pre4[b, t])
//   s   = f2 @ fc3 + b3  (+ Gumbel noise unless greedy)
//   sample = 2·argmax(s)/(C−1) − 1
//
// The conditioning streams pre1..pre4 are precomputed outside as large
// matrix products (`ops/wavernn_sampler.py`). Weights are in `[out, in]`
// layout, so the dot product of one output column reads one contiguous row.
//
// What bounds it on the H100: each step is a chain of five dependent
// matrix-vector products over 3.93 M weights (15.7 MB in float32) at a batch
// of a few rows, and step t+1 needs step t's sample. At the float32 peak the
// operations take ≈ 7 ms for a 2.3 s utterance, but no phase can start before
// the previous one ends: the time is 5·T phases of latency, each one a
// staging of the phase's inputs, a short dot product and a grid barrier.
// What the design does about each part:
//
// 1. Weights out of L2. The grid is fixed at ⌈max(R, F, C) / 4⌉ blocks (at
//    most one an SM), and block g owns the same columns of every phase at
//    every step: ⌈R/G⌉ of both GRUs (six weight rows each), ⌈F/G⌉ of fc1 and
//    fc2, ⌈C/G⌉ of fc3. At R = F = C = 512 that is 4 columns a phase and
//    120 KB of weights a block, so the 15.7 MB of loop weights live in the
//    shared memory of 128 SMs, loaded once a launch; no step reads a weight
//    from L2. Where a block's share does not fit beside one row of staging
//    (R = 1024, say), the same code reads its rows from global memory
//    (`kShared` false; the wrapper's plan decides).
// 2. Batch rows over launches. The input vectors of every row of the launch
//    are staged in shared memory beside the weights (26 rows at the served
//    widths); the wrapper splits a larger batch into consecutive chunks, one
//    launch each, and the noise is keyed by the row's index in the whole
//    batch (`row0`), so the draws do not depend on the split.
// 3. One wait for memory a phase. Each phase first stages its input vectors
//    (values other blocks wrote, and the streams) in shared memory. Staged a
//    scalar an iteration, every store waits for its own L2 load: about 20
//    round trips a phase at B = 5. The staging moves float4, each thread
//    issues up to 4 loads before it stores any, and a warp's gate inputs
//    from the streams are loaded before the staging, so a phase waits for
//    memory about once.
// 4. Short dot products. Weight rows and staged vectors are read as float4
//    (R and F multiples of 4: the wrapper zero-pads other widths, which
//    changes no draw; the loop bound masks a
//    float4 count that is not a multiple of 32), two iterations unrolled. A
//    block has 8 warps; a column's batch rows are split over 8 / columns warps
//    (2 at 4 columns), so every warp has work at B ≥ 2 and no dot product is
//    split across warps (no cross-warp sum, no extra barrier). A warp's sums
//    are reduced by a reduce-scatter (31 shuffles for a GRU column's 4 rows
//    × 6 gates, not 120) and each lane gathers its row's.
// 5. The draw. Every block takes the same argmax itself (ties to the lowest
//    index), so the draw adds no grid barrier; one warp takes one row (8
//    score loads in flight a lane), and a single __syncthreads ends it.
//
// Five grid barriers a step remain (GRU1 → GRU2 → fc1 → fc2 → fc3 → draw).
// `barrier_probe_kernel` runs them alone at K2's grid and block size: on an
// H100 80GB HBM3 at 700 W, B = 5, R = F = C = 512, they take ≈ 5.5 µs of a
// step of ≈ 18 µs (`chip_smoke.py`); fewer barriers a step is the next cut.
// Values written during the launch by other blocks are read with `__ldcg`
// (L2, not a possibly stale L1 line).
//
// Random numbers: the counter hash of the JAX kernel's interpret-mode path
// (wavernn_pallas.py:116-130), keyed by (seed, t / time_chunk, t % time_chunk,
// class, row0 + row), so the port's draws equal the JAX package's
// interpret-mode draws for the same seed.

#include <cooperative_groups.h>
#include <cuda_runtime.h>
#include <math_constants.h>
#include <stdint.h>

namespace cg = cooperative_groups;

namespace {

constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;
constexpr int kRows = 4;  // batch rows one warp accumulates in one pass

struct Params {
  const float* pre1;   // [B, T, R]   I-layer contribution of (mel, a1) + bias
  const float* pre2;   // [B, T, 3R]  GRU2 input contribution of a2 + input biases
  const float* pre3;   // [B, T, F]   fc1 contribution of a3 + bias
  const float* pre4;   // [B, T, F]   fc2 contribution of a4 + bias
  const float* w_s;    // [R]         I-layer column of the previous sample
  const float* w1_i;   // [3R, R]
  const float* b1;     // [3R]
  const float* w1_h;   // [2R, R]
  const float* w1_hn;  // [R, R]
  const float* b1_hn;  // [R]
  const float* w2_ix;  // [3R, R]
  const float* w2_h;   // [2R, R]
  const float* w2_hn;  // [R, R]
  const float* b2_hn;  // [R]
  const float* fc1;    // [F, R]
  const float* fc2;    // [F, F]
  const float* fc3;    // [C, F]
  const float* b3;     // [C]
  float* h1;           // [2, B, R] double-buffered state, buffer 0 zero on entry
  float* h2;           // [2, B, R]
  float* f1;           // [B, F]
  float* f2;           // [B, F]
  float* scores;       // [B, C]
  float* out;          // [B, T]
  int B, T, R, F, C, time_chunk, greedy;
  unsigned int seed;
  int row0;            // index of row 0 in the whole batch (the noise's key)
  int nR, nF, nC;      // columns of each phase one block owns
};

// Row i (r, z, n of the input weights, then r, z, n of the hidden weights) of GRU column j.
__device__ __forceinline__ const float* gru_row(const float* wi, const float* wh, const float* whn, int R, int j,
                                                int i) {
  if (i < 3) return wi + (static_cast<size_t>(i) * R + j) * R;
  if (i < 5) return wh + (static_cast<size_t>(i - 3) * R + j) * R;
  return whn + static_cast<size_t>(j) * R;
}

template <bool kShared>
__device__ __forceinline__ float4 ldw(const float* p) {
  if constexpr (kShared)
    return *reinterpret_cast<const float4*>(p);
  else
    return __ldg(reinterpret_cast<const float4*>(p));
}

__device__ __forceinline__ float dot4(float4 a, float4 b, float acc) {
  acc = fmaf(a.x, b.x, acc);
  acc = fmaf(a.y, b.y, acc);
  acc = fmaf(a.z, b.z, acc);
  return fmaf(a.w, b.w, acc);
}

__device__ __forceinline__ float4 add4(float4 a, float4 b) {
  return make_float4(a.x + b.x, a.y + b.y, a.z + b.z, a.w + b.w);
}

__device__ __forceinline__ float sigmoidf(float v) { return 1.0f / (1.0f + expf(-v)); }

__device__ __forceinline__ float gumbel(unsigned int seed, int t, int time_chunk, int c, int row) {
  const unsigned int chunk = static_cast<unsigned int>(t / time_chunk);
  const unsigned int tt = static_cast<unsigned int>(t % time_chunk);
  unsigned int h = seed + chunk * 65521u + tt * 2654435761u + static_cast<unsigned int>(c) * 40503u +
                   static_cast<unsigned int>(row) * 69069u;
  h ^= h >> 16;
  h *= 2246822519u;
  h ^= h >> 13;
  h *= 3266489917u;
  h ^= h >> 16;
  const float u = __uint_as_float((h >> 9) | 0x3F800000u) - 1.0f;
  return -logf(-logf(u + 1e-12f) + 1e-12f);
}

// One warp: for the nb (≤ kRows) batch rows b0, b0 + bs, …, the NX dot
// products of the weight rows `wx[i]` with the staged vector `xs[b]` and the
// NH of `wh[i]` with `hs[b]`, each of length K (a multiple of 4), read as
// float4. On return each lane holds its partial sums (over its share of K).
template <bool kShared, int NX, int NH>
__device__ __forceinline__ void warp_dots(const float* const* wx, const float* const* wh, const float* xs,
                                          const float* hs, int K, int b0, int bs, int nb, int lane,
                                          float (&acc)[kRows][NX + NH]) {
#pragma unroll
  for (int r = 0; r < kRows; ++r)
#pragma unroll
    for (int i = 0; i < NX + NH; ++i) acc[r][i] = 0.0f;
  const int K4 = K / 4;
#pragma unroll 2
  for (int k4 = lane; k4 < K4; k4 += 32) {
    float4 wxv[NX], whv[NH > 0 ? NH : 1];
#pragma unroll
    for (int i = 0; i < NX; ++i) wxv[i] = ldw<kShared>(wx[i] + 4 * k4);
#pragma unroll
    for (int i = 0; i < NH; ++i) whv[i] = ldw<kShared>(wh[i] + 4 * k4);
#pragma unroll
    for (int r = 0; r < kRows; ++r) {
      if (r < nb) {
        const int b = b0 + r * bs;
        const float4 xv = reinterpret_cast<const float4*>(xs + b * K)[k4];
#pragma unroll
        for (int i = 0; i < NX; ++i) acc[r][i] = dot4(xv, wxv[i], acc[r][i]);
        if constexpr (NH > 0) {
          const float4 hv = reinterpret_cast<const float4*>(hs + b * K)[k4];
#pragma unroll
          for (int i = 0; i < NH; ++i) acc[r][NX + i] = dot4(hv, whv[i], acc[r][NX + i]);
        }
      }
    }
  }
}

__host__ __device__ constexpr int pow2_at_least(int n) { return n <= 1 ? 1 : 2 * pow2_at_least((n + 1) / 2); }
__host__ __device__ constexpr int log2_of(int p) { return p <= 1 ? 0 : 1 + log2_of(p / 2); }

// Level OFF of a warp's reduce-scatter of the first N of P values a lane
// holds: a lane keeps half its values and adds its partner's other half, so
// after the five levels lane l holds the warp's sum of value l >> (5 − log2 P),
// in P − 1 + 5 − log2 P shuffles instead of 5·P.
template <int P, int N, int OFF>
__device__ __forceinline__ void reduce_scatter(float (&a)[P], int lane) {
  if constexpr (OFF > 0) {
    if constexpr (N > 1) {
      const bool upper = (lane & OFF) != 0;
#pragma unroll
      for (int i = 0; i < N / 2; ++i) {
        const float send = upper ? a[i] : a[i + N / 2];
        const float keep = upper ? a[i + N / 2] : a[i];
        a[i] = keep + __shfl_xor_sync(0xffffffffu, send, OFF);
      }
      reduce_scatter<P, N / 2, OFF / 2>(a, lane);
    } else {
      a[0] += __shfl_xor_sync(0xffffffffu, a[0], OFF);
      reduce_scatter<P, 1, OFF / 2>(a, lane);
    }
  }
}

// Staging of n float4: each thread issues up to kStage loads before it
// stores any, so a phase waits for L2 about once, not once an element.
constexpr int kStage = 4;
template <class Load, class Store>
__device__ __forceinline__ void stage(int n, int tid, Load load, Store store) {
  for (int base = tid; base < n; base += kStage * kThreads) {
    decltype(load(0)) v[kStage];
#pragma unroll
    for (int u = 0; u < kStage; ++u)
      if (base + u * kThreads < n) v[u] = load(base + u * kThreads);
#pragma unroll
    for (int u = 0; u < kStage; ++u)
      if (base + u * kThreads < n) store(base + u * kThreads, v[u]);
  }
}

// One phase for the block's `ncols` columns and all B rows. `stage_in()`
// stages the phase's input vectors; then warp units (column, row slice)
// take the dot products, S = kWarps / ncols slices a column (1 when the
// block has more columns than warps). `rows(cl, wx, wh)` sets the weight
// rows of local column cl; lane r of a pass takes its r-th row: `pre(cl, b)`
// loads that output's inputs from the streams (for a warp's first pass
// before the staging, so the two wait for memory together) and
// `emit(cl, b, sums, pre)` writes the output.
template <bool kShared, int NX, int NH, class Stage, class Rows, class Pre, class Emit>
__device__ __forceinline__ void phase(int ncols, int B, int K, const float* xs, const float* hs, int warp, int lane,
                                      Stage stage_in, Rows rows, Pre pre, Emit emit) {
  const int S = ncols >= kWarps ? 1 : kWarps / max(ncols, 1);
  float4 q = make_float4(0.0f, 0.0f, 0.0f, 0.0f);
  if (warp < ncols * S && lane < min(kRows, (B - warp / ncols + S - 1) / S))
    q = pre(warp % ncols, warp / ncols + lane * S);
  stage_in();
  __syncthreads();
  for (int u = warp; u < ncols * S; u += kWarps) {
    const int cl = u % ncols, s = u / ncols;
    const float* wx[NX];
    const float* wh[NH > 0 ? NH : 1];
    rows(cl, wx, wh);
    for (int b0 = s; b0 < B; b0 += S * kRows) {
      const int nb = min(kRows, (B - b0 + S - 1) / S);
      const int b = b0 + lane * S;  // this lane's row, if lane < nb
      if (u != warp || b0 != s) {
        q = make_float4(0.0f, 0.0f, 0.0f, 0.0f);
        if (lane < nb) q = pre(cl, b);
      }
      constexpr int V = NX + NH, P = pow2_at_least(kRows * V), SH = 5 - log2_of(P);
      static_assert(kRows * V <= 32, "one value of the reduce-scatter a lane at most");
      float acc[kRows][V];
      warp_dots<kShared, NX, NH>(wx, wh, xs, hs, K, b0, S, nb, lane, acc);
      float a[P];
#pragma unroll
      for (int i = 0; i < P; ++i) a[i] = i < kRows * V ? acc[i / V][i % V] : 0.0f;
      reduce_scatter<P, P, 16>(a, lane);
      float v[V];  // lane r < nb gathers its row's sums
#pragma unroll
      for (int i = 0; i < V; ++i) v[i] = __shfl_sync(0xffffffffu, a[0], (min(lane, kRows - 1) * V + i) << SH);
      if (lane < nb) emit(cl, b, v, q);
    }
  }
}

struct Stage3 {
  float4 a, b, c;
};

template <bool kShared>
__global__ void __launch_bounds__(kThreads, 1) wavernn_sample_kernel(Params p) {
  cg::grid_group grid = cg::this_grid();
  extern __shared__ float4 smem4[];
  float* smem = reinterpret_cast<float*>(smem4);
  const int B = p.B, T = p.T, R = p.R, F = p.F, C = p.C;
  const int D = R > F ? R : F;
  // this block's columns of each phase, the same at every step
  const int jR = blockIdx.x * p.nR, jF = blockIdx.x * p.nF, jC = blockIdx.x * p.nC;
  const int ncR = max(0, min(p.nR, R - jR)), ncF = max(0, min(p.nF, F - jF)), ncC = max(0, min(p.nC, C - jC));
  // shared memory (float offsets, all multiples of 4): the weights when held
  float* wg1 = smem;                             // [nR][6][R] GRU1 rows of the block's columns
  float* wg2 = wg1 + p.nR * 6 * R;               // [nR][6][R] GRU2
  float* wf1 = wg2 + p.nR * 6 * R;               // [nF][R]    fc1
  float* wf2 = wf1 + p.nF * R;                   // [nF][F]    fc2
  float* wf3 = wf2 + p.nF * F;                   // [nC][F]    fc3
  float* xs = kShared ? wf3 + p.nC * F : smem;   // [B, R]     x, then x + h1, then x + h1 + h2
  float* hs = xs + B * D;                        // [B, D]     h1, then h2, then f1, then f2
  float* samp = hs + B * D;                      // [B]        previous sample of each row

  const int tid = threadIdx.x, lane = tid % 32, warp = tid / 32;

  if constexpr (kShared) {  // the block's weight rows, once a launch
    const int R4 = R / 4;
    for (int e = tid; e < ncR * 6 * R4; e += kThreads) {
      const int row = e / R4, k4 = e % R4;
      smem4[(wg1 - smem) / 4 + e] = ldw<false>(gru_row(p.w1_i, p.w1_h, p.w1_hn, R, jR + row / 6, row % 6) + 4 * k4);
      smem4[(wg2 - smem) / 4 + e] = ldw<false>(gru_row(p.w2_ix, p.w2_h, p.w2_hn, R, jR + row / 6, row % 6) + 4 * k4);
    }
    for (int e = tid; e < ncF * R4; e += kThreads)
      smem4[(wf1 - smem) / 4 + e] = ldw<false>(p.fc1 + static_cast<size_t>(jF) * R + 4 * e);
    for (int e = tid; e < ncF * F / 4; e += kThreads)
      smem4[(wf2 - smem) / 4 + e] = ldw<false>(p.fc2 + static_cast<size_t>(jF) * F + 4 * e);
    for (int e = tid; e < ncC * F / 4; e += kThreads)
      smem4[(wf3 - smem) / 4 + e] = ldw<false>(p.fc3 + static_cast<size_t>(jC) * F + 4 * e);
  }
  for (int b = tid; b < B; b += kThreads) samp[b] = 0.0f;
  __syncthreads();

  float4* xs4 = reinterpret_cast<float4*>(xs);
  float4* hs4 = reinterpret_cast<float4*>(hs);
  const int BR4 = B * R / 4, BF4 = B * F / 4;

  for (int t = 0; t < T; ++t) {
    const float4* h1_cur = reinterpret_cast<const float4*>(p.h1 + (t % 2) * B * R);
    float* h1_next = p.h1 + ((t + 1) % 2) * B * R;
    const float4* h2_cur = reinterpret_cast<const float4*>(p.h2 + (t % 2) * B * R);
    float* h2_next = p.h2 + ((t + 1) % 2) * B * R;

    // ---- GRU 1: x = sample·w_s + pre1, column j of h1 for every row
    phase<kShared, 3, 3>(
        ncR, B, R, xs, hs, warp, lane,
        [&] {
          stage(
              BR4, tid,
              [&](int i) {
                const int b = i / (R / 4), k = 4 * i - b * R;
                return Stage3{__ldg(reinterpret_cast<const float4*>(p.w_s + k)),
                              __ldg(reinterpret_cast<const float4*>(p.pre1 + (static_cast<size_t>(b) * T + t) * R + k)),
                              __ldcg(h1_cur + i)};
              },
              [&](int i, Stage3 v) {
                const float s = samp[i / (R / 4)];
                xs4[i] = make_float4(s * v.a.x + v.b.x, s * v.a.y + v.b.y, s * v.a.z + v.b.z, s * v.a.w + v.b.w);
                hs4[i] = v.c;
              });
        },
        [&](int cl, const float** wx, const float** wh) {
          for (int i = 0; i < 3; ++i) {
            wx[i] = kShared ? wg1 + (cl * 6 + i) * R : gru_row(p.w1_i, p.w1_h, p.w1_hn, R, jR + cl, i);
            wh[i] = kShared ? wg1 + (cl * 6 + 3 + i) * R : gru_row(p.w1_i, p.w1_h, p.w1_hn, R, jR + cl, 3 + i);
          }
        },
        [&](int cl, int b) {
          const int j = jR + cl;
          return make_float4(__ldg(p.b1 + j), __ldg(p.b1 + R + j), __ldg(p.b1 + 2 * R + j), __ldg(p.b1_hn + j));
        },
        [&](int cl, int b, const float* v, float4 q) {
          const int j = jR + cl;
          const float rg = sigmoidf((v[0] + q.x) + v[3]);
          const float zg = sigmoidf((v[1] + q.y) + v[4]);
          const float ng = tanhf((v[2] + q.z) + rg * (v[5] + q.w));
          h1_next[b * R + j] = (1.0f - zg) * ng + zg * hs[b * R + j];
        });
    grid.sync();

    // ---- GRU 2: x += h1, column j of h2
    phase<kShared, 3, 3>(
        ncR, B, R, xs, hs, warp, lane,
        [&] {
          stage(
              BR4, tid,
              [&](int i) {
                return Stage3{__ldcg(reinterpret_cast<const float4*>(h1_next) + i), __ldcg(h2_cur + i), {}};
              },
              [&](int i, Stage3 v) {
                xs4[i] = add4(xs4[i], v.a);
                hs4[i] = v.b;
              });
        },
        [&](int cl, const float** wx, const float** wh) {
          for (int i = 0; i < 3; ++i) {
            wx[i] = kShared ? wg2 + (cl * 6 + i) * R : gru_row(p.w2_ix, p.w2_h, p.w2_hn, R, jR + cl, i);
            wh[i] = kShared ? wg2 + (cl * 6 + 3 + i) * R : gru_row(p.w2_ix, p.w2_h, p.w2_hn, R, jR + cl, 3 + i);
          }
        },
        [&](int cl, int b) {
          const int j = jR + cl;
          const float* pre2 = p.pre2 + (static_cast<size_t>(b) * T + t) * 3 * R;
          return make_float4(__ldg(pre2 + j), __ldg(pre2 + R + j), __ldg(pre2 + 2 * R + j), __ldg(p.b2_hn + j));
        },
        [&](int cl, int b, const float* v, float4 q) {
          const int j = jR + cl;
          const float rg = sigmoidf((v[0] + q.x) + v[3]);
          const float zg = sigmoidf((v[1] + q.y) + v[4]);
          const float ng = tanhf((v[2] + q.z) + rg * (v[5] + q.w));
          h2_next[b * R + j] = (1.0f - zg) * ng + zg * hs[b * R + j];
        });
    grid.sync();

    // ---- fc1: x += h2, column j of f1
    phase<kShared, 1, 0>(
        ncF, B, R, xs, xs, warp, lane,
        [&] {
          stage(
              BR4, tid, [&](int i) { return __ldcg(reinterpret_cast<const float4*>(h2_next) + i); },
              [&](int i, float4 v) { xs4[i] = add4(xs4[i], v); });
        },
        [&](int cl, const float** wx, const float**) {
          wx[0] = kShared ? wf1 + cl * R : p.fc1 + static_cast<size_t>(jF + cl) * R;
        },
        [&](int cl, int b) {
          return make_float4(__ldg(p.pre3 + (static_cast<size_t>(b) * T + t) * F + jF + cl), 0.0f, 0.0f, 0.0f);
        },
        [&](int cl, int b, const float* v, float4 q) { p.f1[b * F + jF + cl] = fmaxf(v[0] + q.x, 0.0f); });
    grid.sync();

    // ---- fc2: column j of f2
    phase<kShared, 1, 0>(
        ncF, B, F, hs, hs, warp, lane,
        [&] {
          stage(
              BF4, tid, [&](int i) { return __ldcg(reinterpret_cast<const float4*>(p.f1) + i); },
              [&](int i, float4 v) { hs4[i] = v; });
        },
        [&](int cl, const float** wx, const float**) {
          wx[0] = kShared ? wf2 + cl * F : p.fc2 + static_cast<size_t>(jF + cl) * F;
        },
        [&](int cl, int b) {
          return make_float4(__ldg(p.pre4 + (static_cast<size_t>(b) * T + t) * F + jF + cl), 0.0f, 0.0f, 0.0f);
        },
        [&](int cl, int b, const float* v, float4 q) { p.f2[b * F + jF + cl] = fmaxf(v[0] + q.x, 0.0f); });
    grid.sync();

    // ---- fc3: score of class c (+ noise)
    phase<kShared, 1, 0>(
        ncC, B, F, hs, hs, warp, lane,
        [&] {
          stage(
              BF4, tid, [&](int i) { return __ldcg(reinterpret_cast<const float4*>(p.f2) + i); },
              [&](int i, float4 v) { hs4[i] = v; });
        },
        [&](int cl, const float** wx, const float**) {
          wx[0] = kShared ? wf3 + cl * F : p.fc3 + static_cast<size_t>(jC + cl) * F;
        },
        [&](int cl, int b) {
          const int c = jC + cl;
          return make_float4(__ldg(p.b3 + c), p.greedy ? 0.0f : gumbel(p.seed, t, p.time_chunk, c, p.row0 + b),
                             0.0f, 0.0f);
        },
        [&](int cl, int b, const float* v, float4 q) {
          float s = v[0] + q.x;
          if (!p.greedy) s = s + q.y;
          p.scores[b * C + jC + cl] = s;
        });
    grid.sync();

    // ---- draw: every block takes the same argmax (ties to the lowest index), one warp a row
    for (int b = warp; b < B; b += kWarps) {
      float best = -CUDART_INF_F;
      int idx = C;
      for (int c0 = lane; c0 < C; c0 += 8 * 32) {  // 8 loads in flight, then the compares in class order
        float v[8];
#pragma unroll
        for (int u = 0; u < 8; ++u)
          if (c0 + 32 * u < C) v[u] = __ldcg(p.scores + b * C + c0 + 32 * u);
#pragma unroll
        for (int u = 0; u < 8; ++u)
          if (c0 + 32 * u < C && (v[u] > best || idx == C)) {
            best = v[u];
            idx = c0 + 32 * u;
          }
      }
#pragma unroll
      for (int off = 16; off > 0; off >>= 1) {
        const float ov = __shfl_xor_sync(0xffffffffu, best, off);
        const int oi = __shfl_xor_sync(0xffffffffu, idx, off);
        if (ov > best || (ov == best && oi < idx)) {
          best = ov;
          idx = oi;
        }
      }
      if (lane == 0) {
        const float s = 2.0f * static_cast<float>(idx) / (static_cast<float>(C) - 1.0f) - 1.0f;
        samp[b] = s;
        if (blockIdx.x == 0) p.out[static_cast<size_t>(b) * T + t] = s;
      }
    }
    __syncthreads();
  }
}

// Only the five grid barriers of a step, T steps: what they cost at K2's grid and block size.
__global__ void __launch_bounds__(kThreads, 1) barrier_probe_kernel(int T) {
  cg::grid_group grid = cg::this_grid();
  for (int t = 0; t < T; ++t) {
#pragma unroll
    for (int i = 0; i < 5; ++i) grid.sync();
  }
}

// The layout of the kernel's shared memory (ops/wavernn_sampler.py `Plan.smem_bytes` mirrors it).
size_t smem_bytes(int B, int R, int F, int C, int grid, bool shared) {
  const size_t D = R > F ? R : F;
  size_t floats = 2 * B * D + (B + 3) / 4 * 4;
  if (shared) {
    const size_t nR = (R + grid - 1) / grid, nF = (F + grid - 1) / grid, nC = (C + grid - 1) / grid;
    floats += nR * 12 * R + nF * (R + F) + nC * F;
  }
  return floats * sizeof(float);
}

}  // namespace

extern "C" {

// Shared memory one block needs for a launch of B rows on `grid` blocks.
size_t wavernn_smem_bytes(int B, int R, int F, int C, int grid, int weights_shared) {
  return smem_bytes(B, R, F, C, grid, weights_shared != 0);
}

// Runs the whole loop for B rows (rows row0 … of the whole batch) in one
// cooperative launch of `grid_blocks` blocks on `stream`, the weights held in
// shared memory if `weights_shared`. Returns a cudaError_t:
// cudaErrorNotSupported when the device refuses cooperative launches,
// cudaErrorCooperativeLaunchTooLarge when the blocks cannot all be resident,
// cudaErrorInvalidValue for widths the kernel does not take.
int wavernn_sample(const float* pre1, const float* pre2, const float* pre3, const float* pre4, const float* w_s,
                   const float* w1_i, const float* b1, const float* w1_h, const float* w1_hn, const float* b1_hn,
                   const float* w2_ix, const float* w2_h, const float* w2_hn, const float* b2_hn, const float* fc1,
                   const float* fc2, const float* fc3, const float* b3, float* h1, float* h2, float* f1, float* f2,
                   float* scores, float* out, int B, int T, int R, int F, int C, int time_chunk, int greedy,
                   unsigned int seed, int row0, int grid_blocks, int weights_shared, void* stream) {
  int dev = 0, coop = 0, n_sm = 0, per_sm = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err != cudaSuccess) return err;
  if ((err = cudaDeviceGetAttribute(&coop, cudaDevAttrCooperativeLaunch, dev)) != cudaSuccess) return err;
  if (!coop) return cudaErrorNotSupported;
  if ((err = cudaDeviceGetAttribute(&n_sm, cudaDevAttrMultiProcessorCount, dev)) != cudaSuccess) return err;
  if (B < 1 || grid_blocks < 1 || R % 4 || F % 4) return cudaErrorInvalidValue;
  const bool shared = weights_shared != 0;
  const void* kernel = shared ? reinterpret_cast<const void*>(wavernn_sample_kernel<true>)
                              : reinterpret_cast<const void*>(wavernn_sample_kernel<false>);
  const size_t smem = smem_bytes(B, R, F, C, grid_blocks, shared);
  if ((err = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, static_cast<int>(smem))) !=
      cudaSuccess)
    return err;
  if ((err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, kernel, kThreads, smem)) != cudaSuccess)
    return err;
  if (per_sm * n_sm < grid_blocks) return cudaErrorCooperativeLaunchTooLarge;

  const int nR = (R + grid_blocks - 1) / grid_blocks, nF = (F + grid_blocks - 1) / grid_blocks,
            nC = (C + grid_blocks - 1) / grid_blocks;
  Params p{pre1, pre2, pre3, pre4, w_s, w1_i, b1, w1_h, w1_hn, b1_hn, w2_ix, w2_h, w2_hn, b2_hn, fc1, fc2,
           fc3,  b3,   h1,   h2,   f1,  f2,   scores, out, B, T, R, F, C, time_chunk, greedy, seed, row0,
           nR,   nF,   nC};
  void* args[] = {&p};
  err = cudaLaunchCooperativeKernel(kernel, dim3(grid_blocks), dim3(kThreads), args, smem,
                                    static_cast<cudaStream_t>(stream));
  if (err != cudaSuccess) return err;
  return cudaGetLastError();
}

// The barrier probe: T steps of five grid barriers, `grid` blocks of K2's size with `smem` bytes each.
int wavernn_barrier_probe(int T, int grid, size_t smem, void* stream) {
  cudaError_t err = cudaFuncSetAttribute(barrier_probe_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                                         static_cast<int>(smem));
  if (err != cudaSuccess) return err;
  void* args[] = {&T};
  err = cudaLaunchCooperativeKernel(reinterpret_cast<void*>(barrier_probe_kernel), dim3(grid), dim3(kThreads), args,
                                    smem, static_cast<cudaStream_t>(stream));
  if (err != cudaSuccess) return err;
  return cudaGetLastError();
}

const char* wavernn_error_string(int err) { return cudaGetErrorString(static_cast<cudaError_t>(err)); }

}  // extern "C"
