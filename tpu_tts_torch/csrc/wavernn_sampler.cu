// WaveRNN autoregressive sampling loop for Hopper (sm_90a), plain C interface for ctypes.
//
// Replaces the Pallas kernel `_kernel` of tpu_tts/ops/wavernn_pallas.py
// (launched by `PallasWavernnSampler._run`). One launch runs the whole loop
// of one `Wavernn.inference` call: for every step t of T, for every batch
// row b (a fold of the utterance),
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
// What bounds it on the H100: each step's work is a chain of five dependent
// matrix-vector products over 3.9 M weights (15.7 MB in float32) at a batch
// of a few rows, and step t+1 needs step t's sample. The operation count
// gives ≈ 7 ms for a 2.3 s utterance at the float32 peak, but no step can
// start before the previous one ends, so the chain of 5·T dependent phases,
// each one weight pass from L2, sets the time. The design keeps the loop in
// one persistent cooperative launch: every block owns a strided set of
// output columns of each phase, one warp a column; the block stages the
// phase's input vectors (all batch rows) in shared memory; a grid barrier
// ends each phase (five a step). The weights stay in the 50 MB L2 across
// steps. Every block takes the argmax of the scores itself, identically, so
// the draw needs no further barrier. Values written during the launch by
// other blocks are read with `__ldcg` (L2, not a possibly stale L1 line).
//
// Random numbers: the counter hash of the JAX kernel's interpret-mode path
// (wavernn_pallas.py:116-130), keyed by (seed, t / time_chunk, t % time_chunk,
// class, row), so the port's draws equal the JAX package's interpret-mode
// draws for the same seed.

#include <cooperative_groups.h>
#include <cuda_runtime.h>
#include <math_constants.h>
#include <stdint.h>

namespace cg = cooperative_groups;

namespace {

constexpr int kThreads = 128;
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
};

__device__ __forceinline__ float sigmoidf(float v) { return 1.0f / (1.0f + expf(-v)); }

__device__ __forceinline__ float gumbel(unsigned int seed, int t, int time_chunk, int c, int b) {
  const unsigned int chunk = static_cast<unsigned int>(t / time_chunk);
  const unsigned int tt = static_cast<unsigned int>(t % time_chunk);
  unsigned int h = seed + chunk * 65521u + tt * 2654435761u + static_cast<unsigned int>(c) * 40503u +
                   static_cast<unsigned int>(b) * 69069u;
  h ^= h >> 16;
  h *= 2246822519u;
  h ^= h >> 13;
  h *= 3266489917u;
  h ^= h >> 16;
  const float u = __uint_as_float((h >> 9) | 0x3F800000u) - 1.0f;
  return -logf(-logf(u + 1e-12f) + 1e-12f);
}

// One warp: for batch rows b0 .. b0+nb−1, the NX dot products of the rows
// `wx[i]` with the staged vector `xs[b]` and the NH dot products of `wh[i]`
// with `hs[b]`, each of length K. On return every lane holds the sums.
template <int NX, int NH>
__device__ __forceinline__ void warp_dots(const float* const (&wx)[NX > 0 ? NX : 1],
                                          const float* const (&wh)[NH > 0 ? NH : 1], const float* xs,
                                          const float* hs, int K, int b0, int nb, int lane,
                                          float (&acc)[kRows][NX + NH]) {
#pragma unroll
  for (int r = 0; r < kRows; ++r)
#pragma unroll
    for (int i = 0; i < NX + NH; ++i) acc[r][i] = 0.0f;
  for (int k = lane; k < K; k += 32) {
    float wxv[NX > 0 ? NX : 1], whv[NH > 0 ? NH : 1];
#pragma unroll
    for (int i = 0; i < NX; ++i) wxv[i] = __ldg(wx[i] + k);
#pragma unroll
    for (int i = 0; i < NH; ++i) whv[i] = __ldg(wh[i] + k);
#pragma unroll
    for (int r = 0; r < kRows; ++r) {
      if (r < nb) {
        const float xv = xs[(b0 + r) * K + k];
#pragma unroll
        for (int i = 0; i < NX; ++i) acc[r][i] = fmaf(xv, wxv[i], acc[r][i]);
        if (NH > 0) {
          const float hv = hs[(b0 + r) * K + k];
#pragma unroll
          for (int i = 0; i < NH; ++i) acc[r][NX + i] = fmaf(hv, whv[i], acc[r][NX + i]);
        }
      }
    }
  }
#pragma unroll
  for (int r = 0; r < kRows; ++r)
#pragma unroll
    for (int i = 0; i < NX + NH; ++i)
#pragma unroll
      for (int off = 16; off > 0; off >>= 1) acc[r][i] += __shfl_xor_sync(0xffffffffu, acc[r][i], off);
}

__global__ void __launch_bounds__(kThreads) wavernn_sample_kernel(Params p) {
  cg::grid_group grid = cg::this_grid();
  extern __shared__ float smem[];
  const int B = p.B, T = p.T, R = p.R, F = p.F, C = p.C;
  const int D = R > F ? R : F;
  float* xs = smem;            // [B, R]  x, then x + h1, then x + h1 + h2
  float* hs = xs + B * D;      // [B, D]  h1, then h2, then f1, then f2
  float* samp = hs + B * D;    // [B]     previous sample of each row
  float* red_v = samp + B;     // [kWarps] argmax scratch
  int* red_i = reinterpret_cast<int*>(red_v + kWarps);

  const int tid = threadIdx.x, lane = tid % 32, warp = tid / 32;
  const int gwarp = blockIdx.x * kWarps + warp, nwarps = gridDim.x * kWarps;

  for (int b = tid; b < B; b += kThreads) samp[b] = 0.0f;
  __syncthreads();

  for (int t = 0; t < T; ++t) {
    const float* h1_cur = p.h1 + (t % 2) * B * R;
    float* h1_next = p.h1 + ((t + 1) % 2) * B * R;
    const float* h2_cur = p.h2 + (t % 2) * B * R;
    float* h2_next = p.h2 + ((t + 1) % 2) * B * R;

    // ---- GRU 1: column j of h1 for every row
    for (int i = tid; i < B * R; i += kThreads) {
      const int b = i / R, k = i % R;
      xs[i] = samp[b] * p.w_s[k] + p.pre1[(static_cast<size_t>(b) * T + t) * R + k];
      hs[i] = __ldcg(h1_cur + i);
    }
    __syncthreads();
    for (int j = gwarp; j < R; j += nwarps) {
      const float* const wx[3] = {p.w1_i + static_cast<size_t>(j) * R, p.w1_i + static_cast<size_t>(R + j) * R,
                                  p.w1_i + static_cast<size_t>(2 * R + j) * R};
      const float* const wh[3] = {p.w1_h + static_cast<size_t>(j) * R, p.w1_h + static_cast<size_t>(R + j) * R,
                                  p.w1_hn + static_cast<size_t>(j) * R};
      for (int b0 = 0; b0 < B; b0 += kRows) {
        const int nb = min(kRows, B - b0);
        float acc[kRows][6];
        warp_dots<3, 3>(wx, wh, xs, hs, R, b0, nb, lane, acc);
        if (lane == 0) {
          for (int r = 0; r < nb; ++r) {
            const int b = b0 + r;
            const float rg = sigmoidf((acc[r][0] + p.b1[j]) + acc[r][3]);
            const float zg = sigmoidf((acc[r][1] + p.b1[R + j]) + acc[r][4]);
            const float ng = tanhf((acc[r][2] + p.b1[2 * R + j]) + rg * (acc[r][5] + p.b1_hn[j]));
            h1_next[b * R + j] = (1.0f - zg) * ng + zg * hs[b * R + j];
          }
        }
      }
    }
    grid.sync();

    // ---- GRU 2: x += h1, column j of h2
    for (int i = tid; i < B * R; i += kThreads) {
      xs[i] += __ldcg(h1_next + i);
      hs[i] = __ldcg(h2_cur + i);
    }
    __syncthreads();
    for (int j = gwarp; j < R; j += nwarps) {
      const float* const wx[3] = {p.w2_ix + static_cast<size_t>(j) * R, p.w2_ix + static_cast<size_t>(R + j) * R,
                                  p.w2_ix + static_cast<size_t>(2 * R + j) * R};
      const float* const wh[3] = {p.w2_h + static_cast<size_t>(j) * R, p.w2_h + static_cast<size_t>(R + j) * R,
                                  p.w2_hn + static_cast<size_t>(j) * R};
      for (int b0 = 0; b0 < B; b0 += kRows) {
        const int nb = min(kRows, B - b0);
        float acc[kRows][6];
        warp_dots<3, 3>(wx, wh, xs, hs, R, b0, nb, lane, acc);
        if (lane == 0) {
          for (int r = 0; r < nb; ++r) {
            const int b = b0 + r;
            const float* pre2 = p.pre2 + (static_cast<size_t>(b) * T + t) * 3 * R;
            const float rg = sigmoidf((acc[r][0] + pre2[j]) + acc[r][3]);
            const float zg = sigmoidf((acc[r][1] + pre2[R + j]) + acc[r][4]);
            const float ng = tanhf((acc[r][2] + pre2[2 * R + j]) + rg * (acc[r][5] + p.b2_hn[j]));
            h2_next[b * R + j] = (1.0f - zg) * ng + zg * hs[b * R + j];
          }
        }
      }
    }
    grid.sync();

    // ---- fc1: x += h2, column j of f1
    for (int i = tid; i < B * R; i += kThreads) xs[i] += __ldcg(h2_next + i);
    __syncthreads();
    for (int j = gwarp; j < F; j += nwarps) {
      const float* const wx[1] = {p.fc1 + static_cast<size_t>(j) * R};
      for (int b0 = 0; b0 < B; b0 += kRows) {
        const int nb = min(kRows, B - b0);
        float acc[kRows][1];
        warp_dots<1, 0>(wx, wx, xs, xs, R, b0, nb, lane, acc);
        if (lane == 0)
          for (int r = 0; r < nb; ++r) {
            const int b = b0 + r;
            p.f1[b * F + j] = fmaxf(acc[r][0] + p.pre3[(static_cast<size_t>(b) * T + t) * F + j], 0.0f);
          }
      }
    }
    grid.sync();

    // ---- fc2: column j of f2
    for (int i = tid; i < B * F; i += kThreads) hs[i] = __ldcg(p.f1 + i);
    __syncthreads();
    for (int j = gwarp; j < F; j += nwarps) {
      const float* const wx[1] = {p.fc2 + static_cast<size_t>(j) * F};
      for (int b0 = 0; b0 < B; b0 += kRows) {
        const int nb = min(kRows, B - b0);
        float acc[kRows][1];
        warp_dots<1, 0>(wx, wx, hs, hs, F, b0, nb, lane, acc);
        if (lane == 0)
          for (int r = 0; r < nb; ++r) {
            const int b = b0 + r;
            p.f2[b * F + j] = fmaxf(acc[r][0] + p.pre4[(static_cast<size_t>(b) * T + t) * F + j], 0.0f);
          }
      }
    }
    grid.sync();

    // ---- fc3: score of class c (+ noise)
    for (int i = tid; i < B * F; i += kThreads) hs[i] = __ldcg(p.f2 + i);
    __syncthreads();
    for (int c = gwarp; c < C; c += nwarps) {
      const float* const wx[1] = {p.fc3 + static_cast<size_t>(c) * F};
      for (int b0 = 0; b0 < B; b0 += kRows) {
        const int nb = min(kRows, B - b0);
        float acc[kRows][1];
        warp_dots<1, 0>(wx, wx, hs, hs, F, b0, nb, lane, acc);
        if (lane == 0)
          for (int r = 0; r < nb; ++r) {
            const int b = b0 + r;
            float s = acc[r][0] + p.b3[c];
            if (!p.greedy) s = s + gumbel(p.seed, t, p.time_chunk, c, b);
            p.scores[b * C + c] = s;
          }
      }
    }
    grid.sync();

    // ---- draw: every block takes the same argmax (ties to the lowest index)
    for (int b = 0; b < B; ++b) {
      float best = -CUDART_INF_F;
      int idx = C;
      for (int c = tid; c < C; c += kThreads) {
        const float v = __ldcg(p.scores + b * C + c);
        if (v > best || idx == C) {
          best = v;
          idx = c;
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
        red_v[warp] = best;
        red_i[warp] = idx;
      }
      __syncthreads();
      if (tid == 0) {
        for (int w = 1; w < kWarps; ++w)
          if (red_v[w] > best || (red_v[w] == best && red_i[w] < idx)) {
            best = red_v[w];
            idx = red_i[w];
          }
        const float s = 2.0f * static_cast<float>(idx) / (static_cast<float>(C) - 1.0f) - 1.0f;
        samp[b] = s;
        if (blockIdx.x == 0) p.out[static_cast<size_t>(b) * T + t] = s;
      }
      __syncthreads();
    }
  }
}

size_t smem_bytes(int B, int R, int F) {
  const int D = R > F ? R : F;
  return (static_cast<size_t>(2) * B * D + B + 2 * kWarps) * sizeof(float);
}

}  // namespace

extern "C" {

// Shared memory one block needs for this batch and these widths.
size_t wavernn_smem_bytes(int B, int R, int F) { return smem_bytes(B, R, F); }

// Runs the whole loop in one cooperative launch on `stream`. Returns a
// cudaError_t: cudaErrorNotSupported when the device refuses cooperative
// launches, cudaErrorCooperativeLaunchTooLarge when not one block fits.
int wavernn_sample(const float* pre1, const float* pre2, const float* pre3, const float* pre4, const float* w_s,
                   const float* w1_i, const float* b1, const float* w1_h, const float* w1_hn, const float* b1_hn,
                   const float* w2_ix, const float* w2_h, const float* w2_hn, const float* b2_hn, const float* fc1,
                   const float* fc2, const float* fc3, const float* b3, float* h1, float* h2, float* f1, float* f2,
                   float* scores, float* out, int B, int T, int R, int F, int C, int time_chunk, int greedy,
                   unsigned int seed, void* stream) {
  int dev = 0, coop = 0, n_sm = 0, per_sm = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err != cudaSuccess) return err;
  if ((err = cudaDeviceGetAttribute(&coop, cudaDevAttrCooperativeLaunch, dev)) != cudaSuccess) return err;
  if (!coop) return cudaErrorNotSupported;
  if ((err = cudaDeviceGetAttribute(&n_sm, cudaDevAttrMultiProcessorCount, dev)) != cudaSuccess) return err;
  const size_t smem = smem_bytes(B, R, F);
  if ((err = cudaFuncSetAttribute(wavernn_sample_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                                  static_cast<int>(smem))) != cudaSuccess)
    return err;
  if ((err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, wavernn_sample_kernel, kThreads, smem)) !=
      cudaSuccess)
    return err;
  if (per_sm == 0) return cudaErrorCooperativeLaunchTooLarge;
  int widest = R > F ? R : F;
  widest = widest > C ? widest : C;
  int grid = (widest + kWarps - 1) / kWarps;  // one warp per output column of the widest phase
  if (grid > per_sm * n_sm) grid = per_sm * n_sm;

  Params p{pre1, pre2, pre3, pre4, w_s, w1_i, b1, w1_h, w1_hn, b1_hn, w2_ix, w2_h, w2_hn, b2_hn, fc1, fc2,
           fc3,  b3,   h1,   h2,   f1,  f2,   scores, out, B, T, R, F, C, time_chunk, greedy, seed};
  void* args[] = {&p};
  err = cudaLaunchCooperativeKernel(reinterpret_cast<void*>(wavernn_sample_kernel), dim3(grid), dim3(kThreads), args,
                                    smem, static_cast<cudaStream_t>(stream));
  if (err != cudaSuccess) return err;
  return cudaGetLastError();
}

const char* wavernn_error_string(int err) { return cudaGetErrorString(static_cast<cudaError_t>(err)); }

}  // extern "C"
