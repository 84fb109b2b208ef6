// HiFi-GAN ResBlock1 MRF unit for Hopper (sm_90a), plain C interface for ctypes.
//
// Replaces the Pallas kernel `_mrf_kernel` of tpu_tts/ops/hifigan_pallas.py
// (launched by `mrf_stack_pallas`). One launch computes one dilation unit of
// one resblock over the whole tensor:
//
//   h_out = x + conv_k(mask(lrelu(conv_{k,d}(mask(lrelu(x))) + b1))) + b2
//
// with zero SAME padding (positions outside [0, T) are zero before each conv,
// as the Pallas kernel's `_mask` does) and float32 sums. The last unit of a
// resblock folds that resblock into the stage mean instead of storing h:
// mode 1 starts the float32 sum, mode 2 adds to it, mode 3 adds the last
// resblock and writes (sum + h) / n_blocks in the working type, mode 4 is a
// stage with a single resblock. A stage of R resblocks × U units is R·U
// launches in stream order, so no block reads what another block of the same
// launch writes.
//
// Layout of the work. A time tile of `tile` outputs needs lrelu(x) over the
// tile plus the unit's halo ((k-1)/2·d + (k-1)/2 per side) and the first
// conv's output over the tile plus (k-1)/2 per side, both for all C
// channels, in shared memory (float32). That is why a launch covers one unit
// and not a whole resblock: at C = 256 the tiles of one unit already fill
// most of a block's 227 KB. To still give the 132 SMs enough blocks when C is
// large and T short, the S blocks of a thread-block cluster share one time
// tile: each loads the whole input tile, computes its C/S rows of the first
// conv, gathers the other rows from its neighbours' shared memory (Hopper's
// distributed shared memory), then computes its C/S rows of the second conv.
//
// What bounds it on the H100: at the VITS widths a stage is ≈ 0.6 GFLOP per
// mel frame against a few bytes per sample, far above the card's
// operations-per-byte balance, so it is bound by arithmetic. This version
// runs float32 FMAs on the CUDA cores (67 TFLOP/s peak), not on the tensor
// cores: weights stream through shared memory in chunks of 8 input channels,
// double-buffered with cp.async; each lane owns 8 output channels × 4 time
// positions of a 32 × 32 warp tile and reads weights as 16-byte loads shared
// by 8 lanes and activations lane-contiguously, so the inner loop is 32 FMAs
// per 6 shared loads with no bank conflicts; each kernel size has its own
// instantiation so the taps unroll. Measured on the H100 this reaches a
// fraction of the float32 peak (PERF.md); tensor cores (wgmma) and TMA are
// later work.

#include <cooperative_groups.h>
#include <cuda_bf16.h>
#include <cuda_pipeline.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace cg = cooperative_groups;

namespace {

constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;
constexpr int kLaneCo = 8;                  // output channels of one lane (4 lane groups → 32 a warp tile)
constexpr int kLaneT = 4;                   // time positions of one lane, 8 apart (8 lane groups → 32)
constexpr int kTile = 32;                   // a warp tile is 32 channels × 32 positions
constexpr int kMaxItems = 2;                // warp tiles one warp holds at once
constexpr int kCi = 8;                      // input channels per weight chunk
constexpr int kSlack = kTile;               // floats after each activation array (a warp tile may read past out_w)

__device__ __forceinline__ float lrelu(float v) { return v > 0.f ? v : 0.1f * v; }

__device__ __forceinline__ float to_f(float v) { return v; }
__device__ __forceinline__ float to_f(__nv_bfloat16 v) { return __bfloat162float(v); }

template <typename T>
__device__ __forceinline__ T from_f(float v);
template <>
__device__ __forceinline__ float from_f<float>(float v) { return v; }
template <>
__device__ __forceinline__ __nv_bfloat16 from_f<__nv_bfloat16>(float v) { return __float2bfloat16(v); }

// 8 consecutive weights from shared memory (32 B aligned for float, 16 B for bf16).
__device__ __forceinline__ void load8(const float* p, float* w) {
  const float4 a = reinterpret_cast<const float4*>(p)[0];
  const float4 b = reinterpret_cast<const float4*>(p)[1];
  w[0] = a.x; w[1] = a.y; w[2] = a.z; w[3] = a.w;
  w[4] = b.x; w[5] = b.y; w[6] = b.z; w[7] = b.w;
}
__device__ __forceinline__ void load8(const __nv_bfloat16* p, float* w) {
  const uint4 raw = *reinterpret_cast<const uint4*>(p);
  const __nv_bfloat162* h = reinterpret_cast<const __nv_bfloat162*>(&raw);
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const float2 f = __bfloat1622float2(h[i]);
    w[2 * i] = f.x;
    w[2 * i + 1] = f.y;
  }
}

__host__ __device__ constexpr int round4(int n) { return (n + 3) & ~3; }

// Weights w[ci][j][co] of input channels [ci0, ci0 + kCi) and output channels
// [co0, co0 + share) → dst[c][j][share], asynchronously (cp.async, 16 B).
template <typename W>
__device__ __forceinline__ void fetch_weights(W* dst, const W* __restrict__ w, int ci0, int C, int k, int co0,
                                              int share) {
  constexpr int vec = 16 / sizeof(W);
  const int per_row = share / vec;
  const int n = kCi * k * per_row;
  for (int i = threadIdx.x; i < n; i += blockDim.x) {
    const int row = i / per_row;  // c·k + j
    const int q = i - row * per_row;
    __pipeline_memcpy_async(dst + row * share + q * vec, w + ((size_t)ci0 * k + row) * C + co0 + q * vec, 16);
  }
  __pipeline_commit();
}

// out[co][p] = sum_ci sum_j w[ci][j][co] · in_s[ci][p + j·d] for co in
// [co0, co0 + share) and p in [0, out_w), handed to epi(co, p, sum).
template <int K, typename W, typename Epi>
__device__ __forceinline__ void conv_smem(const float* in_s, int in_w, const W* __restrict__ w, W* w_s, int C,
                                          int k_rt, int d, int co0, int share, int out_w, Epi epi) {
  const int k = K ? K : k_rt;
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  const int cgrp = lane & 3;   // channels cgrp·8 .. +7 of the warp tile
  const int tgrp = lane >> 2;  // positions tgrp, tgrp + 8, tgrp + 16, tgrp + 24
  const int n_wco = share / kTile;
  const int n_items = n_wco * ((out_w + kTile - 1) / kTile);
  const int buf = kCi * k * share;
  const int n_chunks = C / kCi;

  // a block holds kMaxItems · kWarps warp tiles at once; more take further passes
  for (int first = 0; first < n_items; first += kMaxItems * kWarps) {
    int w_off[kMaxItems], x_off[kMaxItems];
#pragma unroll
    for (int it = 0; it < kMaxItems; ++it) {
      const int item = min(first + warp + it * kWarps, n_items - 1);
      w_off[it] = (item % n_wco) * kTile + cgrp * kLaneCo;
      x_off[it] = (item / n_wco) * kTile + tgrp;
    }
    float acc[kMaxItems][kLaneCo][kLaneT];
#pragma unroll
    for (int it = 0; it < kMaxItems; ++it)
#pragma unroll
      for (int c = 0; c < kLaneCo; ++c)
#pragma unroll
        for (int i = 0; i < kLaneT; ++i) acc[it][c][i] = 0.f;

    fetch_weights(w_s, w, 0, C, k, co0, share);
    for (int ch = 0; ch < n_chunks; ++ch) {
      if (ch + 1 < n_chunks) {
        fetch_weights(w_s + ((ch + 1) & 1) * buf, w, (ch + 1) * kCi, C, k, co0, share);
        __pipeline_wait_prior(1);
      } else {
        __pipeline_wait_prior(0);
      }
      __syncthreads();
      const W* ws = w_s + (ch & 1) * buf;
      for (int c = 0; c < kCi; ++c) {
        const float* row = in_s + (ch * kCi + c) * in_w;
#pragma unroll
        for (int j = 0; j < (K ? K : k); ++j) {
          const W* wr = ws + (c * k + j) * share;
          const float* xr = row + j * d;
#pragma unroll
          for (int it = 0; it < kMaxItems; ++it) {
            if (first + warp + it * kWarps < n_items) {
              float wv[kLaneCo], xv[kLaneT];
              load8(wr + w_off[it], wv);
#pragma unroll
              for (int i = 0; i < kLaneT; ++i) xv[i] = xr[x_off[it] + 8 * i];
#pragma unroll
              for (int cc = 0; cc < kLaneCo; ++cc)
#pragma unroll
                for (int i = 0; i < kLaneT; ++i) acc[it][cc][i] = fmaf(wv[cc], xv[i], acc[it][cc][i]);
            }
          }
        }
      }
      __syncthreads();  // the next fetch overwrites this buffer
    }

#pragma unroll
    for (int it = 0; it < kMaxItems; ++it) {
      if (first + warp + it * kWarps < n_items) {
#pragma unroll
        for (int cc = 0; cc < kLaneCo; ++cc)
#pragma unroll
          for (int i = 0; i < kLaneT; ++i) {
            const int p = x_off[it] + 8 * i;
            if (p < out_w) epi(co0 + w_off[it] + cc, p, acc[it][cc][i]);
          }
      }
    }
  }
}

template <typename T, int K>
__global__ void __launch_bounds__(kThreads) mrf_unit_kernel(
    const T* __restrict__ x, const T* __restrict__ w1, const float* __restrict__ b1, const T* __restrict__ w2,
    const float* __restrict__ b2, T* __restrict__ h_out, float* __restrict__ acc, T* __restrict__ y, int C,
    int T_len, int k, int d, int tile, int S, int mode, float inv_n) {
  extern __shared__ __align__(16) float smem[];
  const int pad2 = (k - 1) / 2;
  const int halo = pad2 * d + pad2;
  const int in_w = tile + 2 * halo;   // lrelu(x) at times t0 - halo ..
  const int mid_w = tile + 2 * pad2;  // conv1 output at times t0 - pad2 ..
  float* xs = smem;
  float* ms = xs + round4(C * in_w + kSlack);
  T* w_s = reinterpret_cast<T*>(ms + round4(C * mid_w + kSlack));
  const int rank = blockIdx.x % S;
  const int share = C / S;
  const int t0 = (blockIdx.x / S) * tile;
  const size_t base = (size_t)blockIdx.y * C * T_len;
  const T* xb = x + base;

  for (int i = threadIdx.x; i < C * in_w; i += blockDim.x) {
    const int c = i / in_w;
    const int t = t0 - halo + (i - c * in_w);
    xs[i] = (t >= 0 && t < T_len) ? lrelu(to_f(xb[(size_t)c * T_len + t])) : 0.f;
  }
  for (int i = threadIdx.x; i < kSlack; i += blockDim.x) {
    xs[C * in_w + i] = 0.f;
    ms[C * mid_w + i] = 0.f;
  }
  __syncthreads();

  conv_smem<K>(xs, in_w, w1, w_s, C, k, d, rank * share, share, mid_w, [&](int co, int p, float s) {
    const int t = t0 - pad2 + p;
    ms[co * mid_w + p] = (t >= 0 && t < T_len) ? lrelu(s + b1[co]) : 0.f;
  });

  if (S > 1) {  // gather the other blocks' rows of the first conv
    cg::cluster_group cluster = cg::this_cluster();
    cluster.sync();
    for (int r = 1; r < S; ++r) {
      const int src = (rank + r) % S;
      const float4* remote = reinterpret_cast<const float4*>(cluster.map_shared_rank(ms, src) + src * share * mid_w);
      float4* local = reinterpret_cast<float4*>(ms + src * share * mid_w);
      for (int i = threadIdx.x; i < share * mid_w / 4; i += blockDim.x) local[i] = remote[i];
    }
    cluster.sync();
  } else {
    __syncthreads();
  }

  conv_smem<K>(ms, mid_w, w2, w_s, C, k, 1, rank * share, share, tile, [&](int co, int p, float s) {
    const int t = t0 + p;
    if (t >= T_len) return;
    const size_t off = base + (size_t)co * T_len + t;
    const float h = to_f(x[off]) + s + b2[co];
    switch (mode) {
      case 0: h_out[off] = from_f<T>(h); break;
      case 1: acc[off] = h; break;
      case 2: acc[off] += h; break;
      case 3: y[off] = from_f<T>((acc[off] + h) * inv_n); break;
      default: y[off] = from_f<T>(h * inv_n); break;
    }
  });
}

size_t smem_bytes(int C, int k, int d, int tile, int S, size_t w_size) {
  const int pad2 = (k - 1) / 2;
  const int halo = pad2 * d + pad2;
  return sizeof(float) * (round4(C * (tile + 2 * halo) + kSlack) + round4(C * (tile + 2 * pad2) + kSlack)) +
         2 * (size_t)kCi * k * (C / S) * w_size;
}

template <typename T, int K>
int launch_k(const void* x, const void* w1, const void* b1, const void* w2, const void* b2, void* h_out, void* acc,
           void* y, int B, int C, int T_len, int k, int d, int tile, int S, int mode, float inv_n,
           cudaStream_t stream) {
  const size_t smem = smem_bytes(C, k, d, tile, S, sizeof(T));
  cudaError_t err = cudaFuncSetAttribute(mrf_unit_kernel<T, K>, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return (int)err;
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3(((T_len + tile - 1) / tile) * S, B);
  cfg.blockDim = dim3(kThreads);
  cfg.dynamicSmemBytes = smem;
  cfg.stream = stream;
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeClusterDimension;
  attr[0].val.clusterDim.x = S;
  attr[0].val.clusterDim.y = 1;
  attr[0].val.clusterDim.z = 1;
  cfg.attrs = attr;
  cfg.numAttrs = 1;
  err = cudaLaunchKernelEx(&cfg, mrf_unit_kernel<T, K>, static_cast<const T*>(x), static_cast<const T*>(w1),
                           static_cast<const float*>(b1), static_cast<const T*>(w2), static_cast<const float*>(b2),
                           static_cast<T*>(h_out), static_cast<float*>(acc), static_cast<T*>(y), C, T_len, k, d, tile,
                           S, mode, inv_n);
  if (err != cudaSuccess) return (int)err;
  return (int)cudaGetLastError();
}

// The HiFi-GAN kernel sizes get their own unrolled instantiation.
template <typename T>
int launch(const void* x, const void* w1, const void* b1, const void* w2, const void* b2, void* h_out, void* acc,
           void* y, int B, int C, int T_len, int k, int d, int tile, int S, int mode, float inv_n,
           cudaStream_t stream) {
  switch (k) {
    case 3: return launch_k<T, 3>(x, w1, b1, w2, b2, h_out, acc, y, B, C, T_len, k, d, tile, S, mode, inv_n, stream);
    case 7: return launch_k<T, 7>(x, w1, b1, w2, b2, h_out, acc, y, B, C, T_len, k, d, tile, S, mode, inv_n, stream);
    case 11: return launch_k<T, 11>(x, w1, b1, w2, b2, h_out, acc, y, B, C, T_len, k, d, tile, S, mode, inv_n, stream);
    default: return launch_k<T, 0>(x, w1, b1, w2, b2, h_out, acc, y, B, C, T_len, k, d, tile, S, mode, inv_n, stream);
  }
}

}  // namespace

// Shared memory one launch needs, for the wrapper's choice of tile and S.
extern "C" size_t hifigan_mrf_smem_bytes(int C, int k, int d, int tile, int S, int is_bf16) {
  return smem_bytes(C, k, d, tile, S, is_bf16 ? sizeof(__nv_bfloat16) : sizeof(float));
}

// x, h_out, y: [B, C, T] in the working type (float32 or bfloat16, is_bf16);
// w1, w2: [C_in][k][C_out] in the working type; b1, b2: [C] float32;
// acc: [B, C, T] float32 (unused in modes 0 and 4). C % (32·S) == 0, k odd,
// S in {1, 2, 4, 8}; T is tiled by `tile`, each tile shared by a cluster of
// S blocks. Returns the CUDA error code of the launch (0 on success).
extern "C" int hifigan_mrf_unit(const void* x, const void* w1, const void* b1, const void* w2, const void* b2,
                                void* h_out, void* acc, void* y, int B, int C, int T_len, int k, int d, int tile,
                                int S, int mode, float inv_n, int is_bf16, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (is_bf16)
    return launch<__nv_bfloat16>(x, w1, b1, w2, b2, h_out, acc, y, B, C, T_len, k, d, tile, S, mode, inv_n, s);
  return launch<float>(x, w1, b1, w2, b2, h_out, acc, y, B, C, T_len, k, d, tile, S, mode, inv_n, s);
}
