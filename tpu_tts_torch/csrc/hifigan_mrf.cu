// HiFi-GAN ResBlock1 MRF convolutions on Hopper's tensor cores (sm_90a),
// plain C interface for ctypes.
//
// Replaces the Pallas kernel `_mrf_kernel` of tpu_tts/ops/hifigan_pallas.py
// (launched by `mrf_stack_pallas`). One dilation unit of one resblock,
//
//   h_out = x + conv_k(mask(lrelu(conv_{k,d}(mask(lrelu(x))) + b1))) + b2
//
// with zero SAME padding (positions outside [0, T) are zero before each conv,
// as the Pallas kernel's `_mask` does), is two launches of one kernel:
//   conv 1: mid = lrelu(conv_{k,d}(mask(lrelu(x))) + b1), float32 [B, C, T];
//   conv 2: h = x + conv_k(mask(mid)) + b2, then the stage mean: mode 0
//           stores h, mode 1 starts the float32 sum, mode 2 adds to it,
//           mode 3 adds the last resblock and writes (sum + h) / n_blocks in
//           the working type, mode 4 is a stage with a single resblock.
// A stage of R resblocks × U units is 2·R·U launches in stream order.
//
// What bounds it on the H100: at the VITS widths a stage is ≈ 0.6 GFLOP per
// mel frame against a few bytes per sample, so it is bound by arithmetic.
// On the CUDA cores (67 TFLOP/s float32) the four VITS stages of a 256-frame
// forward cannot take less than 2.27 ms; the tensor cores do TF32 at 495
// TFLOP/s. TF32 keeps 10 mantissa bits, so one pass misses the float32 bar
// of 2e-4 over a whole stack (tests/test_torch_port_mrf_numerics.py
// emulates it). The float32 path therefore runs 3×TF32: each operand is
// split into hi = tf32(x) and lo = tf32(x − hi) (cvt.rna, the low 13 bits
// cleared) and the product is lo·hi + hi·lo + hi·hi; the weights are split
// once, by `pack_stage`, the activations as they are loaded. The tensor cores align each product to the accumulator
// they are given and truncate, so a sum carried through the whole K loop
// drifts by ≈ 2^-23 of its size per step (1e-4 over a C = 256 stack): each
// K step is summed from zero and added to the float32 accumulator on the
// CUDA cores, which keeps float32's own error. The bfloat16 path takes one
// TF32 pass: every bf16 weight is exact in TF32 and the activations keep 3
// more bits than bf16, with one kernel body for both types.
//
// Each conv is an implicit GEMM, as the Pallas kernel's im2col: M = time,
// N = C_out, K = taps × C_in; the K loop walks (tap j, 32 input channels),
// tap j reading the activations shifted by (j − (k−1)/2)·d, so no im2col
// buffer is built. A block is three warpgroups on a 128 × BN output tile.
// One thread of warpgroup 2 keeps a 4-stage ring of weight tiles in flight
// by TMA (BN rows × 32 input channels, K-major, 128-byte swizzle, hi and
// lo), through full/empty mbarriers. Warpgroups 0 and 1 each own 64 time
// rows: they load their activation fragments straight from global memory
// into registers two K steps ahead (lrelu, mask and split on the way) and
// run wgmma.m64nBNk8 TF32 with the activations as the register operand and
// the weight tile as the shared-memory operand. `plan` picks BN per stage
// shape. Splitting a unit into two launches costs one write and one read of
// the float32 `mid` per unit (L2-resident at the VITS shapes) and lets both
// operands stream in K chunks: a fused unit would hold conv 1's output for
// all C channels in shared memory. What limits it now is each consumer
// warpgroup's serial chain a K step (wait for the weight tile, issue,
// wait_group 0, promotion, the next split), not the tensor cores: bf16, a
// third of the products, is only a little faster (PERF.md).

#include <cuda.h>  // CUtensorMap and its enums; the encoder is looked up in libcuda with dlsym
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <dlfcn.h>
#include <stdint.h>

namespace {

constexpr int kBM = 128, kBK = 32, kThreads = 384, kStages = 4;

__device__ __forceinline__ float lrelu(float v) { return v > 0.f ? v : 0.1f * v; }

__device__ __forceinline__ float to_f(float v) { return v; }
__device__ __forceinline__ float to_f(__nv_bfloat16 v) { return __bfloat162float(v); }

template <typename T>
__device__ __forceinline__ T from_f(float v);
template <>
__device__ __forceinline__ float from_f<float>(float v) { return v; }
template <>
__device__ __forceinline__ __nv_bfloat16 from_f<__nv_bfloat16>(float v) { return __float2bfloat16(v); }

// x rounded to TF32: nearest, ties away from zero, low 13 bits zero.
__device__ __forceinline__ float tf32(float x) {
  uint32_t r;
  asm("cvt.rna.tf32.f32 %0, %1;" : "=r"(r) : "f"(x));
  return __uint_as_float(r & 0xffffe000u);
}

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}
__device__ __forceinline__ void mbar_init(uint64_t* bar, int count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;\n" ::"r"(smem_u32(bar)), "r"(count) : "memory");
}
__device__ __forceinline__ void mbar_expect_tx(uint64_t* bar, uint32_t bytes) {
  asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n" ::"r"(smem_u32(bar)), "r"(bytes)
               : "memory");
}
__device__ __forceinline__ void mbar_arrive(uint64_t* bar) {
  asm volatile("mbarrier.arrive.shared::cta.b64 _, [%0];\n" ::"r"(smem_u32(bar)) : "memory");
}
// Waits for the phase of parity `parity` to complete; traps, rather than
// hang the card, if it has not after 2^22 polls.
__device__ __forceinline__ void mbar_wait(uint64_t* bar, int parity) {
  uint32_t done = 0;
  for (int i = 0; !done; ++i) {
    asm volatile(
        "{\n.reg .pred P1;\nmbarrier.try_wait.parity.shared::cta.b64 P1, [%1], %2;\nselp.u32 %0, 1, 0, P1;\n}\n"
        : "=r"(done)
        : "r"(smem_u32(bar)), "r"(parity)
        : "memory");
    if (!done && i == (1 << 22)) __trap();
  }
}
__device__ __forceinline__ void tma_load_2d(void* dst, const CUtensorMap* map, uint64_t* bar, int c0, int c1) {
  asm volatile(
      "cp.async.bulk.tensor.2d.shared::cluster.global.mbarrier::complete_tx::bytes [%0], [%1, {%3, %4}], [%2];\n" ::
          "r"(smem_u32(dst)),
      "l"(reinterpret_cast<uint64_t>(map)), "r"(smem_u32(bar)), "r"(c0), "r"(c1)
      : "memory");
}
// Shared-memory matrix descriptor: K-major rows of 128 bytes, 128-byte
// swizzle, 8-row groups 1024 bytes apart.
__device__ __forceinline__ uint64_t desc_sw128(const void* p) {
  uint64_t d = (uint64_t)((smem_u32(p) & 0x3FFFF) >> 4);
  d |= (uint64_t)1 << 16;
  d |= (uint64_t)(1024 >> 4) << 32;
  d |= (uint64_t)1 << 62;
  return d;
}
__device__ __forceinline__ void wgmma_fence() { asm volatile("wgmma.fence.sync.aligned;\n" ::: "memory"); }
__device__ __forceinline__ void wgmma_commit() { asm volatile("wgmma.commit_group.sync.aligned;\n" ::: "memory"); }
__device__ __forceinline__ void wgmma_wait0() { asm volatile("wgmma.wait_group.sync.aligned 0;\n" ::: "memory"); }
__device__ __forceinline__ void reg_fence(float& r) { asm volatile("" : "+f"(r)::"memory"); }

// d[0:16] += a (64 × 8, registers) · b (8 × 32, shared memory, K-major, 128-byte swizzle)
__device__ __forceinline__ void wgmma_n32(float (&d)[16], const uint32_t (&a)[4], uint64_t b, int scale_d) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %21, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n32k8.f32.tf32.tf32 {%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15}, {%16, %17, %18, %19}, %20, p, 1, 1;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(b), "r"(scale_d));
}

// d[0:32] += a (64 × 8, registers) · b (8 × 64, shared memory, K-major, 128-byte swizzle)
__device__ __forceinline__ void wgmma_n64(float (&d)[32], const uint32_t (&a)[4], uint64_t b, int scale_d) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %37, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k8.f32.tf32.tf32 {%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, %16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31}, {%32, %33, %34, %35}, %36, p, 1, 1;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]), "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]), "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(b), "r"(scale_d));
}

template <int BN>
__device__ __forceinline__ void wgmma_tile(float (&d)[BN / 2], const uint32_t (&a)[4], uint64_t b, int scale_d) {
  if constexpr (BN == 32) wgmma_n32(d, a, b, scale_d);
  else wgmma_n64(d, a, b, scale_d);
}

struct Args {
  const void* src;     // conv 1: the unit input x (working type); conv 2: mid (float32)
  const void* x;       // the unit input, for the residual (working type)
  const float* w_hi;   // [k][C_out][C_in], TF32
  const float* w_lo;   // the same layout, TF32 (read by the 3-pass path only)
  const float* bias;   // [C]
  void* mid;           // conv 1's output, float32
  void* h_out;         // mode 0
  float* acc;          // modes 1-3
  void* y;             // modes 3-4
  int C, T, k, d, conv, mode;
  float inv_n;
};

template <int NPASS, int BN>
struct Ring {
  static constexpr int kSplit = NPASS == 3 ? 2 : 1;
  static constexpr int kBBytes = BN * kBK * 4;  // one of hi / lo: BN rows of 32 floats
  static constexpr int kTx = kSplit * kBBytes;
  static constexpr int kStageBytes = (kTx + 1023) / 1024 * 1024;
  static constexpr size_t kBytes = 1024 + (size_t)kStages * kStageBytes + 2 * 8 * kStages;
};

template <typename T, int NPASS, int BN>
__global__ void __launch_bounds__(kThreads, 1)
    mrf_conv_kernel(const __grid_constant__ CUtensorMap w_hi, const __grid_constant__ CUtensorMap w_lo,
                    const Args a) {
  using R = Ring<NPASS, BN>;
  extern __shared__ __align__(1024) uint8_t smem_raw[];
  uint8_t* smem = smem_raw + ((1024 - (smem_u32(smem_raw) & 1023)) & 1023);
  uint64_t* full = reinterpret_cast<uint64_t*>(smem + kStages * R::kStageBytes);
  uint64_t* empty = full + kStages;
  const int C = a.C, T_len = a.T, pad = (a.k - 1) / 2;
  const int t0 = blockIdx.x * kBM, n0 = blockIdx.y * BN;
  const size_t base = (size_t)blockIdx.z * C * T_len;
  const int n_chunks = C / kBK, steps = a.k * n_chunks;
  const int wg = __shfl_sync(0xffffffff, (int)threadIdx.x / 128, 0);  // warp-uniform role
  if (threadIdx.x == 0) {
    for (int i = 0; i < kStages; ++i) {
      mbar_init(&full[i], 1);
      mbar_init(&empty[i], 256);
    }
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();

  if (wg == 2) {
    // producer: one thread keeps the weight tiles of the next K steps in flight
    if (threadIdx.x == 256) {
      for (int s = 0; s < steps; ++s) {
        const int st = s % kStages;
        if (s >= kStages) mbar_wait(&empty[st], ((s / kStages) - 1) & 1);
        uint8_t* stage = smem + st * R::kStageBytes;
        const int j = s / n_chunks, ci0 = (s - j * n_chunks) * kBK;
        mbar_expect_tx(&full[st], R::kTx);
        tma_load_2d(stage, &w_hi, &full[st], ci0, j * C + n0);
        if (NPASS == 3) tma_load_2d(stage + R::kBBytes, &w_lo, &full[st], ci0, j * C + n0);
      }
    }
  } else {
    // consumers: warpgroup wg owns time rows wg·64 .. wg·64 + 63 of the tile
    const int warp = (threadIdx.x >> 5) & 3, lane = threadIdx.x & 31, g = lane >> 2, tig = lane & 3;
    const int m0 = wg * 64 + warp * 16 + g;  // this thread's fragment rows: m0 and m0 + 8
    const bool first = a.conv == 1;
    // the activation fragments of K step s, from global memory: lrelu (conv 1), zero outside [0, T)
    auto load = [&](int s, float (&v)[kBK / 8][4]) {
      const int j = s / n_chunks, ci0 = (s - j * n_chunks) * kBK;
      const int t = t0 + m0 + (j - pad) * a.d;
#pragma unroll
      for (int kk = 0; kk < kBK / 8; ++kk)
#pragma unroll
        for (int i = 0; i < 4; ++i) {
          const int tt = t + (i & 1) * 8;  // a0..a3: (row, col) = (g, tig), (g+8, tig), (g, tig+4), (g+8, tig+4)
          const int ci = ci0 + kk * 8 + tig + (i >> 1) * 4;
          const bool ok = tt >= 0 && tt < T_len;
          const size_t off = base + (size_t)ci * T_len + (ok ? tt : 0);
          const float x = first ? lrelu(to_f(static_cast<const T*>(a.src)[off])) : static_cast<const float*>(a.src)[off];
          v[kk][i] = ok ? x : 0.f;
        }
    };
    float acc[BN / 2];
#pragma unroll
    for (int i = 0; i < BN / 2; ++i) acc[i] = 0.f;
    // K step s: split v into TF32 hi/lo fragments, refill v with step s + 2,
    // then this step's products against the weight tile of ring stage s % 4
    auto step = [&](int s, float (&v)[kBK / 8][4]) {
      uint32_t ah[kBK / 8][4], al[kBK / 8][4];
#pragma unroll
      for (int kk = 0; kk < kBK / 8; ++kk)
#pragma unroll
        for (int i = 0; i < 4; ++i) {
          const float hi = tf32(v[kk][i]);
          ah[kk][i] = __float_as_uint(hi);
          al[kk][i] = NPASS == 3 ? __float_as_uint(tf32(v[kk][i] - hi)) : 0u;
        }
      if (s + 2 < steps) load(s + 2, v);
      const int st = s % kStages;
      mbar_wait(&full[st], (s / kStages) & 1);
      const uint8_t* stage = smem + st * R::kStageBytes;
      const uint64_t dh = desc_sw128(stage), dl = desc_sw128(stage + R::kBBytes);
      float part[BN / 2];  // this K step's sum, from zero, added to acc on the CUDA cores
#pragma unroll
      for (int i = 0; i < BN / 2; ++i) reg_fence(part[i]);
      wgmma_fence();
#pragma unroll
      for (int kk = 0; kk < kBK / 8; ++kk) {
        if (NPASS == 3) {  // the small terms first
          wgmma_tile<BN>(part, al[kk], dh + 2 * kk, kk > 0);
          wgmma_tile<BN>(part, ah[kk], dl + 2 * kk, 1);
        }
        wgmma_tile<BN>(part, ah[kk], dh + 2 * kk, NPASS == 3 || kk > 0);
      }
      wgmma_commit();
      wgmma_wait0();
#pragma unroll
      for (int i = 0; i < BN / 2; ++i) {
        reg_fence(part[i]);
        acc[i] += part[i];
      }
      mbar_arrive(&empty[st]);
    };
    float va[kBK / 8][4], vb[kBK / 8][4];  // the fragments of two K steps in flight
    load(0, va);
    if (steps > 1) load(1, vb);
    for (int s = 0; s < steps; s += 2) {
      step(s, va);
      if (s + 1 < steps) step(s + 1, vb);
    }

#pragma unroll
    for (int i = 0; i < BN / 2; ++i) {
      const int t = t0 + m0 + ((i >> 1) & 1) * 8;
      const int co = n0 + (i >> 2) * 8 + 2 * tig + (i & 1);
      if (t >= T_len) continue;
      const size_t off = base + (size_t)co * T_len + t;
      const float r = acc[i] + a.bias[co];
      if (first) {
        static_cast<float*>(a.mid)[off] = lrelu(r);
        continue;
      }
      const float h = to_f(static_cast<const T*>(a.x)[off]) + r;
      switch (a.mode) {
        case 0: static_cast<T*>(a.h_out)[off] = from_f<T>(h); break;
        case 1: a.acc[off] = h; break;
        case 2: a.acc[off] += h; break;
        case 3: static_cast<T*>(a.y)[off] = from_f<T>((a.acc[off] + h) * a.inv_n); break;
        default: static_cast<T*>(a.y)[off] = from_f<T>(h * a.inv_n); break;
      }
    }
  }
}

typedef CUresult (*EncodeTiled)(CUtensorMap*, CUtensorMapDataType, cuuint32_t, void*, const cuuint64_t*,
                                const cuuint64_t*, const cuuint32_t*, const cuuint32_t*, CUtensorMapInterleave,
                                CUtensorMapSwizzle, CUtensorMapL2promotion, CUtensorMapFloatOOBfill);

EncodeTiled encoder() {
  static EncodeTiled fn = nullptr;
  if (fn == nullptr) {
    void* h = dlopen("libcuda.so.1", RTLD_NOW | RTLD_NOLOAD);
    if (h == nullptr) h = dlopen("libcuda.so.1", RTLD_NOW);
    if (h != nullptr) fn = reinterpret_cast<EncodeTiled>(dlsym(h, "cuTensorMapEncodeTiled"));
  }
  return fn;
}

// A 2-D tensor map; out-of-range elements (past `inner`, or below 0) read as zero.
int encode_2d(CUtensorMap* map, CUtensorMapDataType type, const void* p, uint64_t inner, uint64_t outer,
              uint64_t row_bytes, uint32_t box_inner, uint32_t box_outer, CUtensorMapSwizzle swizzle) {
  EncodeTiled fn = encoder();
  if (fn == nullptr) return (int)cudaErrorSharedObjectInitFailed;
  const cuuint64_t dims[2] = {inner, outer};
  const cuuint64_t strides[1] = {row_bytes};
  const cuuint32_t box[2] = {box_inner, box_outer};
  const cuuint32_t elem[2] = {1, 1};
  const CUresult r = fn(map, type, 2, const_cast<void*>(p), dims, strides, box, elem, CU_TENSOR_MAP_INTERLEAVE_NONE,
                        swizzle, CU_TENSOR_MAP_L2_PROMOTION_L2_128B, CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE);
  return r == CUDA_SUCCESS ? 0 : 1000 + (int)r;
}

template <typename T, int NPASS, int BN>
int launch(const Args& a, int B, cudaStream_t stream) {
  if (a.C % BN || a.C % kBK) return (int)cudaErrorInvalidValue;
  CUtensorMap whi, wlo;  // [k·C_out rows][C_in], boxes of BN rows × 32 floats
  int err = encode_2d(&whi, CU_TENSOR_MAP_DATA_TYPE_FLOAT32, a.w_hi, a.C, (uint64_t)a.k * a.C, (uint64_t)a.C * 4,
                      kBK, BN, CU_TENSOR_MAP_SWIZZLE_128B);
  if (!err)
    err = encode_2d(&wlo, CU_TENSOR_MAP_DATA_TYPE_FLOAT32, a.w_lo, a.C, (uint64_t)a.k * a.C, (uint64_t)a.C * 4,
                    kBK, BN, CU_TENSOR_MAP_SWIZZLE_128B);
  if (err) return err;
  auto kernel = mrf_conv_kernel<T, NPASS, BN>;
  const size_t smem = Ring<NPASS, BN>::kBytes;
  cudaError_t e = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (e != cudaSuccess) return (int)e;
  kernel<<<dim3((a.T + kBM - 1) / kBM, a.C / BN, B), kThreads, smem, stream>>>(whi, wlo, a);
  return (int)cudaGetLastError();
}

template <typename T, int NPASS>
int launch_bn(int bn, const Args& a, int B, cudaStream_t stream) {
  switch (bn) {
    case 32: return launch<T, NPASS, 32>(a, B, stream);
    case 64: return launch<T, NPASS, 64>(a, B, stream);
    default: return (int)cudaErrorInvalidValue;
  }
}

}  // namespace

// Shared memory of one launch with output tiles 128 × bn (0 if bn is not 32 or 64).
extern "C" size_t hifigan_mrf_smem_bytes(int bn, int is_bf16) {
  switch (bn) {
    case 32: return is_bf16 ? Ring<1, 32>::kBytes : Ring<3, 32>::kBytes;
    case 64: return is_bf16 ? Ring<1, 64>::kBytes : Ring<3, 64>::kBytes;
    default: return 0;
  }
}

// One conv of a dilation unit (conv = 1 or 2, see the top of this file) on
// output tiles of 128 time steps × bn channels (bn 32 or 64, C % bn == 0).
// src: conv 1 the unit input x, conv 2 `mid`; x, h_out, y: [B, C, T] in the
// working type (float32, or bfloat16 if is_bf16); mid, acc: [B, C, T]
// float32; w_hi, w_lo: [k][C_out][C_in] float32 rounded to TF32 (w_lo unread
// for bfloat16); bias: [C] float32. C % 32 == 0, k odd. Returns the CUDA
// error code of the launch, or 1000 + the CUresult if a tensor map
// cannot be made.
extern "C" int hifigan_mrf_conv(const void* src, const void* x, const void* w_hi, const void* w_lo,
                                const void* bias, void* mid, void* h_out, void* acc, void* y, int B, int C,
                                int T_len, int k, int d, int conv, int mode, float inv_n, int bn, int is_bf16,
                                void* stream) {
  Args a;
  a.src = src;
  a.x = x;
  a.w_hi = static_cast<const float*>(w_hi);
  a.w_lo = static_cast<const float*>(w_lo);
  a.bias = static_cast<const float*>(bias);
  a.mid = mid;
  a.h_out = h_out;
  a.acc = static_cast<float*>(acc);
  a.y = y;
  a.C = C;
  a.T = T_len;
  a.k = k;
  a.d = d;
  a.conv = conv;
  a.mode = mode;
  a.inv_n = inv_n;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  return is_bf16 ? launch_bn<__nv_bfloat16, 1>(bn, a, B, s) : launch_bn<float, 3>(bn, a, B, s);
}
