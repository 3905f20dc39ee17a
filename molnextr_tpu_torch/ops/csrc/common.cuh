// Shared device helpers for the port's hand-written kernels: dtype
// conversion, warp reductions, the pieces of the decode-attention kernels,
// and the encoder's GEMM (LayerNorm prologue, bias / exact-GELU epilogue):
// on the CUDA cores in float32, and with TMA and wgmma in bf16.
//
// Every kernel here is built for sm_90a by ops/_build.py (nvcc, plain C
// interface, loaded with ctypes).  The model's working dtype T is float or
// __nv_bfloat16; every product accumulates in float32.
#pragma once

#include <cuda.h>  // CUtensorMap and its enums; the encoder is reached through the runtime
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

#include <type_traits>

namespace mnx {

// dtype codes shared with the Python wrappers
enum DType : int { kF32 = 0, kBF16 = 1 };

template <typename T> __device__ __forceinline__ float to_f32(T v);
template <> __device__ __forceinline__ float to_f32<float>(float v) { return v; }
template <> __device__ __forceinline__ float to_f32<__nv_bfloat16>(__nv_bfloat16 v) {
  return __bfloat162float(v);
}

template <typename T> __device__ __forceinline__ T from_f32(float v);
template <> __device__ __forceinline__ float from_f32<float>(float v) { return v; }
template <> __device__ __forceinline__ __nv_bfloat16 from_f32<__nv_bfloat16>(float v) {
  return __float2bfloat16(v);  // round to nearest even, as XLA's convert
}

// value rounded through T and back: the JAX kernels' `.astype(T)` points
template <typename T> __device__ __forceinline__ float round_to(float v) {
  return to_f32<T>(from_f32<T>(v));
}

__device__ __forceinline__ float warp_sum(float v) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) v += __shfl_xor_sync(0xffffffffu, v, o);
  return v;
}

__device__ __forceinline__ float warp_max(float v) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) v = fmaxf(v, __shfl_xor_sync(0xffffffffu, v, o));
  return v;
}

__device__ __forceinline__ float gelu_exact(float x) {
  return 0.5f * x * (1.0f + erff(x * 0.70710678118654752f));
}

// Exact GELU with the Pallas kernels' own erf (Abramowitz & Stegun 7.1.26,
// |error| <= 1.5e-7; molnextr_tpu/ops/swin_fused.py::_erf), for the bf16
// kernels, whose GELU output is rounded to bf16 at once: a fraction of
// erff's instructions, whose cost on the CUDA cores holds up the fused
// MLP's GELU step.
__device__ __forceinline__ float gelu_poly(float x) {
  const float z = x * 0.70710678118654752f, az = fabsf(z);
  float t;
  asm("rcp.approx.ftz.f32 %0, %1;" : "=f"(t) : "f"(1.0f + 0.3275911f * az));
  const float poly =
      ((((1.061405429f * t - 1.453152027f) * t + 1.421413741f) * t - 0.284496736f) * t +
       0.254829592f) * t;
  const float e = 1.0f - poly * __expf(-az * az);
  return 0.5f * x * (1.0f + copysignf(e, z));
}

// ---------------------------------------------------------------------------
// Pieces of the decode-attention kernels (decode_attention.cu,
// folded_attention.cu): a cache row read 16 bytes a lane, asynchronous
// staging of a run of cache rows into shared memory, and the (max, sum)
// pair of a softmax split over slices of positions.
// ---------------------------------------------------------------------------

// elements of a cache row in 16 bytes: 4 float, 8 bf16, 16 int8
template <typename KT> struct Vec16 { static constexpr int n = 16 / (int)sizeof(KT); };

__device__ __forceinline__ float elem_f32(float v) { return v; }
__device__ __forceinline__ float elem_f32(__nv_bfloat16 v) { return __bfloat162float(v); }
__device__ __forceinline__ float elem_f32(int8_t v) { return (float)v; }

// 16 bytes of a row as floats
template <typename KT>
__device__ __forceinline__ void unpack16(const uint4& raw, float* f) {
  if constexpr (std::is_same<KT, float>::value) {
    f[0] = __uint_as_float(raw.x);
    f[1] = __uint_as_float(raw.y);
    f[2] = __uint_as_float(raw.z);
    f[3] = __uint_as_float(raw.w);
  } else if constexpr (std::is_same<KT, int8_t>::value) {
    const char4* c = reinterpret_cast<const char4*>(&raw);
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      f[4 * i] = (float)c[i].x;
      f[4 * i + 1] = (float)c[i].y;
      f[4 * i + 2] = (float)c[i].z;
      f[4 * i + 3] = (float)c[i].w;
    }
  } else {
    const __nv_bfloat162* h = reinterpret_cast<const __nv_bfloat162*>(&raw);
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const float2 v = __bfloat1622float2(h[i]);
      f[2 * i] = v.x;
      f[2 * i + 1] = v.y;
    }
  }
}

// The largest of 16, 8, 4, 2, 1 bytes that divides the row width and the
// addresses of both cache arrays: every row of the arrays then starts on
// that boundary, and so does every run of rows.
__device__ __forceinline__ int copy_unit(int row_bytes, const void* a, const void* b) {
  const unsigned long long addr = (unsigned long long)a | (unsigned long long)b;
  int u = 16;
  while (u > 1 && ((row_bytes % u) || (addr % u))) u >>= 1;
  return u;
}

// The block copies `nbytes` (a multiple of `unit`) from device memory to
// shared memory: cp.async of `unit` bytes a thread-step for a unit of 16
// (bypassing L1), 8 or 4; plain loads and stores for the rare 2- or 1-byte
// unit, whose data is in place once the block passes its next barrier.
// cp_async_commit() closes the group; cp_async_wait<N>() waits until at
// most N of this thread's groups are in flight, and a block barrier after it
// makes every thread's copies visible.
__device__ __forceinline__ void stage_rows(void* dst, const void* src, int nbytes, int unit) {
  const uint32_t s = (uint32_t)__cvta_generic_to_shared(dst);
  const char* g = static_cast<const char*>(src);
  const int step = (int)blockDim.x * unit;
  if (unit == 16) {
    for (int i = threadIdx.x * 16; i < nbytes; i += step)
      asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(s + i), "l"(g + i)
                   : "memory");
  } else if (unit == 8) {
    for (int i = threadIdx.x * 8; i < nbytes; i += step)
      asm volatile("cp.async.ca.shared.global [%0], [%1], 8;\n" ::"r"(s + i), "l"(g + i)
                   : "memory");
  } else if (unit == 4) {
    for (int i = threadIdx.x * 4; i < nbytes; i += step)
      asm volatile("cp.async.ca.shared.global [%0], [%1], 4;\n" ::"r"(s + i), "l"(g + i)
                   : "memory");
  } else {
    char* d = static_cast<char*>(dst);
    for (int i = threadIdx.x; i < nbytes; i += blockDim.x) d[i] = g[i];
  }
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}

template <int N> __device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N) : "memory");
}

// cp.async.wait_group with a count known only at run time (0 to 4)
__device__ __forceinline__ void cp_async_wait_upto(int n) {
  switch (n) {
    case 0: cp_async_wait<0>(); break;
    case 1: cp_async_wait<1>(); break;
    case 2: cp_async_wait<2>(); break;
    case 3: cp_async_wait<3>(); break;
    default: cp_async_wait<4>(); break;
  }
}

// The first and one-past-last position of slice `rank` of positions
// 0..pos, `slice_rows` positions a slice (ops/_launch.py::slices computes
// the same).  A slice that would start past pos is empty and starts at pos:
// no slice starts past pos, and an empty one reads nothing.
__device__ __forceinline__ void slice_bounds(int rank, int slice_rows, int pos, int* t0,
                                             int* t1) {
  const int raw = rank * slice_rows;
  *t0 = raw <= pos ? raw : pos;
  *t1 = raw <= pos ? min(raw + slice_rows, pos + 1) : *t0;
}

// (m, l) of a softmax over a set of scores: the max m and the sum of
// exp(s - m).  An empty set is (-inf, 0); merging never forms inf - inf.
__device__ __forceinline__ void ml_push(float& m, float& l, float s) {
  if (s > m) {
    l = l * expf(m - s) + 1.f;  // m = -inf: l is 0 and expf(-inf) is 0
    m = s;
  } else {
    l += expf(s - m);
  }
}

__device__ __forceinline__ void ml_merge(float& m, float& l, float m2, float l2) {
  if (m2 == -INFINITY) return;
  if (m == -INFINITY) {
    m = m2;
    l = l2;
    return;
  }
  const float mx = fmaxf(m, m2);
  l = l * expf(m - mx) + l2 * expf(m2 - mx);
  m = mx;
}

// Signalling inside a thread-block cluster without cluster-wide barriers
// (a cluster.sync() costs about 1.6 us at 8 CTAs a cluster, 2048 CTAs,
// on an H100; chip_probe.py): a CTA stores into a peer's shared memory
// (cluster.map_shared_rank) and then arrives on an mbarrier in the peer's
// shared memory with release semantics at cluster scope; the peer waits on
// its own mbarrier with acquire semantics.  The one cluster barrier left
// orders each CTA's mbarrier initialisation before any peer's arrival; it
// is split (arrive at the start, wait just before the first remote store)
// so that it overlaps the loads.
__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return (uint32_t)__cvta_generic_to_shared(p);
}

__device__ __forceinline__ void mbar_init(uint64_t* bar, int count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;\n" ::"r"(smem_u32(bar)), "r"(count)
               : "memory");
}

// every thread of the CTA, after one thread initialised its mbarriers
__device__ __forceinline__ void cluster_arrive_after_init() {
  asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  asm volatile("barrier.cluster.arrive.relaxed.aligned;\n" ::: "memory");
}

__device__ __forceinline__ void cluster_wait() {
  asm volatile("barrier.cluster.wait.aligned;\n" ::: "memory");
}

// arrive on the mbarrier at `bar`'s offset in the shared memory of the
// cluster's CTA `rank`, releasing this thread's earlier stores
__device__ __forceinline__ void mbar_arrive_remote(uint64_t* bar, int rank) {
  uint32_t remote;
  asm volatile("mapa.shared::cluster.u32 %0, %1, %2;\n"
               : "=r"(remote)
               : "r"(smem_u32(bar)), "r"(rank));
  asm volatile("mbarrier.arrive.release.cluster.shared::cluster.b64 _, [%0];\n" ::"r"(remote)
               : "memory");
}

// wait for phase `parity` of a local mbarrier to complete; a wait of more
// than about a second traps, so that a lost arrival fails the launch
// instead of hanging the card
__device__ __forceinline__ void mbar_wait(uint64_t* bar, int parity) {
  const uint32_t a = smem_u32(bar);
  const long long start = clock64();
  while (true) {
    uint32_t done;
    asm volatile(
        "{\n .reg .pred p;\n"
        " mbarrier.try_wait.parity.acquire.cluster.shared::cta.b64 p, [%1], %2;\n"
        " selp.u32 %0, 1, 0, p;\n}\n"
        : "=r"(done)
        : "r"(a), "r"(parity)
        : "memory");
    if (done) return;
    if (clock64() - start > 2000000000ll) __trap();
  }
}

__device__ __forceinline__ void warp_ml(float& m, float& l) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) {
    const float m2 = __shfl_xor_sync(0xffffffffu, m, o);
    const float l2 = __shfl_xor_sync(0xffffffffu, l, o);
    ml_merge(m, l, m2, l2);
  }
}

// ---------------------------------------------------------------------------
// out[m, n] = epi(sum_k a(m, k) * W[k, n] + bias[n])
//
//   A (M, K) row-major in T; W (K, N) row-major in T (the flax Dense layout);
//   bias (N,) float32; out (M, N).
//   LN:   a(m, k) = T((A[m,k] - mu_m) * rstd_m * ln_s[k] + ln_b[k]), with
//         mu/rstd from a two-pass f32 reduction over the row (eps given);
//         otherwise a(m, k) = A[m, k].
//   GELU: epi(v) = exact GELU (gelu_exact in float32, gelu_poly in bf16);
//         otherwise identity.
//
// Two implementations of that one function, one per input type:
//   float:  a 64x64 output tile per 256-thread block, 16-deep K slices in
//           shared memory, a 4x4 register tile per thread, FMA on the CUDA
//           cores (exact float32, as the float32 model needs);
//   bf16:   gemm_tma_kernel below: TMA tile loads into a 128-byte-swizzled
//           ring in shared memory, wgmma.mma_async on the tensor cores.
// ---------------------------------------------------------------------------

constexpr int kBM = 64, kBN = 64, kBK = 16, kGemmThreads = 256;

template <typename TO, bool LN, bool GELU>
__global__ void __launch_bounds__(kGemmThreads)
gemm_f32_kernel(const float* __restrict__ A, const float* __restrict__ W,
                const float* __restrict__ bias, const float* __restrict__ ln_s,
                const float* __restrict__ ln_b, TO* __restrict__ out,
                int M, int N, int K, float eps) {
  __shared__ __align__(16) float As[kBK][kBM + 4];
  __shared__ __align__(16) float Ws[kBK][kBN + 4];
  __shared__ float mu_s[kBM], rstd_s[kBM];

  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const int m0 = blockIdx.y * kBM, n0 = blockIdx.x * kBN;
  if (LN) {  // mean and 1/std of the block's rows, one warp a row
    for (int r = warp; r < kBM; r += kGemmThreads / 32) {
      const int m = m0 + r;
      float mu = 0.f, rstd = 0.f;
      if (m < M) {
        const float* row = A + (size_t)m * K;
        float s = 0.f;
        for (int k = lane; k < K; k += 32) s += row[k];
        mu = warp_sum(s) / K;
        float v = 0.f;
        for (int k = lane; k < K; k += 32) v += (row[k] - mu) * (row[k] - mu);
        rstd = rsqrtf(warp_sum(v) / K + eps);
      }
      if (lane == 0) {
        mu_s[r] = mu;
        rstd_s[r] = rstd;
      }
    }
    __syncthreads();
  }

  const int tx = tid % 16, ty = tid / 16;
  float acc[4][4];
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int j = 0; j < 4; ++j) acc[i][j] = 0.f;

  for (int k0 = 0; k0 < K; k0 += kBK) {
    for (int i = tid; i < kBM * kBK; i += kGemmThreads) {
      const int r = i / kBK, kk = i % kBK;
      const int m = m0 + r, k = k0 + kk;
      float v = 0.f;
      if (m < M && k < K) {
        v = A[(size_t)m * K + k];
        if (LN) v = (v - mu_s[r]) * rstd_s[r] * ln_s[k] + ln_b[k];
      }
      As[kk][r] = v;
    }
    for (int i = tid; i < kBK * kBN; i += kGemmThreads) {
      const int kk = i / kBN, c = i % kBN;
      const int k = k0 + kk, n = n0 + c;
      Ws[kk][c] = (k < K && n < N) ? W[(size_t)k * N + n] : 0.f;
    }
    __syncthreads();
#pragma unroll
    for (int kk = 0; kk < kBK; ++kk) {
      const float4 a = *reinterpret_cast<const float4*>(&As[kk][ty * 4]);
      const float4 w = *reinterpret_cast<const float4*>(&Ws[kk][tx * 4]);
      const float av[4] = {a.x, a.y, a.z, a.w};
      const float wv[4] = {w.x, w.y, w.z, w.w};
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int j = 0; j < 4; ++j) acc[i][j] += av[i] * wv[j];
    }
    __syncthreads();
  }

#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int m = m0 + ty * 4 + i;
    if (m >= M) continue;
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      const int n = n0 + tx * 4 + j;
      if (n >= N) continue;
      float v = acc[i][j] + bias[n];
      if (GELU) v = gelu_exact(v);
      out[(size_t)m * N + n] = from_f32<TO>(v);
    }
  }
}

template <typename TO, bool LN, bool GELU>
inline cudaError_t launch_gemm_f32(const void* A, const void* W, const float* bias,
                                   const float* ln_s, const float* ln_b, void* out, int M,
                                   int N, int K, cudaStream_t stream) {
  const dim3 grid((N + kBN - 1) / kBN, (M + kBM - 1) / kBM);
  gemm_f32_kernel<TO, LN, GELU><<<grid, kGemmThreads, 0, stream>>>(
      static_cast<const float*>(A), static_cast<const float*>(W), bias, ln_s, ln_b,
      static_cast<TO*>(out), M, N, K, 1e-5f);
  return cudaGetLastError();
}

// ---------------------------------------------------------------------------
// Hopper pieces of the bf16 kernels: TMA loads of 64-element-wide tiles into
// 128-byte-swizzled shared memory, completed on mbarriers; wgmma on them.
//
// A tile ("box") is 64 bf16 columns (128 bytes) by R rows, row r at byte
// r * 128 with its 16-byte chunks XOR-ed by r % 8 (CU_TENSOR_MAP_SWIZZLE_128B),
// boxes 1024-byte aligned.  wgmma reads such boxes through descriptors:
//   K-major A (rows = M, the 128 bytes = 64 K values): a k16 step is the
//     box's address + 32 bytes; 8-row groups 1024 bytes apart (SBO);
//   MN-major B (rows = K, the 128 bytes = 64 N values, which is W's own
//     row-major layout): a k16 step is the next 16 rows, + 2048 bytes; the
//     two 8-row groups of a step 1024 bytes apart.  One instruction covers
//     one box's 64 columns (m64n64k16), so the stride between boxes along N
//     never enters; both offset fields carry the 1024.
// ---------------------------------------------------------------------------

constexpr int kBox = 64 * 128;      // bytes of a 64 x 64 bf16 box
constexpr int kMaxStages = 8;
constexpr int kTmaThreads = 288;    // two consumer warpgroups and one producer warp
constexpr int kProducerWarp = 8;
constexpr int kEmptyArrivals = 8;   // lane 0 of each consumer warp releases a stage

__device__ __forceinline__ uint8_t* align1024(uint8_t* p) {
  return p + ((1024 - (smem_u32(p) & 1023)) & 1023);
}

__device__ __forceinline__ void mbar_arrive(uint64_t* bar) {
  asm volatile("mbarrier.arrive.shared::cta.b64 _, [%0];\n" ::"r"(smem_u32(bar)) : "memory");
}

__device__ __forceinline__ void mbar_expect_tx(uint64_t* bar, uint32_t bytes) {
  asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n" ::"r"(smem_u32(bar)),
               "r"(bytes)
               : "memory");
}

// box at inner coordinate x (column), outer y (row) of `map` into `dst`
__device__ __forceinline__ void tma_load(void* dst, const CUtensorMap* map, uint64_t* bar, int x,
                                         int y) {
  asm volatile(
      "cp.async.bulk.tensor.2d.shared::cluster.global.mbarrier::complete_tx::bytes "
      "[%0], [%1, {%3, %4}], [%2];\n" ::"r"(smem_u32(dst)),
      "l"(reinterpret_cast<uint64_t>(map)), "r"(smem_u32(bar)), "r"(x), "r"(y)
      : "memory");
}

// generic-proxy stores to shared memory made visible to wgmma and TMA
__device__ __forceinline__ void fence_proxy_async() {
  asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
}

// barrier `id` of `threads` threads (a multiple of 32); the non-.aligned
// form, which a warp may reach with its lanes apart
__device__ __forceinline__ void named_bar_sync(int id, int threads) {
  asm volatile("barrier.sync %0, %1;\n" ::"r"(id), "r"(threads) : "memory");
}

// arrival on barrier `id` of `threads` threads without waiting for it
__device__ __forceinline__ void named_bar_arrive(int id, int threads) {
  asm volatile("bar.arrive %0, %1;\n" ::"r"(id), "r"(threads) : "memory");
}

// mbar_wait by every lane of a warp.  The lanes leave the wait's loop one
// by one; __syncwarp joins them again before the .aligned instructions
// that follow (wgmma, warp shuffles), which a split warp must not reach.
__device__ __forceinline__ void mbar_wait_warp(uint64_t* bar, int parity) {
  mbar_wait(bar, parity);
  __syncwarp();
}

__device__ __forceinline__ uint64_t sw128_desc(const void* p, uint32_t lbo, uint32_t sbo) {
  return (uint64_t)((smem_u32(p) & 0x3FFFF) >> 4) | ((uint64_t)(lbo >> 4) << 16) |
         ((uint64_t)(sbo >> 4) << 32) | (1ull << 62);
}
__device__ __forceinline__ uint64_t desc_a(const void* p) { return sw128_desc(p, 16, 1024); }
__device__ __forceinline__ uint64_t desc_b(const void* p) { return sw128_desc(p, 1024, 1024); }

__device__ __forceinline__ void wgmma_fence() {
  asm volatile("wgmma.fence.sync.aligned;\n" ::: "memory");
}
__device__ __forceinline__ void wgmma_commit() {
  asm volatile("wgmma.commit_group.sync.aligned;\n" ::: "memory");
}
__device__ __forceinline__ void wgmma_wait_all(float (&d)[32]) {
  asm volatile("wgmma.wait_group.sync.aligned 0;\n" ::: "memory");
#pragma unroll
  for (int i = 0; i < 32; ++i) asm volatile("" : "+f"(d[i])::"memory");
}

// d(64x64, f32) = A(64x16, K-major in shared memory) * B(16x64, MN-major)
// + (accumulate ? d : 0): the first product of a sum passes 0, so no
// instruction other than wgmma writes d while products are in flight
__device__ __forceinline__ void wgmma_64x64(float (&d)[32], uint64_t a, uint64_t b,
                                            int accumulate) {
  asm volatile(
      "{\n"
      ".reg .pred p;\n"
      "setp.ne.b32 p, %34, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31}, "
      "%32, %33, p, 1, 1, 0, 1;\n"
      "}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]),
        "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]),
        "+f"(d[13]), "+f"(d[14]), "+f"(d[15]), "+f"(d[16]), "+f"(d[17]), "+f"(d[18]),
        "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]), "+f"(d[24]),
        "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]),
        "+f"(d[31])
      : "l"(a), "l"(b), "r"(accumulate));
}

// byte offset of element (r, c) (c < 64) in a 128-byte-swizzled box
__device__ __forceinline__ int sw128(int r, int c) {
  return r * 128 + ((((c >> 3) ^ r) & 7) << 4) + (c & 7) * 2;
}

// The LN prologue shared by the bf16 GEMM and the fused MLP.  The 256
// consumer threads copy rows m0 .. m0 + 63 of A (M, K) into ceil(K / 64)
// K-major boxes at `xn` (cp.async, 16 bytes a thread, every copy in flight
// at once; rows past M and columns past K zero), take each row's mean and
// 1/std (two f32 passes over the row in shared memory, a warp a row) and
// normalise the rows in place, rounding to bf16 where the Pallas kernels
// round xn.  Ends with the consumers' barrier 1 and the fence that hands
// xn to wgmma.  K is a multiple of 8.
__device__ __forceinline__ void ln_rows(const __nv_bfloat16* __restrict__ A, int m0, int M, int K,
                                        const float* __restrict__ ln_s,
                                        const float* __restrict__ ln_b, float eps, uint8_t* xn,
                                        float2* stats, int tid) {
  const int nch = K / 8, wch = (K + 63) / 64 * 8, warp = tid >> 5, lane = tid & 31;
  auto chunk = [&](int r, int c) -> uint4* {
    return reinterpret_cast<uint4*>(xn + (c >> 3) * kBox + sw128(r, (c & 7) * 8));
  };
  for (int i = tid; i < 64 * wch; i += 256) {
    const int r = i / wch, c = i % wch;
    uint4* d = chunk(r, c);
    if (m0 + r < M && c < nch)
      asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(smem_u32(d)),
                   "l"(A + (size_t)(m0 + r) * K + 8 * c)
                   : "memory");
    else
      *d = make_uint4(0u, 0u, 0u, 0u);
  }
  cp_async_commit();
  cp_async_wait<0>();
  named_bar_sync(1, 256);
  for (int r = warp; r < 64; r += 8) {
    float f[8], s = 0.f;
    for (int c = lane; c < nch; c += 32) {
      unpack16<__nv_bfloat16>(*chunk(r, c), f);
#pragma unroll
      for (int i = 0; i < 8; ++i) s += f[i];
    }
    const float mu = warp_sum(s) / K;
    float v = 0.f;
    for (int c = lane; c < nch; c += 32) {
      unpack16<__nv_bfloat16>(*chunk(r, c), f);
#pragma unroll
      for (int i = 0; i < 8; ++i) v += (f[i] - mu) * (f[i] - mu);
    }
    v = warp_sum(v);
    if (lane == 0) stats[r] = make_float2(mu, rsqrtf(v / K + eps));
  }
  named_bar_sync(1, 256);
  for (int i = tid; i < 64 * nch; i += 256) {
    const int r = i / nch, c = i % nch;
    if (m0 + r >= M) continue;
    uint4* p = chunk(r, c);
    float f[8];
    unpack16<__nv_bfloat16>(*p, f);
    const float mu = stats[r].x, rstd = stats[r].y;
    const float4 s0 = __ldg(reinterpret_cast<const float4*>(ln_s + 8 * c));
    const float4 s1 = __ldg(reinterpret_cast<const float4*>(ln_s + 8 * c + 4));
    const float4 b0 = __ldg(reinterpret_cast<const float4*>(ln_b + 8 * c));
    const float4 b1 = __ldg(reinterpret_cast<const float4*>(ln_b + 8 * c + 4));
    const float sc[8] = {s0.x, s0.y, s0.z, s0.w, s1.x, s1.y, s1.z, s1.w};
    const float bi[8] = {b0.x, b0.y, b0.z, b0.w, b1.x, b1.y, b1.z, b1.w};
    uint4 o;
    __nv_bfloat162* h = reinterpret_cast<__nv_bfloat162*>(&o);
#pragma unroll
    for (int k = 0; k < 4; ++k)
      h[k] = __floats2bfloat162_rn((f[2 * k] - mu) * rstd * sc[2 * k] + bi[2 * k],
                                   (f[2 * k + 1] - mu) * rstd * sc[2 * k + 1] + bi[2 * k + 1]);
    *p = o;
  }
  fence_proxy_async();
  named_bar_sync(1, 256);
}

// LayerNorm of each row of A (M, K) into xn (M, K), a warp a row, with the
// same sums, statistics and bf16 rounding as ln_rows: for rows too wide to
// stay in a GEMM block's shared memory beside its ring.  K is a multiple
// of 8.
__global__ void __launch_bounds__(256)
ln_rows_kernel(const __nv_bfloat16* __restrict__ A, const float* __restrict__ ln_s,
               const float* __restrict__ ln_b, __nv_bfloat16* __restrict__ xn, int M, int K,
               float eps) {
  const int lane = threadIdx.x & 31, m = blockIdx.x * 8 + (threadIdx.x >> 5);
  if (m >= M) return;
  const uint4* row = reinterpret_cast<const uint4*>(A + (size_t)m * K);
  uint4* dst = reinterpret_cast<uint4*>(xn + (size_t)m * K);
  const int nch = K / 8;
  float f[8], s = 0.f;
  for (int c = lane; c < nch; c += 32) {
    unpack16<__nv_bfloat16>(row[c], f);
#pragma unroll
    for (int i = 0; i < 8; ++i) s += f[i];
  }
  const float mu = warp_sum(s) / K;
  float v = 0.f;
  for (int c = lane; c < nch; c += 32) {
    unpack16<__nv_bfloat16>(row[c], f);
#pragma unroll
    for (int i = 0; i < 8; ++i) v += (f[i] - mu) * (f[i] - mu);
  }
  const float rstd = rsqrtf(warp_sum(v) / K + eps);
  for (int c = lane; c < nch; c += 32) {
    unpack16<__nv_bfloat16>(row[c], f);
    const float4 s0 = __ldg(reinterpret_cast<const float4*>(ln_s + 8 * c));
    const float4 s1 = __ldg(reinterpret_cast<const float4*>(ln_s + 8 * c + 4));
    const float4 b0 = __ldg(reinterpret_cast<const float4*>(ln_b + 8 * c));
    const float4 b1 = __ldg(reinterpret_cast<const float4*>(ln_b + 8 * c + 4));
    const float sc[8] = {s0.x, s0.y, s0.z, s0.w, s1.x, s1.y, s1.z, s1.w};
    const float bi[8] = {b0.x, b0.y, b0.z, b0.w, b1.x, b1.y, b1.z, b1.w};
    uint4 o;
    __nv_bfloat162* h = reinterpret_cast<__nv_bfloat162*>(&o);
#pragma unroll
    for (int k = 0; k < 4; ++k)
      h[k] = __floats2bfloat162_rn((f[2 * k] - mu) * rstd * sc[2 * k] + bi[2 * k],
                                   (f[2 * k + 1] - mu) * rstd * sc[2 * k + 1] + bi[2 * k + 1]);
    dst[c] = o;
  }
}

// The epilogue of a consumer warpgroup's 64x64 accumulator: + bias (columns
// n0 .. n0 + 63, zero past N), exact GELU, rounding to bf16, staged in the
// 128-byte-swizzled box `st`, then stored 16 bytes a thread to out (M, N)
// at rows m0 .., masked to M and N (N is a multiple of 8).  `bar` is a
// named barrier of the warpgroup's 128 threads, passed before and after
// the stores.
template <bool GELU>
__device__ __forceinline__ void store_tile(const float (&acc)[32], const float* __restrict__ bias,
                                           uint8_t* st, __nv_bfloat16* __restrict__ out, int m0,
                                           int n0, int M, int N, int wg_tid, int bar) {
  const int wl = wg_tid >> 5, lane = wg_tid & 31;
#pragma unroll
  for (int j = 0; j < 8; ++j) {
    const int col = 8 * j + 2 * (lane & 3), n = n0 + col;
    const float c0 = n < N ? bias[n] : 0.f, c1 = n + 1 < N ? bias[n + 1] : 0.f;
#pragma unroll
    for (int half = 0; half < 2; ++half) {
      const int row = 16 * wl + (lane >> 2) + 8 * half;
      float v0 = acc[4 * j + 2 * half] + c0, v1 = acc[4 * j + 2 * half + 1] + c1;
      if (GELU) {
        v0 = gelu_poly(v0);
        v1 = gelu_poly(v1);
      }
      *reinterpret_cast<__nv_bfloat162*>(st + sw128(row, col)) = __floats2bfloat162_rn(v0, v1);
    }
  }
  named_bar_sync(bar, 128);
  for (int i = wg_tid; i < 64 * 8; i += 128) {
    const int row = i >> 3, ch = i & 7, m = m0 + row, n = n0 + 8 * ch;
    if (m < M && n < N)
      *reinterpret_cast<uint4*>(out + (size_t)m * N + n) =
          *reinterpret_cast<const uint4*>(st + sw128(row, 8 * ch));
  }
  named_bar_sync(bar, 128);  // the staging box may be refilled
}

// Consumer side of one ring slot: wait until the TMA data of slot `it` is
// in, and later release it for the producer (lane 0 of each consumer warp).
struct Ring {
  uint64_t* full;
  uint64_t* empty;
  int stages;
  __device__ __forceinline__ int wait(int it) const {
    const int s = it % stages;
    mbar_wait_warp(&full[s], (it / stages) & 1);
    return s;
  }
  __device__ __forceinline__ void release(int it, int lane) const {
    if (lane == 0) mbar_arrive(&empty[it % stages]);
  }
  // producer: the slot of load `it`, once its previous use is released,
  // armed for `bytes`
  __device__ __forceinline__ int acquire(int it, uint32_t bytes) const {
    const int s = it % stages, round = it / stages;
    if (round > 0) mbar_wait(&empty[s], (round - 1) & 1);
    mbar_expect_tx(&full[s], bytes);
    return s;
  }
};

__device__ __forceinline__ void ring_init(uint64_t* full, uint64_t* empty, int stages) {
  if (threadIdx.x == 0) {
    for (int s = 0; s < stages; ++s) {
      mbar_init(&full[s], 1);
      mbar_init(&empty[s], kEmptyArrivals);
    }
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();
}

template <int N>
__device__ __forceinline__ void wgmma_wait() {
  asm volatile("wgmma.wait_group.sync.aligned %0;\n" ::"n"(N) : "memory");
}

// The bf16 GEMM.  A block owns rows m0 .. m0 + 63 and walks `tiles` 128-wide
// column tiles of out from blockIdx.x * tiles.  With LN the consumers first
// normalise the block's rows (all of K) into shared memory, once for every
// tile, where they stay as the A operand.  Warp 8 issues the TMA loads of
// each tile's 64-deep K slices of W (two 64-column boxes) and, without LN,
// of A, into a ring of `stages` slots with full and empty mbarriers.
// Consumer warpgroup g (warps 4g .. 4g + 3) runs m64n64k16 on the tile's
// columns 64g .. 64g + 63, keeping one slice's wgmma in flight while it
// waits for the next slice.
template <bool LN, bool GELU>
__global__ void __launch_bounds__(kTmaThreads, 2)
gemm_tma_kernel(const __grid_constant__ CUtensorMap map_a, const __grid_constant__ CUtensorMap map_w,
                const __nv_bfloat16* __restrict__ A, const float* __restrict__ bias,
                const float* __restrict__ ln_s, const float* __restrict__ ln_b,
                __nv_bfloat16* __restrict__ out, int M, int N, int K, int stages, int tiles,
                float eps) {
  extern __shared__ uint8_t smem_raw[];
  __shared__ __align__(8) uint64_t full[kMaxStages], empty[kMaxStages];
  __shared__ float2 stats[64];
  const int kb = (K + 63) / 64;
  uint8_t* xn = align1024(smem_raw);                 // LN: kb boxes of the block's rows
  uint8_t* ring = xn + (LN ? kb * kBox : 0);
  const int stage_bytes = (LN ? 2 : 3) * kBox;       // W's two boxes, then A's
  uint8_t* staging = ring + stages * stage_bytes;    // one box per warpgroup
  const int m0 = blockIdx.y * 64;
  const int t0 = blockIdx.x * tiles, t1 = min((N + 127) / 128, t0 + tiles);
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const Ring ring_bars{full, empty, stages};
  ring_init(full, empty, stages);

  if (warp == kProducerWarp) {
    if (lane == 0) {
      int it = 0;
      for (int t = t0; t < t1; ++t)
        for (int ks = 0; ks < kb; ++ks, ++it) {
          const int s = ring_bars.acquire(it, stage_bytes);
          uint8_t* st = ring + s * stage_bytes;
          tma_load(st, &map_w, &full[s], t * 128, ks * 64);
          tma_load(st + kBox, &map_w, &full[s], t * 128 + 64, ks * 64);
          if (!LN) tma_load(st + 2 * kBox, &map_a, &full[s], ks * 64, m0);
        }
    }
    return;
  }

  // with LN, the consumers normalise the rows while the producer loads W
  if (LN) ln_rows(A, m0, M, K, ln_s, ln_b, eps, xn, stats, threadIdx.x);
  const int wg = warp >> 2;
  // zeroed once, before any product is in flight; each tile's sum then
  // starts with a product that does not accumulate
  float acc[32];
#pragma unroll
  for (int i = 0; i < 32; ++i) acc[i] = 0.f;
  int it = 0;
  for (int t = t0; t < t1; ++t) {
    for (int ks = 0; ks < kb; ++ks, ++it) {
      const int s = ring_bars.wait(it);
      const uint8_t* st = ring + s * stage_bytes;
      const uint8_t* a = LN ? xn + ks * kBox : st + 2 * kBox;
      const uint8_t* b = st + wg * kBox;
      wgmma_fence();
#pragma unroll
      for (int j = 0; j < 4; ++j)
        wgmma_64x64(acc, desc_a(a + 32 * j), desc_b(b + 2048 * j), ks > 0 || j > 0);
      wgmma_commit();
      if (ks > 0) {  // the previous slice's products are done: release its slot
        wgmma_wait<1>();
        ring_bars.release(it - 1, lane);
      }
    }
    wgmma_wait_all(acc);
    ring_bars.release(it - 1, lane);
    store_tile<GELU>(acc, bias, staging + wg * kBox, out, m0, t * 128 + 64 * wg, M, N,
                     threadIdx.x & 127, 2 + wg);
  }
}

// The LN GEMM where a block has the SM to itself (its normalised rows and
// a ring of 3 stages do not fit twice; the plan's LN_PINGPONG): ping-pong.
// Consumer warpgroup g takes the block's tiles t0 + g, t0 + g + 2, ...: a
// whole 64 x 128 tile each (two m64n64 accumulators), from its own ring
// fed by producer warp 8 + g.  The warpgroups take turns on the tensor
// cores: one starts a tile's products once the other has issued its
// previous tile's last ones (named barriers 4 and 5), so each tile's
// epilogue runs under the other warpgroup's products.  Both warpgroups
// normalise the rows once, as above.
constexpr int kPingThreads = 320;  // two consumer warpgroups, two producer warps

template <bool GELU>
__global__ void __launch_bounds__(kPingThreads, 1)
gemm_ln_pingpong_kernel(const __grid_constant__ CUtensorMap map_w,
                        const __nv_bfloat16* __restrict__ A, const float* __restrict__ bias,
                        const float* __restrict__ ln_s, const float* __restrict__ ln_b,
                        __nv_bfloat16* __restrict__ out, int M, int N, int K, int stages,
                        int tiles, float eps) {
  extern __shared__ uint8_t smem_raw[];
  __shared__ __align__(8) uint64_t full[2][kMaxStages], empty[2][kMaxStages];
  __shared__ float2 stats[64];
  const int kb = (K + 63) / 64;
  uint8_t* xn = align1024(smem_raw);    // kb boxes of the block's rows
  uint8_t* staging = xn + kb * kBox;    // two boxes per warpgroup
  uint8_t* rings = staging + 4 * kBox;  // [warpgroup][stage]: two boxes of W
  const int m0 = blockIdx.y * 64;
  const int t0 = blockIdx.x * tiles, nt = min((N + 127) / 128, t0 + tiles) - t0;
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  if (threadIdx.x == 0) {
    for (int g = 0; g < 2; ++g)
      for (int s = 0; s < stages; ++s) {
        mbar_init(&full[g][s], 1);
        mbar_init(&empty[g][s], 4);  // lane 0 of each of the warpgroup's warps
      }
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();

  if (warp >= 8) {
    const int g = warp - 8;
    if (lane == 0) {
      const Ring ring{full[g], empty[g], stages};
      uint8_t* base = rings + g * stages * 2 * kBox;
      int it = 0;
      for (int r = g; r < nt; r += 2)
        for (int ks = 0; ks < kb; ++ks, ++it) {
          const int s = ring.acquire(it, 2 * kBox);
          tma_load(base + s * 2 * kBox, &map_w, &full[g][s], (t0 + r) * 128, ks * 64);
          tma_load(base + s * 2 * kBox + kBox, &map_w, &full[g][s], (t0 + r) * 128 + 64, ks * 64);
        }
    }
    return;
  }

  ln_rows(A, m0, M, K, ln_s, ln_b, eps, xn, stats, threadIdx.x);
  const int g = warp >> 2, wg_tid = threadIdx.x & 127;
  const Ring ring{full[g], empty[g], stages};
  const uint8_t* base = rings + g * stages * 2 * kBox;
  // zeroed once, before any product is in flight; each tile's sums then
  // start with a product that does not accumulate
  float lo[32], hi[32];
#pragma unroll
  for (int i = 0; i < 32; ++i) lo[i] = hi[i] = 0.f;
  int it = 0;
  for (int r = g; r < nt; r += 2) {
    if (r > 0) named_bar_sync(4 + (g ^ 1), 256);  // the other issued tile r - 1
    for (int ks = 0; ks < kb; ++ks, ++it) {
      const uint8_t* st = base + ring.wait(it) * 2 * kBox;
      const uint8_t* a = xn + ks * kBox;
      wgmma_fence();
#pragma unroll
      for (int j = 0; j < 4; ++j)
        wgmma_64x64(lo, desc_a(a + 32 * j), desc_b(st + 2048 * j), ks > 0 || j > 0);
#pragma unroll
      for (int j = 0; j < 4; ++j)
        wgmma_64x64(hi, desc_a(a + 32 * j), desc_b(st + kBox + 2048 * j), ks > 0 || j > 0);
      wgmma_commit();
      if (ks > 0) {  // the previous slice's products are done: release its slot
        wgmma_wait<1>();
        ring.release(it - 1, lane);
      }
    }
    if (r + 1 < nt) named_bar_arrive(4 + g, 256);  // the other may start tile r + 1
    wgmma_wait_all(lo);
    wgmma_wait_all(hi);
    ring.release(it - 1, lane);
    const int n0 = (t0 + r) * 128;
    store_tile<GELU>(lo, bias, staging + 2 * g * kBox, out, m0, n0, M, N, wg_tid, 2 + g);
    store_tile<GELU>(hi, bias, staging + (2 * g + 1) * kBox, out, m0, n0 + 64, M, N, wg_tid, 2 + g);
  }
}

typedef CUresult (*EncodeTiledFn)(CUtensorMap*, CUtensorMapDataType, cuuint32_t, void*,
                                  const cuuint64_t*, const cuuint64_t*, const cuuint32_t*,
                                  const cuuint32_t*, CUtensorMapInterleave, CUtensorMapSwizzle,
                                  CUtensorMapL2promotion, CUtensorMapFloatOOBfill);

// A TMA descriptor of a row-major bf16 (rows, cols) matrix read in boxes of
// 64 columns x box_rows rows, 128-byte swizzled; boxes past the edge are
// zero-filled.  cuTensorMapEncodeTiled is a driver function: it is taken
// from the runtime's driver entry point, so the library needs no -lcuda.
inline cudaError_t bf16_map(CUtensorMap* map, const void* ptr, int rows, int cols, int box_rows) {
  static EncodeTiledFn encode = nullptr;
  if (encode == nullptr) {
    void* fn = nullptr;
    cudaDriverEntryPointQueryResult found;
    const cudaError_t err =
        cudaGetDriverEntryPoint("cuTensorMapEncodeTiled", &fn, cudaEnableDefault, &found);
    if (err != cudaSuccess) return err;
    if (found != cudaDriverEntryPointSuccess || fn == nullptr) return cudaErrorSymbolNotFound;
    encode = reinterpret_cast<EncodeTiledFn>(fn);
  }
  const cuuint64_t dims[2] = {(cuuint64_t)cols, (cuuint64_t)rows};
  const cuuint64_t strides[1] = {(cuuint64_t)cols * 2};
  const cuuint32_t box[2] = {64, (cuuint32_t)box_rows};
  const cuuint32_t unit[2] = {1, 1};
  const CUresult r = encode(map, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, 2, const_cast<void*>(ptr), dims,
                            strides, box, unit, CU_TENSOR_MAP_INTERLEAVE_NONE,
                            CU_TENSOR_MAP_SWIZZLE_128B, CU_TENSOR_MAP_L2_PROMOTION_L2_256B,
                            CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE);
  return r == CUDA_SUCCESS ? cudaSuccess : cudaErrorInvalidValue;
}

// dynamic shared memory of gemm_tma_kernel (ops/_launch.py::encoder_plan
// computes the same)
inline size_t gemm_tma_smem(bool ln, int K, int stages) {
  return 1024 + (ln ? (size_t)((K + 63) / 64) * kBox : 0) + 2 * kBox +
         (size_t)stages * (ln ? 2 : 3) * kBox;
}

// ... and of gemm_ln_pingpong_kernel, `stages` per warpgroup
inline size_t gemm_pingpong_smem(int K, int stages) {
  return 1024 + (size_t)((K + 63) / 64) * kBox + 4 * kBox + (size_t)stages * 4 * kBox;
}

// `tiles`: 128-wide column tiles per block (the plan's; a block with LN
// normalises its rows once for all of them)
template <bool LN, bool GELU>
inline cudaError_t launch_gemm_tma(const void* A, const void* W, const float* bias,
                                   const float* ln_s, const float* ln_b, void* out, int M, int N,
                                   int K, int stages, int tiles, cudaStream_t stream) {
  if (stages < 2 || stages > kMaxStages || tiles < 1) return cudaErrorInvalidValue;
  CUtensorMap map_a, map_w;
  cudaError_t err = bf16_map(&map_w, W, K, N, 64);
  if (err != cudaSuccess) return err;
  err = bf16_map(&map_a, A, M, K, 64);
  if (err != cudaSuccess) return err;
  const int ntiles = (N + 127) / 128;
  const dim3 grid((ntiles + tiles - 1) / tiles, (M + 63) / 64);
  const size_t smem = gemm_tma_smem(LN, K, stages);
  err = cudaFuncSetAttribute(gemm_tma_kernel<LN, GELU>,
                             cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return err;
  gemm_tma_kernel<LN, GELU><<<grid, kTmaThreads, smem, stream>>>(
      map_a, map_w, static_cast<const __nv_bfloat16*>(A), bias, ln_s, ln_b,
      static_cast<__nv_bfloat16*>(out), M, N, K, stages, tiles, 1e-5f);
  return cudaGetLastError();
}

// How an LN GEMM gets its LayerNormed rows: the plan's ln_form
// (ops/_launch.py LN_RESIDENT, LN_PINGPONG, LN_APART), which follows from
// the shared memory each form needs at width K.
enum LnForm : int { kLnResident = 0, kLnPingPong = 1, kLnApart = 2 };

// The LN GEMM in the plan's form.  kLnApart writes the LayerNormed rows
// into `xn` (M, K), a scratch the caller does not read until this GEMM is
// done, and streams them through the plain GEMM.
template <bool GELU>
inline cudaError_t launch_ln_gemm(const void* A, const void* W, const float* bias,
                                  const float* ln_s, const float* ln_b, void* out, int M, int N,
                                  int K, int form, int stages, int tiles, void* xn,
                                  cudaStream_t stream) {
  if (form == kLnResident)
    return launch_gemm_tma<true, GELU>(A, W, bias, ln_s, ln_b, out, M, N, K, stages, tiles,
                                       stream);
  if (form == kLnApart) {
    if (xn == nullptr) return cudaErrorInvalidValue;
    ln_rows_kernel<<<(M + 7) / 8, 256, 0, stream>>>(static_cast<const __nv_bfloat16*>(A), ln_s,
                                                    ln_b, static_cast<__nv_bfloat16*>(xn), M, K,
                                                    1e-5f);
    const cudaError_t err = cudaGetLastError();
    if (err != cudaSuccess) return err;
    return launch_gemm_tma<false, GELU>(xn, W, bias, nullptr, nullptr, out, M, N, K, stages, 1,
                                        stream);
  }
  if (form != kLnPingPong || stages < 2 || stages > kMaxStages || tiles < 1)
    return cudaErrorInvalidValue;
  CUtensorMap map_w;
  cudaError_t err = bf16_map(&map_w, W, K, N, 64);
  if (err != cudaSuccess) return err;
  const dim3 grid(((N + 127) / 128 + tiles - 1) / tiles, (M + 63) / 64);
  const size_t smem = gemm_pingpong_smem(K, stages);
  err = cudaFuncSetAttribute(gemm_ln_pingpong_kernel<GELU>,
                             cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return err;
  gemm_ln_pingpong_kernel<GELU><<<grid, kPingThreads, smem, stream>>>(
      map_w, static_cast<const __nv_bfloat16*>(A), bias, ln_s, ln_b,
      static_cast<__nv_bfloat16*>(out), M, N, K, stages, tiles, 1e-5f);
  return cudaGetLastError();
}

}  // namespace mnx
