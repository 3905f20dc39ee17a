// Shared device helpers for the port's hand-written kernels: dtype
// conversion, warp reductions, and a GEMM with an optional LayerNorm
// prologue and a bias / exact-GELU epilogue.
//
// Every kernel here is built for sm_90a by ops/_build.py (nvcc, plain C
// interface, loaded with ctypes).  The model's working dtype T is float or
// __nv_bfloat16; every product accumulates in float32.
#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <mma.h>
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
//   bias (N,) float32; out (M, N) in TO.
//   LN:   a(m, k) = T((A[m,k] - mu_m) * rstd_m * ln_s[k] + ln_b[k]), with
//         mu/rstd from a two-pass f32 reduction over the row (eps given);
//         otherwise a(m, k) = A[m, k].
//   GELU: epi(v) = gelu_exact(v); otherwise identity.
//
// Two implementations of that one function, one per input type:
//   float:  a 64x64 output tile per 256-thread block, 16-deep K slices in
//           shared memory, a 4x4 register tile per thread, FMA on the CUDA
//           cores (exact float32, as the float32 model needs);
//   bf16:   the tensor cores (mma.sync through nvcuda::wmma, f32
//           accumulation): a 128x128 tile per 256-thread block, 32-deep K
//           slices in shared memory, 8 warps in a 2x4 grid each holding
//           64x32 of accumulators.  Rows are loaded 16 bytes at a time, so
//           K and N are multiples of 8 (the wrappers check).
// Neither pipelines its loads; wgmma and TMA are a later change.
// ---------------------------------------------------------------------------

// mean and 1/std of rows m0 .. m0 + rows - 1 of A, one warp per row
template <typename T>
__device__ __forceinline__ void row_stats(const T* __restrict__ A, int m0, int rows, int M,
                                          int K, float eps, float* mu_s, float* rstd_s) {
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  for (int r = warp; r < rows; r += blockDim.x / 32) {
    const int m = m0 + r;
    float mu = 0.f, rstd = 0.f;
    if (m < M) {
      const T* row = A + (size_t)m * K;
      float s = 0.f;
      for (int k = lane; k < K; k += 32) s += to_f32(row[k]);
      mu = warp_sum(s) / K;
      float v = 0.f;
      for (int k = lane; k < K; k += 32) {
        const float dlt = to_f32(row[k]) - mu;
        v += dlt * dlt;
      }
      rstd = rsqrtf(warp_sum(v) / K + eps);
    }
    if (lane == 0) {
      mu_s[r] = mu;
      rstd_s[r] = rstd;
    }
  }
}

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

  const int tid = threadIdx.x;
  const int m0 = blockIdx.y * kBM, n0 = blockIdx.x * kBN;
  if (LN) {
    row_stats(A, m0, kBM, M, K, eps, mu_s, rstd_s);
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

constexpr int kTBM = 128, kTBN = 128, kTBK = 32, kTThreads = 256, kTPad = 8;

template <typename TO, bool LN, bool GELU>
__global__ void __launch_bounds__(kTThreads)
gemm_bf16_kernel(const __nv_bfloat16* __restrict__ A, const __nv_bfloat16* __restrict__ W,
                 const float* __restrict__ bias, const float* __restrict__ ln_s,
                 const float* __restrict__ ln_b, TO* __restrict__ out,
                 int M, int N, int K, float eps) {
  using namespace nvcuda;
  // rows padded by 8 elements (16 bytes) against bank conflicts; every
  // fragment pointer below stays 32-byte aligned
  __shared__ __align__(128) __nv_bfloat16 As[kTBM][kTBK + kTPad];
  __shared__ __align__(128) __nv_bfloat16 Ws[kTBK][kTBN + kTPad];
  __shared__ __align__(128) float stage[kTThreads / 32][16 * 16];
  __shared__ float mu_s[kTBM], rstd_s[kTBM];

  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const int m0 = blockIdx.y * kTBM, n0 = blockIdx.x * kTBN;
  const int wm = warp / 4, wn = warp % 4;
  if (LN) {
    row_stats(A, m0, kTBM, M, K, eps, mu_s, rstd_s);
    __syncthreads();
  }

  wmma::fragment<wmma::accumulator, 16, 16, 16, float> acc[4][2];
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int j = 0; j < 2; ++j) wmma::fill_fragment(acc[i][j], 0.f);

  for (int k0 = 0; k0 < K; k0 += kTBK) {
    for (int v = tid; v < kTBM * kTBK / 8; v += kTThreads) {
      const int r = v / (kTBK / 8), c = (v % (kTBK / 8)) * 8;
      const int m = m0 + r, k = k0 + c;
      uint4 raw = make_uint4(0u, 0u, 0u, 0u);
      if (m < M && k < K) {
        raw = *reinterpret_cast<const uint4*>(A + (size_t)m * K + k);
        if (LN) {
          __nv_bfloat16* e = reinterpret_cast<__nv_bfloat16*>(&raw);
#pragma unroll
          for (int i = 0; i < 8; ++i)
            e[i] = __float2bfloat16((__bfloat162float(e[i]) - mu_s[r]) * rstd_s[r] *
                                        ln_s[k + i] + ln_b[k + i]);
        }
      }
      *reinterpret_cast<uint4*>(&As[r][c]) = raw;
    }
    for (int v = tid; v < kTBK * kTBN / 8; v += kTThreads) {
      const int r = v / (kTBN / 8), c = (v % (kTBN / 8)) * 8;
      const int k = k0 + r, n = n0 + c;
      uint4 raw = make_uint4(0u, 0u, 0u, 0u);
      if (k < K && n < N) raw = *reinterpret_cast<const uint4*>(W + (size_t)k * N + n);
      *reinterpret_cast<uint4*>(&Ws[r][c]) = raw;
    }
    __syncthreads();
#pragma unroll
    for (int kk = 0; kk < kTBK; kk += 16) {
      wmma::fragment<wmma::matrix_a, 16, 16, 16, __nv_bfloat16, wmma::row_major> a[4];
      wmma::fragment<wmma::matrix_b, 16, 16, 16, __nv_bfloat16, wmma::row_major> b[2];
#pragma unroll
      for (int i = 0; i < 4; ++i)
        wmma::load_matrix_sync(a[i], &As[wm * 64 + i * 16][kk], kTBK + kTPad);
#pragma unroll
      for (int j = 0; j < 2; ++j)
        wmma::load_matrix_sync(b[j], &Ws[kk][wn * 32 + j * 16], kTBN + kTPad);
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int j = 0; j < 2; ++j) wmma::mma_sync(acc[i][j], a[i], b[j], acc[i][j]);
    }
    __syncthreads();
  }

  // epilogue through a per-warp 16x16 staging tile: bias, GELU, convert
  float* st = stage[warp];
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int j = 0; j < 2; ++j) {
      wmma::store_matrix_sync(st, acc[i][j], 16, wmma::mem_row_major);
      __syncwarp();
      for (int e = lane; e < 16 * 16; e += 32) {
        const int m = m0 + wm * 64 + i * 16 + e / 16;
        const int n = n0 + wn * 32 + j * 16 + e % 16;
        if (m < M && n < N) {
          float v = st[e] + bias[n];
          if (GELU) v = gelu_exact(v);
          out[(size_t)m * N + n] = from_f32<TO>(v);
        }
      }
      __syncwarp();
    }
}

template <typename T, typename TO, bool LN, bool GELU>
inline cudaError_t launch_gemm(const void* A, const void* W, const float* bias,
                               const float* ln_s, const float* ln_b, void* out,
                               int M, int N, int K, float eps, cudaStream_t stream) {
  if constexpr (std::is_same<T, __nv_bfloat16>::value) {
    const dim3 grid((N + kTBN - 1) / kTBN, (M + kTBM - 1) / kTBM);
    gemm_bf16_kernel<TO, LN, GELU><<<grid, kTThreads, 0, stream>>>(
        static_cast<const __nv_bfloat16*>(A), static_cast<const __nv_bfloat16*>(W), bias,
        ln_s, ln_b, static_cast<TO*>(out), M, N, K, eps);
  } else {
    const dim3 grid((N + kBN - 1) / kBN, (M + kBM - 1) / kBM);
    gemm_f32_kernel<TO, LN, GELU><<<grid, kGemmThreads, 0, stream>>>(
        static_cast<const float*>(A), static_cast<const float*>(W), bias, ln_s, ln_b,
        static_cast<TO*>(out), M, N, K, eps);
  }
  return cudaGetLastError();
}

}  // namespace mnx
