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
