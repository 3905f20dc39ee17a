// K1 and K2 of the Swin encoder, hand-written for Hopper (sm_90a).
//
// K1 replaces molnextr_tpu/ops/swin_fused.py::fused_window_attention
// (Pallas kernel _win_attn_kernel): LN1 -> x @ Wqkv + b -> per window and
// head softmax(q k^T * hd^-1/2 + relbias[h] + mask) v -> concat heads ->
// @ Wproj + b.  The caller rolls the input for shifted windows.
// K2 replaces swin_fused.py::fused_ln_mlp (Pallas kernel _ln_mlp_kernel):
// LN2 -> fc1 -> exact GELU -> fc2 + b2.
//
// What bounds them on the card: at Swin-B widths the four products are
// large GEMMs (operations-bound: about 2*T*C*(3C + C + 8C) FLOPs a block),
// the window attention itself is small (N = 144, hd = 32) and bound by the
// qkv scratch it reads.  The GEMMs (common.cuh) run on the tensor cores in
// bf16 and on the CUDA cores in float32; intermediates go through device
// scratch between launches:
//   K1: [LN1 + QKV GEMM] -> qkv (T, 3C) f32 -> [window attention, one block
//       per (window, head), scores in registers and shared memory] -> ctx
//       (T, C) in T -> [proj GEMM + bias] -> out (T, C), natural layout.
//   K2: [LN2 + fc1 GEMM + GELU] -> h (T, 4C) in T -> [fc2 GEMM + bias].
// The TPU kernels keep qkv and h on chip; moving them through HBM is the
// known gap of this version (PERF.md).  Rounding points follow the Pallas
// kernels: LN output and attention context are rounded to the weight dtype
// before their products, qkv stays f32, h is rounded before fc2.
#include "common.cuh"

namespace mnx {

constexpr int kAttnThreads = 256;
constexpr int kAttnWarps = kAttnThreads / 32;
constexpr int kMaxKeysPerLane = 5;  // N <= 160 keys per window

// qkv (B*Hres*Wres, 3C) f32 in natural token order -> ctx (same tokens, C).
// grid (B * nWh * nWw, heads); each warp owns query rows warp, warp+8, ...
template <typename T>
__global__ void __launch_bounds__(kAttnThreads)
window_attn_kernel(const float* __restrict__ qkv, const float* __restrict__ bias,
                   const float* __restrict__ mask, T* __restrict__ ctx,
                   int Hres, int Wres, int C, int heads, int ws, float scale) {
  extern __shared__ float smem[];
  const int n = ws * ws, hd = C / heads;
  const int nww = Wres / ws, nwh = Hres / ws;
  const int win = blockIdx.x, h = blockIdx.y;
  const int wj = win % nww, wi = (win / nww) % nwh, b = win / (nww * nwh);

  float* qs = smem;               // n * hd
  float* ks = qs + n * hd;        // n * (hd + 1): padded, conflict-free rows
  float* vs = ks + n * (hd + 1);  // n * hd
  float* ps = vs + n * hd;        // kAttnWarps * n probability rows

  for (int i = threadIdx.x; i < n * hd; i += blockDim.x) {
    const int tok = i / hd, d = i % hd;
    const int r = wi * ws + tok / ws, c = wj * ws + tok % ws;
    const size_t t = ((size_t)b * Hres + r) * Wres + c;
    const float* row = qkv + t * 3 * C + h * hd + d;
    qs[i] = row[0];
    ks[tok * (hd + 1) + d] = row[C];
    vs[i] = row[2 * C];
  }
  __syncthreads();

  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const float* bias_h = bias + (size_t)h * n * n;
  const float* mask_w = mask ? mask + (size_t)(wi * nww + wj) * n * n : nullptr;
  float* prow = ps + warp * n;

  for (int i = warp; i < n; i += kAttnWarps) {
    float s[kMaxKeysPerLane];
    float mx = -INFINITY;
#pragma unroll
    for (int u = 0; u < kMaxKeysPerLane; ++u) {
      const int j = lane + 32 * u;
      s[u] = -INFINITY;
      if (j < n) {
        float dot = 0.f;
        for (int d = 0; d < hd; ++d) dot += qs[i * hd + d] * ks[j * (hd + 1) + d];
        float v = dot * scale + bias_h[i * n + j];
        if (mask_w) v += mask_w[i * n + j];
        s[u] = v;
        mx = fmaxf(mx, v);
      }
    }
    mx = warp_max(mx);
    float sum = 0.f;
#pragma unroll
    for (int u = 0; u < kMaxKeysPerLane; ++u) {
      const int j = lane + 32 * u;
      if (j < n) {
        s[u] = expf(s[u] - mx);
        sum += s[u];
      }
    }
    sum = warp_sum(sum);
#pragma unroll
    for (int u = 0; u < kMaxKeysPerLane; ++u) {
      const int j = lane + 32 * u;
      if (j < n) prow[j] = s[u] / sum;
    }
    __syncwarp();
    if (lane < hd) {
      float acc = 0.f;
      for (int j = 0; j < n; ++j) acc += prow[j] * vs[j * hd + lane];
      const int r = wi * ws + i / ws, c = wj * ws + i % ws;
      const size_t t = ((size_t)b * Hres + r) * Wres + c;
      ctx[t * C + h * hd + lane] = from_f32<T>(acc);
    }
    __syncwarp();
  }
}

template <typename T>
cudaError_t window_attention(const void* x, const void* wqkv, const float* bqkv,
                             const void* wproj, const float* bproj,
                             const float* ln_s, const float* ln_b,
                             const float* bias, const float* mask,
                             float* qkv, void* ctx, void* out, int B, int Hres,
                             int Wres, int C, int heads, int ws,
                             cudaStream_t stream) {
  const int M = B * Hres * Wres;
  cudaError_t err = launch_gemm<T, float, true, false>(
      x, wqkv, bqkv, ln_s, ln_b, qkv, M, 3 * C, C, 1e-5f, stream);
  if (err != cudaSuccess) return err;

  const int n = ws * ws, hd = C / heads;
  const size_t smem = sizeof(float) * ((size_t)n * hd * 2 + (size_t)n * (hd + 1) +
                                       (size_t)kAttnWarps * n);
  err = cudaFuncSetAttribute(window_attn_kernel<T>,
                             cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return err;
  const dim3 grid(B * (Hres / ws) * (Wres / ws), heads);
  window_attn_kernel<T><<<grid, kAttnThreads, smem, stream>>>(
      qkv, bias, mask, static_cast<T*>(ctx), Hres, Wres, C, heads, ws,
      1.0f / sqrtf((float)hd));
  err = cudaGetLastError();
  if (err != cudaSuccess) return err;

  return launch_gemm<T, T, false, false>(ctx, wproj, bproj, nullptr, nullptr, out,
                                         M, C, C, 0.f, stream);
}

template <typename T>
cudaError_t ln_mlp(const void* x, const float* ln_s, const float* ln_b,
                   const void* w1, const float* b1, const void* w2,
                   const float* b2, void* hbuf, void* out, int M, int C, int F,
                   cudaStream_t stream) {
  cudaError_t err = launch_gemm<T, T, true, true>(x, w1, b1, ln_s, ln_b, hbuf, M, F,
                                                  C, 1e-5f, stream);
  if (err != cudaSuccess) return err;
  return launch_gemm<T, T, false, false>(hbuf, w2, b2, nullptr, nullptr, out, M, C,
                                         F, 0.f, stream);
}

}  // namespace mnx

extern "C" {

// Returns a cudaError_t code (0 on success); launches nothing on a bad dtype.
int mnx_fused_window_attention(int dtype, const void* x, const void* wqkv,
                               const float* bqkv, const void* wproj,
                               const float* bproj, const float* ln_s,
                               const float* ln_b, const float* bias,
                               const float* mask, float* qkv_scratch,
                               void* ctx_scratch, void* out, int B, int Hres,
                               int Wres, int C, int heads, int ws, void* stream) {
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (dtype == mnx::kF32)
    return mnx::window_attention<float>(x, wqkv, bqkv, wproj, bproj, ln_s, ln_b,
                                        bias, mask, qkv_scratch, ctx_scratch, out,
                                        B, Hres, Wres, C, heads, ws, st);
  if (dtype == mnx::kBF16)
    return mnx::window_attention<__nv_bfloat16>(x, wqkv, bqkv, wproj, bproj, ln_s,
                                                ln_b, bias, mask, qkv_scratch,
                                                ctx_scratch, out, B, Hres, Wres, C,
                                                heads, ws, st);
  return cudaErrorInvalidValue;
}

int mnx_fused_ln_mlp(int dtype, const void* x, const float* ln_s,
                     const float* ln_b, const void* w1, const float* b1,
                     const void* w2, const float* b2, void* h_scratch, void* out,
                     int M, int C, int F, void* stream) {
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (dtype == mnx::kF32)
    return mnx::ln_mlp<float>(x, ln_s, ln_b, w1, b1, w2, b2, h_scratch, out, M, C,
                              F, st);
  if (dtype == mnx::kBF16)
    return mnx::ln_mlp<__nv_bfloat16>(x, ln_s, ln_b, w1, b1, w2, b2, h_scratch, out,
                                      M, C, F, st);
  return cudaErrorInvalidValue;
}

}  // extern "C"
