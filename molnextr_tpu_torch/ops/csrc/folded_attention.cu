// K5 and K6: all-head single-query decode attention over the prefix 0..pos
// of one layer of a head-folded stacked KV cache, hand-written for Hopper
// (sm_90a).
//
// Replaces molnextr_tpu/ops/folded_attention.py::folded_decode_attention
// (K5, Pallas kernel _make_kernel) and ::folded_decode_attention_bb (K6,
// _make_kernel_bb, bb batch rows per program).  The math is that of
// folded_decode_attention_reference: q (B, D) and k/v (L, B, T, D) with
// D = H * hd, head h owning channels [h * hd, (h + 1) * hd) of a row;
//   s_ht = (q_h . k_th) / sqrt(hd),  p_h = softmax(s_h over t <= pos),
//   out_h = sum_t p_ht * v_th,
// all in float32 (p is not rounded, as in both Pallas bodies and the
// reference), the output rounded once to q's dtype and concatenated in
// head order.  The layer is an index into the stacked array: no copy.
//
// What bounds it on the card: bytes.  A call reads (pos + 1) * D elements of
// K and of V per batch row and does about 4 * (pos + 1) * D operations on
// them (2 per bf16 byte read), far below the tensor-core ridge.  So the
// design reads every needed byte once, coalesced, and nothing past pos (the
// TPU kernels' clamped block index does the same):
//   * one block of kWarps warps takes bb batch rows, one after another
//     (K5: bb = 1; K6: bb is the TPU kernel's batch block, a launch
//     parameter here; on the card it only lengthens each block's work);
//   * the folded row suits a warp: a lane loads 16 bytes (8 bf16 or 4 f32
//     channels), so the warp reads whole rows, and one head's dot product is
//     a shuffle reduction over the hd / 8 (hd / 4) lanes that hold it;
//   * scores: warps stride over positions, kUnroll rows in flight per warp,
//     per-head scores parked in shared memory ([H][pos + 1], 16 KB at
//     H = 8, T = 512);
//   * softmax: one warp per head, an exact two-pass max / sum (the TPU
//     kernels' online softmax over 128-position chunks is the same function
//     up to float32 rounding);
//   * PV: the same lane-to-channel map, warps striding over positions, the
//     partial contexts summed across warps in shared memory.
#include "common.cuh"

namespace mnx {

constexpr int kFoldWarps = 16;
constexpr int kUnroll = 4;  // rows each warp has in flight

template <typename T> struct Vec16;  // channels in 16 bytes
template <> struct Vec16<float> { static constexpr int n = 4; };
template <> struct Vec16<__nv_bfloat16> { static constexpr int n = 8; };

template <typename T>
__device__ __forceinline__ void unpack16(const uint4& raw, float* f) {
  if constexpr (std::is_same<T, float>::value) {
    f[0] = __uint_as_float(raw.x);
    f[1] = __uint_as_float(raw.y);
    f[2] = __uint_as_float(raw.z);
    f[3] = __uint_as_float(raw.w);
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

// NI: 16-byte vectors per lane of a row (D / V / 32, rounded up to 1, 2 or 4)
template <typename T, int NI>
__global__ void __launch_bounds__(kFoldWarps * 32)
folded_attn_kernel(const T* __restrict__ q, const T* __restrict__ kc,
                   const T* __restrict__ vc, T* __restrict__ out, int B, int Tc,
                   int D, int H, int hd, int pos, int layer, int bb, float sqrt_hd) {
  constexpr int V = Vec16<T>::n;
  extern __shared__ float smem[];
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int nvec = D / V;   // 16-byte vectors in a row
  const int G = hd / V;     // lanes holding one head: a power of two <= 32
  const int npos = pos + 1;
  const int ld = npos | 1;  // odd row stride: the heads' scores of one
                            // position fall in distinct banks
  float* sc = smem;                   // [H][ld] scores, then probabilities
  float* red = smem + (size_t)H * ld;  // [kFoldWarps][D] partial contexts
  const uint4 zero = make_uint4(0u, 0u, 0u, 0u);

  for (int r = 0; r < bb; ++r) {
    const int b = blockIdx.x * bb + r;
    const size_t row0 = ((size_t)layer * B + b) * Tc;  // row of position 0
    const uint4* kr = reinterpret_cast<const uint4*>(kc) + row0 * nvec;
    const uint4* vr = reinterpret_cast<const uint4*>(vc) + row0 * nvec;
    const uint4* qr = reinterpret_cast<const uint4*>(q) + (size_t)b * nvec;

    float qf[NI][V];
#pragma unroll
    for (int i = 0; i < NI; ++i) {
      const int j = lane + 32 * i;
      unpack16<T>(j < nvec ? qr[j] : zero, qf[i]);
    }

    // 1. scores (t0 depends on the warp only: every lane takes the shuffles)
    for (int t0 = warp * kUnroll; t0 < npos; t0 += kFoldWarps * kUnroll) {
      uint4 raw[kUnroll][NI];
#pragma unroll
      for (int u = 0; u < kUnroll; ++u)
#pragma unroll
        for (int i = 0; i < NI; ++i) {
          const int t = t0 + u, j = lane + 32 * i;
          raw[u][i] = (t < npos && j < nvec) ? kr[(size_t)t * nvec + j] : zero;
        }
#pragma unroll
      for (int u = 0; u < kUnroll; ++u)
#pragma unroll
        for (int i = 0; i < NI; ++i) {
          float f[V];
          unpack16<T>(raw[u][i], f);
          float s = 0.f;
#pragma unroll
          for (int e = 0; e < V; ++e) s += qf[i][e] * f[e];
          for (int o = G >> 1; o > 0; o >>= 1) s += __shfl_xor_sync(0xffffffffu, s, o);
          const int t = t0 + u, j = lane + 32 * i;
          if (t < npos && j < nvec && (lane & (G - 1)) == 0) sc[(j / G) * ld + t] = s / sqrt_hd;
        }
    }
    __syncthreads();

    // 2. softmax of each head over t <= pos
    for (int h = warp; h < H; h += kFoldWarps) {
      float* s = sc + (size_t)h * ld;
      float mx = -INFINITY;
      for (int t = lane; t < npos; t += 32) mx = fmaxf(mx, s[t]);
      mx = warp_max(mx);
      float sum = 0.f;
      for (int t = lane; t < npos; t += 32) {
        const float e = expf(s[t] - mx);
        s[t] = e;
        sum += e;
      }
      sum = warp_sum(sum);
      for (int t = lane; t < npos; t += 32) s[t] = s[t] / sum;
    }
    __syncthreads();

    // 3. PV: lane j's channels take their head's probabilities
    float acc[NI][V];
#pragma unroll
    for (int i = 0; i < NI; ++i)
#pragma unroll
      for (int e = 0; e < V; ++e) acc[i][e] = 0.f;
    for (int t0 = warp * kUnroll; t0 < npos; t0 += kFoldWarps * kUnroll) {
      uint4 raw[kUnroll][NI];
#pragma unroll
      for (int u = 0; u < kUnroll; ++u)
#pragma unroll
        for (int i = 0; i < NI; ++i) {
          const int t = t0 + u, j = lane + 32 * i;
          raw[u][i] = (t < npos && j < nvec) ? vr[(size_t)t * nvec + j] : zero;
        }
#pragma unroll
      for (int u = 0; u < kUnroll; ++u) {
        const int t = t0 + u;
        if (t >= npos) break;
#pragma unroll
        for (int i = 0; i < NI; ++i) {
          const int j = lane + 32 * i;
          if (j >= nvec) continue;
          const float p = sc[(j / G) * ld + t];
          float f[V];
          unpack16<T>(raw[u][i], f);
#pragma unroll
          for (int e = 0; e < V; ++e) acc[i][e] += p * f[e];
        }
      }
    }
#pragma unroll
    for (int i = 0; i < NI; ++i) {
      const int j = lane + 32 * i;
      if (j < nvec)
#pragma unroll
        for (int e = 0; e < V; ++e) red[(size_t)warp * D + j * V + e] = acc[i][e];
    }
    __syncthreads();
    for (int c = threadIdx.x; c < D; c += kFoldWarps * 32) {
      float o = 0.f;
#pragma unroll
      for (int w = 0; w < kFoldWarps; ++w) o += red[(size_t)w * D + c];
      out[(size_t)b * D + c] = from_f32<T>(o);
    }
    __syncthreads();  // sc and red are reused by the next row
  }
}

template <typename T, int NI>
cudaError_t folded_attn(const void* q, const void* k, const void* v, void* out, int B,
                        int Tc, int D, int H, int pos, int layer, int bb,
                        cudaStream_t stream) {
  const size_t smem = sizeof(float) * ((size_t)H * ((pos + 1) | 1) + (size_t)kFoldWarps * D);
  if (smem > 48 * 1024) {
    const cudaError_t e = cudaFuncSetAttribute(
        folded_attn_kernel<T, NI>, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (e != cudaSuccess) return e;
  }
  const int hd = D / H;
  folded_attn_kernel<T, NI><<<B / bb, kFoldWarps * 32, smem, stream>>>(
      static_cast<const T*>(q), static_cast<const T*>(k), static_cast<const T*>(v),
      static_cast<T*>(out), B, Tc, D, H, hd, pos, layer, bb, sqrtf((float)hd));
  return cudaGetLastError();
}

template <typename T>
cudaError_t folded_attn_dispatch(const void* q, const void* k, const void* v, void* out,
                                 int B, int Tc, int D, int H, int pos, int layer, int bb,
                                 cudaStream_t st) {
  const int lanes_per_row = (D / Vec16<T>::n + 31) / 32;
  if (lanes_per_row <= 1)
    return folded_attn<T, 1>(q, k, v, out, B, Tc, D, H, pos, layer, bb, st);
  if (lanes_per_row <= 2)
    return folded_attn<T, 2>(q, k, v, out, B, Tc, D, H, pos, layer, bb, st);
  if (lanes_per_row <= 4)
    return folded_attn<T, 4>(q, k, v, out, B, Tc, D, H, pos, layer, bb, st);
  return cudaErrorInvalidValue;
}

}  // namespace mnx

extern "C" {

// q (B, D) and out (B, D), k/v (L, B, Tc, D), all in one dtype, 16-byte
// aligned; D = H * hd with hd / (16 / sizeof(dtype)) a power of two <= 32,
// at most 128 16-byte vectors in a row; 0 <= pos < Tc, 0 <= layer < L,
// B % bb == 0.  The wrapper checks these.  Returns a cudaError_t code.
int mnx_folded_decode_attention(int dtype, const void* q, const void* k, const void* v,
                                void* out, int B, int Tc, int D, int H, int pos, int layer,
                                int bb, void* stream) {
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (dtype == mnx::kF32)
    return mnx::folded_attn_dispatch<float>(q, k, v, out, B, Tc, D, H, pos, layer, bb, st);
  if (dtype == mnx::kBF16)
    return mnx::folded_attn_dispatch<__nv_bfloat16>(q, k, v, out, B, Tc, D, H, pos, layer,
                                                    bb, st);
  return cudaErrorInvalidValue;
}

}  // extern "C"
