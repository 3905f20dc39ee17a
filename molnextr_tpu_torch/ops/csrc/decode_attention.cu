// K3 and K4: single-query decode attention over the prefix 0..pos of one
// layer of a stacked self-attention KV cache, hand-written for Hopper
// (sm_90a).
//
// Replaces molnextr_tpu/ops/decode_attention.py::decode_attention_layered
// (K3, Pallas kernel _kernel_layered) and ::decode_attention (K4, Pallas
// kernel _kernel, the same attention on an unstacked (B, H, T, d) cache,
// which the wrapper passes as a one-layer stack).  The int8 form computes
// ::cached_decode_attention_layered_q8, which the JAX package leaves to
// XLA.  Two cache forms, one template:
//   Q8:    int8 K/V (L, B, H, T, d) with f32 per-token scales (L, B, H, T, 1),
//          the math of decode_attention_reference_q8:
//            s_t = (q . k_t) * sk_t / sqrt(d),  p = softmax(s over t <= pos),
//            out = sum_t T(p_t * sv_t) * v_t   (p * sv rounded to the model
//            dtype before the PV product, as the reference does);
//   dense: K/V in the model dtype, the math of decode_attention_reference:
//            s_t = (q . k_t) / sqrt(d), out = sum_t T(p_t) * v_t.
// The layer is an index into the stacked array: no per-layer copy.
//
// What bounds it on the card: bytes.  One step reads (pos + 1) * d bytes of
// K and of V per (b, h) (twice that for bf16) plus the scales, and does
// about 4 * (pos + 1) * d FLOPs on them, far below the tensor-core ridge.
// At decode batch sizes the whole read is a few MB, so launch latency
// dominates; this version keeps it to one launch per layer-step.  The TPU
// kernels keep p in float32 for the PV product; this one rounds p as the
// references do, which the JAX package runs everywhere but on a TPU.
// Design: one warp per (b, h).  Pass 1: lanes stride over positions, each
// lane computes whole dot products and parks scores in shared memory
// (4 bytes per position, 2 KB at T = 512); warp reductions give the max and
// the sum.  Pass 2: each lane owns one channel (d <= 32) and sweeps the
// positions, reading V rows coalesced.  Positions past pos are never read,
// and masked positions contribute exactly 0 in the reference, so skipping
// them is the same function.  The TPU kernel's online softmax over
// 128-position chunks is replaced by this exact two-pass softmax because
// the int8 form rounds the *normalized* p * s_v to the model dtype before
// the PV product, which an online softmax (normalizing at the end) cannot
// reproduce.
#include "common.cuh"

namespace mnx {

constexpr int kDecodeWarps = 4;

template <typename T, bool Q8>
__global__ void __launch_bounds__(kDecodeWarps * 32)
decode_attn_layered_kernel(const T* __restrict__ q, const void* __restrict__ kc,
                           const void* __restrict__ vc,
                           const float* __restrict__ k_scale,
                           const float* __restrict__ v_scale, T* __restrict__ out,
                           int BH, int Tc, int d, int pos, int layer, float sqrt_d) {
  extern __shared__ float smem[];
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int bh = blockIdx.x * kDecodeWarps + warp;
  if (bh >= BH) return;  // whole warp exits together; no block barrier below
  const int npos = pos + 1;
  float* qs = smem + warp * (32 + npos);
  float* sc = qs + 32;

  if (lane < d) qs[lane] = to_f32(q[(size_t)bh * d + lane]);
  __syncwarp();

  const size_t base = ((size_t)layer * BH + bh) * Tc;  // row of position 0
  float mx = -INFINITY;
  for (int t = lane; t < npos; t += 32) {
    float dot = 0.f;
    float s;
    if (Q8) {
      const int8_t* kr = static_cast<const int8_t*>(kc) + (base + t) * d;
      for (int c = 0; c < d; ++c) dot += qs[c] * (float)kr[c];
      s = dot * k_scale[base + t] / sqrt_d;
    } else {
      const T* kr = static_cast<const T*>(kc) + (base + t) * d;
      for (int c = 0; c < d; ++c) dot += qs[c] * to_f32(kr[c]);
      s = dot / sqrt_d;
    }
    sc[t] = s;
    mx = fmaxf(mx, s);
  }
  mx = warp_max(mx);
  float sum = 0.f;
  for (int t = lane; t < npos; t += 32) {
    const float e = expf(sc[t] - mx);
    sc[t] = e;
    sum += e;
  }
  sum = warp_sum(sum);
  for (int t = lane; t < npos; t += 32) {
    const float p = sc[t] / sum;
    sc[t] = Q8 ? round_to<T>(p * v_scale[base + t]) : round_to<T>(p);
  }
  __syncwarp();

  if (lane < d) {
    float acc = 0.f;
    if (Q8) {
      const int8_t* vb = static_cast<const int8_t*>(vc) + base * d + lane;
      for (int t = 0; t < npos; ++t) acc += sc[t] * (float)vb[(size_t)t * d];
    } else {
      const T* vb = static_cast<const T*>(vc) + base * d + lane;
      for (int t = 0; t < npos; ++t) acc += sc[t] * to_f32(vb[(size_t)t * d]);
    }
    out[(size_t)bh * d + lane] = from_f32<T>(acc);
  }
}

template <typename T, bool Q8>
cudaError_t decode_attn(const void* q, const void* k, const void* v,
                        const float* ks, const float* vs, void* out, int B, int H,
                        int Tc, int d, int pos, int layer, cudaStream_t stream) {
  const int BH = B * H;
  const int blocks = (BH + kDecodeWarps - 1) / kDecodeWarps;
  const size_t smem = sizeof(float) * kDecodeWarps * (32 + pos + 1);
  decode_attn_layered_kernel<T, Q8><<<blocks, kDecodeWarps * 32, smem, stream>>>(
      static_cast<const T*>(q), k, v, ks, vs, static_cast<T*>(out), BH, Tc, d, pos,
      layer, sqrtf((float)d));
  return cudaGetLastError();
}

}  // namespace mnx

extern "C" {

// q (B, H, d) and out (B, H, d) in the model dtype; k/v (L, B, H, Tc, d) int8
// (q8 = 1, with f32 scales (L, B, H, Tc, 1)) or in the model dtype (q8 = 0,
// scales unused).  Requires d <= 32 and 0 <= pos < Tc.  Returns a
// cudaError_t code.
int mnx_decode_attention_layered(int dtype, int q8, const void* q, const void* k,
                                 const void* v, const float* k_scale,
                                 const float* v_scale, void* out, int B, int H,
                                 int Tc, int d, int pos, int layer, void* stream) {
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (dtype == mnx::kF32)
    return q8 ? mnx::decode_attn<float, true>(q, k, v, k_scale, v_scale, out, B, H,
                                              Tc, d, pos, layer, st)
              : mnx::decode_attn<float, false>(q, k, v, k_scale, v_scale, out, B, H,
                                               Tc, d, pos, layer, st);
  if (dtype == mnx::kBF16)
    return q8 ? mnx::decode_attn<__nv_bfloat16, true>(q, k, v, k_scale, v_scale, out,
                                                      B, H, Tc, d, pos, layer, st)
              : mnx::decode_attn<__nv_bfloat16, false>(q, k, v, k_scale, v_scale,
                                                       out, B, H, Tc, d, pos, layer,
                                                       st);
  return cudaErrorInvalidValue;
}

}  // extern "C"
