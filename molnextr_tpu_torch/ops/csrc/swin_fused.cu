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
// large GEMMs (operations-bound: 2*T*C*(3C + C + 8C) FLOPs a block at 989
// TFLOP/s in bf16); the window attention (4*T*N*C FLOPs) is small beside
// them.  The bf16 model (the serving path) runs:
//   K1: [LN1 + QKV GEMM, common.cuh gemm_tma_kernel: TMA ring, wgmma, the
//       block's LayerNormed rows resident in shared memory; at C = 512
//       gemm_ln_pingpong_kernel, the same with its two warpgroups taking
//       turns on whole tiles; above C = 1408, where the rows do not fit,
//       ln_rows_kernel into scratch and the plain GEMM] -> qkv (T, 3C)
//       bf16 -> [window attention on the tensor cores, mma.sync m16n8k16:
//       a warp holds 16 query rows' scores over the whole window in
//       registers; a block walks several images' windows of one head and
//       window position, so bias[h] + mask[w] is read once per block] ->
//       ctx (T, C) bf16 -> [proj GEMM, TMA A and W] -> out (T, C).
//   K2: at C <= 128, one kernel (mlp_fused_kernel): a block owns 64 rows,
//       LayerNorms them once into shared memory and walks F in chunks of
//       128: h = GELU(xn W1[:, chunk] + b1) goes to shared memory in bf16
//       and straight into acc += h W2[chunk, :], acc 64 x C f32 in the two
//       consumer warpgroups' registers; W1 and W2 stream through one TMA
//       ring; two blocks share an SM.  h never reaches device memory.  At
//       C >= 256 a block needs the SM to itself and two GEMMs measured
//       faster (PERF.md): [LN2 + fc1 + GELU GEMM] -> h (T, 4C) bf16 ->
//       [fc2 GEMM].
//   The float32 model (parity runs) keeps the CUDA-core GEMM and a CUDA-core
//   attention reading q, k and v from the f32 qkv scratch.
// The launch plan (ring depths, fused or two-GEMM K2, attention tiles and
// windows per block) comes from ops/_launch.py::encoder_plan.  On the H100
// (PERF.md, chip_probe.py --parts encoder) the GEMMs reach 100-310 of the
// 989 TFLOP/s; the ones with the LN prologue are the slow end.
//
// Rounding points, as the Pallas kernels and the plain versions
// (ops/swin_fused.py) round: the LN output, the attention context and the
// GELU output are rounded to the weight dtype before their products.  The
// bf16 model adds two: qkv is rounded to bf16 after its bias (the hand-off
// to the attention), and p after its normalisation (the A operand of PV).
// In float32 all of them are no-ops.  The bf16 GELU takes erf from the
// Pallas kernel's polynomial (common.cuh gelu_poly, |error| <= 1.5e-7, far
// inside h's bf16 rounding); the float32 GELU uses erff.
#include "common.cuh"

namespace mnx {

// ---------------------------------------------------------------------------
// Window attention, float32 (CUDA cores).  One block per (window, head),
// a warp per query row: lane j scores keys j, j + 32, ...; the probability
// row goes through shared memory into PV, lane d taking columns d, d + 32,
// ...  q, k and v are read from the f32 qkv scratch through L1.
// ---------------------------------------------------------------------------

constexpr int kAttnThreads = 256;
constexpr int kAttnWarps = kAttnThreads / 32;
constexpr int kMaxKeysPerLane = 8;  // N <= 256 keys per window

__global__ void __launch_bounds__(kAttnThreads)
window_attn_f32_kernel(const float* __restrict__ qkv, const float* __restrict__ bias,
                       const float* __restrict__ mask, float* __restrict__ ctx, int Hres,
                       int Wres, int C, int heads, int ws, float scale) {
  extern __shared__ float smem[];
  const int n = ws * ws, hd = C / heads;
  const int nww = Wres / ws, nwh = Hres / ws;
  const int win = blockIdx.x, h = blockIdx.y;
  const int wj = win % nww, wi = (win / nww) % nwh, b = win / (nww * nwh);
  float* ps = smem;                                       // kAttnWarps * n probabilities
  int* tok = reinterpret_cast<int*>(ps + kAttnWarps * n);  // n token indices
  for (int i = threadIdx.x; i < n; i += blockDim.x)
    tok[i] = (b * Hres + wi * ws + i / ws) * Wres + wj * ws + i % ws;
  __syncthreads();

  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const float* bias_h = bias + (size_t)h * n * n;
  const float* mask_w = mask ? mask + (size_t)(wi * nww + wj) * n * n : nullptr;
  float* prow = ps + warp * n;
  const size_t row3 = 3 * (size_t)C;

  for (int i = warp; i < n; i += kAttnWarps) {
    const float* q = qkv + tok[i] * row3 + h * hd;
    float s[kMaxKeysPerLane];
    float mx = -INFINITY;
#pragma unroll
    for (int u = 0; u < kMaxKeysPerLane; ++u) {
      const int j = lane + 32 * u;
      s[u] = -INFINITY;
      if (j < n) {
        const float* k = qkv + tok[j] * row3 + C + h * hd;
        float dot = 0.f;
        for (int d = 0; d < hd; ++d) dot += q[d] * k[d];
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
    for (int d = lane; d < hd; d += 32) {
      float acc = 0.f;
      for (int j = 0; j < n; ++j) acc += prow[j] * qkv[tok[j] * row3 + 2 * C + h * hd + d];
      ctx[(size_t)tok[i] * C + h * hd + d] = acc;
    }
    __syncwarp();
  }
}

// ---------------------------------------------------------------------------
// Window attention, bf16, on the tensor cores (mma.sync m16n8k16, f32
// accumulation).  KT 16-key tiles (N padded with keys that get -inf), HT
// 16-wide head-dim tiles (hd padded with zero columns).  A block takes head
// blockIdx.y at window position p of images b0 .. b0 + wpb - 1: q, k and v
// of one window at a time staged in shared memory (cp.async, double-
// buffered when the plan says so), a warp per 16 query rows.  The warp's
// scores over all keys stay in registers (KT * 8 floats a thread); the
// exact softmax is normalised, p rounded to bf16 and used in place as the
// A fragments of PV.  At KT <= 9 (N <= 144) bias[h] + mask[p] of the
// warp's rows is read once per block into registers; above, once per
// window, and each warp takes two query tiles to keep registers in bounds.
// At KT 9 the held bias spills a little (168 registers a thread) and still
// measured faster than reading it per window on the H100 (PERF.md).
// ---------------------------------------------------------------------------

template <int KT>
constexpr int attn_threads() {
  return KT <= 9 ? 32 * KT : 32 * ((KT + 1) / 2);
}

template <int KT, int HT>
__global__ void __launch_bounds__(attn_threads<KT>())
window_attn_mma_kernel(const __nv_bfloat16* __restrict__ qkv, const float* __restrict__ bias,
                       const float* __restrict__ mask, __nv_bfloat16* __restrict__ ctx, int B,
                       int Hres, int Wres, int C, int heads, int ws, int wpb, int nbuf,
                       float scale) {
  constexpr int HP = HT * 16 + 8;   // staged row pitch in elements: 16 bytes of padding
  constexpr int MAT = KT * 16 * HP;  // elements of one staged q, k or v
  constexpr bool kHoldBias = KT <= 9;
  extern __shared__ __align__(16) __nv_bfloat16 sm[];
  const int n = ws * ws, hd = C / heads;
  const int nww = Wres / ws, nw = (Hres / ws) * nww;
  const int p = blockIdx.x % nw, h = blockIdx.y;
  const int wi = p / nww, wj = p % nww;
  const int b0 = (blockIdx.x / nw) * wpb, b1 = min(B, b0 + wpb);
  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const int nwarps = blockDim.x >> 5, qtiles = (n + 15) / 16;

  // pad rows and columns stay zero: copies write only the window's n rows
  // and hd columns
  for (int i = tid * 8; i < nbuf * 3 * MAT; i += blockDim.x * 8)
    *reinterpret_cast<uint4*>(sm + i) = make_uint4(0u, 0u, 0u, 0u);
  __syncthreads();

  const int unit = hd % 8 == 0 ? 16 : hd % 4 == 0 ? 8 : hd % 2 == 0 ? 4 : 2;
  const int per_row = hd * 2 / unit;
  auto stage = [&](int b, __nv_bfloat16* dst) {
    for (int i = tid; i < 3 * n * per_row; i += blockDim.x) {
      const int which = i / (n * per_row), rem = i % (n * per_row);
      const int tok = rem / per_row, part = rem % per_row;
      const size_t t = ((size_t)b * Hres + wi * ws + tok / ws) * Wres + wj * ws + tok % ws;
      const char* src =
          reinterpret_cast<const char*>(qkv + t * 3 * C + which * C + h * hd) + part * unit;
      char* d = reinterpret_cast<char*>(dst + which * MAT + tok * HP) + part * unit;
      const uint32_t sd = smem_u32(d);
      if (unit == 16)
        asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(sd), "l"(src) : "memory");
      else if (unit == 8)
        asm volatile("cp.async.ca.shared.global [%0], [%1], 8;\n" ::"r"(sd), "l"(src) : "memory");
      else if (unit == 4)
        asm volatile("cp.async.ca.shared.global [%0], [%1], 4;\n" ::"r"(sd), "l"(src) : "memory");
      else
        *reinterpret_cast<__nv_bfloat16*>(d) = *reinterpret_cast<const __nv_bfloat16*>(src);
    }
    cp_async_commit();
  };

  const float* bias_h = bias + (size_t)h * n * n;
  const float* mask_p = mask ? mask + (size_t)p * n * n : nullptr;
  auto bm_at = [&](int r, int k) -> float {
    if (r >= n || k >= n) return 0.f;
    return bias_h[r * n + k] + (mask_p ? mask_p[r * n + k] : 0.f);
  };
  float bm[kHoldBias ? KT * 8 : 1];
  if constexpr (kHoldBias) {  // one query tile per warp: the warp's rows
    const int r0 = warp * 16 + (lane >> 2);
#pragma unroll
    for (int nt = 0; nt < 2 * KT; ++nt) {
      const int k = 8 * nt + 2 * (lane & 3);
      bm[4 * nt] = bm_at(r0, k);
      bm[4 * nt + 1] = bm_at(r0, k + 1);
      bm[4 * nt + 2] = bm_at(r0 + 8, k);
      bm[4 * nt + 3] = bm_at(r0 + 8, k + 1);
    }
  }

  stage(b0, sm);
  for (int b = b0; b < b1; ++b) {
    const int cur = nbuf == 2 ? (b - b0) & 1 : 0;
    if (nbuf == 2 && b + 1 < b1) {
      stage(b + 1, sm + (cur ^ 1) * 3 * MAT);
      cp_async_wait<1>();
    } else {
      cp_async_wait<0>();
    }
    __syncthreads();
    const __nv_bfloat16* qs = sm + cur * 3 * MAT;
    const __nv_bfloat16* ks = qs + MAT;
    const __nv_bfloat16* vs = ks + MAT;

    for (int qt = warp; qt < qtiles; qt += nwarps) {
      const int r0 = qt * 16 + (lane >> 2), r1 = r0 + 8;
      float s[KT * 8];
#pragma unroll
      for (int i = 0; i < KT * 8; ++i) s[i] = 0.f;
#pragma unroll
      for (int kk = 0; kk < HT; ++kk) {
        uint32_t a[4];
        ldsm_x4(a, qs + (qt * 16 + (lane & 15)) * HP + kk * 16 + 8 * (lane >> 4));
#pragma unroll
        for (int np = 0; np < KT; ++np) {
          uint32_t bk[4];
          ldsm_x4(bk, ks + (np * 16 + (lane & 7) + 8 * (lane >> 4)) * HP + kk * 16 +
                          8 * ((lane >> 3) & 1));
          mma_16816(s + 8 * np, a, bk[0], bk[1]);
          mma_16816(s + 8 * np + 4, a, bk[2], bk[3]);
        }
      }
      float mx0 = -INFINITY, mx1 = -INFINITY;
#pragma unroll
      for (int nt = 0; nt < 2 * KT; ++nt) {
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const int k = 8 * nt + 2 * (lane & 3) + (e & 1), r = e < 2 ? r0 : r1;
          float v = s[4 * nt + e] * scale;
          if constexpr (kHoldBias) v += bm[4 * nt + e];
          else v += bm_at(r, k);
          if (k >= n) v = -INFINITY;
          s[4 * nt + e] = v;
          if (e < 2) mx0 = fmaxf(mx0, v);
          else mx1 = fmaxf(mx1, v);
        }
      }
#pragma unroll
      for (int o = 1; o <= 2; o <<= 1) {
        mx0 = fmaxf(mx0, __shfl_xor_sync(0xffffffffu, mx0, o));
        mx1 = fmaxf(mx1, __shfl_xor_sync(0xffffffffu, mx1, o));
      }
      // exp(s - max) as exp2((s - max) * log2 e); the keys masked at -100
      // underflow to denormals, which a division would take through its
      // slow path: p is e times the row's one reciprocal
      constexpr float kLog2e = 1.4426950408889634f;
      float sum0 = 0.f, sum1 = 0.f;
#pragma unroll
      for (int nt = 0; nt < 2 * KT; ++nt) {
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const float v = exp2f((s[4 * nt + e] - (e < 2 ? mx0 : mx1)) * kLog2e);
          s[4 * nt + e] = v;
          if (e < 2) sum0 += v;
          else sum1 += v;
        }
      }
#pragma unroll
      for (int o = 1; o <= 2; o <<= 1) {
        sum0 += __shfl_xor_sync(0xffffffffu, sum0, o);
        sum1 += __shfl_xor_sync(0xffffffffu, sum1, o);
      }
      // p = e / sum rounded to bf16: the A fragments of PV, key tile j
      const float inv0 = 1.f / sum0, inv1 = 1.f / sum1;
      uint32_t pa[KT][4];
#pragma unroll
      for (int j = 0; j < KT; ++j) {
        pa[j][0] = pack_bf16(s[8 * j] * inv0, s[8 * j + 1] * inv0);
        pa[j][1] = pack_bf16(s[8 * j + 2] * inv1, s[8 * j + 3] * inv1);
        pa[j][2] = pack_bf16(s[8 * j + 4] * inv0, s[8 * j + 5] * inv0);
        pa[j][3] = pack_bf16(s[8 * j + 6] * inv1, s[8 * j + 7] * inv1);
      }
      float o[HT * 8];
#pragma unroll
      for (int i = 0; i < HT * 8; ++i) o[i] = 0.f;
#pragma unroll
      for (int j = 0; j < KT; ++j) {
#pragma unroll
        for (int dp = 0; dp < HT; ++dp) {
          uint32_t bv[4];
          ldsm_x4_t(bv, vs + (j * 16 + (lane & 7) + 8 * ((lane >> 3) & 1)) * HP + dp * 16 +
                            8 * (lane >> 4));
          mma_16816(o + 8 * dp, pa[j], bv[0], bv[1]);
          mma_16816(o + 8 * dp + 4, pa[j], bv[2], bv[3]);
        }
      }
#pragma unroll
      for (int half = 0; half < 2; ++half) {
        const int r = half ? r1 : r0;
        if (r >= n) continue;
        const size_t t = ((size_t)b * Hres + wi * ws + r / ws) * Wres + wj * ws + r % ws;
        __nv_bfloat16* dst = ctx + t * C + h * hd;
#pragma unroll
        for (int dn = 0; dn < 2 * HT; ++dn) {
          const int d = 8 * dn + 2 * (lane & 3);
          const float v0 = o[4 * dn + 2 * half], v1 = o[4 * dn + 2 * half + 1];
          if (d + 1 < hd && hd % 2 == 0) {
            *reinterpret_cast<__nv_bfloat162*>(dst + d) = __floats2bfloat162_rn(v0, v1);
          } else {
            if (d < hd) dst[d] = __float2bfloat16(v0);
            if (d + 1 < hd) dst[d + 1] = __float2bfloat16(v1);
          }
        }
      }
    }
    __syncthreads();  // every warp is done with this buffer before it is refilled
    if (nbuf == 1 && b + 1 < b1) stage(b + 1, sm);
  }
}

template <int KT, int HT>
cudaError_t launch_attn_mma(const void* qkv, const float* bias, const float* mask, void* ctx,
                            int B, int Hres, int Wres, int C, int heads, int ws, int wpb, int nbuf,
                            cudaStream_t stream) {
  const int n = ws * ws, hd = C / heads;
  const size_t smem = (size_t)nbuf * 3 * KT * 16 * (HT * 16 + 8) * sizeof(__nv_bfloat16);
  cudaError_t err = cudaFuncSetAttribute(window_attn_mma_kernel<KT, HT>,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return err;
  const int qtiles = (n + 15) / 16;
  const int threads = 32 * (KT <= 9 ? qtiles : (qtiles + 1) / 2);
  const int nw = (Hres / ws) * (Wres / ws);
  const dim3 grid(nw * ((B + wpb - 1) / wpb), heads);
  window_attn_mma_kernel<KT, HT><<<grid, threads, smem, stream>>>(
      static_cast<const __nv_bfloat16*>(qkv), bias, mask, static_cast<__nv_bfloat16*>(ctx), B,
      Hres, Wres, C, heads, ws, wpb, nbuf, 1.0f / sqrtf((float)hd));
  return cudaGetLastError();
}

template <int KT>
cudaError_t attn_mma_ht(int ht, const void* qkv, const float* bias, const float* mask, void* ctx,
                        int B, int Hres, int Wres, int C, int heads, int ws, int wpb, int nbuf,
                        cudaStream_t st) {
  switch (ht) {
    case 1: return launch_attn_mma<KT, 1>(qkv, bias, mask, ctx, B, Hres, Wres, C, heads, ws, wpb, nbuf, st);
    case 2: return launch_attn_mma<KT, 2>(qkv, bias, mask, ctx, B, Hres, Wres, C, heads, ws, wpb, nbuf, st);
    case 4: return launch_attn_mma<KT, 4>(qkv, bias, mask, ctx, B, Hres, Wres, C, heads, ws, wpb, nbuf, st);
    case 8: return launch_attn_mma<KT, 8>(qkv, bias, mask, ctx, B, Hres, Wres, C, heads, ws, wpb, nbuf, st);
    default: return cudaErrorInvalidValue;
  }
}

// the plan's key tiles and head-dim tiles (ops/_launch.py ATTN_KEY_TILES,
// ATTN_HD_TILES), checked against the window here too
cudaError_t attention_bf16(int kt, int ht, const void* qkv, const float* bias, const float* mask,
                           void* ctx, int B, int Hres, int Wres, int C, int heads, int ws, int wpb,
                           int nbuf, cudaStream_t st) {
  const int n = ws * ws, hd = C / heads;
  if (kt * 16 < n || ht * 16 < hd || wpb < 1 || nbuf < 1 || nbuf > 2) return cudaErrorInvalidValue;
  switch (kt) {
    case 1: return attn_mma_ht<1>(ht, qkv, bias, mask, ctx, B, Hres, Wres, C, heads, ws, wpb, nbuf, st);
    case 2: return attn_mma_ht<2>(ht, qkv, bias, mask, ctx, B, Hres, Wres, C, heads, ws, wpb, nbuf, st);
    case 4: return attn_mma_ht<4>(ht, qkv, bias, mask, ctx, B, Hres, Wres, C, heads, ws, wpb, nbuf, st);
    case 9: return attn_mma_ht<9>(ht, qkv, bias, mask, ctx, B, Hres, Wres, C, heads, ws, wpb, nbuf, st);
    case 16: return attn_mma_ht<16>(ht, qkv, bias, mask, ctx, B, Hres, Wres, C, heads, ws, wpb, nbuf, st);
    default: return cudaErrorInvalidValue;
  }
}

// ---------------------------------------------------------------------------
// K2 fused, bf16, C <= 128: a block owns rows m0 .. m0 + 63, which the
// consumers LayerNorm once into shared memory (ln_rows).  Warp 8 streams,
// for each 128-wide chunk of F, W1[k-slice, chunk] (two 64 x 64 boxes per
// 64-deep slice of C) and W2[chunk, slab] (a 128-row x 64-column box per
// 64-column slab of C) through one ring.  Consumer warpgroup g computes
// h[:, 64g .. 64g + 63] of the chunk against the resident xn, adds b1,
// applies GELU, rounds to bf16 into a 128-byte-swizzled h buffer (double-
// buffered by chunk parity), and after a barrier of both warpgroups adds
// h W2[chunk, slab g] into its accumulator (slab g: columns 64g .. 64g + 63
// of the output; at C <= 64 warpgroup 1 has none).
//
// One group of wgmma stays in flight while the warpgroup waits for the next
// slot, across the boundary of the two products too: a chunk's last slab
// is still running while the next chunk's first W1 slice is awaited.  Each
// warpgroup then holds up to two slots, so the ring needs 3 stages.
//
// It runs where two blocks share an SM (ops/_launch.py::encoder_plan, C <=
// 128).  Wider, a block would need the SM to itself, which leaves the
// tensor cores idle through its LN prologue, every chunk's GELU and the
// epilogue; there two GEMMs through device memory measured faster on the
// H100 (PERF.md).
// ---------------------------------------------------------------------------

__global__ void __launch_bounds__(kTmaThreads, 2)
mlp_fused_kernel(const __grid_constant__ CUtensorMap map_w1, const __grid_constant__ CUtensorMap map_w2,
                 const __nv_bfloat16* __restrict__ x, const float* __restrict__ ln_s,
                 const float* __restrict__ ln_b, const float* __restrict__ b1,
                 const float* __restrict__ b2, __nv_bfloat16* __restrict__ out, int M, int C,
                 int F, int stages) {
  extern __shared__ uint8_t smem_raw[];
  __shared__ __align__(8) uint64_t full[kMaxStages], empty[kMaxStages];
  __shared__ float2 stats[64];
  const int kb = (C + 63) / 64, nch = (F + 127) / 128;
  uint8_t* xn = align1024(smem_raw);  // kb boxes; the output staging at the end
  uint8_t* hbuf = xn + kb * kBox;     // [chunk parity][warpgroup] boxes
  uint8_t* ring = hbuf + 4 * kBox;    // stages of 2 boxes
  const int m0 = blockIdx.x * 64;
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const Ring bars{full, empty, stages};
  ring_init(full, empty, stages);

  if (warp == kProducerWarp) {
    if (lane == 0) {
      int it = 0;
      for (int ch = 0; ch < nch; ++ch) {
        const int f0 = ch * 128;
        for (int ks = 0; ks < kb; ++ks, ++it) {
          const int s = bars.acquire(it, 2 * kBox);
          tma_load(ring + s * 2 * kBox, &map_w1, &full[s], f0, ks * 64);
          tma_load(ring + s * 2 * kBox + kBox, &map_w1, &full[s], f0 + 64, ks * 64);
        }
        for (int i = 0; i < kb; ++i, ++it) {
          const int s = bars.acquire(it, 2 * kBox);
          tma_load(ring + s * 2 * kBox, &map_w2, &full[s], i * 64, f0);
        }
      }
    }
    return;
  }

  ln_rows(x, m0, M, C, ln_s, ln_b, 1e-5f, xn, stats, threadIdx.x);
  const int wg = warp >> 2, wl = warp & 3;
  // zeroed once, before any product is in flight; each sum then starts
  // with a product that does not accumulate
  float acc[32], hacc[32];
#pragma unroll
  for (int i = 0; i < 32; ++i) acc[i] = hacc[i] = 0.f;
  int it = 0, held = -1;  // held: the slot of this warpgroup's group that may be in flight
  auto committed = [&](int slot) {  // a group reading `slot` was just committed
    wgmma_wait<1>();
    if (held >= 0) bars.release(held, lane);
    held = slot;
  };
  for (int ch = 0; ch < nch; ++ch) {
    const int f0 = ch * 128;
    for (int ks = 0; ks < kb; ++ks, ++it) {
      const uint8_t* st = ring + bars.wait(it) * 2 * kBox + wg * kBox;
      wgmma_fence();
#pragma unroll
      for (int j = 0; j < 4; ++j)
        wgmma_64x64(hacc, desc_a(xn + ks * kBox + 32 * j), desc_b(st + 2048 * j), ks > 0 || j > 0);
      wgmma_commit();
      committed(it);
    }
    wgmma_wait_all(hacc);
    bars.release(held, lane);
    held = -1;
    uint8_t* hb = hbuf + (ch & 1) * 2 * kBox;
#pragma unroll
    for (int j = 0; j < 8; ++j) {
      const int col = 8 * j + 2 * (lane & 3), f = f0 + 64 * wg + col;
      const float c0 = f < F ? b1[f] : 0.f, c1 = f + 1 < F ? b1[f + 1] : 0.f;
#pragma unroll
      for (int half = 0; half < 2; ++half) {
        const int row = 16 * wl + (lane >> 2) + 8 * half;
        *reinterpret_cast<__nv_bfloat162*>(hb + wg * kBox + sw128(row, col)) =
            __floats2bfloat162_rn(gelu_poly(hacc[4 * j + 2 * half] + c0),
                                  gelu_poly(hacc[4 * j + 2 * half + 1] + c1));
      }
    }
    fence_proxy_async();
    named_bar_sync(1, 256);  // both halves of h are in place
    for (int i = 0; i < kb; ++i, ++it) {
      const int s = bars.wait(it);
      if (i == wg) {
        wgmma_fence();
#pragma unroll
        for (int j = 0; j < 8; ++j)
          wgmma_64x64(acc, desc_a(hb + (j >> 2) * kBox + 32 * (j & 3)),
                      desc_b(ring + s * 2 * kBox + 2048 * j), 1);
        wgmma_commit();
        committed(it);
      } else {
        bars.release(it, lane);  // the other warpgroup's slab
      }
    }
  }
  wgmma_wait_all(acc);
  if (held >= 0) bars.release(held, lane);
  // xn is read no more (the last chunk's barrier is behind every step 1):
  // it stages the output, slab g in box g
  if (wg < kb)
    store_tile<false>(acc, b2, xn + wg * kBox, out, m0, 64 * wg, M, C, threadIdx.x & 127, 2 + wg);
}

cudaError_t launch_mlp_fused(const void* x, const float* ln_s, const float* ln_b, const void* w1,
                             const float* b1, const void* w2, const float* b2, void* out, int M,
                             int C, int F, int stages, cudaStream_t stream) {
  if (C > 128 || stages < 3 || stages > kMaxStages) return cudaErrorInvalidValue;
  CUtensorMap map_w1, map_w2;
  cudaError_t err = bf16_map(&map_w1, w1, C, F, 64);
  if (err != cudaSuccess) return err;
  err = bf16_map(&map_w2, w2, F, C, 128);
  if (err != cudaSuccess) return err;
  const size_t smem = 1024 + (size_t)((C + 63) / 64) * kBox + 4 * kBox + (size_t)stages * 2 * kBox;
  err = cudaFuncSetAttribute(mlp_fused_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                             (int)smem);
  if (err != cudaSuccess) return err;
  mlp_fused_kernel<<<(M + 63) / 64, kTmaThreads, smem, stream>>>(
      map_w1, map_w2, static_cast<const __nv_bfloat16*>(x), ln_s, ln_b, b1, b2,
      static_cast<__nv_bfloat16*>(out), M, C, F, stages);
  return cudaGetLastError();
}

// plan: kt, ht, wpb, nbuf of the attention; ln_form, ln_stages, stages,
// tiles per block of the QKV GEMM.  With LN apart, the LayerNormed rows go
// through ctx, which the attention writes only after the QKV GEMM.
cudaError_t window_attention_bf16(const void* x, const void* wqkv, const float* bqkv,
                                  const void* wproj, const float* bproj, const float* ln_s,
                                  const float* ln_b, const float* bias, const float* mask,
                                  void* qkv, void* ctx, void* out, int B, int Hres, int Wres, int C,
                                  int heads, int ws, const int* plan, cudaStream_t st) {
  const int M = B * Hres * Wres;
  cudaError_t err = launch_ln_gemm<false>(x, wqkv, bqkv, ln_s, ln_b, qkv, M, 3 * C, C, plan[4],
                                          plan[5], plan[7], ctx, st);
  if (err != cudaSuccess) return err;
  err = attention_bf16(plan[0], plan[1], qkv, bias, mask, ctx, B, Hres, Wres, C, heads, ws,
                       plan[2], plan[3], st);
  if (err != cudaSuccess) return err;
  return launch_gemm_tma<false, false>(ctx, wproj, bproj, nullptr, nullptr, out, M, C, C, plan[6],
                                       1, st);
}

cudaError_t window_attention_f32(const void* x, const void* wqkv, const float* bqkv,
                                 const void* wproj, const float* bproj, const float* ln_s,
                                 const float* ln_b, const float* bias, const float* mask,
                                 void* qkv, void* ctx, void* out, int B, int Hres, int Wres, int C,
                                 int heads, int ws, cudaStream_t st) {
  const int M = B * Hres * Wres, n = ws * ws;
  cudaError_t err = launch_gemm_f32<float, true, false>(x, wqkv, bqkv, ln_s, ln_b, qkv, M, 3 * C,
                                                        C, st);
  if (err != cudaSuccess) return err;
  const size_t smem = sizeof(float) * (kAttnWarps + 1) * n;  // probabilities, token indices
  err = cudaFuncSetAttribute(window_attn_f32_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                             (int)smem);
  if (err != cudaSuccess) return err;
  const dim3 grid(B * (Hres / ws) * (Wres / ws), heads);
  window_attn_f32_kernel<<<grid, kAttnThreads, smem, st>>>(
      static_cast<const float*>(qkv), bias, mask, static_cast<float*>(ctx), Hres, Wres, C, heads,
      ws, 1.0f / sqrtf((float)(C / heads)));
  err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  return launch_gemm_f32<float, false, false>(ctx, wproj, bproj, nullptr, nullptr, out, M, C, C,
                                              st);
}

// plan: fused, mlp_stages, ln_form, ln_stages, stages, tiles per block of
// fc1.  With LN apart, the LayerNormed rows go through out, which fc2
// writes only after fc1.
cudaError_t ln_mlp_bf16(const void* x, const float* ln_s, const float* ln_b, const void* w1,
                        const float* b1, const void* w2, const float* b2, void* hbuf, void* out,
                        int M, int C, int F, const int* plan, cudaStream_t st) {
  if (plan[0]) return launch_mlp_fused(x, ln_s, ln_b, w1, b1, w2, b2, out, M, C, F, plan[1], st);
  cudaError_t err = launch_ln_gemm<true>(x, w1, b1, ln_s, ln_b, hbuf, M, F, C, plan[2], plan[3],
                                         plan[5], out, st);
  if (err != cudaSuccess) return err;
  return launch_gemm_tma<false, false>(hbuf, w2, b2, nullptr, nullptr, out, M, C, F, plan[4], 1,
                                       st);
}

cudaError_t ln_mlp_f32(const void* x, const float* ln_s, const float* ln_b, const void* w1,
                       const float* b1, const void* w2, const float* b2, void* hbuf, void* out,
                       int M, int C, int F, cudaStream_t st) {
  cudaError_t err = launch_gemm_f32<float, true, true>(x, w1, b1, ln_s, ln_b, hbuf, M, F, C, st);
  if (err != cudaSuccess) return err;
  return launch_gemm_f32<float, false, false>(hbuf, w2, b2, nullptr, nullptr, out, M, C, F, st);
}

}  // namespace mnx

extern "C" {

// Each returns a cudaError_t code (0 on success); a bad dtype or plan
// launches nothing.  The trailing ints are the wrapper's encoder_plan: K1's
// key tiles, head-dim tiles, windows per block, buffers, LN form, LN-GEMM
// stages, GEMM stages and QKV tiles per block; K2's fused flag, fused
// stages, LN form, LN-GEMM stages, GEMM stages and fc1 tiles per block.
// The float32 kernels do not read them.
int mnx_fused_window_attention(int dtype, const void* x, const void* wqkv,
                               const float* bqkv, const void* wproj,
                               const float* bproj, const float* ln_s,
                               const float* ln_b, const float* bias,
                               const float* mask, void* qkv_scratch,
                               void* ctx_scratch, void* out, int B, int Hres,
                               int Wres, int C, int heads, int ws, int kt, int ht, int wpb,
                               int nbuf, int ln_form, int ln_stages, int stages, int tiles,
                               void* stream) {
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (dtype == mnx::kF32)
    return mnx::window_attention_f32(x, wqkv, bqkv, wproj, bproj, ln_s, ln_b, bias, mask,
                                     qkv_scratch, ctx_scratch, out, B, Hres, Wres, C, heads, ws,
                                     st);
  if (dtype == mnx::kBF16) {
    const int plan[8] = {kt, ht, wpb, nbuf, ln_form, ln_stages, stages, tiles};
    return mnx::window_attention_bf16(x, wqkv, bqkv, wproj, bproj, ln_s, ln_b, bias, mask,
                                      qkv_scratch, ctx_scratch, out, B, Hres, Wres, C, heads, ws,
                                      plan, st);
  }
  return cudaErrorInvalidValue;
}

int mnx_fused_ln_mlp(int dtype, const void* x, const float* ln_s,
                     const float* ln_b, const void* w1, const float* b1,
                     const void* w2, const float* b2, void* h_scratch, void* out,
                     int M, int C, int F, int fused, int mlp_stages, int ln_form, int ln_stages,
                     int stages, int tiles, void* stream) {
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (dtype == mnx::kF32)
    return mnx::ln_mlp_f32(x, ln_s, ln_b, w1, b1, w2, b2, h_scratch, out, M, C, F, st);
  if (dtype == mnx::kBF16) {
    const int plan[6] = {fused, mlp_stages, ln_form, ln_stages, stages, tiles};
    return mnx::ln_mlp_bf16(x, ln_s, ln_b, w1, b1, w2, b2, h_scratch, out, M, C, F, plan, st);
  }
  return cudaErrorInvalidValue;
}

}  // extern "C"
