// K7, K8 and K9: causal flash attention for the decoder's teacher-forced
// self-attention, hand-written for Hopper (sm_90a).
//
// They replace the TPU kernels of JAX's library flash attention
// (jax/experimental/pallas/ops/tpu/flash_attention.py, JAX 0.9.0), which
// molnextr_tpu/models/decoder.py::MHA.__call__ calls with causal=True and
// sm_scale = hd ** -0.5:
//   K7 flash_fwd_*      <- _flash_attention_impl     (:589, pallas_call :758)
//   K8 flash_bwd_dkv_*  <- _flash_attention_bwd_dkv  (:941, pallas_call :1121)
//   K9 flash_bwd_dq_*   <- _flash_attention_bwd_dq   (:1287, pallas_call :1456)
// The math is that of ops/flash_attention.py's plain version (the library's
// mha_reference_no_custom_vjp and its backward formulas).  Per (b, h), with
// key j visible to query i when j <= i:
//   s = q k^T * scale in float32, lse_i = log sum_j exp(s_ij),
//   o = exp(s - lse) v;
//   backward, with di = sum(o * do, -1) in float32 from the wrapper (the
//   library computes it outside its kernels too):
//   p = exp(s - lse), dv = p^T do, ds = p * (do v^T - di) * scale,
//   dk = ds^T q, dq = ds k.
// The exponentials are taken as exp2 of s * scale * log2(e); lse is stored
// in natural units, float32, (B, H, T).
//
// What bounds them on the card: at the recipe's shape (B 256, H 8, T 256,
// d 32, bf16) bytes.  K7 reads q, k and v and writes o (33.5 MB each) for
// 2 * 2 * T (T + 1) / 2 * d operations per (b, h), about 64 operations per
// byte, under the H100's ridge of 295; K8 and K9 read q, k, v, do, lse and
// di and write dk, dv and dq.  The (B, H, T, T) scores and probabilities
// that the plain version materialises (537 MB each in float32 at that
// shape) never leave the SM.
//
// Design (a first, simple form; wgmma, TMA and warp specialisation are
// later work):
//   * bf16: one block of 4 warps per 64-row tile of one (b, h), each warp
//     16 rows; the products on the tensor cores (mma.sync m16n8k16, f32
//     accumulation), operands from shared memory by ldmatrix (rows padded
//     to 80 bytes: no bank conflicts).  The tiles the block walks (64 x 32
//     each) are double-buffered with cp.async, the next landing while the
//     current is multiplied.  The row tile's own operands stay in registers
//     as A fragments, and the probabilities go from the score accumulators
//     to A fragments in registers (rounded to bf16, as the library rounds p
//     and ds before its second products), never through shared memory.
//     - K7: one block per query tile, walking the key tiles 0 .. diagonal;
//       online softmax in float32 (running max and sum per row, the
//       accumulator rescaled by exp2(m_old - m_new)), o normalised once at
//       the end.  Query tiles run longest first.
//     - K8: one block per key tile, walking the query tiles diagonal .. end,
//       S^T = K Q^T and dP^T = V dO^T recomputed per tile from lse; dk and
//       dv accumulate in registers and are written once: no atomics.
//     - K9: one block per query tile, walking the key tiles 0 .. diagonal;
//       dq accumulates in registers.
//   * float32 (the parity runs): the same tiles on the CUDA cores, a thread
//     per row (K7, K9: a query row; K8: a key row) with its row's operands
//     and accumulators in registers, the walked tile in shared memory read
//     by every thread at one address (a broadcast).  K7 updates its online
//     softmax per key.
//   * strides: every (B, H, T, d) operand is read and written through its
//     own batch, head and row strides (the last dimension contiguous), so
//     the decoder's q, k and v are read in place from its qkv projection and
//     o is written straight into the (B, T, H * d) layout of the output
//     projection.  Rows and strides are 16-byte aligned (the wrapper checks).
//   * d = 32 only (the head width of both decoder configs) and T a multiple
//     of 64; the launchers refuse anything else.
#include "common.cuh"

namespace mnx {

constexpr int kFlashD = 32;              // head width
constexpr int kFlashTile = 64;           // rows of a tile (queries or keys)
constexpr int kFlashPitch = 40;          // bf16 elements of a staged row: 32 + 8 of padding
constexpr int kFlashThreads = 128;       // bf16 blocks: 4 warps of 16 rows
constexpr int kFlashF32Threads = 64;     // float32 blocks: a thread per row
constexpr float kLog2e = 1.4426950408889634f;
constexpr float kLn2 = 0.6931471805599453f;

// batch, head and row strides (in elements) of up to 6 (B, H, T, d) operands
struct FlashLayout {
  long long s[6][3];
};

typedef __nv_bfloat16 bf16;

// the (T, d) rows of head h of batch row b of operand `op`
template <typename P>
__device__ __forceinline__ P head_ptr(P base, const FlashLayout& lay, int op, int b, int h) {
  return base + b * lay.s[op][0] + h * lay.s[op][1];
}

__device__ __forceinline__ void cp_async16(void* dst, const void* src) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(smem_u32(dst)), "l"(src)
               : "memory");
}

// rows r0 .. r0 + 63 of a (T, 32) bf16 head at row stride st into a padded
// tile: 4 copies of 16 bytes a row, 2 a thread
__device__ __forceinline__ void stage_tile(bf16* dst, const bf16* src, long long st, int r0) {
  for (int i = threadIdx.x; i < kFlashTile * 4; i += kFlashThreads) {
    const int r = i >> 2, c = (i & 3) * 8;
    cp_async16(dst + r * kFlashPitch + c, src + (r0 + r) * st + c);
  }
}

// 64 floats (lse or di of a tile's rows), 16 copies of 16 bytes
__device__ __forceinline__ void stage_vec(float* dst, const float* src) {
  if (threadIdx.x < 16) cp_async16(dst + 4 * threadIdx.x, src + 4 * threadIdx.x);
}

// A fragments of rows warp * 16 .. + 15 of a staged tile, both 16-wide
// halves of d
__device__ __forceinline__ void load_a(uint32_t (&a)[2][4], const bf16* tile, int warp, int lane) {
#pragma unroll
  for (int kk = 0; kk < 2; ++kk)
    ldsm_x4(a[kk], tile + (warp * 16 + (lane & 15)) * kFlashPitch + kk * 16 + 8 * (lane >> 4));
}

// acc (16 x 64, c[4 * nt + e]: column 8 nt + 2 (lane & 3) + (e & 1), row
// (lane >> 2) + 8 (e >> 1)) = A (16 x 32) times the staged tile's rows
// transposed: acc[i][j] = sum_c a[i][c] tile[j][c]
__device__ __forceinline__ void mma_rows_t(float (&acc)[32], const uint32_t (&a)[2][4],
                                           const bf16* tile, int lane) {
#pragma unroll
  for (int i = 0; i < 32; ++i) acc[i] = 0.f;
#pragma unroll
  for (int kk = 0; kk < 2; ++kk) {
#pragma unroll
    for (int np = 0; np < 4; ++np) {
      uint32_t b[4];
      ldsm_x4(b, tile + (np * 16 + (lane & 7) + 8 * (lane >> 4)) * kFlashPitch + kk * 16 +
                     8 * ((lane >> 3) & 1));
      mma_16816(acc + 8 * np, a[kk], b[0], b[1]);
      mma_16816(acc + 8 * np + 4, a[kk], b[2], b[3]);
    }
  }
}

// the 16 x 64 values x (layout of mma_rows_t) rounded to bf16 as A
// fragments over 4 steps of 16 columns
__device__ __forceinline__ void to_a(uint32_t (&a)[4][4], const float (&x)[32]) {
#pragma unroll
  for (int j = 0; j < 4; ++j) {
    a[j][0] = pack_bf16(x[8 * j], x[8 * j + 1]);
    a[j][1] = pack_bf16(x[8 * j + 2], x[8 * j + 3]);
    a[j][2] = pack_bf16(x[8 * j + 4], x[8 * j + 5]);
    a[j][3] = pack_bf16(x[8 * j + 6], x[8 * j + 7]);
  }
}

// acc (16 x 32, c[4 * dn + e]) += A (16 x 64) times the staged tile (64 x 32)
__device__ __forceinline__ void mma_tile(float (&acc)[16], const uint32_t (&a)[4][4],
                                         const bf16* tile, int lane) {
#pragma unroll
  for (int j = 0; j < 4; ++j) {
#pragma unroll
    for (int dp = 0; dp < 2; ++dp) {
      uint32_t b[4];
      ldsm_x4_t(b, tile + (j * 16 + (lane & 7) + 8 * ((lane >> 3) & 1)) * kFlashPitch + dp * 16 +
                       8 * (lane >> 4));
      mma_16816(acc + 8 * dp, a[j], b[0], b[1]);
      mma_16816(acc + 8 * dp + 4, a[j], b[2], b[3]);
    }
  }
}

// rows r and r + 8 (r = the lane's row of the warp's 16) of a 16 x 32
// accumulator, times f0 and f1, to a bf16 (T, 32) head at row stride st
__device__ __forceinline__ void store_rows(bf16* dst, long long st, int r, const float (&acc)[16],
                                           float f0, float f1, int lane) {
#pragma unroll
  for (int dn = 0; dn < 4; ++dn) {
    const int c = 8 * dn + 2 * (lane & 3);
    *reinterpret_cast<__nv_bfloat162*>(dst + r * st + c) =
        __floats2bfloat162_rn(acc[4 * dn] * f0, acc[4 * dn + 1] * f0);
    *reinterpret_cast<__nv_bfloat162*>(dst + (r + 8) * st + c) =
        __floats2bfloat162_rn(acc[4 * dn + 2] * f1, acc[4 * dn + 3] * f1);
  }
}

// ---------------------------------------------------------------------------
// K7, bf16.  Operands: 0 q, 1 k, 2 v, 3 o.
// ---------------------------------------------------------------------------
__global__ void __launch_bounds__(kFlashThreads)
flash_fwd_bf16(const bf16* __restrict__ q, const bf16* __restrict__ k, const bf16* __restrict__ v,
               bf16* __restrict__ o, float* __restrict__ lse, int H, int T, FlashLayout lay,
               float scale_log2) {
  __shared__ __align__(16) bf16 qs[kFlashTile * kFlashPitch];
  __shared__ __align__(16) bf16 ks[2][kFlashTile * kFlashPitch];
  __shared__ __align__(16) bf16 vs[2][kFlashTile * kFlashPitch];
  const int nt_q = T / kFlashTile, qt = nt_q - 1 - blockIdx.x;  // longest rows first
  const int bh = blockIdx.y, b = bh / H, h = bh % H;
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5, g = lane >> 2, t4 = lane & 3;
  const bf16* qh = head_ptr(q, lay, 0, b, h);
  const bf16* kh = head_ptr(k, lay, 1, b, h);
  const bf16* vh = head_ptr(v, lay, 2, b, h);
  const long long sk = lay.s[1][2], sv = lay.s[2][2];

  stage_tile(qs, qh, lay.s[0][2], qt * kFlashTile);
  stage_tile(ks[0], kh, sk, 0);
  stage_tile(vs[0], vh, sv, 0);
  cp_async_commit();

  const int row = qt * kFlashTile + warp * 16 + g;  // this lane's rows: row, row + 8
  float m0 = -INFINITY, m1 = -INFINITY, l0 = 0.f, l1 = 0.f;  // l: this lane's partial sums
  float acc[16];
#pragma unroll
  for (int i = 0; i < 16; ++i) acc[i] = 0.f;
  uint32_t qa[2][4];

  for (int kt = 0; kt <= qt; ++kt) {
    const int cur = kt & 1;
    if (kt < qt) {
      stage_tile(ks[cur ^ 1], kh, sk, (kt + 1) * kFlashTile);
      stage_tile(vs[cur ^ 1], vh, sv, (kt + 1) * kFlashTile);
      cp_async_commit();
      cp_async_wait<1>();
    } else {
      cp_async_wait<0>();
    }
    __syncthreads();
    if (kt == 0) load_a(qa, qs, warp, lane);

    float s[32];
    mma_rows_t(s, qa, ks[cur], lane);
    float mx0 = m0, mx1 = m1;
#pragma unroll
    for (int i = 0; i < 32; ++i) {
      float x = s[i] * scale_log2;
      if (kt == qt) {
        const int key = kt * kFlashTile + 8 * (i >> 2) + 2 * t4 + (i & 1);
        if (key > row + 8 * ((i >> 1) & 1)) x = -INFINITY;
      }
      s[i] = x;
      if (i & 2) mx1 = fmaxf(mx1, x);
      else mx0 = fmaxf(mx0, x);
    }
#pragma unroll
    for (int off = 1; off <= 2; off <<= 1) {
      mx0 = fmaxf(mx0, __shfl_xor_sync(0xffffffffu, mx0, off));
      mx1 = fmaxf(mx1, __shfl_xor_sync(0xffffffffu, mx1, off));
    }
    // key 0 is visible to every row, so the maxima are finite from the
    // first tile on; the first tile's alpha is exp2(-inf) = 0
    const float a0 = exp2f(m0 - mx0), a1 = exp2f(m1 - mx1);
    m0 = mx0;
    m1 = mx1;
    float sum0 = 0.f, sum1 = 0.f;
#pragma unroll
    for (int i = 0; i < 32; ++i) {
      const float p = exp2f(s[i] - ((i & 2) ? m1 : m0));
      s[i] = p;
      if (i & 2) sum1 += p;
      else sum0 += p;
    }
    l0 = l0 * a0 + sum0;
    l1 = l1 * a1 + sum1;
#pragma unroll
    for (int i = 0; i < 16; ++i) acc[i] *= (i & 2) ? a1 : a0;
    uint32_t pa[4][4];
    to_a(pa, s);
    mma_tile(acc, pa, vs[cur], lane);
    __syncthreads();  // every warp is done with this buffer before it is refilled
  }
#pragma unroll
  for (int off = 1; off <= 2; off <<= 1) {
    l0 += __shfl_xor_sync(0xffffffffu, l0, off);
    l1 += __shfl_xor_sync(0xffffffffu, l1, off);
  }
  store_rows(head_ptr(o, lay, 3, b, h), lay.s[3][2], row, acc, 1.f / l0, 1.f / l1, lane);
  if (t4 == 0) {
    lse[(long long)bh * T + row] = (m0 + log2f(l0)) * kLn2;
    lse[(long long)bh * T + row + 8] = (m1 + log2f(l1)) * kLn2;
  }
}

// ---------------------------------------------------------------------------
// K8, bf16.  Operands: 0 q, 1 k, 2 v, 3 do, 4 dk, 5 dv.
// ---------------------------------------------------------------------------
__global__ void __launch_bounds__(kFlashThreads)
flash_bwd_dkv_bf16(const bf16* __restrict__ q, const bf16* __restrict__ k,
                   const bf16* __restrict__ v, const bf16* __restrict__ dout,
                   const float* __restrict__ lse, const float* __restrict__ di,
                   bf16* __restrict__ dk, bf16* __restrict__ dv, int H, int T, FlashLayout lay,
                   float scale, float scale_log2) {
  __shared__ __align__(16) bf16 ks[kFlashTile * kFlashPitch];
  __shared__ __align__(16) bf16 vs[kFlashTile * kFlashPitch];
  __shared__ __align__(16) bf16 qs[2][kFlashTile * kFlashPitch];
  __shared__ __align__(16) bf16 dos[2][kFlashTile * kFlashPitch];
  __shared__ __align__(16) float ls[2][kFlashTile];
  __shared__ __align__(16) float dis[2][kFlashTile];
  const int nt_q = T / kFlashTile, kt = blockIdx.x;  // key tile 0 walks the most
  const int bh = blockIdx.y, b = bh / H, h = bh % H;
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5, g = lane >> 2, t4 = lane & 3;
  const bf16* qh = head_ptr(q, lay, 0, b, h);
  const bf16* doh = head_ptr(dout, lay, 3, b, h);
  const float* lh = lse + (long long)bh * T;
  const float* dih = di + (long long)bh * T;
  const long long sq = lay.s[0][2], sdo = lay.s[3][2];

  stage_tile(ks, head_ptr(k, lay, 1, b, h), lay.s[1][2], kt * kFlashTile);
  stage_tile(vs, head_ptr(v, lay, 2, b, h), lay.s[2][2], kt * kFlashTile);
  stage_tile(qs[0], qh, sq, kt * kFlashTile);
  stage_tile(dos[0], doh, sdo, kt * kFlashTile);
  stage_vec(ls[0], lh + kt * kFlashTile);
  stage_vec(dis[0], dih + kt * kFlashTile);
  cp_async_commit();

  const int key = kt * kFlashTile + warp * 16 + g;  // this lane's keys: key, key + 8
  float dka[16], dva[16];
#pragma unroll
  for (int i = 0; i < 16; ++i) dka[i] = dva[i] = 0.f;
  uint32_t ka[2][4], va[2][4];

  for (int qt = kt; qt < nt_q; ++qt) {
    const int cur = (qt - kt) & 1;
    if (qt + 1 < nt_q) {
      const int r0 = (qt + 1) * kFlashTile;
      stage_tile(qs[cur ^ 1], qh, sq, r0);
      stage_tile(dos[cur ^ 1], doh, sdo, r0);
      stage_vec(ls[cur ^ 1], lh + r0);
      stage_vec(dis[cur ^ 1], dih + r0);
      cp_async_commit();
      cp_async_wait<1>();
    } else {
      cp_async_wait<0>();
    }
    __syncthreads();
    if (qt == kt) {
      load_a(ka, ks, warp, lane);
      load_a(va, vs, warp, lane);
    }
    float st[32], dpt[32];  // S^T and dP^T: 16 keys x 64 queries
    mma_rows_t(st, ka, qs[cur], lane);
    mma_rows_t(dpt, va, dos[cur], lane);
#pragma unroll
    for (int i = 0; i < 32; ++i) {
      const int c = 8 * (i >> 2) + 2 * t4 + (i & 1);  // query within the tile
      float p = exp2f(st[i] * scale_log2 - ls[cur][c] * kLog2e);
      if (qt == kt && c < key - kt * kFlashTile + 8 * ((i >> 1) & 1)) p = 0.f;
      st[i] = p;
      dpt[i] = p * (dpt[i] - dis[cur][c]) * scale;
    }
    uint32_t pa[4][4], dsa[4][4];
    to_a(pa, st);
    to_a(dsa, dpt);
    mma_tile(dva, pa, dos[cur], lane);
    mma_tile(dka, dsa, qs[cur], lane);
    __syncthreads();
  }
  store_rows(head_ptr(dk, lay, 4, b, h), lay.s[4][2], key, dka, 1.f, 1.f, lane);
  store_rows(head_ptr(dv, lay, 5, b, h), lay.s[5][2], key, dva, 1.f, 1.f, lane);
}

// ---------------------------------------------------------------------------
// K9, bf16.  Operands: 0 q, 1 k, 2 v, 3 do, 4 dq.
// ---------------------------------------------------------------------------
__global__ void __launch_bounds__(kFlashThreads)
flash_bwd_dq_bf16(const bf16* __restrict__ q, const bf16* __restrict__ k,
                  const bf16* __restrict__ v, const bf16* __restrict__ dout,
                  const float* __restrict__ lse, const float* __restrict__ di,
                  bf16* __restrict__ dq, int H, int T, FlashLayout lay, float scale,
                  float scale_log2) {
  __shared__ __align__(16) bf16 qs[kFlashTile * kFlashPitch];
  __shared__ __align__(16) bf16 dos[kFlashTile * kFlashPitch];
  __shared__ __align__(16) bf16 ks[2][kFlashTile * kFlashPitch];
  __shared__ __align__(16) bf16 vs[2][kFlashTile * kFlashPitch];
  const int nt_q = T / kFlashTile, qt = nt_q - 1 - blockIdx.x;
  const int bh = blockIdx.y, b = bh / H, h = bh % H;
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5, g = lane >> 2, t4 = lane & 3;
  const bf16* kh = head_ptr(k, lay, 1, b, h);
  const bf16* vh = head_ptr(v, lay, 2, b, h);
  const long long sk = lay.s[1][2], sv = lay.s[2][2];

  stage_tile(qs, head_ptr(q, lay, 0, b, h), lay.s[0][2], qt * kFlashTile);
  stage_tile(dos, head_ptr(dout, lay, 3, b, h), lay.s[3][2], qt * kFlashTile);
  stage_tile(ks[0], kh, sk, 0);
  stage_tile(vs[0], vh, sv, 0);
  cp_async_commit();

  const int row = qt * kFlashTile + warp * 16 + g;
  const float lse0 = lse[(long long)bh * T + row] * kLog2e;
  const float lse1 = lse[(long long)bh * T + row + 8] * kLog2e;
  const float di0 = di[(long long)bh * T + row], di1 = di[(long long)bh * T + row + 8];
  float dqa[16];
#pragma unroll
  for (int i = 0; i < 16; ++i) dqa[i] = 0.f;
  uint32_t qa[2][4], da[2][4];

  for (int kt = 0; kt <= qt; ++kt) {
    const int cur = kt & 1;
    if (kt < qt) {
      stage_tile(ks[cur ^ 1], kh, sk, (kt + 1) * kFlashTile);
      stage_tile(vs[cur ^ 1], vh, sv, (kt + 1) * kFlashTile);
      cp_async_commit();
      cp_async_wait<1>();
    } else {
      cp_async_wait<0>();
    }
    __syncthreads();
    if (kt == 0) {
      load_a(qa, qs, warp, lane);
      load_a(da, dos, warp, lane);
    }
    float s[32], dp[32];  // S and dP: 16 queries x 64 keys
    mma_rows_t(s, qa, ks[cur], lane);
    mma_rows_t(dp, da, vs[cur], lane);
#pragma unroll
    for (int i = 0; i < 32; ++i) {
      const bool hi = (i >> 1) & 1;
      float p = exp2f(s[i] * scale_log2 - (hi ? lse1 : lse0));
      if (kt == qt) {
        const int key = kt * kFlashTile + 8 * (i >> 2) + 2 * t4 + (i & 1);
        if (key > row + 8 * hi) p = 0.f;
      }
      s[i] = p * (dp[i] - (hi ? di1 : di0)) * scale;
    }
    uint32_t dsa[4][4];
    to_a(dsa, s);
    mma_tile(dqa, dsa, ks[cur], lane);
    __syncthreads();
  }
  store_rows(head_ptr(dq, lay, 4, b, h), lay.s[4][2], row, dqa, 1.f, 1.f, lane);
}

// ---------------------------------------------------------------------------
// float32 on the CUDA cores: a thread per row, the walked 64-row tiles in
// shared memory ([64][32] floats, read at one address by every thread).
// ---------------------------------------------------------------------------

// rows r0 .. r0 + 63 of a (T, 32) float32 head into a [64][32] tile
__device__ __forceinline__ void load_tile_f32(float* dst, const float* src, long long st, int r0) {
  for (int i = threadIdx.x; i < kFlashTile * 8; i += kFlashF32Threads) {
    const int r = i >> 3, c = (i & 7) * 4;
    *reinterpret_cast<float4*>(dst + r * kFlashD + c) =
        *reinterpret_cast<const float4*>(src + (r0 + r) * st + c);
  }
}

__device__ __forceinline__ void load_row_f32(float (&x)[kFlashD], const float* src, float f) {
#pragma unroll
  for (int c = 0; c < kFlashD; c += 4) {
    const float4 v4 = *reinterpret_cast<const float4*>(src + c);
    x[c] = v4.x * f;
    x[c + 1] = v4.y * f;
    x[c + 2] = v4.z * f;
    x[c + 3] = v4.w * f;
  }
}

__device__ __forceinline__ void store_row_f32(float* dst, const float (&x)[kFlashD], float f) {
#pragma unroll
  for (int c = 0; c < kFlashD; c += 4)
    *reinterpret_cast<float4*>(dst + c) = make_float4(x[c] * f, x[c + 1] * f, x[c + 2] * f, x[c + 3] * f);
}

__device__ __forceinline__ float dot32(const float (&x)[kFlashD], const float* y) {
  float s = 0.f;
#pragma unroll
  for (int c = 0; c < kFlashD; ++c) s = fmaf(x[c], y[c], s);
  return s;
}

// K7, float32
__global__ void __launch_bounds__(kFlashF32Threads)
flash_fwd_f32(const float* __restrict__ q, const float* __restrict__ k,
              const float* __restrict__ v, float* __restrict__ o, float* __restrict__ lse, int H,
              int T, FlashLayout lay, float scale_log2) {
  __shared__ __align__(16) float ks[kFlashTile * kFlashD];
  __shared__ __align__(16) float vs[kFlashTile * kFlashD];
  const int qt = T / kFlashTile - 1 - blockIdx.x;
  const int bh = blockIdx.y, b = bh / H, h = bh % H;
  const int row = qt * kFlashTile + threadIdx.x;
  const float* kh = head_ptr(k, lay, 1, b, h);
  const float* vh = head_ptr(v, lay, 2, b, h);
  float qr[kFlashD], acc[kFlashD];
  load_row_f32(qr, head_ptr(q, lay, 0, b, h) + row * lay.s[0][2], scale_log2);
#pragma unroll
  for (int c = 0; c < kFlashD; ++c) acc[c] = 0.f;
  float m = -INFINITY, l = 0.f;
  for (int kt = 0; kt <= qt; ++kt) {
    __syncthreads();
    load_tile_f32(ks, kh, lay.s[1][2], kt * kFlashTile);
    load_tile_f32(vs, vh, lay.s[2][2], kt * kFlashTile);
    __syncthreads();
    const int nk = kt == qt ? threadIdx.x + 1 : kFlashTile;
    for (int j = 0; j < nk; ++j) {
      const float s = dot32(qr, ks + j * kFlashD);
      const float mn = fmaxf(m, s), a = exp2f(m - mn), p = exp2f(s - mn);
      l = l * a + p;
#pragma unroll
      for (int c = 0; c < kFlashD; ++c) acc[c] = fmaf(p, vs[j * kFlashD + c], acc[c] * a);
      m = mn;
    }
  }
  store_row_f32(head_ptr(o, lay, 3, b, h) + row * lay.s[3][2], acc, 1.f / l);
  lse[(long long)bh * T + row] = (m + log2f(l)) * kLn2;
}

// K8, float32: a thread per key row
__global__ void __launch_bounds__(kFlashF32Threads)
flash_bwd_dkv_f32(const float* __restrict__ q, const float* __restrict__ k,
                  const float* __restrict__ v, const float* __restrict__ dout,
                  const float* __restrict__ lse, const float* __restrict__ di,
                  float* __restrict__ dk, float* __restrict__ dv, int H, int T, FlashLayout lay,
                  float scale, float scale_log2) {
  __shared__ __align__(16) float qs[kFlashTile * kFlashD];
  __shared__ __align__(16) float dos[kFlashTile * kFlashD];
  __shared__ float ls[kFlashTile], dis[kFlashTile];
  const int nt_q = T / kFlashTile, kt = blockIdx.x;
  const int bh = blockIdx.y, b = bh / H, h = bh % H;
  const int key = kt * kFlashTile + threadIdx.x;
  const float* qh = head_ptr(q, lay, 0, b, h);
  const float* doh = head_ptr(dout, lay, 3, b, h);
  float kr[kFlashD], vr[kFlashD], dka[kFlashD], dva[kFlashD];
  load_row_f32(kr, head_ptr(k, lay, 1, b, h) + key * lay.s[1][2], scale_log2);
  load_row_f32(vr, head_ptr(v, lay, 2, b, h) + key * lay.s[2][2], 1.f);
#pragma unroll
  for (int c = 0; c < kFlashD; ++c) dka[c] = dva[c] = 0.f;
  for (int qt = kt; qt < nt_q; ++qt) {
    __syncthreads();
    load_tile_f32(qs, qh, lay.s[0][2], qt * kFlashTile);
    load_tile_f32(dos, doh, lay.s[3][2], qt * kFlashTile);
    ls[threadIdx.x] = lse[(long long)bh * T + qt * kFlashTile + threadIdx.x] * kLog2e;
    dis[threadIdx.x] = di[(long long)bh * T + qt * kFlashTile + threadIdx.x];
    __syncthreads();
    for (int i = qt == kt ? threadIdx.x : 0; i < kFlashTile; ++i) {
      const float p = exp2f(dot32(kr, qs + i * kFlashD) - ls[i]);
      const float ds = p * (dot32(vr, dos + i * kFlashD) - dis[i]) * scale;
#pragma unroll
      for (int c = 0; c < kFlashD; ++c) {
        dva[c] = fmaf(p, dos[i * kFlashD + c], dva[c]);
        dka[c] = fmaf(ds, qs[i * kFlashD + c], dka[c]);
      }
    }
  }
  store_row_f32(head_ptr(dk, lay, 4, b, h) + key * lay.s[4][2], dka, 1.f);
  store_row_f32(head_ptr(dv, lay, 5, b, h) + key * lay.s[5][2], dva, 1.f);
}

// K9, float32: a thread per query row
__global__ void __launch_bounds__(kFlashF32Threads)
flash_bwd_dq_f32(const float* __restrict__ q, const float* __restrict__ k,
                 const float* __restrict__ v, const float* __restrict__ dout,
                 const float* __restrict__ lse, const float* __restrict__ di,
                 float* __restrict__ dq, int H, int T, FlashLayout lay, float scale,
                 float scale_log2) {
  __shared__ __align__(16) float ks[kFlashTile * kFlashD];
  __shared__ __align__(16) float vs[kFlashTile * kFlashD];
  const int qt = T / kFlashTile - 1 - blockIdx.x;
  const int bh = blockIdx.y, b = bh / H, h = bh % H;
  const int row = qt * kFlashTile + threadIdx.x;
  const float* kh = head_ptr(k, lay, 1, b, h);
  const float* vh = head_ptr(v, lay, 2, b, h);
  float qr[kFlashD], dor[kFlashD], dqa[kFlashD];
  load_row_f32(qr, head_ptr(q, lay, 0, b, h) + row * lay.s[0][2], scale_log2);
  load_row_f32(dor, head_ptr(dout, lay, 3, b, h) + row * lay.s[3][2], 1.f);
#pragma unroll
  for (int c = 0; c < kFlashD; ++c) dqa[c] = 0.f;
  const float l2 = lse[(long long)bh * T + row] * kLog2e, dir = di[(long long)bh * T + row];
  for (int kt = 0; kt <= qt; ++kt) {
    __syncthreads();
    load_tile_f32(ks, kh, lay.s[1][2], kt * kFlashTile);
    load_tile_f32(vs, vh, lay.s[2][2], kt * kFlashTile);
    __syncthreads();
    const int nk = kt == qt ? threadIdx.x + 1 : kFlashTile;
    for (int j = 0; j < nk; ++j) {
      const float p = exp2f(dot32(qr, ks + j * kFlashD) - l2);
      const float ds = p * (dot32(dor, vs + j * kFlashD) - dir) * scale;
#pragma unroll
      for (int c = 0; c < kFlashD; ++c) dqa[c] = fmaf(ds, ks[j * kFlashD + c], dqa[c]);
    }
  }
  store_row_f32(head_ptr(dq, lay, 4, b, h) + row * lay.s[4][2], dqa, 1.f);
}

FlashLayout flash_layout(const long long* strides, int ops) {
  FlashLayout lay{};
  for (int i = 0; i < ops; ++i)
    for (int j = 0; j < 3; ++j) lay.s[i][j] = strides[3 * i + j];
  return lay;
}

bool flash_shape_ok(int B, int H, int T, int d) {
  return d == kFlashD && T > 0 && T % kFlashTile == 0 && B > 0 && H > 0 &&
         (long long)B * H <= 65535;
}

}  // namespace mnx

extern "C" {

// q, k, v, o (B, H, T, 32) in one dtype through their (batch, head, row)
// strides in `strides` (4 x 3 elements), each row contiguous and 16-byte
// aligned; lse (B, H, T) float32 contiguous; T a multiple of 64, B * H at
// most 65535.  The wrapper checks these.  Returns a cudaError_t code.
int mnx_flash_attention_fwd(int dtype, const void* q, const void* k, const void* v, void* o,
                            float* lse, int B, int H, int T, int d, const long long* strides,
                            float sm_scale, void* stream) {
  if (!mnx::flash_shape_ok(B, H, T, d)) return cudaErrorInvalidValue;
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  const mnx::FlashLayout lay = mnx::flash_layout(strides, 4);
  const dim3 grid(T / mnx::kFlashTile, B * H);
  const float sl = sm_scale * mnx::kLog2e;
  if (dtype == mnx::kBF16)
    mnx::flash_fwd_bf16<<<grid, mnx::kFlashThreads, 0, st>>>(
        static_cast<const mnx::bf16*>(q), static_cast<const mnx::bf16*>(k),
        static_cast<const mnx::bf16*>(v), static_cast<mnx::bf16*>(o), lse, H, T, lay, sl);
  else if (dtype == mnx::kF32)
    mnx::flash_fwd_f32<<<grid, mnx::kFlashF32Threads, 0, st>>>(
        static_cast<const float*>(q), static_cast<const float*>(k), static_cast<const float*>(v),
        static_cast<float*>(o), lse, H, T, lay, sl);
  else
    return cudaErrorInvalidValue;
  return cudaGetLastError();
}

// q, k, v, do, dk, dv (B, H, T, 32) through their strides (6 x 3); lse and
// di (B, H, T) float32 contiguous.
int mnx_flash_attention_bwd_dkv(int dtype, const void* q, const void* k, const void* v,
                                const void* dout, const float* lse, const float* di, void* dk,
                                void* dv, int B, int H, int T, int d, const long long* strides,
                                float sm_scale, void* stream) {
  if (!mnx::flash_shape_ok(B, H, T, d)) return cudaErrorInvalidValue;
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  const mnx::FlashLayout lay = mnx::flash_layout(strides, 6);
  const dim3 grid(T / mnx::kFlashTile, B * H);
  const float sl = sm_scale * mnx::kLog2e;
  if (dtype == mnx::kBF16)
    mnx::flash_bwd_dkv_bf16<<<grid, mnx::kFlashThreads, 0, st>>>(
        static_cast<const mnx::bf16*>(q), static_cast<const mnx::bf16*>(k),
        static_cast<const mnx::bf16*>(v), static_cast<const mnx::bf16*>(dout), lse, di,
        static_cast<mnx::bf16*>(dk), static_cast<mnx::bf16*>(dv), H, T, lay, sm_scale, sl);
  else if (dtype == mnx::kF32)
    mnx::flash_bwd_dkv_f32<<<grid, mnx::kFlashF32Threads, 0, st>>>(
        static_cast<const float*>(q), static_cast<const float*>(k), static_cast<const float*>(v),
        static_cast<const float*>(dout), lse, di, static_cast<float*>(dk),
        static_cast<float*>(dv), H, T, lay, sm_scale, sl);
  else
    return cudaErrorInvalidValue;
  return cudaGetLastError();
}

// q, k, v, do, dq (B, H, T, 32) through their strides (5 x 3); lse and di
// (B, H, T) float32 contiguous.
int mnx_flash_attention_bwd_dq(int dtype, const void* q, const void* k, const void* v,
                               const void* dout, const float* lse, const float* di, void* dq,
                               int B, int H, int T, int d, const long long* strides,
                               float sm_scale, void* stream) {
  if (!mnx::flash_shape_ok(B, H, T, d)) return cudaErrorInvalidValue;
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  const mnx::FlashLayout lay = mnx::flash_layout(strides, 5);
  const dim3 grid(T / mnx::kFlashTile, B * H);
  const float sl = sm_scale * mnx::kLog2e;
  if (dtype == mnx::kBF16)
    mnx::flash_bwd_dq_bf16<<<grid, mnx::kFlashThreads, 0, st>>>(
        static_cast<const mnx::bf16*>(q), static_cast<const mnx::bf16*>(k),
        static_cast<const mnx::bf16*>(v), static_cast<const mnx::bf16*>(dout), lse, di,
        static_cast<mnx::bf16*>(dq), H, T, lay, sm_scale, sl);
  else if (dtype == mnx::kF32)
    mnx::flash_bwd_dq_f32<<<grid, mnx::kFlashF32Threads, 0, st>>>(
        static_cast<const float*>(q), static_cast<const float*>(k), static_cast<const float*>(v),
        static_cast<const float*>(dout), lse, di, static_cast<float*>(dq), H, T, lay, sm_scale,
        sl);
  else
    return cudaErrorInvalidValue;
  return cudaGetLastError();
}

}  // extern "C"
