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
// in natural units, float32, (B, H, T).  p and ds are rounded to bf16
// before their second products, where the library rounds them.
//
// What bounds them on the card: bytes.  At the recipe's shape (B 256, H 8,
// T 256, d 32, bf16) K7 reads q, k and v and writes o (33.5 MB each) for
// 2 * 2 * T (T + 1) / 2 * d operations per (b, h), about 64 operations per
// byte, under the H100's ridge of 295; K8 reads q, k, v, do, lse and di and
// writes dk and dv; K9 reads the same and writes dq.  The (B, H, T, T)
// scores and probabilities that the plain version materialises (537 MB each
// in float32 at that shape) never leave the SM.  So the kernels have to
// read each operand once, keep enough loads in flight to cover the latency
// of device memory, and write whole rows; the tensor cores are far from
// their limit.
//
// bf16 K7 and K8 (TMA and wgmma):
//   * One pass over each head's operands.  A persistent block (two consumer
//     warpgroups and one producer warp, one block an SM) walks the (b, h)
//     heads from blockIdx.x in steps of gridDim.x.  It owns every query
//     tile of a head in K7 and every key tile in K8, so each K and V tile
//     (K7), or each Q, dO, lse and di tile (K8), is loaded once per head
//     into a ring of shared-memory stages and read there by every tile that
//     needs it.
//   * Balanced tile pairs.  With nt = T / 64 tiles, warpgroup g of round r
//     takes pair p = 2 r + g: tiles p and nt - 1 - p (one tile when they
//     are the same, for odd nt).  A round streams the tiles its pairs need,
//     K7 key tiles 0 .. nt - 1 - 2 r, K8 query tiles 2 r .. nt - 1, and
//     each warpgroup applies a streamed tile to those of its pair that see
//     it: nt + 1 tile-steps a round (5 at T 256, one round a head), where a
//     block per tile would walk 1 to 4.  At T 256 and T 128 a head is
//     one round and each tile is loaded once; a longer T takes more rounds,
//     each streaming its tiles again (from L2, mostly).
//   * TMA into mbarrier rings, fed by the producer warp.  Each input has a
//     4-D tensor map over (d, T, H, B) with its own row, head and batch
//     strides (the decoder's q, k and v are read in place from its qkv
//     projection); a box is 64 rows of 64 bytes, 64-byte swizzled.  The
//     stream's ring (K7: 12 stages of a K and a V box; K8: 8 stages of a Q
//     and a dO box and 64 lse and 64 di, the vectors by bulk copy) and each
//     warpgroup's two slots for its pair's own tiles (K7: Q; K8: K and V)
//     take the next round's and the next head's loads while the consumers
//     finish the current one.  A long T streams through the ring; nothing
//     needs the whole head in shared memory.
//   * wgmma.  K7: S = Q K^T by m64n64k16 (two k16 steps over d = 32, both
//     operands K-major boxes), the online softmax in float32 on the
//     accumulator fragments, then O += P V by m64n32k16 with P from
//     registers as the A operand and V an MN-major B; where a key tile
//     reaches both tiles of the pair, the two run in lockstep (one wait for
//     both products).  K8: S^T = K Q^T and dP^T = V dO^T by m64n64k16, then
//     dV += P^T dO and dK += dS^T Q by m64n32k16 with P^T and dS^T from
//     registers and dO and Q as MN-major B; dK and dV accumulate in
//     registers for both tiles of the pair and are written once: no
//     atomics.  The causal mask applies on the diagonal tile only.
//   * Whole-row epilogues: each warp stages its 16 rows of o, dk or dv in
//     shared memory and writes them as whole 64-byte rows, 16 bytes a lane,
//     into the (B, T, H, d) buffers the wrapper allocates; K7's lse goes out
//     as runs of contiguous floats.
//   * What is left: at the recipe's shape both kernels take about twice
//     their bound (PERF.md).  Their operands arrive ahead of use; each
//     warpgroup's steps are a chain (products, then the softmax's 32
//     exponentials a lane on the SM's 16-a-clock special-function units,
//     then products), and two warpgroups an SM, all the registers allow
//     (K7 168 a thread, K8 168), do not hide it.
//
// bf16 K9: one block of 4 warps
// per 64-row query tile of one (b, h), each warp 16 rows, walking the key
// tiles 0 .. diagonal through a two-slot cp.async ring (rows padded to 80
// bytes, read by ldmatrix), the products by mma.sync m16n8k16 with f32
// accumulation, the tile's own operands and ds as A fragments in
// registers; dq accumulates in registers.
//
// float32 (the parity runs): the same tiles on the CUDA cores, a thread per
// row (K7, K9: a query row; K8: a key row) with its row's operands and
// accumulators in registers, the walked tile in shared memory read by every
// thread at one address (a broadcast).  K7 updates its online softmax per
// key.
//
// Strides: every (B, H, T, d) operand is read and written through its own
// batch, head and row strides (the last dimension contiguous); rows, strides
// and lse and di are 16-byte aligned (the wrapper checks).  d = 32 only (the
// head width of both decoder configs), T a multiple of 64 and B * H at most
// 65535; the launchers refuse anything else.
#include "common.cuh"

namespace mnx {

constexpr int kFlashD = 32;              // head width
constexpr int kFlashTile = 64;           // rows of a tile (queries or keys)
constexpr int kFlashPitch = 40;          // bf16 elements of a staged row: 32 + 8 of padding
constexpr int kFlashThreads = 128;       // K9's bf16 blocks: 4 warps of 16 rows
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

// the 16 x 64 values x (layout of mma_rows_t, which is also a warp's share
// of a wgmma m64n64 accumulator) rounded to bf16 as A fragments over 4
// steps of 16 columns (mma.sync's layout, and wgmma's for A in registers)
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
// bf16 K7 and K8 on Hopper: 64 x 32 bf16 boxes (64-byte rows, 8-row groups
// 512 bytes apart) landed by TMA with CU_TENSOR_MAP_SWIZZLE_64B and read by
// wgmma through descriptors of that swizzle.  The same box serves as a
// K-major operand (rows = M or N, the 64 bytes = d: a k16 step is the box's
// address + 32 bytes) and as an MN-major B (rows = K, the 64 bytes = N =
// d: a k16 step is the next 16 rows, + 1024 bytes).
// ---------------------------------------------------------------------------

constexpr int kBoxBytes = kFlashTile * kFlashD * 2;   // 4096
constexpr int kConsumers = 2;                          // consumer warpgroups a block
constexpr int kHopperThreads = 128 * kConsumers + 32;  // and one producer warp
constexpr int kProducer = 4 * kConsumers;              // the producer's warp
constexpr int kFwdStages = 12;                         // K7's ring: a K and a V box a stage
constexpr int kFwdStage = 2 * kBoxBytes;
constexpr int kBwdStages = 8;                          // K8's ring: Q, dO, lse and di
constexpr int kBwdStage = 2 * kBoxBytes + 1024;        // lse at 8192, di at 8448
constexpr int kVecBytes = kFlashTile * 4;              // 64 floats
constexpr int kOwnSlots = 2;                           // slots of a warpgroup's own tiles

static_assert(kEmptyArrivals == 4 * kConsumers, "a stage is released by every consumer warp");

__device__ __forceinline__ uint64_t sw64_desc(const void* p, uint32_t lbo) {
  return (uint64_t)((smem_u32(p) & 0x3FFFF) >> 4) | ((uint64_t)(lbo >> 4) << 16) |
         ((uint64_t)(512 >> 4) << 32) | (2ull << 62);
}
// K-major (the leading offset is not read for a swizzled K-major operand)
__device__ __forceinline__ uint64_t kmajor(const void* p) { return sw64_desc(p, 16); }
// MN-major: N = 32 is one swizzle width, so only the 8-row stride is read
__device__ __forceinline__ uint64_t mnmajor(const void* p) { return sw64_desc(p, 512); }

// d (64 x 64, f32) = A (64 x 16) B (16 x 64) + (accumulate ? d : 0), both
// K-major boxes in shared memory
__device__ __forceinline__ void wgmma_ss(float (&d)[32], uint64_t a, uint64_t b, int accumulate) {
  asm volatile(
      "{\n"
      ".reg .pred p;\n"
      "setp.ne.b32 p, %34, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31}, "
      "%32, %33, p, 1, 1, 0, 0;\n"
      "}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]),
        "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]),
        "+f"(d[13]), "+f"(d[14]), "+f"(d[15]), "+f"(d[16]), "+f"(d[17]), "+f"(d[18]),
        "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]), "+f"(d[24]),
        "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]),
        "+f"(d[31])
      : "l"(a), "l"(b), "r"(accumulate));
}

// d (64 x 32, f32) += A (64 x 16, bf16 fragments in registers, the layout
// of to_a) B (16 x 32, an MN-major box)
__device__ __forceinline__ void wgmma_rs(float (&d)[16], const uint32_t (&a)[4], uint64_t b) {
  asm volatile(
      "{\n"
      ".reg .pred p;\n"
      "setp.ne.b32 p, %21, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n32k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15}, "
      "{%16, %17, %18, %19}, %20, p, 1, 1, 1;\n"
      "}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]),
        "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]),
        "+f"(d[13]), "+f"(d[14]), "+f"(d[15])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(b), "r"(1));
}

// registers that an asynchronous wgmma reads or writes are held in place
// until its wait: no instruction moves across this point
template <int N> __device__ __forceinline__ void hold(float (&r)[N]) {
#pragma unroll
  for (int i = 0; i < N; ++i) asm volatile("" : "+f"(r[i])::"memory");
}
__device__ __forceinline__ void hold(uint32_t (&r)[4][4]) {
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int j = 0; j < 4; ++j) asm volatile("" : "+r"(r[i][j])::"memory");
}

// rows row .. row + 63 of the (b, h) head of `map` into `dst`
__device__ __forceinline__ void tma_load_rows(void* dst, const CUtensorMap* map, uint64_t* bar,
                                              int row, int h, int b) {
  asm volatile(
      "cp.async.bulk.tensor.4d.shared::cluster.global.mbarrier::complete_tx::bytes "
      "[%0], [%1, {%3, %4, %5, %6}], [%2];\n" ::"r"(smem_u32(dst)),
      "l"(reinterpret_cast<uint64_t>(map)), "r"(smem_u32(bar)), "r"(0), "r"(row), "r"(h), "r"(b)
      : "memory");
}

// `bytes` contiguous bytes (16-byte aligned) into `dst`
__device__ __forceinline__ void bulk_load(void* dst, const void* src, uint32_t bytes, uint64_t* bar) {
  asm volatile(
      "cp.async.bulk.shared::cluster.global.mbarrier::complete_tx::bytes [%0], [%1], %2, [%3];\n" ::"r"(
          smem_u32(dst)),
      "l"(src), "r"(bytes), "r"(smem_u32(bar))
      : "memory");
}

// The epilogue of a 64 x 32 accumulator, a warp at a time: the warp's 16
// rows of wgmma's fragments (c[4 j + e] at row 16 w + (lane >> 2) + 8 (e >>
// 1), column 8 j + 2 (lane & 3) + (e & 1)), rows scaled by f0 and f1,
// rounded to bf16 into rows 16 w .. 16 w + 15 of a box of plain 64-byte
// rows (stage_box); then those rows out as whole 64-byte rows, 16 bytes a
// lane (store_rows16).  The warp reads only its own rows, so __syncwarp
// orders it all.
__device__ __forceinline__ void stage_box(uint8_t* box, const float (&acc)[16], float f0, float f1,
                                          int w, int lane) {
  const int r = 16 * w + (lane >> 2);
#pragma unroll
  for (int j = 0; j < 4; ++j) {
    const int c = 8 * j + 2 * (lane & 3);
    *reinterpret_cast<__nv_bfloat162*>(box + r * 64 + 2 * c) =
        __floats2bfloat162_rn(acc[4 * j] * f0, acc[4 * j + 1] * f0);
    *reinterpret_cast<__nv_bfloat162*>(box + (r + 8) * 64 + 2 * c) =
        __floats2bfloat162_rn(acc[4 * j + 2] * f1, acc[4 * j + 3] * f1);
  }
}
// rows 16 w .. 16 w + 15 of a staged box to rows row0 + 16 w .. of a (T, 32)
// head at row stride st
__device__ __forceinline__ void store_rows16(bf16* __restrict__ head, long long st, int row0,
                                             const uint8_t* box, int w, int lane) {
#pragma unroll
  for (int i = lane; i < 64; i += 32) {
    const int r = 16 * w + (i >> 2), c = i & 3;
    *reinterpret_cast<uint4*>(head + (row0 + r) * st + 8 * c) =
        *reinterpret_cast<const uint4*>(box + r * 64 + 16 * c);
  }
}

constexpr int kMaxFlashStages = kFwdStages > kBwdStages ? kFwdStages : kBwdStages;

// The mbarriers of a block: the stream's ring (full: the producer's arrival
// and the bytes; empty: lane 0 of every consumer warp) and each consumer
// warpgroup's kOwnSlots slots for its pair's own tiles (empty: lane 0 of
// each of its warps), so that the producer runs a head ahead.
struct FlashBars {
  uint64_t full[kMaxFlashStages], empty[kMaxFlashStages];
  uint64_t own_full[kConsumers][kOwnSlots], own_empty[kConsumers][kOwnSlots];
  __device__ __forceinline__ void init(int stages) {
    if (threadIdx.x == 0) {
      for (int s = 0; s < stages; ++s) {
        mbar_init(&full[s], 1);
        mbar_init(&empty[s], kEmptyArrivals);
      }
      for (int g = 0; g < kConsumers; ++g)
        for (int s = 0; s < kOwnSlots; ++s) {
          mbar_init(&own_full[g][s], 1);
          mbar_init(&own_empty[g][s], 4);
        }
      asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
    }
    __syncthreads();
  }
  // producer: own slot of warpgroup g's n-th pair, once its use kOwnSlots
  // pairs before is released, armed for `bytes`
  __device__ __forceinline__ int own_acquire(int g, int n, uint32_t bytes) {
    const int s = n % kOwnSlots, use = n / kOwnSlots;
    if (use > 0) mbar_wait(&own_empty[g][s], (use - 1) & 1);
    mbar_expect_tx(&own_full[g][s], bytes);
    return s;
  }
  __device__ __forceinline__ int own_wait(int g, int n) {
    mbar_wait_warp(&own_full[g][n % kOwnSlots], (n / kOwnSlots) & 1);
    return n % kOwnSlots;
  }
};

__device__ __forceinline__ float ex2(float x) {
  float y;
  asm("ex2.approx.ftz.f32 %0, %1;" : "=f"(y) : "f"(x));
  return y;
}

// the largest and the sum of a lane's 16 values of each of its two rows in
// a 64 x 64 accumulator (row `row`: i & 2 == 0; row + 8: i & 2), by trees
__device__ __forceinline__ void row_max(const float (&s)[32], float& r0, float& r1) {
  float a[8], b[8];
#pragma unroll
  for (int j = 0; j < 8; ++j) {
    a[j] = fmaxf(s[4 * j], s[4 * j + 1]);
    b[j] = fmaxf(s[4 * j + 2], s[4 * j + 3]);
  }
#pragma unroll
  for (int w = 4; w > 0; w >>= 1)
#pragma unroll
    for (int j = 0; j < w; ++j) {
      a[j] = fmaxf(a[j], a[j + w]);
      b[j] = fmaxf(b[j], b[j + w]);
    }
  r0 = a[0];
  r1 = b[0];
}
__device__ __forceinline__ void row_sum(const float (&s)[32], float& r0, float& r1) {
  float a[8], b[8];
#pragma unroll
  for (int j = 0; j < 8; ++j) {
    a[j] = s[4 * j] + s[4 * j + 1];
    b[j] = s[4 * j + 2] + s[4 * j + 3];
  }
#pragma unroll
  for (int w = 4; w > 0; w >>= 1)
#pragma unroll
    for (int j = 0; j < w; ++j) {
      a[j] += a[j + w];
      b[j] += b[j + w];
    }
  r0 = a[0];
  r1 = b[0];
}

// K7's running state of one query tile in a lane: its share of the o
// accumulator, and of its two rows the running maxima (log2 units) and
// this lane's partial sums
struct FwdTile {
  float o[16];
  float m0, m1, l0, l1;
  __device__ __forceinline__ void reset() {
#pragma unroll
    for (int i = 0; i < 16; ++i) o[i] = 0.f;
    m0 = m1 = -INFINITY;
    l0 = l1 = 0.f;
  }
  // The online softmax's update with the scores s of one key tile: the
  // maxima, alpha = exp2(m_old - m_new) applied to the sums and the
  // accumulator, and p = exp2(s scale_log2 - m_new), rounded to bf16 as A
  // fragments.  `diag`: the key tile is the query tile, keys past the row
  // are masked.  Key 0 is visible to every row, so the maxima are finite
  // from the first tile on, whose alpha is exp2(-inf) = 0.
  __device__ __forceinline__ void update(float (&s)[32], uint32_t (&pa)[4][4], bool diag,
                                         float scale_log2, int row, int t4) {
    if (diag) {
#pragma unroll
      for (int i = 0; i < 32; ++i)
        if (8 * (i >> 2) + 2 * t4 + (i & 1) > row + 8 * ((i >> 1) & 1)) s[i] = -INFINITY;
    }
    float r0, r1;
    row_max(s, r0, r1);
#pragma unroll
    for (int off = 1; off <= 2; off <<= 1) {
      r0 = fmaxf(r0, __shfl_xor_sync(0xffffffffu, r0, off));
      r1 = fmaxf(r1, __shfl_xor_sync(0xffffffffu, r1, off));
    }
    const float mx0 = fmaxf(m0, r0 * scale_log2), mx1 = fmaxf(m1, r1 * scale_log2);
    const float a0 = ex2(m0 - mx0), a1 = ex2(m1 - mx1);
    m0 = mx0;
    m1 = mx1;
#pragma unroll
    for (int i = 0; i < 32; ++i) s[i] = ex2(fmaf(s[i], scale_log2, (i & 2) ? -mx1 : -mx0));
    float sum0, sum1;
    row_sum(s, sum0, sum1);
    l0 = l0 * a0 + sum0;  // reduced over the quad at the end
    l1 = l1 * a1 + sum1;
#pragma unroll
    for (int i = 0; i < 16; ++i) o[i] *= (i & 2) ? a1 : a0;
    to_a(pa, s);
  }
};

// One key tile of K7 against the warpgroup's later query tile `hi` and,
// with BOTH, its earlier tile `lo`, in lockstep: S = Q K^T for each, one
// wait, the online softmax of each, O += P V for each, one wait.
// `diag_*`: the key tile is that query tile.  (BOTH is a template argument
// so that no wgmma sits in a branch of its own: ptxas serialises wgmma
// whose registers a divergent path defines.)
template <bool BOTH>
__device__ __forceinline__ void fwd_step(const uint8_t* qh, const uint8_t* ql, const uint8_t* kb,
                                         const uint8_t* vb, bool diag_h, bool diag_l, FwdTile& hi,
                                         FwdTile& lo, float scale_log2, int row, int t4) {
  float sh[32], sl[32];
  uint32_t ph[4][4], pl[4][4];
  wgmma_fence();
  wgmma_ss(sh, kmajor(qh), kmajor(kb), 0);
  wgmma_ss(sh, kmajor(qh + 32), kmajor(kb + 32), 1);
  if constexpr (BOTH) {
    wgmma_ss(sl, kmajor(ql), kmajor(kb), 0);
    wgmma_ss(sl, kmajor(ql + 32), kmajor(kb + 32), 1);
  }
  wgmma_commit();
  wgmma_wait<0>();
  hold(sh);
  if constexpr (BOTH) hold(sl);
  hi.update(sh, ph, diag_h, scale_log2, row, t4);
  if constexpr (BOTH) lo.update(sl, pl, diag_l, scale_log2, row, t4);
  wgmma_fence();
#pragma unroll
  for (int kk = 0; kk < 4; ++kk) wgmma_rs(hi.o, ph[kk], mnmajor(vb + kk * 1024));
  if constexpr (BOTH) {
#pragma unroll
    for (int kk = 0; kk < 4; ++kk) wgmma_rs(lo.o, pl[kk], mnmajor(vb + kk * 1024));
  }
  wgmma_commit();
  wgmma_wait<0>();
  hold(hi.o);
  hold(ph);
  if constexpr (BOTH) {
    hold(lo.o);
    hold(pl);
  }
}

// K7's end of one query tile in a warp: its 16 rows of o normalised into
// the warp's rows of the staging box, and their lse to `lse_tile`
__device__ __forceinline__ void fwd_finish(uint8_t* box, float* __restrict__ lse_tile,
                                           FwdTile& t, int w, int lane) {
#pragma unroll
  for (int off = 1; off <= 2; off <<= 1) {
    t.l0 += __shfl_xor_sync(0xffffffffu, t.l0, off);
    t.l1 += __shfl_xor_sync(0xffffffffu, t.l1, off);
  }
  stage_box(box, t.o, 1.f / t.l0, 1.f / t.l1, w, lane);
  if ((lane & 3) == 0) {
    const int r = 16 * w + (lane >> 2);
    lse_tile[r] = (t.m0 + __log2f(t.l0)) * kLn2;
    lse_tile[r + 8] = (t.m1 + __log2f(t.l1)) * kLn2;
  }
}

// ---------------------------------------------------------------------------
// K7, bf16.  Shared memory: the ring (kFwdStages x [K box, V box]), each
// consumer warpgroup's two slots of its pair's Q boxes ([later tile, earlier
// tile]) and its staging boxes for o.
// ---------------------------------------------------------------------------
__global__ void __launch_bounds__(kHopperThreads, 1)
flash_fwd_hopper(const __grid_constant__ CUtensorMap map_q, const __grid_constant__ CUtensorMap map_k,
                 const __grid_constant__ CUtensorMap map_v, bf16* __restrict__ o,
                 float* __restrict__ lse, FlashLayout lay, int H, int BH, int T, float scale_log2) {
  extern __shared__ uint8_t smem_raw[];
  __shared__ __align__(8) FlashBars bars;
  uint8_t* ring = align1024(smem_raw);
  uint8_t* own = ring + kFwdStages * kFwdStage;                  // [g][slot][2 boxes]
  uint8_t* staging = own + kConsumers * kOwnSlots * 2 * kBoxBytes;  // [g][2 boxes]
  const int nt = T / kFlashTile, pairs = (nt + 1) / 2;
  const int rounds = (pairs + kConsumers - 1) / kConsumers;
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  bars.init(kFwdStages);
  const Ring stream{bars.full, bars.empty, kFwdStages};

  if (warp == kProducer) {
    if (lane == 0) {
      int it = 0, n[kConsumers] = {};
      for (int bh = blockIdx.x; bh < BH; bh += gridDim.x) {
        const int b = bh / H, h = bh % H;
        for (int r = 0; r < rounds; ++r) {
#pragma unroll
          for (int g = 0; g < kConsumers; ++g) {
            const int lo = r * kConsumers + g, hi = nt - 1 - lo;  // the pair's tiles
            if (lo >= pairs) continue;
            const int s = bars.own_acquire(g, n[g]++, (lo == hi ? 1 : 2) * kBoxBytes);
            uint8_t* dst = own + (g * kOwnSlots + s) * 2 * kBoxBytes;
            tma_load_rows(dst, &map_q, &bars.own_full[g][s], hi * kFlashTile, h, b);
            if (lo != hi) tma_load_rows(dst + kBoxBytes, &map_q, &bars.own_full[g][s], lo * kFlashTile, h, b);
          }
          for (int kt = 0; kt < nt - r * kConsumers; ++kt, ++it) {
            const int s = stream.acquire(it, kFwdStage);
            uint8_t* st = ring + s * kFwdStage;
            tma_load_rows(st, &map_k, &bars.full[s], kt * kFlashTile, h, b);
            tma_load_rows(st + kBoxBytes, &map_v, &bars.full[s], kt * kFlashTile, h, b);
          }
        }
      }
    }
    return;
  }

  const int g = warp >> 2, w = warp & 3, t4 = lane & 3;
  const int row = 16 * w + (lane >> 2);  // the lane's rows of a tile: row, row + 8
  uint8_t* box = staging + g * 2 * kBoxBytes;  // the warp's rows: w * 1024 of each box
  int it = 0, n = 0;
  for (int bh = blockIdx.x; bh < BH; bh += gridDim.x) {
    const int b = bh / H, h = bh % H;
    for (int r = 0; r < rounds; ++r) {
      const int lo = r * kConsumers + g, hi = nt - 1 - lo, len = nt - r * kConsumers;
      const bool active = lo < pairs, two = lo != hi;
      const uint8_t* qb =
          active ? own + (g * kOwnSlots + bars.own_wait(g, n)) * 2 * kBoxBytes : nullptr;
      FwdTile th, tl;
      th.reset();
      tl.reset();
      for (int kt = 0; kt < len; ++kt, ++it) {
        const uint8_t* st = ring + stream.wait(it) * kFwdStage;
        if (active && two && kt <= lo)
          fwd_step<true>(qb, qb + kBoxBytes, st, st + kBoxBytes, kt == hi, kt == lo, th, tl,
                         scale_log2, row, t4);
        else if (active && kt <= hi)
          fwd_step<false>(qb, nullptr, st, st + kBoxBytes, kt == hi, false, th, tl, scale_log2,
                          row, t4);
        stream.release(it, lane);
      }
      if (!active) continue;
      if (lane == 0) mbar_arrive(&bars.own_empty[g][n % kOwnSlots]);
      ++n;
      float* lh = lse + (long long)bh * T;
      bf16* oh = head_ptr(o, lay, 3, b, h);
      __syncwarp();  // the warp's last stores have read its staging rows
      fwd_finish(box, lh + hi * kFlashTile, th, w, lane);
      if (two) fwd_finish(box + kBoxBytes, lh + lo * kFlashTile, tl, w, lane);
      __syncwarp();
      store_rows16(oh, lay.s[3][2], hi * kFlashTile, box, w, lane);
      if (two) store_rows16(oh, lay.s[3][2], lo * kFlashTile, box + kBoxBytes, w, lane);
    }
  }
}

// One query tile of K8 against one key tile: S^T = K Q^T and dP^T = V dO^T,
// P^T from lse, dS^T = P^T (dP^T - di) scale, dV += P^T dO, dK += dS^T Q.
// `key` is the lane's first key row in the tile; `diag`: the query tile is
// the key tile, queries before the key are masked.
__device__ __forceinline__ void bwd_step(const uint8_t* kb, const uint8_t* vb, const uint8_t* st,
                                         bool diag, float (&dk)[16], float (&dv)[16], float scale,
                                         float scale_log2, int key, int t4) {
  const uint8_t* qb = st;
  const uint8_t* dob = st + kBoxBytes;
  const float* ls = reinterpret_cast<const float*>(st + 2 * kBoxBytes);
  const float* dis = ls + kFlashTile;
  float sp[32], dp[32];
  wgmma_fence();
  wgmma_ss(sp, kmajor(kb), kmajor(qb), 0);
  wgmma_ss(sp, kmajor(kb + 32), kmajor(qb + 32), 1);
  wgmma_ss(dp, kmajor(vb), kmajor(dob), 0);
  wgmma_ss(dp, kmajor(vb + 32), kmajor(dob + 32), 1);
  wgmma_commit();
  wgmma_wait<0>();
  hold(sp);
  hold(dp);
  // element i is key row key + 8 ((i >> 1) & 1), query column c(i) of the tiles
#pragma unroll
  for (int i = 0; i < 32; ++i)
    sp[i] = ex2(fmaf(sp[i], scale_log2, -ls[8 * (i >> 2) + 2 * t4 + (i & 1)] * kLog2e));
  if (diag) {
#pragma unroll
    for (int i = 0; i < 32; ++i)
      if (8 * (i >> 2) + 2 * t4 + (i & 1) < key + 8 * ((i >> 1) & 1)) sp[i] = 0.f;
  }
#pragma unroll
  for (int i = 0; i < 32; ++i)
    dp[i] = sp[i] * (dp[i] - dis[8 * (i >> 2) + 2 * t4 + (i & 1)]) * scale;
  uint32_t pa[4][4], dsa[4][4];
  to_a(pa, sp);
  to_a(dsa, dp);
  wgmma_fence();
#pragma unroll
  for (int kk = 0; kk < 4; ++kk) wgmma_rs(dv, pa[kk], mnmajor(dob + kk * 1024));
#pragma unroll
  for (int kk = 0; kk < 4; ++kk) wgmma_rs(dk, dsa[kk], mnmajor(qb + kk * 1024));
  wgmma_commit();
  wgmma_wait<0>();
  hold(dv);
  hold(dk);
  hold(pa);
  hold(dsa);
}

// ---------------------------------------------------------------------------
// K8, bf16.  Shared memory: the ring (kBwdStages x [Q box, dO box, lse,
// di]), each consumer warpgroup's two slots of its pair's K and V boxes
// ([K, V of the earlier tile, K, V of the later]) and its staging boxes for
// dk and dv (the same order).
// ---------------------------------------------------------------------------
__global__ void __launch_bounds__(kHopperThreads, 1)
flash_bwd_dkv_hopper(const __grid_constant__ CUtensorMap map_q, const __grid_constant__ CUtensorMap map_k,
                     const __grid_constant__ CUtensorMap map_v, const __grid_constant__ CUtensorMap map_do,
                     bf16* __restrict__ dk, bf16* __restrict__ dv, const float* __restrict__ lse,
                     const float* __restrict__ di, FlashLayout lay, int H, int BH, int T,
                     float scale, float scale_log2) {
  extern __shared__ uint8_t smem_raw[];
  __shared__ __align__(8) FlashBars bars;
  uint8_t* ring = align1024(smem_raw);
  uint8_t* own = ring + kBwdStages * kBwdStage;                     // [g][slot][4 boxes]
  uint8_t* staging = own + kConsumers * kOwnSlots * 4 * kBoxBytes;  // [g][4 boxes]
  const int nt = T / kFlashTile, pairs = (nt + 1) / 2;
  const int rounds = (pairs + kConsumers - 1) / kConsumers;
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  bars.init(kBwdStages);
  const Ring stream{bars.full, bars.empty, kBwdStages};

  if (warp == kProducer) {
    if (lane == 0) {
      int it = 0, n[kConsumers] = {};
      for (int bh = blockIdx.x; bh < BH; bh += gridDim.x) {
        const int b = bh / H, h = bh % H;
        const float* lh = lse + (long long)bh * T;
        const float* dh = di + (long long)bh * T;
        for (int r = 0; r < rounds; ++r) {
#pragma unroll
          for (int g = 0; g < kConsumers; ++g) {
            const int lo = r * kConsumers + g, hi = nt - 1 - lo;  // the pair's tiles
            if (lo >= pairs) continue;
            const int s = bars.own_acquire(g, n[g]++, (lo == hi ? 2 : 4) * kBoxBytes);
            uint8_t* dst = own + (g * kOwnSlots + s) * 4 * kBoxBytes;
            uint64_t* bar = &bars.own_full[g][s];
            tma_load_rows(dst, &map_k, bar, lo * kFlashTile, h, b);
            tma_load_rows(dst + kBoxBytes, &map_v, bar, lo * kFlashTile, h, b);
            if (lo != hi) {
              tma_load_rows(dst + 2 * kBoxBytes, &map_k, bar, hi * kFlashTile, h, b);
              tma_load_rows(dst + 3 * kBoxBytes, &map_v, bar, hi * kFlashTile, h, b);
            }
          }
          for (int qt = r * kConsumers; qt < nt; ++qt, ++it) {
            const int s = stream.acquire(it, 2 * kBoxBytes + 2 * kVecBytes);
            uint8_t* st = ring + s * kBwdStage;
            uint64_t* bar = &bars.full[s];
            tma_load_rows(st, &map_q, bar, qt * kFlashTile, h, b);
            tma_load_rows(st + kBoxBytes, &map_do, bar, qt * kFlashTile, h, b);
            bulk_load(st + 2 * kBoxBytes, lh + qt * kFlashTile, kVecBytes, bar);
            bulk_load(st + 2 * kBoxBytes + kVecBytes, dh + qt * kFlashTile, kVecBytes, bar);
          }
        }
      }
    }
    return;
  }

  const int g = warp >> 2, w = warp & 3, t4 = lane & 3;
  const int key = 16 * w + (lane >> 2);  // the lane's key rows of a tile: key, key + 8
  uint8_t* box = staging + g * 4 * kBoxBytes;  // the warp's rows: w * 1024 of each box
  int it = 0, n = 0;
  for (int bh = blockIdx.x; bh < BH; bh += gridDim.x) {
    const int b = bh / H, h = bh % H;
    for (int r = 0; r < rounds; ++r) {
      const int lo = r * kConsumers + g, hi = nt - 1 - lo;
      const bool active = lo < pairs, two = lo != hi;
      const uint8_t* kv =
          active ? own + (g * kOwnSlots + bars.own_wait(g, n)) * 4 * kBoxBytes : nullptr;
      float dkl[16], dvl[16], dkh[16], dvh[16];
#pragma unroll
      for (int i = 0; i < 16; ++i) dkl[i] = dvl[i] = dkh[i] = dvh[i] = 0.f;
      for (int qt = r * kConsumers; qt < nt; ++qt, ++it) {
        const uint8_t* st = ring + stream.wait(it) * kBwdStage;
        if (active && qt >= lo)
          bwd_step(kv, kv + kBoxBytes, st, qt == lo, dkl, dvl, scale, scale_log2, key, t4);
        if (active && two && qt >= hi)
          bwd_step(kv + 2 * kBoxBytes, kv + 3 * kBoxBytes, st, qt == hi, dkh, dvh, scale,
                   scale_log2, key, t4);
        stream.release(it, lane);
      }
      if (!active) continue;
      if (lane == 0) mbar_arrive(&bars.own_empty[g][n % kOwnSlots]);
      ++n;
      bf16* dkh_ = head_ptr(dk, lay, 4, b, h);
      bf16* dvh_ = head_ptr(dv, lay, 5, b, h);
      __syncwarp();  // the warp's last stores have read its staging rows
      stage_box(box, dkl, 1.f, 1.f, w, lane);
      stage_box(box + kBoxBytes, dvl, 1.f, 1.f, w, lane);
      if (two) {
        stage_box(box + 2 * kBoxBytes, dkh, 1.f, 1.f, w, lane);
        stage_box(box + 3 * kBoxBytes, dvh, 1.f, 1.f, w, lane);
      }
      __syncwarp();
      store_rows16(dkh_, lay.s[4][2], lo * kFlashTile, box, w, lane);
      store_rows16(dvh_, lay.s[5][2], lo * kFlashTile, box + kBoxBytes, w, lane);
      if (two) {
        store_rows16(dkh_, lay.s[4][2], hi * kFlashTile, box + 2 * kBoxBytes, w, lane);
        store_rows16(dvh_, lay.s[5][2], hi * kFlashTile, box + 3 * kBoxBytes, w, lane);
      }
    }
  }
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

// A 4-D map over (d, T, H, B) of a bf16 (B, H, T, 32) operand whose batch,
// head and row strides (elements) are st[0..2], in boxes of a tile's 64
// rows, 64-byte swizzled for wgmma.
inline cudaError_t head_map(CUtensorMap* map, const void* ptr, int B, int H, int T,
                            const long long* st) {
  EncodeTiledFn encode;
  const cudaError_t err = tensor_map_encoder(&encode);
  if (err != cudaSuccess) return err;
  const cuuint64_t dims[4] = {(cuuint64_t)kFlashD, (cuuint64_t)T, (cuuint64_t)H, (cuuint64_t)B};
  const cuuint64_t strides[3] = {(cuuint64_t)st[2] * 2, (cuuint64_t)st[1] * 2,
                                 (cuuint64_t)st[0] * 2};
  const cuuint32_t box[4] = {(cuuint32_t)kFlashD, (cuuint32_t)kFlashTile, 1, 1};
  const cuuint32_t unit[4] = {1, 1, 1, 1};
  const CUresult r = encode(map, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, 4, const_cast<void*>(ptr), dims,
                            strides, box, unit, CU_TENSOR_MAP_INTERLEAVE_NONE,
                            CU_TENSOR_MAP_SWIZZLE_64B,
                            CU_TENSOR_MAP_L2_PROMOTION_L2_128B, CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE);
  return r == CUDA_SUCCESS ? cudaSuccess : cudaErrorInvalidValue;
}

// dynamic shared memory of the Hopper kernels (1024 of it for alignment)
constexpr size_t kFwdSmem =
    1024 + kFwdStages * kFwdStage + kConsumers * (kOwnSlots * 2 + 2) * (size_t)kBoxBytes;
constexpr size_t kBwdSmem =
    1024 + kBwdStages * kBwdStage + kConsumers * (kOwnSlots * 4 + 4) * (size_t)kBoxBytes;

// Each Hopper block takes more than half an SM's 228 KB of shared memory,
// so one block an SM.
static_assert(2 * (kFwdSmem + 1024) > 228 * 1024 && 2 * (kBwdSmem + 1024) > 228 * 1024,
              "the persistent grid assumes one block an SM");

// The persistent grid: a block an SM, at most one a head.  The
// shared-memory attribute is set before every launch.
template <typename Kernel>
inline cudaError_t persistent_grid(Kernel kernel, size_t smem, int heads, int* grid) {
  int dev, sms = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err == cudaSuccess) err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  if (err == cudaSuccess)
    err = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  *grid = sms < heads ? sms : heads;
  return err;
}

// K7 in bf16: q, k, v, o through strides[0..11]
inline cudaError_t launch_fwd_hopper(const void* q, const void* k, const void* v, void* o,
                                     float* lse, int B, int H, int T, const long long* strides,
                                     float scale_log2, cudaStream_t stream) {
  CUtensorMap maps[3];
  const void* ptrs[3] = {q, k, v};
  for (int i = 0; i < 3; ++i) {
    const cudaError_t err = head_map(&maps[i], ptrs[i], B, H, T, strides + 3 * i);
    if (err != cudaSuccess) return err;
  }
  int grid;
  const cudaError_t err = persistent_grid(flash_fwd_hopper, kFwdSmem, B * H, &grid);
  if (err != cudaSuccess) return err;
  flash_fwd_hopper<<<grid, kHopperThreads, kFwdSmem, stream>>>(
      maps[0], maps[1], maps[2], static_cast<bf16*>(o), lse, flash_layout(strides, 4), H, B * H, T,
      scale_log2);
  return cudaGetLastError();
}

// K8 in bf16: q, k, v, do, dk, dv through strides[0..17]
inline cudaError_t launch_bwd_dkv_hopper(const void* q, const void* k, const void* v,
                                         const void* dout, const float* lse, const float* di,
                                         void* dk, void* dv, int B, int H, int T,
                                         const long long* strides, float scale, float scale_log2,
                                         cudaStream_t stream) {
  CUtensorMap maps[4];
  const void* ptrs[4] = {q, k, v, dout};
  for (int i = 0; i < 4; ++i) {
    const cudaError_t err = head_map(&maps[i], ptrs[i], B, H, T, strides + 3 * i);
    if (err != cudaSuccess) return err;
  }
  int grid;
  const cudaError_t err = persistent_grid(flash_bwd_dkv_hopper, kBwdSmem, B * H, &grid);
  if (err != cudaSuccess) return err;
  flash_bwd_dkv_hopper<<<grid, kHopperThreads, kBwdSmem, stream>>>(
      maps[0], maps[1], maps[2], maps[3], static_cast<bf16*>(dk), static_cast<bf16*>(dv), lse, di,
      flash_layout(strides, 6), H, B * H, T, scale, scale_log2);
  return cudaGetLastError();
}

}  // namespace mnx

extern "C" {

// q, k, v, o (B, H, T, 32) in one dtype through their (batch, head, row)
// strides in `strides` (4 x 3 elements), each row contiguous and every
// stride and address 16-byte aligned; lse (B, H, T) float32 contiguous; T a
// multiple of 64, B * H at most 65535.  The wrapper checks these.  Returns
// a cudaError_t code.
int mnx_flash_attention_fwd(int dtype, const void* q, const void* k, const void* v, void* o,
                            float* lse, int B, int H, int T, int d, const long long* strides,
                            float sm_scale, void* stream) {
  if (!mnx::flash_shape_ok(B, H, T, d)) return cudaErrorInvalidValue;
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  const float sl = sm_scale * mnx::kLog2e;
  if (dtype == mnx::kBF16)
    return mnx::launch_fwd_hopper(q, k, v, o, lse, B, H, T, strides, sl, st);
  if (dtype != mnx::kF32) return cudaErrorInvalidValue;
  const mnx::FlashLayout lay = mnx::flash_layout(strides, 4);
  const dim3 grid(T / mnx::kFlashTile, B * H);
  mnx::flash_fwd_f32<<<grid, mnx::kFlashF32Threads, 0, st>>>(
      static_cast<const float*>(q), static_cast<const float*>(k), static_cast<const float*>(v),
      static_cast<float*>(o), lse, H, T, lay, sl);
  return cudaGetLastError();
}

// q, k, v, do, dk, dv (B, H, T, 32) through their strides (6 x 3); lse and
// di (B, H, T) float32 contiguous, 16-byte aligned.
int mnx_flash_attention_bwd_dkv(int dtype, const void* q, const void* k, const void* v,
                                const void* dout, const float* lse, const float* di, void* dk,
                                void* dv, int B, int H, int T, int d, const long long* strides,
                                float sm_scale, void* stream) {
  if (!mnx::flash_shape_ok(B, H, T, d)) return cudaErrorInvalidValue;
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  const float sl = sm_scale * mnx::kLog2e;
  if (dtype == mnx::kBF16)
    return mnx::launch_bwd_dkv_hopper(q, k, v, dout, lse, di, dk, dv, B, H, T, strides, sm_scale,
                                      sl, st);
  if (dtype != mnx::kF32) return cudaErrorInvalidValue;
  const mnx::FlashLayout lay = mnx::flash_layout(strides, 6);
  const dim3 grid(T / mnx::kFlashTile, B * H);
  mnx::flash_bwd_dkv_f32<<<grid, mnx::kFlashF32Threads, 0, st>>>(
      static_cast<const float*>(q), static_cast<const float*>(k), static_cast<const float*>(v),
      static_cast<const float*>(dout), lse, di, static_cast<float*>(dk), static_cast<float*>(dv),
      H, T, lay, sm_scale, sl);
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
