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
// Head widths: the kernels below are templates on the head width D, 32,
// 64, 128 or 256; the wrapper gives any other width up to 128 zero columns
// up to the next of these (a zero column adds nothing to q k^T and gives
// zero columns of o, dq, dk and dv) and cuts the outputs back.  Above 128
// the library takes multiples of 128 only.  Above 256 whole-width tiles no
// longer fit (at 384 one 64-row bf16 tile is 48 KB, and K8's K and V tiles
// with one Q and dO stage pass the 225 KB a block has), so every multiple
// of 128 above 256 runs in the wide kernels (flash_*_wide, D at run time),
// which stream the head width (below).
//
// What bounds them on the card: bytes.  At the recipe's shape (B 256, H 8,
// T 256, d 32, bf16) K7 reads q, k and v and writes o (33.5 MB each) for
// 2 * 2 * T (T + 1) / 2 * d operations per (b, h), about 64 operations per
// byte, under the H100's ridge of 295 (the ratio does not depend on d);
// K8 reads q, k, v, do, lse and di and writes dk and dv; K9 reads the same
// and writes dq.  The (B, H, T, T) scores and probabilities that the plain
// version materialises (537 MB each in float32 at that shape) never leave
// the SM.  So the kernels have to read each operand once, keep enough
// loads in flight to cover the latency of device memory, and write whole
// rows.
//
// bf16 K7, K8 and K9 (TMA and wgmma):
//   * One pass over each head's operands.  A persistent block (two consumer
//     warpgroups and a producer warpgroup, one block an SM) walks the (b, h)
//     heads from blockIdx.x in steps of gridDim.x.  It owns every query
//     tile of a head in K7 and K9 and every key tile in K8, so each K and V
//     tile (K7, K9), or each Q, dO, lse and di tile (K8), is loaded once per
//     head into a ring of shared-memory stages and read there by every tile
//     that needs it.
//   * Balanced tile pairs.  With nt = T / 64 tiles, warpgroup g of round r
//     takes pair p = 2 r + g: tiles p and nt - 1 - p (one tile when they
//     are the same, for odd nt).  A round streams the tiles its pairs need,
//     K7 and K9 key tiles 0 .. nt - 1 - 2 r, K8 query tiles 2 r .. nt - 1,
//     and each warpgroup applies a streamed tile to those of its pair that
//     see it: nt + 1 tile-steps a round (5 at T 256, one round a head),
//     where a block per tile would walk 1 to 4.  At T 256 and T 128 a head
//     is one round and each tile is loaded once; a longer T takes more
//     rounds, each streaming its tiles again (from L2, mostly).  Where a
//     pair's accumulators do not fit in registers (K7 and K9 at D 128, K8
//     above D 32) a round takes two passes, each warpgroup taking one tile
//     of its pair in each: the first pass streams what the tile that needs
//     most needs, the second what the other needs (nt + 2 tile loads a
//     round instead of nt - 2 r).
//   * TMA into mbarrier rings, fed by one thread of the producer warpgroup,
//     which hands the consumers its registers where they need them
//     (setmaxnreg: 40 a thread for it, 232 for them, where ptxas gives each
//     168).  Each input has a
//     4-D tensor map over (d, T, H, B) with its own row, head and batch
//     strides (the decoder's q, k and v are read in place from its qkv
//     projection); a box is 64 rows of min(D, 64) columns, swizzled over
//     its row (64 bytes at D 32, 128 above), D / 64 boxes a tile above.
//     The stream's ring (K7, K9: stages of a K and a V tile; K8: of a Q and
//     a dO tile and 64 lse and 64 di, the vectors by bulk copy) and each
//     warpgroup's two slots for its pass's own tiles (K7: Q; K8: K and V;
//     K9: Q, dO, lse and di) take the next round's and the next head's
//     loads while the consumers finish the current one.  The ring's depth
//     is what shared memory leaves at each width.  A long T streams through
//     the ring; nothing needs the whole head in shared memory.
//   * wgmma.  K7: S = Q K^T by m64n64k16 (D / 16 k16 steps, both operands
//     K-major), the online softmax in float32 on the accumulator fragments,
//     then O += P V by m64nDk16 with P from registers as the A operand and V
//     an MN-major B; where a key tile reaches both tiles of the pair, the
//     two run in lockstep (one wait for both products).  K8: S^T = K Q^T
//     and dP^T = V dO^T by m64n64k16, then dV += P^T dO and dK += dS^T Q by
//     m64nDk16 with P^T and dS^T from registers and dO and Q as MN-major B.
//     K9: S = Q K^T and dP = dO V^T by m64n64k16, dS = P (dP - di) scale,
//     then dQ += dS K by m64nDk16 with dS from registers and K an MN-major
//     B, the two tiles of a pair in lockstep as in K7.  The accumulators
//     (o, dk and dv, dq) stay in registers for the pass's tiles and are
//     written once: no atomics.  The causal mask applies on the diagonal
//     tile only.
//   * Whole-row epilogues: once all four warps of a warpgroup are past
//     their last product, each warp stages its 16 rows of o, dk, dv or dq
//     in the warpgroup's own slot (the operand tile they replace) and
//     writes them as whole rows, 16 bytes a lane, into the (B, T, H, d)
//     buffers the wrapper allocates; K7's lse goes out as runs of
//     contiguous floats.  The slot is then released to the producer.
//   * K8 and K9 at D 256, the column split.  A 64-row tile is 32 KB there,
//     so a warpgroup's own tiles at 128 (two slots of K and V, or of Q,
//     dO, lse and di) leave no room for a ring of two stages, and K8's dk
//     and dv of one tile alone would take 256 registers a thread.  So the
//     two consumer warpgroups take the same tile, one a round (no pairs: a
//     round streams what that tile needs), from one own slot beside the
//     ring's two stages (193 to 195 KB), and each owns 128 of the 256
//     accumulator columns, its dk and dv, or dq half by m64n128k16 on its
//     half of the MN-major B.  Each computes S and dP (S^T and dP^T in K8)
//     over the whole d itself, which doubles those products and the
//     exponentials but hands nothing between the warpgroups.  Both
//     warpgroups stage into the one own slot, each its half of the
//     columns, once both are past their last product (one barrier of 256
//     threads).  K9's producer loads a round's own tiles, then its stream,
//     as at D <= 128; K8's issues the stream's first stages before it
//     waits for the one own slot, which gains there and loses in K9
//     (PERF.md).
//   * K7 at D 256 does not split (flash_fwd_d256; the split took 1.45x
//     PyTorch's flash forward, PERF.md): a 64 x 256 o is 128 float32
//     registers a thread, which with S (32) and P (16) fits the 232 that
//     setmaxnreg gives, so each warpgroup owns its query tiles, balanced
//     pairs over two passes as at D 128, and computes S and the
//     exponentials once a tile.  See the kernel.
//   * What is left: at the recipe's shape K7 and K8 take about twice their
//     bound (PERF.md).  Their operands arrive ahead of use; each
//     warpgroup's steps are a chain (products, then the softmax's 32
//     exponentials a lane on the SM's 16-a-clock special-function units,
//     then products), and two warpgroups an SM, all the registers allow,
//     do not hide it.
//
// bf16 wide heads (D a multiple of 128 above 256): a simple, non-persistent
// form, right before fast.  A block is one 64-row tile of one (b, h) with
// one consumer warpgroup and a producer warp; the head width streams as
// 64-column chunks through a ring of four 16 KB stages, so shared memory
// (65 KB) and registers do not grow with D.  S = sum_c Q_c K_c^T (and dP),
// chunk by chunk; the outputs go a column chunk at a time (K7 128, K9 128,
// K8 64 columns of dk and of dv), each chunk's pass recomputing S (and dP)
// on the tensor cores, K7 after a first pass for lse.  That costs (D / 128
// + 1), D / 128 and D / 64 times the products of S (and dP) in K7, K9 and
// K8: first forms, 2 to 8 times their bounds at D 384 and 512 (PERF.md).
//
// float32 (the parity runs): the same tiles on the CUDA cores, one block
// per 64-row tile of one (b, h) on grid x.  To D 256, D / 32 threads a row
// (K7, K9: a query row; K8: a key row), each with 32 of the row's columns
// of its operands and accumulators in registers and the row's dot products
// summed over those threads by shuffles; the walked tile in shared memory
// (at D 256, 512 threads and 128 or 129 KB).  K7 updates its online
// softmax per key.  Above 256 (flash_*_f32_wide), 256 threads a block each
// hold a 4 x 4 share of every 64 x 64 product, the head width streams
// through shared memory 32 columns at a time and the outputs go 64 columns
// at a time, as the bf16 wide kernels do.
//
// Strides: every (B, H, T, d) operand is read and written through its own
// batch, head and row strides (the last dimension contiguous); rows, strides
// and lse and di are 16-byte aligned (the wrapper checks).  D 32, 64, 128,
// or a multiple of 128, and T a multiple of 64; the launchers refuse
// anything else.
#include "common.cuh"

namespace mnx {

constexpr int kFlashTile = 64;  // rows of a tile (queries or keys)
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

// the 16 x 64 values x (a warp's share of a wgmma m64n64 accumulator: c[4 j
// + e] at row (lane >> 2) + 8 (e >> 1), column 8 j + 2 (lane & 3) + (e &
// 1)) rounded to bf16 as A fragments over 4 steps of 16 columns (wgmma's
// layout for A in registers)
__device__ __forceinline__ void to_a(uint32_t (&a)[4][4], const float (&x)[32]) {
#pragma unroll
  for (int j = 0; j < 4; ++j) {
    a[j][0] = pack_bf16(x[8 * j], x[8 * j + 1]);
    a[j][1] = pack_bf16(x[8 * j + 2], x[8 * j + 3]);
    a[j][2] = pack_bf16(x[8 * j + 4], x[8 * j + 5]);
    a[j][3] = pack_bf16(x[8 * j + 6], x[8 * j + 7]);
  }
}

// ---------------------------------------------------------------------------
// bf16 tiles on Hopper: a tile is 64 rows of D bf16 values, landed by TMA
// in boxes of 64 rows by min(D, 64) columns (64- or 128-byte rows, 8-row
// groups 512 or 1024 bytes apart, swizzled over the row:
// CU_TENSOR_MAP_SWIZZLE_64B at D 32, _128B above), D / 64 boxes above, and
// read by wgmma through descriptors of that swizzle.  The same tile serves
// as a K-major operand (rows = M or N, d = K: a k16 step is 32 bytes on in
// the row, in the next box after the row's end) and as an MN-major B (rows
// = K, d = N: a k16 step is the next 16 rows; the boxes along N a box
// apart).
// ---------------------------------------------------------------------------

template <int D>
struct Tile {
  static_assert(D == 32 || D == 64 || D == 128 || D == 256, "the kernels' head widths");
  static constexpr int kBoxCols = D < 64 ? D : 64;     // bf16 columns of a box
  static constexpr int kRowBytes = 2 * kBoxCols;        // the swizzle's span
  static constexpr int kBoxes = D / kBoxCols;           // boxes a tile
  static constexpr int kBoxBytes = kFlashTile * kRowBytes;
  static constexpr int kBytes = kBoxes * kBoxBytes;     // 128 D
  static constexpr int kSteps = D / 16;                 // k16 steps over d
  static constexpr uint64_t kLayout = D == 32 ? 2 : 1;  // descriptor: 64- or 128-byte swizzle

  static __device__ __forceinline__ uint64_t desc(const uint8_t* p, uint32_t lbo, uint32_t sbo) {
    return (uint64_t)((smem_u32(p) & 0x3FFFF) >> 4) | ((uint64_t)(lbo >> 4) << 16) |
           ((uint64_t)(sbo >> 4) << 32) | (kLayout << 62);
  }
  // k16 step kk of a K-major operand (the leading offset is not read)
  static __device__ __forceinline__ uint64_t kmajor(const uint8_t* t, int kk) {
    return desc(t + (kk * 32 / kRowBytes) * kBoxBytes + kk * 32 % kRowBytes, 16, 8 * kRowBytes);
  }
  // k16 step kk of an MN-major B: the leading offset steps along N from box
  // to box (read where N spans two swizzle widths: D 128, and a warpgroup's
  // half at 256, from the box of its first column)
  static __device__ __forceinline__ uint64_t mnmajor(const uint8_t* t, int kk) {
    return desc(t + kk * 16 * kRowBytes, kBoxes > 1 ? kBoxBytes : 8 * kRowBytes, 8 * kRowBytes);
  }
};

constexpr int kConsumers = 2;                          // consumer warpgroups a block
constexpr int kHopperThreads = 128 * (kConsumers + 1);  // and a producer warpgroup
constexpr int kProducer = 4 * kConsumers;              // the producer's first warp, the one that loads
// Registers a thread: ptxas gives a block of three warpgroups 168 each (it
// counts whole warpgroups); where a kernel's consumers need more (kRaise)
// the producer warpgroup gives all but 40 of its own to them, which then
// have 232.  Where 168 suffice, the kernel keeps them (K7 at d 32 read no
// faster with 232: PERF.md)
constexpr int kProducerRegs = 40, kConsumerRegs = 232;
static_assert((kProducerRegs + kConsumers * kConsumerRegs) * 128 <= 65536, "the SM's registers");
constexpr int kVecBytes = kFlashTile * 4;              // 64 floats
constexpr int kOwnSlots = 2;                           // slots of a warpgroup's own tiles
constexpr int kMaxFlashStages = 12;
// dynamic shared memory a block may take: the SM's 227 KB less 1024 bytes
// of alignment and room for the static mbarriers
constexpr int kSmemLimit = 232448 - 2048;

static_assert(kEmptyArrivals == 4 * kConsumers, "a stage is released by every consumer warp");

// stages of `stage` bytes that fit beside `own` bytes of own slots, at most `cap`
constexpr int ring_stages(int stage, int own, int cap) {
  return (kSmemLimit - 1024 - own) / stage < cap ? (kSmemLimit - 1024 - own) / stage : cap;
}

// Per width: whether a warpgroup takes both tiles of its pair in one pass
// (kPair) or one tile a pass, whether the two warpgroups split one tile's
// accumulator columns instead (kSplit: K8 and K9 at D 256, one set of
// kSlots own slots for both, each owning kCols columns), whether its
// consumers take the producer's registers (kRaise: where 168 a thread
// would spill or serialise wgmma), the bytes of a ring stage and of an own
// slot, the ring's depth and the block's dynamic shared memory (1024 of it
// for alignment).  K7: a stage is a K and a V tile, a slot the pass's Q
// tiles.  K8: a stage is a Q and a dO tile, lse and di; a slot the pass's K
// and V tiles.  K9: a stage is a K and a V tile; a slot the pass's Q, dO,
// lse and di (a unit a tile).
template <int D, int STAGE, int SLOT, int CAP, int SLOTS = kOwnSlots>
struct RingCfg {
  static constexpr bool kSplit = D == 256;
  static constexpr int kOwners = kSplit ? 1 : kConsumers;  // sets of own slots
  static constexpr int kSlots = SLOTS;
  static constexpr int kCols = kSplit ? D / kConsumers : D;  // accumulator columns a warpgroup owns
  static constexpr int kStage = STAGE, kSlot = SLOT;
  static constexpr int kOwnBytes = kOwners * SLOTS * SLOT;
  static constexpr int kStages = ring_stages(STAGE, kOwnBytes, CAP);
  static constexpr size_t kSmem = 1024 + (size_t)kStages * STAGE + kOwnBytes;
  static_assert(SLOTS >= 1 && SLOTS <= kOwnSlots, "own slots");
  static_assert(kStages >= 2 && kStages <= kMaxFlashStages, "the ring's depth");
  static_assert(kSmem <= (size_t)kSmemLimit, "shared memory");
  // more than half an SM's 228 KB: the persistent grid assumes one block an SM
  static_assert(2 * (kSmem + 1024) > 228 * 1024, "one block an SM");
};
template <int D>
struct FwdCfg : RingCfg<D, 2 * Tile<D>::kBytes, (D <= 64 ? 2 : 1) * Tile<D>::kBytes, 12> {
  static constexpr bool kPair = D <= 64;
  static constexpr bool kRaise = D == 64;
};
template <int D>
struct DkvCfg : RingCfg<D, 2 * Tile<D>::kBytes + 1024, (D == 32 ? 2 : 1) * 2 * Tile<D>::kBytes, 8,
                        D == 256 ? 1 : kOwnSlots> {
  static constexpr bool kPair = D == 32;
  static constexpr bool kRaise = D > 32;
};
template <int D>
struct DqCfg : RingCfg<D, 2 * Tile<D>::kBytes, (D <= 64 ? 2 : 1) * (2 * Tile<D>::kBytes + 1024), 12,
                       D == 256 ? 1 : kOwnSlots> {
  static constexpr bool kPair = D <= 64;
  static constexpr bool kRaise = true;
  static constexpr int kUnit = 2 * Tile<D>::kBytes + 1024;  // Q, dO, lse at 2 kBytes, di + 256
};

// d (64 x 64, f32) = A (64 x 16) B (16 x 64) + (accumulate ? d : 0), both
// K-major in shared memory
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

// d (64 x N, f32, N = 32, 64, 128 or 256: N / 2 values a lane) += A (64 x 16,
// bf16 fragments in registers, the layout of to_a) B (16 x N, MN-major)
__device__ __forceinline__ void wgmma_rs(float (&d)[16], const uint32_t (&a)[4], uint64_t b) {
  asm volatile(
      "{\n"
      ".reg .pred p;\n"
      "setp.ne.b32 p, %21, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n32k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15}, "
      "{%16, %17, %18, %19}, %20, p, 1, 1, 1;\n"
      "}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(b), "r"(1));
}
__device__ __forceinline__ void wgmma_rs(float (&d)[32], const uint32_t (&a)[4], uint64_t b) {
  asm volatile(
      "{\n"
      ".reg .pred p;\n"
      "setp.ne.b32 p, %37, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31}, "
      "{%32, %33, %34, %35}, %36, p, 1, 1, 1;\n"
      "}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
        "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(b), "r"(1));
}
__device__ __forceinline__ void wgmma_rs(float (&d)[64], const uint32_t (&a)[4], uint64_t b) {
  asm volatile(
      "{\n"
      ".reg .pred p;\n"
      "setp.ne.b32 p, %69, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31, "
      "%32, %33, %34, %35, %36, %37, %38, %39, %40, %41, %42, %43, %44, %45, %46, %47, "
      "%48, %49, %50, %51, %52, %53, %54, %55, %56, %57, %58, %59, %60, %61, %62, %63}, "
      "{%64, %65, %66, %67}, %68, p, 1, 1, 1;\n"
      "}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
        "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31]),
        "+f"(d[32]), "+f"(d[33]), "+f"(d[34]), "+f"(d[35]), "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]),
        "+f"(d[40]), "+f"(d[41]), "+f"(d[42]), "+f"(d[43]), "+f"(d[44]), "+f"(d[45]), "+f"(d[46]), "+f"(d[47]),
        "+f"(d[48]), "+f"(d[49]), "+f"(d[50]), "+f"(d[51]), "+f"(d[52]), "+f"(d[53]), "+f"(d[54]), "+f"(d[55]),
        "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]), "+f"(d[60]), "+f"(d[61]), "+f"(d[62]), "+f"(d[63])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(b), "r"(1));
}

__device__ __forceinline__ void wgmma_rs(float (&d)[128], const uint32_t (&a)[4], uint64_t b) {
  asm volatile(
      "{\n"
      ".reg .pred p;\n"
      "setp.ne.b32 p, %133, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n256k16.f32.bf16.bf16 "
      "{"
      "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31, "
      "%32, %33, %34, %35, %36, %37, %38, %39, %40, %41, %42, %43, %44, %45, %46, %47, "
      "%48, %49, %50, %51, %52, %53, %54, %55, %56, %57, %58, %59, %60, %61, %62, %63, "
      "%64, %65, %66, %67, %68, %69, %70, %71, %72, %73, %74, %75, %76, %77, %78, %79, "
      "%80, %81, %82, %83, %84, %85, %86, %87, %88, %89, %90, %91, %92, %93, %94, %95, "
      "%96, %97, %98, %99, %100, %101, %102, %103, %104, %105, %106, %107, %108, %109, %110, %111, "
      "%112, %113, %114, %115, %116, %117, %118, %119, %120, %121, %122, %123, %124, %125, %126, %127"
      "}, "
      "{%128, %129, %130, %131}, %132, p, 1, 1, 1;\n"
      "}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
        "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31]),
        "+f"(d[32]), "+f"(d[33]), "+f"(d[34]), "+f"(d[35]), "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]),
        "+f"(d[40]), "+f"(d[41]), "+f"(d[42]), "+f"(d[43]), "+f"(d[44]), "+f"(d[45]), "+f"(d[46]), "+f"(d[47]),
        "+f"(d[48]), "+f"(d[49]), "+f"(d[50]), "+f"(d[51]), "+f"(d[52]), "+f"(d[53]), "+f"(d[54]), "+f"(d[55]),
        "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]), "+f"(d[60]), "+f"(d[61]), "+f"(d[62]), "+f"(d[63]),
        "+f"(d[64]), "+f"(d[65]), "+f"(d[66]), "+f"(d[67]), "+f"(d[68]), "+f"(d[69]), "+f"(d[70]), "+f"(d[71]),
        "+f"(d[72]), "+f"(d[73]), "+f"(d[74]), "+f"(d[75]), "+f"(d[76]), "+f"(d[77]), "+f"(d[78]), "+f"(d[79]),
        "+f"(d[80]), "+f"(d[81]), "+f"(d[82]), "+f"(d[83]), "+f"(d[84]), "+f"(d[85]), "+f"(d[86]), "+f"(d[87]),
        "+f"(d[88]), "+f"(d[89]), "+f"(d[90]), "+f"(d[91]), "+f"(d[92]), "+f"(d[93]), "+f"(d[94]), "+f"(d[95]),
        "+f"(d[96]), "+f"(d[97]), "+f"(d[98]), "+f"(d[99]), "+f"(d[100]), "+f"(d[101]), "+f"(d[102]), "+f"(d[103]),
        "+f"(d[104]), "+f"(d[105]), "+f"(d[106]), "+f"(d[107]), "+f"(d[108]), "+f"(d[109]), "+f"(d[110]), "+f"(d[111]),
        "+f"(d[112]), "+f"(d[113]), "+f"(d[114]), "+f"(d[115]), "+f"(d[116]), "+f"(d[117]), "+f"(d[118]), "+f"(d[119]),
        "+f"(d[120]), "+f"(d[121]), "+f"(d[122]), "+f"(d[123]), "+f"(d[124]), "+f"(d[125]), "+f"(d[126]), "+f"(d[127])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(b), "r"(1));
}


// a warpgroup's registers a thread, lowered (the producer) or raised (the
// consumers, which wait until the producer has lowered its own)
template <int N> __device__ __forceinline__ void regs_dec() {
  asm volatile("setmaxnreg.dec.sync.aligned.u32 %0;\n" ::"n"(N));
}
template <int N> __device__ __forceinline__ void regs_inc() {
  asm volatile("setmaxnreg.inc.sync.aligned.u32 %0;\n" ::"n"(N));
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

// the box at column col, rows row .. row + 63 of the (b, h) head of `map`
// into `dst`
__device__ __forceinline__ void tma_load_rows(void* dst, const CUtensorMap* map, uint64_t* bar,
                                              int col, int row, int h, int b) {
  asm volatile(
      "cp.async.bulk.tensor.4d.shared::cluster.global.mbarrier::complete_tx::bytes "
      "[%0], [%1, {%3, %4, %5, %6}], [%2];\n" ::"r"(smem_u32(dst)),
      "l"(reinterpret_cast<uint64_t>(map)), "r"(smem_u32(bar)), "r"(col), "r"(row), "r"(h), "r"(b)
      : "memory");
}

// the tile at rows row .. row + 63, box by box
template <int D>
__device__ __forceinline__ void tma_tile(uint8_t* dst, const CUtensorMap* map, uint64_t* bar,
                                         int row, int h, int b) {
#pragma unroll
  for (int x = 0; x < Tile<D>::kBoxes; ++x)
    tma_load_rows(dst + x * Tile<D>::kBoxBytes, map, bar, x * Tile<D>::kBoxCols, row, h, b);
}

// `bytes` contiguous bytes (16-byte aligned) into `dst`
__device__ __forceinline__ void bulk_load(void* dst, const void* src, uint32_t bytes, uint64_t* bar) {
  asm volatile(
      "cp.async.bulk.shared::cluster.global.mbarrier::complete_tx::bytes [%0], [%1], %2, [%3];\n" ::"r"(
          smem_u32(dst)),
      "l"(src), "r"(bytes), "r"(smem_u32(bar))
      : "memory");
}

// The epilogue of a 64 x N accumulator (N = D, or a warpgroup's half at D
// 256 from column col0), a warp at a time: the warp's 16 rows of wgmma's
// fragments (c[4 j + e] at row 16 w + (lane >> 2) + 8 (e >> 1), column col0
// + 8 j + 2 (lane & 3) + (e & 1)), rows scaled by f0 and f1, rounded to bf16
// into rows 16 w .. 16 w + 15 of a tile laid out as the boxes are but
// unswizzled (stage_rows); then those rows' columns out as whole runs, 16
// bytes a lane (write_rows).  The warp reads only what it wrote, so
// __syncwarp orders it all.
template <int D, int N>
__device__ __forceinline__ void stage_rows(uint8_t* t, const float (&acc)[N / 2], float f0,
                                           float f1, int w, int lane, int col0) {
  using L = Tile<D>;
  const int r = 16 * w + (lane >> 2);
#pragma unroll
  for (int j = 0; j < N / 8; ++j) {
    const int c = col0 + 8 * j + 2 * (lane & 3);
    uint8_t* p = t + (c / L::kBoxCols) * L::kBoxBytes + 2 * (c % L::kBoxCols);
    *reinterpret_cast<__nv_bfloat162*>(p + r * L::kRowBytes) =
        __floats2bfloat162_rn(acc[4 * j] * f0, acc[4 * j + 1] * f0);
    *reinterpret_cast<__nv_bfloat162*>(p + (r + 8) * L::kRowBytes) =
        __floats2bfloat162_rn(acc[4 * j + 2] * f1, acc[4 * j + 3] * f1);
  }
}
// columns col0 .. col0 + N - 1 of rows 16 w .. 16 w + 15 of a staged tile
// to rows row0 + 16 w .. of a (T, D) head at row stride st
template <int D, int N>
__device__ __forceinline__ void write_rows(bf16* __restrict__ head, long long st, int row0,
                                           const uint8_t* t, int w, int lane, int col0) {
  using L = Tile<D>;
  constexpr int kChunks = N / 8;  // 16-byte chunks a row
#pragma unroll
  for (int i = lane; i < 16 * kChunks; i += 32) {
    const int r = 16 * w + i / kChunks, c = col0 + 8 * (i % kChunks);
    *reinterpret_cast<uint4*>(head + (row0 + r) * st + c) = *reinterpret_cast<const uint4*>(
        t + (c / L::kBoxCols) * L::kBoxBytes + r * L::kRowBytes + 2 * (c % L::kBoxCols));
  }
}

// a 64 x N accumulator's fragments (N / 2 a lane, as stage_rows reads
// them), rows scaled by f0 and f1, rounded to bf16, into rows row0 + row
// and row0 + row + 8, columns col0 .. col0 + N - 1 of a (T, D) head at row
// stride st, from the registers
template <int N>
__device__ __forceinline__ void store_frags(bf16* __restrict__ head, long long st, int row0,
                                            int col0, const float (&acc)[N / 2], float f0,
                                            float f1, int row, int t4) {
#pragma unroll
  for (int j = 0; j < N / 8; ++j) {
    const int c = col0 + 8 * j + 2 * t4;
    *reinterpret_cast<__nv_bfloat162*>(head + (row0 + row) * st + c) =
        __floats2bfloat162_rn(acc[4 * j] * f0, acc[4 * j + 1] * f0);
    *reinterpret_cast<__nv_bfloat162*>(head + (row0 + row + 8) * st + c) =
        __floats2bfloat162_rn(acc[4 * j + 2] * f1, acc[4 * j + 3] * f1);
  }
}

// The mbarriers of a block: the stream's ring (full: the producer's arrival
// and the bytes; empty: lane 0 of every consumer warp) and each owner's
// C::kSlots slots for its passes' own tiles (an owner is a consumer
// warpgroup, or both where they split a tile; empty: lane 0 of each of the
// owner's warps), so that the producer runs a pass ahead.
template <class C>
struct FlashBars {
  static constexpr int kOwners = C::kOwners, kSlots = C::kSlots;
  uint64_t full[kMaxFlashStages], empty[kMaxFlashStages];
  uint64_t own_full[kOwners][kSlots], own_empty[kOwners][kSlots];
  __device__ __forceinline__ void init() {
    if (threadIdx.x == 0) {
      for (int s = 0; s < C::kStages; ++s) {
        mbar_init(&full[s], 1);
        mbar_init(&empty[s], kEmptyArrivals);
      }
      for (int g = 0; g < kOwners; ++g)
        for (int s = 0; s < kSlots; ++s) {
          mbar_init(&own_full[g][s], 1);
          mbar_init(&own_empty[g][s], kEmptyArrivals / kOwners);
        }
      asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
    }
    __syncthreads();
  }
  // producer: own slot of owner g's n-th pass, once its use kSlots passes
  // before is released, armed for `bytes`
  __device__ __forceinline__ int own_acquire(int g, int n, uint32_t bytes) {
    const int s = n % kSlots, use = n / kSlots;
    if (use > 0) mbar_wait(&own_empty[g][s], (use - 1) & 1);
    mbar_expect_tx(&own_full[g][s], bytes);
    return s;
  }
  __device__ __forceinline__ int own_wait(int g, int n) {
    mbar_wait_warp(&own_full[g][n % kSlots], (n / kSlots) & 1);
    return n % kSlots;
  }
  // a warp of owner g done with its n-th slot, the staged rows in it
  // included: its generic loads and stores ordered before the producer's
  // next TMA writes there
  __device__ __forceinline__ void own_release(int g, int n, int lane) {
    fence_proxy_async();
    __syncwarp();
    if (lane == 0) mbar_arrive(&own_empty[g][n % kSlots]);
  }
};

// Warpgroup g's tiles in one pass of round r: with kPair (one pass) its
// pair, `a` first and `b` the other (-1 for none); else, one tile a pass,
// `a` the pair's first in pass 0 and its other in pass 1.  The first is
// the tile that sees most of the stream: the later query tile where query
// tiles are owned (K7, K9), the earlier key tile where key tiles are (K8).
// An idle warpgroup (a round past the last pair) has a = -1.  With kSplit
// a round is one tile, both warpgroups', in one pass: key tile r (K8), or
// query tile nt - 1 - r (K9).
struct Job {
  int a, b;
};
template <class C>
__device__ __forceinline__ int flash_rounds(int nt) {
  return C::kSplit ? nt : ((nt + 1) / 2 + kConsumers - 1) / kConsumers;
}
template <class C, bool KEYS>
__device__ __forceinline__ Job job(int nt, int r, int g, int pass) {
  if constexpr (C::kSplit) return {KEYS ? r : nt - 1 - r, -1};
  const int lo = r * kConsumers + g, hi = nt - 1 - lo;
  if (lo > hi) return {-1, -1};
  const int first = KEYS ? lo : hi, other = lo == hi ? -1 : (KEYS ? hi : lo);
  if (C::kPair) return {first, other};
  return pass == 0 ? Job{first, -1} : Job{other, -1};
}
// K7, K9: the pass streams key tiles 0 .. the returned count - 1
template <class C>
__device__ __forceinline__ int key_tiles(int nt, int r, int pass) {
  int len = 0;
#pragma unroll
  for (int g = 0; g < kConsumers; ++g) {
    const Job j = job<C, false>(nt, r, g, pass);
    if (j.a >= 0) len = max(len, max(j.a, j.b) + 1);
  }
  return len;
}
// K8: the pass streams query tiles from the returned one to nt - 1
template <class C>
__device__ __forceinline__ int first_query(int nt, int r, int pass) {
  int first = nt;
#pragma unroll
  for (int g = 0; g < kConsumers; ++g) {
    const Job j = job<C, true>(nt, r, g, pass);
    if (j.a >= 0) first = min(first, j.b >= 0 ? min(j.a, j.b) : j.a);
  }
  return first;
}

// every consumer warp on the pass's own tiles past its last product, so
// they may be overwritten: the warpgroup's four, or both warpgroups' eight
// where they split the tiles
template <class C>
__device__ __forceinline__ void owners_sync(int g) {
  if constexpr (C::kSplit)
    named_bar_sync(1, 128 * kConsumers);
  else
    named_bar_sync(1 + g, 128);
}

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

// whether element i of a lane's share of a 64 x 64 tile lies past the
// diagonal: its column (8 (i >> 2) + 2 t4 + (i & 1)) after its row (`row`,
// or row + 8 where i & 2)
__device__ __forceinline__ bool past_diagonal(int i, int row, int t4) {
  return 8 * (i >> 2) + 2 * t4 + (i & 1) > row + 8 * ((i >> 1) & 1);
}

// K7's running state of one query tile in a lane: its share of the o
// accumulator (N of its columns), and of its two rows the running maxima
// (log2 units) and this lane's partial sums
template <int N>
struct FwdTile {
  float o[N / 2];
  float m0, m1, l0, l1;
  __device__ __forceinline__ void reset() {
#pragma unroll
    for (int i = 0; i < N / 2; ++i) o[i] = 0.f;
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
        if (past_diagonal(i, row, t4)) s[i] = -INFINITY;
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
    for (int i = 0; i < N / 2; ++i) o[i] *= (i & 2) ? a1 : a0;
    to_a(pa, s);
  }
};

// One key tile of K7 against the warpgroup's tile `a` and, with BOTH, its
// tile `b`, in lockstep: S = Q K^T for each, one wait, the online softmax
// of each, O += P V for each (V's N columns from `vb`), one wait.
// `diag_*`: the key tile is that query tile.  (BOTH is a template argument
// so that no wgmma sits in a branch of its own: ptxas serialises wgmma
// whose registers a divergent path defines.)
template <int D, int N, bool BOTH>
__device__ __forceinline__ void fwd_step(const uint8_t* qa, const uint8_t* qb, const uint8_t* kb,
                                         const uint8_t* vb, bool diag_a, bool diag_b,
                                         FwdTile<N>& ta, FwdTile<N>& tb, float scale_log2, int row,
                                         int t4) {
  using L = Tile<D>;
  float sa[32], sb[32];
  uint32_t pa[4][4], pb[4][4];
  wgmma_fence();
#pragma unroll
  for (int kk = 0; kk < L::kSteps; ++kk) wgmma_ss(sa, L::kmajor(qa, kk), L::kmajor(kb, kk), kk > 0);
  if constexpr (BOTH) {
#pragma unroll
    for (int kk = 0; kk < L::kSteps; ++kk)
      wgmma_ss(sb, L::kmajor(qb, kk), L::kmajor(kb, kk), kk > 0);
  }
  wgmma_commit();
  wgmma_wait<0>();
  hold(sa);
  if constexpr (BOTH) hold(sb);
  ta.update(sa, pa, diag_a, scale_log2, row, t4);
  if constexpr (BOTH) tb.update(sb, pb, diag_b, scale_log2, row, t4);
  wgmma_fence();
#pragma unroll
  for (int kk = 0; kk < 4; ++kk) wgmma_rs(ta.o, pa[kk], L::mnmajor(vb, kk));
  if constexpr (BOTH) {
#pragma unroll
    for (int kk = 0; kk < 4; ++kk) wgmma_rs(tb.o, pb[kk], L::mnmajor(vb, kk));
  }
  wgmma_commit();
  wgmma_wait<0>();
  hold(ta.o);
  hold(pa);
  if constexpr (BOTH) {
    hold(tb.o);
    hold(pb);
  }
}

// K7's end of one query tile in a warp: its 16 rows of o (columns col0 ..
// col0 + N - 1) normalised into the warp's rows of the staged tile `t`,
// and, with `with_lse`, their lse to `lse_tile`
template <int D, int N>
__device__ __forceinline__ void fwd_finish(uint8_t* t, float* __restrict__ lse_tile,
                                           FwdTile<N>& ft, int w, int lane, int col0,
                                           bool with_lse) {
#pragma unroll
  for (int off = 1; off <= 2; off <<= 1) {
    ft.l0 += __shfl_xor_sync(0xffffffffu, ft.l0, off);
    ft.l1 += __shfl_xor_sync(0xffffffffu, ft.l1, off);
  }
  stage_rows<D, N>(t, ft.o, 1.f / ft.l0, 1.f / ft.l1, w, lane, col0);
  if (with_lse && (lane & 3) == 0) {
    const int r = 16 * w + (lane >> 2);
    lse_tile[r] = (ft.m0 + __log2f(ft.l0)) * kLn2;
    lse_tile[r + 8] = (ft.m1 + __log2f(ft.l1)) * kLn2;
  }
}

// The producer's loads into the ring's next stage (load `it` of the
// stream): K7's and K9's key tile kt (K, V), or K8's query tile qt (Q, dO,
// and the tile's lse and di of the head's lse_h, di_h)
template <int D>
__device__ __forceinline__ void stream_kv(const Ring& stream, int it, uint8_t* ring, int stage,
                                          uint64_t* full, const CUtensorMap* map_k,
                                          const CUtensorMap* map_v, int kt, int h, int b) {
  const int s = stream.acquire(it, stage);
  uint8_t* st = ring + s * stage;
  tma_tile<D>(st, map_k, &full[s], kt * kFlashTile, h, b);
  tma_tile<D>(st + Tile<D>::kBytes, map_v, &full[s], kt * kFlashTile, h, b);
}
template <int D>
__device__ __forceinline__ void stream_qdo(const Ring& stream, int it, uint8_t* ring, int stage,
                                           uint64_t* full, const CUtensorMap* map_q,
                                           const CUtensorMap* map_do, const float* lse_h,
                                           const float* di_h, int qt, int h, int b) {
  using L = Tile<D>;
  const int s = stream.acquire(it, 2 * L::kBytes + 2 * kVecBytes);
  uint8_t* st = ring + s * stage;
  tma_tile<D>(st, map_q, &full[s], qt * kFlashTile, h, b);
  tma_tile<D>(st + L::kBytes, map_do, &full[s], qt * kFlashTile, h, b);
  bulk_load(st + 2 * L::kBytes, lse_h + qt * kFlashTile, kVecBytes, &full[s]);
  bulk_load(st + 2 * L::kBytes + kVecBytes, di_h + qt * kFlashTile, kVecBytes, &full[s]);
}

// ---------------------------------------------------------------------------
// K7, bf16, D 32 to 128.  Shared memory: the ring (stages of [K tile, V
// tile]) and each warpgroup's own slots ([Q of a, Q of b]), where o is
// staged.
// ---------------------------------------------------------------------------
template <int D>
__global__ void __launch_bounds__(kHopperThreads, 1)
flash_fwd_hopper(const __grid_constant__ CUtensorMap map_q, const __grid_constant__ CUtensorMap map_k,
                 const __grid_constant__ CUtensorMap map_v, bf16* __restrict__ o,
                 float* __restrict__ lse, FlashLayout lay, int H, int BH, int T, float scale_log2) {
  using L = Tile<D>;
  using C = FwdCfg<D>;
  static_assert(!C::kSplit, "D 256 runs flash_fwd_d256");
  constexpr int kPasses = C::kPair ? 1 : 2;
  extern __shared__ uint8_t smem_raw[];
  __shared__ __align__(8) FlashBars<C> bars;
  uint8_t* ring = align1024(smem_raw);
  uint8_t* own = ring + C::kStages * C::kStage;  // [warpgroup][slot]
  const int nt = T / kFlashTile, rounds = flash_rounds<C>(nt);
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  bars.init();
  const Ring stream{bars.full, bars.empty, C::kStages};

  if (warp >= kProducer) {
    if constexpr (C::kRaise) regs_dec<kProducerRegs>();
    if (warp == kProducer && lane == 0) {
      int it = 0, n[C::kOwners] = {};
      for (int bh = blockIdx.x; bh < BH; bh += gridDim.x) {
        const int b = bh / H, h = bh % H;
        for (int r = 0; r < rounds; ++r)
          for (int pass = 0; pass < kPasses; ++pass) {
#pragma unroll
            for (int g = 0; g < C::kOwners; ++g) {
              const Job j = job<C, false>(nt, r, g, pass);
              if (j.a < 0) continue;
              const int s = bars.own_acquire(g, n[g]++, (j.b >= 0 ? 2 : 1) * L::kBytes);
              uint8_t* dst = own + (g * C::kSlots + s) * C::kSlot;
              tma_tile<D>(dst, &map_q, &bars.own_full[g][s], j.a * kFlashTile, h, b);
              if (j.b >= 0)
                tma_tile<D>(dst + L::kBytes, &map_q, &bars.own_full[g][s], j.b * kFlashTile, h, b);
            }
            const int len = key_tiles<C>(nt, r, pass);
            for (int kt = 0; kt < len; ++kt, ++it)
              stream_kv<D>(stream, it, ring, C::kStage, bars.full, &map_k, &map_v, kt, h, b);
          }
      }
    }
    return;
  }

  if constexpr (C::kRaise) regs_inc<kConsumerRegs>();
  const int g = warp >> 2, w = warp & 3, t4 = lane & 3;
  const int row = 16 * w + (lane >> 2);  // the lane's rows of a tile: row, row + 8
  int it = 0, n = 0;
  for (int bh = blockIdx.x; bh < BH; bh += gridDim.x) {
    const int b = bh / H, h = bh % H;
    for (int r = 0; r < rounds; ++r)
      for (int pass = 0; pass < kPasses; ++pass) {
        const Job j = job<C, false>(nt, r, g, pass);
        const int len = key_tiles<C>(nt, r, pass);
        uint8_t* qs = j.a >= 0 ? own + (g * C::kSlots + bars.own_wait(g, n)) * C::kSlot : nullptr;
        FwdTile<D> ta, tb;
        ta.reset();
        tb.reset();
        for (int kt = 0; kt < len; ++kt, ++it) {
          const uint8_t* st = ring + stream.wait(it) * C::kStage;
          if constexpr (C::kPair) {
            if (j.b >= 0 && kt <= j.b)
              fwd_step<D, D, true>(qs, qs + L::kBytes, st, st + L::kBytes, kt == j.a, kt == j.b,
                                   ta, tb, scale_log2, row, t4);
            else if (j.a >= 0 && kt <= j.a)
              fwd_step<D, D, false>(qs, nullptr, st, st + L::kBytes, kt == j.a, false, ta, tb,
                                    scale_log2, row, t4);
          } else {
            if (j.a >= 0 && kt <= j.a)
              fwd_step<D, D, false>(qs, nullptr, st, st + L::kBytes, kt == j.a, false, ta, tb,
                                    scale_log2, row, t4);
          }
          stream.release(it, lane);
        }
        if (j.a < 0) continue;
        float* lh = lse + (long long)bh * T;
        bf16* oh = head_ptr(o, lay, 3, b, h);
        owners_sync<C>(g);  // every warp on these tiles past its last product: Q may be overwritten
        fwd_finish<D, D>(qs, lh + j.a * kFlashTile, ta, w, lane, 0, true);
        if (j.b >= 0) fwd_finish<D, D>(qs + L::kBytes, lh + j.b * kFlashTile, tb, w, lane, 0, true);
        __syncwarp();
        write_rows<D, D>(oh, lay.s[3][2], j.a * kFlashTile, qs, w, lane, 0);
        if (j.b >= 0) write_rows<D, D>(oh, lay.s[3][2], j.b * kFlashTile, qs + L::kBytes, w, lane, 0);
        bars.own_release(g, n++, lane);
      }
  }
}

// ---------------------------------------------------------------------------
// K7, bf16, D 256: each consumer warpgroup owns its query tiles and the
// whole 64 x 256 o of one (128 float32 registers a thread), so S and the
// exponentials are computed once a tile.  A round's pairs take two passes
// of one tile each (job<Fwd256Cfg>, as at D 128), each warpgroup with one
// 32 KB slot for its pass's Q, where o is staged.  The stream, for both
// warpgroups, runs a pass's key tiles from the last down (the diagonal
// tile first, which the online softmax takes in any order), in two stages
// of a K and a V tile; where the second pass needs no more key tiles than
// the ring holds (T 256: key tiles 1 and 0), it reads them where the first
// pass left them, so each K and V tile of a head is loaded once.  No
// faster, on the card (PERF.md): the two warpgroups taking turns at their
// products (named barriers), a third Q slot, o stored from the registers,
// K and V in stages of their own, a pass's stream loads before its Q, and
// the next key tile's S issued before the softmax (it spills).
// ---------------------------------------------------------------------------
struct Fwd256Cfg {
  static constexpr bool kSplit = false, kPair = false;
  static constexpr int kOwners = kConsumers, kSlots = 1;  // a Q slot a warpgroup
  static constexpr int kSlot = Tile<256>::kBytes, kStage = 2 * Tile<256>::kBytes;
  static constexpr int kStages = ring_stages(kStage, kOwners * kSlot, kMaxFlashStages);
  static constexpr size_t kSmem = 1024 + (size_t)kStages * kStage + (size_t)kOwners * kSlot;
  static_assert(kStages >= 2, "the ring's depth");
  static_assert(kSmem <= (size_t)kSmemLimit, "shared memory");
};

// The key tiles a pass of round r streams (len) and the stream item of its
// last key tile, from the round's first item `it`: the first pass's from
// `it` on; the second pass's after them, or, where they fit the ring, the
// first pass's last `len` items again (reuse)
struct Pass256 {
  int len, first, reuse;
};
__device__ __forceinline__ Pass256 pass256(int nt, int r, int pass) {
  using C = Fwd256Cfg;
  const int len0 = key_tiles<C>(nt, r, 0), len1 = key_tiles<C>(nt, r, 1);
  const int reuse = len1 <= C::kStages ? len1 : 0;
  if (pass == 0) return {len0, 0, reuse};
  return {len1, reuse ? len0 - len1 : len0, reuse};
}

// One key tile of K7 at D 256 against the warpgroup's query tile: S = Q K^T
// (16 k16 steps), the online softmax, O += P V (4 steps of m64n256k16).
__device__ __forceinline__ void fwd_step256(const uint8_t* qs, const uint8_t* st, bool diag,
                                            FwdTile<256>& ta, float scale_log2, int row, int t4) {
  using L = Tile<256>;
  float s[32];
  uint32_t pa[4][4];
  wgmma_fence();
#pragma unroll
  for (int kk = 0; kk < L::kSteps; ++kk) wgmma_ss(s, L::kmajor(qs, kk), L::kmajor(st, kk), kk > 0);
  wgmma_commit();
  wgmma_wait<0>();
  hold(s);
  ta.update(s, pa, diag, scale_log2, row, t4);
  wgmma_fence();
#pragma unroll
  for (int kk = 0; kk < 4; ++kk) wgmma_rs(ta.o, pa[kk], L::mnmajor(st + L::kBytes, kk));
  wgmma_commit();
  wgmma_wait<0>();
  hold(ta.o);
  hold(pa);
}

__global__ void __launch_bounds__(kHopperThreads, 1)
flash_fwd_d256(const __grid_constant__ CUtensorMap map_q, const __grid_constant__ CUtensorMap map_k,
               const __grid_constant__ CUtensorMap map_v, bf16* __restrict__ o,
               float* __restrict__ lse, FlashLayout lay, int H, int BH, int T, float scale_log2) {
  using L = Tile<256>;
  using C = Fwd256Cfg;
  extern __shared__ uint8_t smem_raw[];
  __shared__ __align__(8) FlashBars<C> bars;
  uint8_t* ring = align1024(smem_raw);
  uint8_t* own = ring + C::kStages * C::kStage;  // [warpgroup]
  const int nt = T / kFlashTile, rounds = flash_rounds<C>(nt);
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  bars.init();
  const Ring stream{bars.full, bars.empty, C::kStages};

  if (warp >= kProducer) {
    regs_dec<kProducerRegs>();
    if (warp == kProducer && lane == 0) {
      int it = 0, n[kConsumers] = {};
      for (int bh = blockIdx.x; bh < BH; bh += gridDim.x) {
        const int b = bh / H, h = bh % H;
        for (int r = 0; r < rounds; ++r)
          for (int pass = 0; pass < 2; ++pass) {
#pragma unroll
            for (int g = 0; g < kConsumers; ++g) {
              const Job j = job<C, false>(nt, r, g, pass);
              if (j.a < 0) continue;
              const int s = bars.own_acquire(g, n[g]++, L::kBytes);
              tma_tile<256>(own + g * C::kSlot, &map_q, &bars.own_full[g][s], j.a * kFlashTile, h, b);
            }
            const Pass256 p = pass256(nt, r, pass);
            if (pass == 1 && p.reuse) continue;
            for (int kt = p.len - 1; kt >= 0; --kt, ++it)
              stream_kv<256>(stream, it, ring, C::kStage, bars.full, &map_k, &map_v, kt, h, b);
          }
      }
    }
    return;
  }

  regs_inc<kConsumerRegs>();
  const int g = warp >> 2, w = warp & 3, t4 = lane & 3;
  const int row = 16 * w + (lane >> 2);  // the lane's rows of a tile: row, row + 8
  uint8_t* qs = own + g * C::kSlot;
  int it = 0, n = 0;  // the round's first stream item; the warpgroup's passes
  for (int bh = blockIdx.x; bh < BH; bh += gridDim.x) {
    const int b = bh / H, h = bh % H;
    for (int r = 0; r < rounds; ++r) {
      for (int pass = 0; pass < 2; ++pass) {
        const Job j = job<C, false>(nt, r, g, pass);
        const Pass256 p = pass256(nt, r, pass);
        if (j.a >= 0) bars.own_wait(g, n);
        FwdTile<256> ta;
        ta.reset();
        for (int kt = p.len - 1, i = it + p.first; kt >= 0; --kt, ++i) {
          // a reused item was waited for in the first pass and is released in the second
          if (pass == 0 || !p.reuse) stream.wait(i);
          if (j.a >= 0 && kt <= j.a)
            fwd_step256(qs, ring + (i % C::kStages) * C::kStage, kt == j.a, ta, scale_log2, row, t4);
          if (pass == 1 || kt >= p.reuse) stream.release(i, lane);
        }
        if (j.a < 0) continue;
        named_bar_sync(1 + g, 128);  // every warp past its last product: Q may be overwritten
        fwd_finish<256, 256>(qs, lse + (long long)bh * T + j.a * kFlashTile, ta, w, lane, 0, true);
        __syncwarp();
        write_rows<256, 256>(head_ptr(o, lay, 3, b, h), lay.s[3][2], j.a * kFlashTile, qs, w, lane, 0);
        bars.own_release(g, n++, lane);
      }
      const Pass256 p = pass256(nt, r, 1);
      it += p.first + p.len;
    }
  }
}

// One query tile of K8 against one key tile: S^T = K Q^T and dP^T = V dO^T,
// P^T from lse, dS^T = P^T (dP^T - di) scale, dV += P^T dO, dK += dS^T Q,
// dK and dV over the N columns of dO and Q from byte `off` of their tiles.
// `key` is the lane's first key row in the tile; `diag`: the query tile is
// the key tile, queries before the key are masked.
template <int D, int N>
__device__ __forceinline__ void bwd_step(const uint8_t* kb, const uint8_t* vb, const uint8_t* st,
                                         bool diag, float (&dk)[N / 2], float (&dv)[N / 2],
                                         float scale, float scale_log2, int key, int t4, int off) {
  using L = Tile<D>;
  const uint8_t* qb = st;
  const uint8_t* dob = st + L::kBytes;
  const float* ls = reinterpret_cast<const float*>(st + 2 * L::kBytes);
  const float* dis = ls + kFlashTile;
  float sp[32], dp[32];
  wgmma_fence();
#pragma unroll
  for (int kk = 0; kk < L::kSteps; ++kk) wgmma_ss(sp, L::kmajor(kb, kk), L::kmajor(qb, kk), kk > 0);
#pragma unroll
  for (int kk = 0; kk < L::kSteps; ++kk)
    wgmma_ss(dp, L::kmajor(vb, kk), L::kmajor(dob, kk), kk > 0);
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
  for (int kk = 0; kk < 4; ++kk) wgmma_rs(dv, pa[kk], L::mnmajor(dob + off, kk));
#pragma unroll
  for (int kk = 0; kk < 4; ++kk) wgmma_rs(dk, dsa[kk], L::mnmajor(qb + off, kk));
  wgmma_commit();
  wgmma_wait<0>();
  hold(dv);
  hold(dk);
  hold(pa);
  hold(dsa);
}

// ---------------------------------------------------------------------------
// K8, bf16.  Shared memory: the ring (stages of [Q tile, dO tile, lse, di])
// and each owner's own slots ([K, V of a, K, V of b]), where dk and dv are
// staged.
// ---------------------------------------------------------------------------
template <int D>
__global__ void __launch_bounds__(kHopperThreads, 1)
flash_bwd_dkv_hopper(const __grid_constant__ CUtensorMap map_q, const __grid_constant__ CUtensorMap map_k,
                     const __grid_constant__ CUtensorMap map_v, const __grid_constant__ CUtensorMap map_do,
                     bf16* __restrict__ dk, bf16* __restrict__ dv, const float* __restrict__ lse,
                     const float* __restrict__ di, FlashLayout lay, int H, int BH, int T,
                     float scale, float scale_log2) {
  using L = Tile<D>;
  using C = DkvCfg<D>;
  constexpr int kPasses = C::kPair || C::kSplit ? 1 : 2;
  extern __shared__ uint8_t smem_raw[];
  __shared__ __align__(8) FlashBars<C> bars;
  uint8_t* ring = align1024(smem_raw);
  uint8_t* own = ring + C::kStages * C::kStage;  // [owner][slot]
  const int nt = T / kFlashTile, rounds = flash_rounds<C>(nt);
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  bars.init();
  const Ring stream{bars.full, bars.empty, C::kStages};

  if (warp >= kProducer) {
    if constexpr (C::kRaise) regs_dec<kProducerRegs>();
    if (warp == kProducer && lane == 0) {
      int it = 0, n[C::kOwners] = {};
      for (int bh = blockIdx.x; bh < BH; bh += gridDim.x) {
        const int b = bh / H, h = bh % H;
        const float* lh = lse + (long long)bh * T;
        const float* dh = di + (long long)bh * T;
        for (int r = 0; r < rounds; ++r)
          for (int pass = 0; pass < kPasses; ++pass) {
            // with kSplit's one own slot, the stages the last round released
            // go out before the slot is waited for (PERF.md: 4 % at d 256,
            // where K7 and K9 lose 1-2 % by it)
            const int q0 = first_query<C>(nt, r, pass);
            const int early = C::kSplit ? q0 + min(nt - q0, C::kStages) : q0;
            for (int qt = q0; qt < early; ++qt, ++it)
              stream_qdo<D>(stream, it, ring, C::kStage, bars.full, &map_q, &map_do, lh, dh, qt, h,
                            b);
#pragma unroll
            for (int g = 0; g < C::kOwners; ++g) {
              const Job j = job<C, true>(nt, r, g, pass);
              if (j.a < 0) continue;
              const int s = bars.own_acquire(g, n[g]++, (j.b >= 0 ? 4 : 2) * L::kBytes);
              uint8_t* dst = own + (g * C::kSlots + s) * C::kSlot;
              uint64_t* bar = &bars.own_full[g][s];
              tma_tile<D>(dst, &map_k, bar, j.a * kFlashTile, h, b);
              tma_tile<D>(dst + L::kBytes, &map_v, bar, j.a * kFlashTile, h, b);
              if (j.b >= 0) {
                tma_tile<D>(dst + 2 * L::kBytes, &map_k, bar, j.b * kFlashTile, h, b);
                tma_tile<D>(dst + 3 * L::kBytes, &map_v, bar, j.b * kFlashTile, h, b);
              }
            }
            for (int qt = early; qt < nt; ++qt, ++it)
              stream_qdo<D>(stream, it, ring, C::kStage, bars.full, &map_q, &map_do, lh, dh, qt, h,
                            b);
          }
      }
    }
    return;
  }

  if constexpr (C::kRaise) regs_inc<kConsumerRegs>();
  const int g = warp >> 2, w = warp & 3, t4 = lane & 3;
  const int key = 16 * w + (lane >> 2);  // the lane's key rows of a tile: key, key + 8
  const int og = C::kSplit ? 0 : g;                   // the owner of its own slots
  const int col0 = C::kSplit ? g * C::kCols : 0;      // its first accumulator column
  const int off = col0 / L::kBoxCols * L::kBoxBytes;  // that column's box in a tile
  constexpr int N = C::kCols;
  int it = 0, n = 0;
  for (int bh = blockIdx.x; bh < BH; bh += gridDim.x) {
    const int b = bh / H, h = bh % H;
    for (int r = 0; r < rounds; ++r)
      for (int pass = 0; pass < kPasses; ++pass) {
        const Job j = job<C, true>(nt, r, g, pass);
        uint8_t* kv = j.a >= 0 ? own + (og * C::kSlots + bars.own_wait(og, n)) * C::kSlot : nullptr;
        float dka[N / 2], dva[N / 2], dkb[N / 2], dvb[N / 2];
#pragma unroll
        for (int i = 0; i < N / 2; ++i) dka[i] = dva[i] = dkb[i] = dvb[i] = 0.f;
        for (int qt = first_query<C>(nt, r, pass); qt < nt; ++qt, ++it) {
          const uint8_t* st = ring + stream.wait(it) * C::kStage;
          if (j.a >= 0 && qt >= j.a)
            bwd_step<D, N>(kv, kv + L::kBytes, st, qt == j.a, dka, dva, scale, scale_log2, key, t4,
                           off);
          if constexpr (C::kPair) {
            if (j.b >= 0 && qt >= j.b)
              bwd_step<D, N>(kv + 2 * L::kBytes, kv + 3 * L::kBytes, st, qt == j.b, dkb, dvb, scale,
                             scale_log2, key, t4, off);
          }
          stream.release(it, lane);
        }
        if (j.a < 0) continue;
        bf16* dkh = head_ptr(dk, lay, 4, b, h);
        bf16* dvh = head_ptr(dv, lay, 5, b, h);
        owners_sync<C>(g);  // every warp on these tiles past its last product: K, V may be overwritten
        stage_rows<D, N>(kv, dka, 1.f, 1.f, w, lane, col0);
        stage_rows<D, N>(kv + L::kBytes, dva, 1.f, 1.f, w, lane, col0);
        if (j.b >= 0) {
          stage_rows<D, N>(kv + 2 * L::kBytes, dkb, 1.f, 1.f, w, lane, col0);
          stage_rows<D, N>(kv + 3 * L::kBytes, dvb, 1.f, 1.f, w, lane, col0);
        }
        __syncwarp();
        write_rows<D, N>(dkh, lay.s[4][2], j.a * kFlashTile, kv, w, lane, col0);
        write_rows<D, N>(dvh, lay.s[5][2], j.a * kFlashTile, kv + L::kBytes, w, lane, col0);
        if (j.b >= 0) {
          write_rows<D, N>(dkh, lay.s[4][2], j.b * kFlashTile, kv + 2 * L::kBytes, w, lane, col0);
          write_rows<D, N>(dvh, lay.s[5][2], j.b * kFlashTile, kv + 3 * L::kBytes, w, lane, col0);
        }
        bars.own_release(og, n++, lane);
      }
  }
}

// a lane's two rows of a K9 tile: lse in log2 units, and di
struct DqRows {
  float l0, l1, d0, d1;
};

// K9's dS of one query tile against one key tile, from S (s) and dP (dp):
// p = exp2(s scale_log2 - lse), masked past the diagonal on the diagonal
// tile, dS = p (dP - di) scale, rounded to bf16 as A fragments
__device__ __forceinline__ void dq_ds(float (&s)[32], const float (&dp)[32], uint32_t (&ds)[4][4],
                                      bool diag, const DqRows& rows, float scale, float scale_log2,
                                      int row, int t4) {
#pragma unroll
  for (int i = 0; i < 32; ++i) {
    const bool second = (i >> 1) & 1;
    const float p = ex2(fmaf(s[i], scale_log2, second ? -rows.l1 : -rows.l0));
    s[i] = p * (dp[i] - (second ? rows.d1 : rows.d0)) * scale;
  }
  if (diag) {
#pragma unroll
    for (int i = 0; i < 32; ++i)
      if (past_diagonal(i, row, t4)) s[i] = 0.f;
  }
  to_a(ds, s);
}

// One key tile of K9 against the warpgroup's tile `a` (its unit `ua`: Q,
// dO) and, with BOTH, its tile `b` (`ub`), in lockstep: S = Q K^T and dP =
// dO V^T for each, one wait, dS of each, dQ += dS K for each (over the N
// columns of K from byte `off` of its tile), one wait.
template <int D, int N, bool BOTH>
__device__ __forceinline__ void dq_step(const uint8_t* ua, const uint8_t* ub, const uint8_t* st,
                                        bool diag_a, bool diag_b, float (&dqa)[N / 2],
                                        float (&dqb)[N / 2], const DqRows& ra, const DqRows& rb,
                                        float scale, float scale_log2, int row, int t4, int off) {
  using L = Tile<D>;
  const uint8_t* kb = st;
  const uint8_t* vb = st + L::kBytes;
  float sa[32], pa[32], sb[32], pb[32];
  wgmma_fence();
#pragma unroll
  for (int kk = 0; kk < L::kSteps; ++kk) wgmma_ss(sa, L::kmajor(ua, kk), L::kmajor(kb, kk), kk > 0);
#pragma unroll
  for (int kk = 0; kk < L::kSteps; ++kk)
    wgmma_ss(pa, L::kmajor(ua + L::kBytes, kk), L::kmajor(vb, kk), kk > 0);
  if constexpr (BOTH) {
#pragma unroll
    for (int kk = 0; kk < L::kSteps; ++kk)
      wgmma_ss(sb, L::kmajor(ub, kk), L::kmajor(kb, kk), kk > 0);
#pragma unroll
    for (int kk = 0; kk < L::kSteps; ++kk)
      wgmma_ss(pb, L::kmajor(ub + L::kBytes, kk), L::kmajor(vb, kk), kk > 0);
  }
  wgmma_commit();
  wgmma_wait<0>();
  hold(sa);
  hold(pa);
  if constexpr (BOTH) {
    hold(sb);
    hold(pb);
  }
  uint32_t dsa[4][4], dsb[4][4];
  dq_ds(sa, pa, dsa, diag_a, ra, scale, scale_log2, row, t4);
  if constexpr (BOTH) dq_ds(sb, pb, dsb, diag_b, rb, scale, scale_log2, row, t4);
  wgmma_fence();
#pragma unroll
  for (int kk = 0; kk < 4; ++kk) wgmma_rs(dqa, dsa[kk], L::mnmajor(kb + off, kk));
  if constexpr (BOTH) {
#pragma unroll
    for (int kk = 0; kk < 4; ++kk) wgmma_rs(dqb, dsb[kk], L::mnmajor(kb + off, kk));
  }
  wgmma_commit();
  wgmma_wait<0>();
  hold(dqa);
  hold(dsa);
  if constexpr (BOTH) {
    hold(dqb);
    hold(dsb);
  }
}

// a lane's two rows of the K9 unit `u`
template <int D>
__device__ __forceinline__ DqRows dq_rows(const uint8_t* u, int row) {
  const float* v = reinterpret_cast<const float*>(u + 2 * Tile<D>::kBytes);
  return {v[row] * kLog2e, v[row + 8] * kLog2e, v[kFlashTile + row], v[kFlashTile + row + 8]};
}

// ---------------------------------------------------------------------------
// K9, bf16.  Shared memory: the ring (stages of [K tile, V tile], K7's
// stream) and each owner's own slots (a unit [Q, dO, lse, di] for a and one
// for b), where dq is staged over Q.
// ---------------------------------------------------------------------------
template <int D>
__global__ void __launch_bounds__(kHopperThreads, 1)
flash_bwd_dq_hopper(const __grid_constant__ CUtensorMap map_q, const __grid_constant__ CUtensorMap map_k,
                    const __grid_constant__ CUtensorMap map_v, const __grid_constant__ CUtensorMap map_do,
                    bf16* __restrict__ dq, const float* __restrict__ lse,
                    const float* __restrict__ di, FlashLayout lay, int H, int BH, int T,
                    float scale, float scale_log2) {
  using L = Tile<D>;
  using C = DqCfg<D>;
  constexpr int kPasses = C::kPair || C::kSplit ? 1 : 2;
  extern __shared__ uint8_t smem_raw[];
  __shared__ __align__(8) FlashBars<C> bars;
  uint8_t* ring = align1024(smem_raw);
  uint8_t* own = ring + C::kStages * C::kStage;  // [owner][slot]
  const int nt = T / kFlashTile, rounds = flash_rounds<C>(nt);
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  bars.init();
  const Ring stream{bars.full, bars.empty, C::kStages};

  if (warp >= kProducer) {
    if constexpr (C::kRaise) regs_dec<kProducerRegs>();
    if (warp == kProducer && lane == 0) {
      int it = 0, n[C::kOwners] = {};
      for (int bh = blockIdx.x; bh < BH; bh += gridDim.x) {
        const int b = bh / H, h = bh % H;
        const float* lh = lse + (long long)bh * T;
        const float* dh = di + (long long)bh * T;
        for (int r = 0; r < rounds; ++r)
          for (int pass = 0; pass < kPasses; ++pass) {
#pragma unroll
            for (int g = 0; g < C::kOwners; ++g) {
              const Job j = job<C, false>(nt, r, g, pass);
              if (j.a < 0) continue;
              const int s = bars.own_acquire(g, n[g]++,
                                             (j.b >= 0 ? 2 : 1) * (2 * L::kBytes + 2 * kVecBytes));
              uint64_t* bar = &bars.own_full[g][s];
#pragma unroll
              for (int u = 0; u < 2; ++u) {
                const int t = u == 0 ? j.a : j.b;
                if (t < 0) continue;
                uint8_t* dst = own + (g * C::kSlots + s) * C::kSlot + u * C::kUnit;
                tma_tile<D>(dst, &map_q, bar, t * kFlashTile, h, b);
                tma_tile<D>(dst + L::kBytes, &map_do, bar, t * kFlashTile, h, b);
                bulk_load(dst + 2 * L::kBytes, lh + t * kFlashTile, kVecBytes, bar);
                bulk_load(dst + 2 * L::kBytes + kVecBytes, dh + t * kFlashTile, kVecBytes, bar);
              }
            }
            const int len = key_tiles<C>(nt, r, pass);
            for (int kt = 0; kt < len; ++kt, ++it)
              stream_kv<D>(stream, it, ring, C::kStage, bars.full, &map_k, &map_v, kt, h, b);
          }
      }
    }
    return;
  }

  if constexpr (C::kRaise) regs_inc<kConsumerRegs>();
  const int g = warp >> 2, w = warp & 3, t4 = lane & 3;
  const int row = 16 * w + (lane >> 2);  // the lane's rows of a tile: row, row + 8
  const int og = C::kSplit ? 0 : g;                   // the owner of its own slots
  const int col0 = C::kSplit ? g * C::kCols : 0;      // its first accumulator column
  const int off = col0 / L::kBoxCols * L::kBoxBytes;  // that column's box in a tile
  constexpr int N = C::kCols;
  int it = 0, n = 0;
  for (int bh = blockIdx.x; bh < BH; bh += gridDim.x) {
    const int b = bh / H, h = bh % H;
    for (int r = 0; r < rounds; ++r)
      for (int pass = 0; pass < kPasses; ++pass) {
        const Job j = job<C, false>(nt, r, g, pass);
        const int len = key_tiles<C>(nt, r, pass);
        uint8_t* ua = j.a >= 0 ? own + (og * C::kSlots + bars.own_wait(og, n)) * C::kSlot : nullptr;
        uint8_t* ub = C::kPair && j.b >= 0 ? ua + C::kUnit : nullptr;
        DqRows ra{}, rb{};
        if (j.a >= 0) ra = dq_rows<D>(ua, row);
        if (C::kPair && j.b >= 0) rb = dq_rows<D>(ub, row);
        float dqa[N / 2], dqb[N / 2];
#pragma unroll
        for (int i = 0; i < N / 2; ++i) dqa[i] = dqb[i] = 0.f;
        for (int kt = 0; kt < len; ++kt, ++it) {
          const uint8_t* st = ring + stream.wait(it) * C::kStage;
          if constexpr (C::kPair) {
            if (j.b >= 0 && kt <= j.b)
              dq_step<D, N, true>(ua, ub, st, kt == j.a, kt == j.b, dqa, dqb, ra, rb, scale,
                                  scale_log2, row, t4, off);
            else if (j.a >= 0 && kt <= j.a)
              dq_step<D, N, false>(ua, nullptr, st, kt == j.a, false, dqa, dqb, ra, rb, scale,
                                   scale_log2, row, t4, off);
          } else {
            if (j.a >= 0 && kt <= j.a)
              dq_step<D, N, false>(ua, nullptr, st, kt == j.a, false, dqa, dqb, ra, rb, scale,
                                   scale_log2, row, t4, off);
          }
          stream.release(it, lane);
        }
        if (j.a < 0) continue;
        bf16* dqh = head_ptr(dq, lay, 4, b, h);
        owners_sync<C>(g);  // every warp on these tiles past its last product: Q may be overwritten
        stage_rows<D, N>(ua, dqa, 1.f, 1.f, w, lane, col0);
        if (j.b >= 0) stage_rows<D, N>(ub, dqb, 1.f, 1.f, w, lane, col0);
        __syncwarp();
        write_rows<D, N>(dqh, lay.s[4][2], j.a * kFlashTile, ua, w, lane, col0);
        if (j.b >= 0) write_rows<D, N>(dqh, lay.s[4][2], j.b * kFlashTile, ub, w, lane, col0);
        bars.own_release(og, n++, lane);
      }
  }
}

// ---------------------------------------------------------------------------
// float32 on the CUDA cores: one block per 64-row tile of one (b, h) (grid
// x = bh * nt + tile index), kTpr = D / 32 threads a row, thread `part` of
// a row holding its columns c * kTpr + part (c < 32); the walked 64-row
// tiles ([64][D] floats) in dynamic shared memory.
// ---------------------------------------------------------------------------

template <int D>
struct F32Cfg {
  static constexpr int kTpr = D / 32;                // threads a row
  static constexpr int kThreads = kFlashTile * kTpr;
  static constexpr int kTileBytes = kFlashTile * D * 4;
};

// rows r0 .. r0 + 63 of a (T, D) float32 head into a [64][D] tile
template <int D>
__device__ __forceinline__ void load_tile_f32(float* dst, const float* src, long long st, int r0) {
  for (int i = threadIdx.x; i < kFlashTile * D / 4; i += F32Cfg<D>::kThreads) {
    const int r = i / (D / 4), c = (i % (D / 4)) * 4;
    *reinterpret_cast<float4*>(dst + r * D + c) =
        *reinterpret_cast<const float4*>(src + (r0 + r) * st + c);
  }
}

// a thread's 32 columns of a row, times f
template <int TPR>
__device__ __forceinline__ void load_row_f32(float (&x)[32], const float* src, int part, float f) {
  if constexpr (TPR == 1) {
#pragma unroll
    for (int c = 0; c < 32; c += 4) {
      const float4 v4 = *reinterpret_cast<const float4*>(src + c);
      x[c] = v4.x * f;
      x[c + 1] = v4.y * f;
      x[c + 2] = v4.z * f;
      x[c + 3] = v4.w * f;
    }
  } else {
#pragma unroll
    for (int c = 0; c < 32; ++c) x[c] = src[c * TPR + part] * f;
  }
}

template <int TPR>
__device__ __forceinline__ void store_row_f32(float* dst, const float (&x)[32], int part, float f) {
  if constexpr (TPR == 1) {
#pragma unroll
    for (int c = 0; c < 32; c += 4)
      *reinterpret_cast<float4*>(dst + c) =
          make_float4(x[c] * f, x[c + 1] * f, x[c + 2] * f, x[c + 3] * f);
  } else {
#pragma unroll
    for (int c = 0; c < 32; ++c) dst[c * TPR + part] = x[c] * f;
  }
}

// the dot product of a row with row y of a tile, summed over the row's
// TPR threads (neighbouring lanes; the butterfly gives each the same sum)
template <int TPR>
__device__ __forceinline__ float dot_row(const float (&x)[32], const float* y, int part) {
  float s = 0.f;
#pragma unroll
  for (int c = 0; c < 32; ++c) s = fmaf(x[c], y[c * TPR + part], s);
  if constexpr (TPR > 1) {
    const unsigned lanes = ((1u << TPR) - 1) << ((threadIdx.x & 31) & ~(TPR - 1));
#pragma unroll
    for (int off = 1; off < TPR; off <<= 1) s += __shfl_xor_sync(lanes, s, off);
  }
  return s;
}

// K7, float32
template <int D>
__global__ void __launch_bounds__(F32Cfg<D>::kThreads)
flash_fwd_f32(const float* __restrict__ q, const float* __restrict__ k,
              const float* __restrict__ v, float* __restrict__ o, float* __restrict__ lse, int H,
              int T, FlashLayout lay, float scale_log2) {
  constexpr int kTpr = F32Cfg<D>::kTpr;
  extern __shared__ uint8_t smem_raw[];
  float* ks = reinterpret_cast<float*>(smem_raw);
  float* vs = ks + kFlashTile * D;
  const int nt = T / kFlashTile, qt = nt - 1 - (int)(blockIdx.x % nt);
  const int bh = blockIdx.x / nt, b = bh / H, h = bh % H;
  const int rt = threadIdx.x / kTpr, part = threadIdx.x % kTpr;
  const int row = qt * kFlashTile + rt;
  const float* kh = head_ptr(k, lay, 1, b, h);
  const float* vh = head_ptr(v, lay, 2, b, h);
  float qr[32], acc[32];
  load_row_f32<kTpr>(qr, head_ptr(q, lay, 0, b, h) + row * lay.s[0][2], part, scale_log2);
#pragma unroll
  for (int c = 0; c < 32; ++c) acc[c] = 0.f;
  float m = -INFINITY, l = 0.f;
  for (int kt = 0; kt <= qt; ++kt) {
    __syncthreads();
    load_tile_f32<D>(ks, kh, lay.s[1][2], kt * kFlashTile);
    load_tile_f32<D>(vs, vh, lay.s[2][2], kt * kFlashTile);
    __syncthreads();
    const int nk = kt == qt ? rt + 1 : kFlashTile;
    for (int j = 0; j < nk; ++j) {
      const float s = dot_row<kTpr>(qr, ks + j * D, part);
      const float mn = fmaxf(m, s), a = exp2f(m - mn), p = exp2f(s - mn);
      l = l * a + p;
#pragma unroll
      for (int c = 0; c < 32; ++c) acc[c] = fmaf(p, vs[j * D + c * kTpr + part], acc[c] * a);
      m = mn;
    }
  }
  store_row_f32<kTpr>(head_ptr(o, lay, 3, b, h) + row * lay.s[3][2], acc, part, 1.f / l);
  if (part == 0) lse[(long long)bh * T + row] = (m + log2f(l)) * kLn2;
}

// K8, float32: kTpr threads a key row
template <int D>
__global__ void __launch_bounds__(F32Cfg<D>::kThreads)
flash_bwd_dkv_f32(const float* __restrict__ q, const float* __restrict__ k,
                  const float* __restrict__ v, const float* __restrict__ dout,
                  const float* __restrict__ lse, const float* __restrict__ di,
                  float* __restrict__ dk, float* __restrict__ dv, int H, int T, FlashLayout lay,
                  float scale, float scale_log2) {
  constexpr int kTpr = F32Cfg<D>::kTpr;
  extern __shared__ uint8_t smem_raw[];
  float* qs = reinterpret_cast<float*>(smem_raw);
  float* dos = qs + kFlashTile * D;
  float* ls = dos + kFlashTile * D;
  float* dis = ls + kFlashTile;
  const int nt = T / kFlashTile, kt = blockIdx.x % nt;
  const int bh = blockIdx.x / nt, b = bh / H, h = bh % H;
  const int rt = threadIdx.x / kTpr, part = threadIdx.x % kTpr;
  const int key = kt * kFlashTile + rt;
  const float* qh = head_ptr(q, lay, 0, b, h);
  const float* doh = head_ptr(dout, lay, 3, b, h);
  float kr[32], vr[32], dka[32], dva[32];
  load_row_f32<kTpr>(kr, head_ptr(k, lay, 1, b, h) + key * lay.s[1][2], part, scale_log2);
  load_row_f32<kTpr>(vr, head_ptr(v, lay, 2, b, h) + key * lay.s[2][2], part, 1.f);
#pragma unroll
  for (int c = 0; c < 32; ++c) dka[c] = dva[c] = 0.f;
  for (int qt = kt; qt < nt; ++qt) {
    __syncthreads();
    load_tile_f32<D>(qs, qh, lay.s[0][2], qt * kFlashTile);
    load_tile_f32<D>(dos, doh, lay.s[3][2], qt * kFlashTile);
    if (threadIdx.x < kFlashTile) {
      ls[threadIdx.x] = lse[(long long)bh * T + qt * kFlashTile + threadIdx.x] * kLog2e;
      dis[threadIdx.x] = di[(long long)bh * T + qt * kFlashTile + threadIdx.x];
    }
    __syncthreads();
    for (int i = qt == kt ? rt : 0; i < kFlashTile; ++i) {
      const float p = exp2f(dot_row<kTpr>(kr, qs + i * D, part) - ls[i]);
      const float ds = p * (dot_row<kTpr>(vr, dos + i * D, part) - dis[i]) * scale;
#pragma unroll
      for (int c = 0; c < 32; ++c) {
        dva[c] = fmaf(p, dos[i * D + c * kTpr + part], dva[c]);
        dka[c] = fmaf(ds, qs[i * D + c * kTpr + part], dka[c]);
      }
    }
  }
  store_row_f32<kTpr>(head_ptr(dk, lay, 4, b, h) + key * lay.s[4][2], dka, part, 1.f);
  store_row_f32<kTpr>(head_ptr(dv, lay, 5, b, h) + key * lay.s[5][2], dva, part, 1.f);
}

// K9, float32: kTpr threads a query row
template <int D>
__global__ void __launch_bounds__(F32Cfg<D>::kThreads)
flash_bwd_dq_f32(const float* __restrict__ q, const float* __restrict__ k,
                 const float* __restrict__ v, const float* __restrict__ dout,
                 const float* __restrict__ lse, const float* __restrict__ di,
                 float* __restrict__ dq, int H, int T, FlashLayout lay, float scale,
                 float scale_log2) {
  constexpr int kTpr = F32Cfg<D>::kTpr;
  extern __shared__ uint8_t smem_raw[];
  float* ks = reinterpret_cast<float*>(smem_raw);
  float* vs = ks + kFlashTile * D;
  const int nt = T / kFlashTile, qt = nt - 1 - (int)(blockIdx.x % nt);
  const int bh = blockIdx.x / nt, b = bh / H, h = bh % H;
  const int rt = threadIdx.x / kTpr, part = threadIdx.x % kTpr;
  const int row = qt * kFlashTile + rt;
  const float* kh = head_ptr(k, lay, 1, b, h);
  const float* vh = head_ptr(v, lay, 2, b, h);
  float qr[32], dor[32], dqa[32];
  load_row_f32<kTpr>(qr, head_ptr(q, lay, 0, b, h) + row * lay.s[0][2], part, scale_log2);
  load_row_f32<kTpr>(dor, head_ptr(dout, lay, 3, b, h) + row * lay.s[3][2], part, 1.f);
#pragma unroll
  for (int c = 0; c < 32; ++c) dqa[c] = 0.f;
  const float l2 = lse[(long long)bh * T + row] * kLog2e, dir = di[(long long)bh * T + row];
  for (int kt = 0; kt <= qt; ++kt) {
    __syncthreads();
    load_tile_f32<D>(ks, kh, lay.s[1][2], kt * kFlashTile);
    load_tile_f32<D>(vs, vh, lay.s[2][2], kt * kFlashTile);
    __syncthreads();
    const int nk = kt == qt ? rt + 1 : kFlashTile;
    for (int j = 0; j < nk; ++j) {
      const float p = exp2f(dot_row<kTpr>(qr, ks + j * D, part) - l2);
      const float ds = p * (dot_row<kTpr>(dor, vs + j * D, part) - dir) * scale;
#pragma unroll
      for (int c = 0; c < 32; ++c) dqa[c] = fmaf(ds, ks[j * D + c * kTpr + part], dqa[c]);
    }
  }
  store_row_f32<kTpr>(head_ptr(dq, lay, 4, b, h) + row * lay.s[4][2], dqa, part, 1.f);
}

// ---------------------------------------------------------------------------
// Wide heads (D a multiple of 128 above 256; D at run time), bf16: the head
// width streams through a ring of 16 KB stages (two 64 x 64 boxes), so
// shared memory and registers do not grow with D.  A block is one consumer
// warpgroup and a producer warp (one thread of it loads), one 64-row tile
// of one (b, h) on grid x (query tiles latest first in K7 and K9, key tiles
// earliest first in K8).  S = sum over 64-column chunks c of Q_c K_c^T
// (and dP = sum dO_c V_c^T, in K8 transposed), each chunk's boxes a stage;
// the outputs are produced a column chunk at a time, each chunk's pass
// recomputing S (and dP) on the tensor cores: K7 first a pass for lse (the
// row maxima and sums), then a pass per 128 columns of o with p = exp2(s
// scale_log2 - lse), so every pass uses the same rounded p; K9 a pass per
// 128 columns of dq; K8 a pass per 64 columns of dk and dv.  Each pass
// streams the operand columns its products need (K7: V, K9: K, K8: dO and
// Q) a stage after the tile's S.  Outputs go to device memory from the
// accumulator fragments.
// ---------------------------------------------------------------------------
constexpr int kWideThreads = 160;                     // a consumer warpgroup and a producer warp
constexpr int kWideBox = Tile<64>::kBytes;            // a 64 x 64 box: 8 KB
constexpr int kWideStage = 2 * kWideBox;
constexpr int kWideStages = 4;
constexpr size_t kWideSmem = 1024 + (size_t)kWideStages * kWideStage;

// the ring's mbarriers: full (the producer's arrival and the bytes), empty
// (lane 0 of each consumer warp)
struct WideBars {
  uint64_t full[kWideStages], empty[kWideStages];
  __device__ __forceinline__ void init() {
    if (threadIdx.x == 0) {
      for (int s = 0; s < kWideStages; ++s) {
        mbar_init(&full[s], 1);
        mbar_init(&empty[s], 4);
      }
      asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
    }
    __syncthreads();
  }
};

// the producer: boxes (col_a of rows row_a of map_a, col_b of rows row_b of
// map_b) into the ring's next stage
__device__ __forceinline__ void wide_load(const Ring& ring, int it, uint8_t* base, uint64_t* full,
                                          const CUtensorMap* map_a, int col_a, int row_a,
                                          const CUtensorMap* map_b, int col_b, int row_b, int h,
                                          int b) {
  const int s = ring.acquire(it, kWideStage);
  tma_load_rows(base + s * kWideStage, map_a, &full[s], col_a, row_a, h, b);
  tma_load_rows(base + s * kWideStage + kWideBox, map_b, &full[s], col_b, row_b, h, b);
}

// the consumers: acc (+)= A_c B_c^T of the ring's next stage ([A box | B
// box], both K-major), the stage released once read
__device__ __forceinline__ void wide_abt(float (&acc)[32], const Ring& ring, int& it,
                                         const uint8_t* base, bool accumulate, int lane) {
  using L = Tile<64>;
  const uint8_t* st = base + ring.wait(it) * kWideStage;
  wgmma_fence();
#pragma unroll
  for (int kk = 0; kk < L::kSteps; ++kk)
    wgmma_ss(acc, L::kmajor(st, kk), L::kmajor(st + kWideBox, kk), accumulate || kk > 0);
  wgmma_commit();
  wgmma_wait<0>();
  hold(acc);
  ring.release(it++, lane);
}

// K7, bf16, wide heads
__global__ void __launch_bounds__(kWideThreads)
flash_fwd_wide(const __grid_constant__ CUtensorMap map_q, const __grid_constant__ CUtensorMap map_k,
               const __grid_constant__ CUtensorMap map_v, bf16* __restrict__ o,
               float* __restrict__ lse, FlashLayout lay, int H, int T, int D, float scale_log2) {
  extern __shared__ uint8_t smem_raw[];
  __shared__ __align__(8) WideBars bars;
  uint8_t* base = align1024(smem_raw);
  const int nt = T / kFlashTile, qt = nt - 1 - (int)(blockIdx.x % nt);
  const int bh = blockIdx.x / nt, b = bh / H, h = bh % H;
  const int chunks = D / 64, passes = 1 + D / 128;  // the lse pass, then one per 128 columns of o
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  bars.init();
  const Ring ring{bars.full, bars.empty, kWideStages};
  if (warp == 4) {
    if (lane == 0) {
      int it = 0;
      for (int p = 0; p < passes; ++p)
        for (int kt = 0; kt <= qt; ++kt) {
          for (int c = 0; c < chunks; ++c, ++it)
            wide_load(ring, it, base, bars.full, &map_q, 64 * c, qt * kFlashTile, &map_k, 64 * c,
                      kt * kFlashTile, h, b);
          if (p > 0)
            wide_load(ring, it++, base, bars.full, &map_v, 128 * (p - 1), kt * kFlashTile, &map_v,
                      128 * (p - 1) + 64, kt * kFlashTile, h, b);
        }
    }
    return;
  }
  const int t4 = lane & 3, row = 16 * warp + (lane >> 2);  // the lane's rows: row, row + 8
  float m0 = -INFINITY, m1 = -INFINITY, l0 = 0.f, l1 = 0.f;  // log2 units
  int it = 0;
  for (int p = 0; p < passes; ++p) {
    float acc[64];
#pragma unroll
    for (int i = 0; i < 64; ++i) acc[i] = 0.f;
    for (int kt = 0; kt <= qt; ++kt) {
      float s[32];
      for (int c = 0; c < chunks; ++c) wide_abt(s, ring, it, base, c > 0, lane);
      if (kt == qt) {
#pragma unroll
        for (int i = 0; i < 32; ++i)
          if (past_diagonal(i, row, t4)) s[i] = -INFINITY;
      }
      if (p == 0) {  // the online maxima and sums
        float r0, r1;
        row_max(s, r0, r1);
#pragma unroll
        for (int off = 1; off <= 2; off <<= 1) {
          r0 = fmaxf(r0, __shfl_xor_sync(0xffffffffu, r0, off));
          r1 = fmaxf(r1, __shfl_xor_sync(0xffffffffu, r1, off));
        }
        const float mx0 = fmaxf(m0, r0 * scale_log2), mx1 = fmaxf(m1, r1 * scale_log2);
#pragma unroll
        for (int i = 0; i < 32; ++i) s[i] = ex2(fmaf(s[i], scale_log2, (i & 2) ? -mx1 : -mx0));
        float sum0, sum1;
        row_sum(s, sum0, sum1);
        l0 = l0 * ex2(m0 - mx0) + sum0;
        l1 = l1 * ex2(m1 - mx1) + sum1;
        m0 = mx0;
        m1 = mx1;
      } else {  // o's columns 128 (p - 1) ..: p = exp2(s scale_log2 - lse) times V's
#pragma unroll
        for (int i = 0; i < 32; ++i) s[i] = ex2(fmaf(s[i], scale_log2, (i & 2) ? -m1 : -m0));
        uint32_t pa[4][4];
        to_a(pa, s);
        const uint8_t* st = base + ring.wait(it) * kWideStage;
        wgmma_fence();
#pragma unroll
        for (int kk = 0; kk < 4; ++kk) wgmma_rs(acc, pa[kk], Tile<128>::mnmajor(st, kk));
        wgmma_commit();
        wgmma_wait<0>();
        hold(acc);
        hold(pa);
        ring.release(it++, lane);
      }
    }
    if (p == 0) {  // lse, natural units, out; m0, m1 hold it in log2 units from here on
#pragma unroll
      for (int off = 1; off <= 2; off <<= 1) {
        l0 += __shfl_xor_sync(0xffffffffu, l0, off);
        l1 += __shfl_xor_sync(0xffffffffu, l1, off);
      }
      m0 += __log2f(l0);
      m1 += __log2f(l1);
      if (t4 == 0) {
        float* lh = lse + (long long)bh * T + qt * kFlashTile;
        lh[row] = m0 * kLn2;
        lh[row + 8] = m1 * kLn2;
      }
    } else {
      store_frags<128>(head_ptr(o, lay, 3, b, h), lay.s[3][2], qt * kFlashTile, 128 * (p - 1), acc,
                       1.f, 1.f, row, t4);
    }
  }
}

// K8, bf16, wide heads: key tile kt against query tiles kt .. nt - 1
__global__ void __launch_bounds__(kWideThreads)
flash_bwd_dkv_wide(const __grid_constant__ CUtensorMap map_q, const __grid_constant__ CUtensorMap map_k,
                   const __grid_constant__ CUtensorMap map_v, const __grid_constant__ CUtensorMap map_do,
                   bf16* __restrict__ dk, bf16* __restrict__ dv, const float* __restrict__ lse,
                   const float* __restrict__ di, FlashLayout lay, int H, int T, int D, float scale,
                   float scale_log2) {
  extern __shared__ uint8_t smem_raw[];
  __shared__ __align__(8) WideBars bars;
  uint8_t* base = align1024(smem_raw);
  const int nt = T / kFlashTile, kt = (int)(blockIdx.x % nt);
  const int bh = blockIdx.x / nt, b = bh / H, h = bh % H;
  const int chunks = D / 64;  // also the passes: one per 64 columns of dk and dv
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  bars.init();
  const Ring ring{bars.full, bars.empty, kWideStages};
  if (warp == 4) {
    if (lane == 0) {
      int it = 0;
      for (int p = 0; p < chunks; ++p)
        for (int qt = kt; qt < nt; ++qt) {
          for (int c = 0; c < chunks; ++c) {
            wide_load(ring, it++, base, bars.full, &map_k, 64 * c, kt * kFlashTile, &map_q, 64 * c,
                      qt * kFlashTile, h, b);
            wide_load(ring, it++, base, bars.full, &map_v, 64 * c, kt * kFlashTile, &map_do, 64 * c,
                      qt * kFlashTile, h, b);
          }
          wide_load(ring, it++, base, bars.full, &map_do, 64 * p, qt * kFlashTile, &map_q, 64 * p,
                    qt * kFlashTile, h, b);
        }
    }
    return;
  }
  const int t4 = lane & 3, key = 16 * warp + (lane >> 2);  // the lane's key rows: key, key + 8
  const float* lh = lse + (long long)bh * T;
  const float* dh = di + (long long)bh * T;
  int it = 0;
  for (int p = 0; p < chunks; ++p) {
    float dka[32], dva[32];
#pragma unroll
    for (int i = 0; i < 32; ++i) dka[i] = dva[i] = 0.f;
    for (int qt = kt; qt < nt; ++qt) {
      float sp[32], dp[32];
      for (int c = 0; c < chunks; ++c) {
        wide_abt(sp, ring, it, base, c > 0, lane);  // S^T += K_c Q_c^T
        wide_abt(dp, ring, it, base, c > 0, lane);  // dP^T += V_c dO_c^T
      }
      // element i is key row key + 8 ((i >> 1) & 1), query column q(i) of the tile
      const float* lq = lh + qt * kFlashTile;
      const float* dd = dh + qt * kFlashTile;
#pragma unroll
      for (int i = 0; i < 32; ++i) {
        const int q = 8 * (i >> 2) + 2 * t4 + (i & 1);
        float pv = ex2(fmaf(sp[i], scale_log2, -__ldg(lq + q) * kLog2e));
        if (qt == kt && q < key + 8 * ((i >> 1) & 1)) pv = 0.f;
        sp[i] = pv;
        dp[i] = pv * (dp[i] - __ldg(dd + q)) * scale;
      }
      uint32_t pa[4][4], dsa[4][4];
      to_a(pa, sp);
      to_a(dsa, dp);
      const uint8_t* st = base + ring.wait(it) * kWideStage;  // [dO box p | Q box p]
      wgmma_fence();
#pragma unroll
      for (int kk = 0; kk < 4; ++kk) wgmma_rs(dva, pa[kk], Tile<64>::mnmajor(st, kk));
#pragma unroll
      for (int kk = 0; kk < 4; ++kk) wgmma_rs(dka, dsa[kk], Tile<64>::mnmajor(st + kWideBox, kk));
      wgmma_commit();
      wgmma_wait<0>();
      hold(dva);
      hold(dka);
      hold(pa);
      hold(dsa);
      ring.release(it++, lane);
    }
    store_frags<64>(head_ptr(dk, lay, 4, b, h), lay.s[4][2], kt * kFlashTile, 64 * p, dka, 1.f, 1.f,
                    key, t4);
    store_frags<64>(head_ptr(dv, lay, 5, b, h), lay.s[5][2], kt * kFlashTile, 64 * p, dva, 1.f, 1.f,
                    key, t4);
  }
}

// K9, bf16, wide heads: query tile qt against key tiles 0 .. qt
__global__ void __launch_bounds__(kWideThreads)
flash_bwd_dq_wide(const __grid_constant__ CUtensorMap map_q, const __grid_constant__ CUtensorMap map_k,
                  const __grid_constant__ CUtensorMap map_v, const __grid_constant__ CUtensorMap map_do,
                  bf16* __restrict__ dq, const float* __restrict__ lse, const float* __restrict__ di,
                  FlashLayout lay, int H, int T, int D, float scale, float scale_log2) {
  extern __shared__ uint8_t smem_raw[];
  __shared__ __align__(8) WideBars bars;
  uint8_t* base = align1024(smem_raw);
  const int nt = T / kFlashTile, qt = nt - 1 - (int)(blockIdx.x % nt);
  const int bh = blockIdx.x / nt, b = bh / H, h = bh % H;
  const int chunks = D / 64, passes = D / 128;  // a pass per 128 columns of dq
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  bars.init();
  const Ring ring{bars.full, bars.empty, kWideStages};
  if (warp == 4) {
    if (lane == 0) {
      int it = 0;
      for (int p = 0; p < passes; ++p)
        for (int kt = 0; kt <= qt; ++kt) {
          for (int c = 0; c < chunks; ++c) {
            wide_load(ring, it++, base, bars.full, &map_q, 64 * c, qt * kFlashTile, &map_k, 64 * c,
                      kt * kFlashTile, h, b);
            wide_load(ring, it++, base, bars.full, &map_do, 64 * c, qt * kFlashTile, &map_v, 64 * c,
                      kt * kFlashTile, h, b);
          }
          wide_load(ring, it++, base, bars.full, &map_k, 128 * p, kt * kFlashTile, &map_k,
                    128 * p + 64, kt * kFlashTile, h, b);
        }
    }
    return;
  }
  const int t4 = lane & 3, row = 16 * warp + (lane >> 2);  // the lane's rows: row, row + 8
  const long long r0 = (long long)bh * T + qt * kFlashTile;
  const DqRows rows{lse[r0 + row] * kLog2e, lse[r0 + row + 8] * kLog2e, di[r0 + row],
                    di[r0 + row + 8]};
  int it = 0;
  for (int p = 0; p < passes; ++p) {
    float dqa[64];
#pragma unroll
    for (int i = 0; i < 64; ++i) dqa[i] = 0.f;
    for (int kt = 0; kt <= qt; ++kt) {
      float s[32], dp[32];
      for (int c = 0; c < chunks; ++c) {
        wide_abt(s, ring, it, base, c > 0, lane);   // S += Q_c K_c^T
        wide_abt(dp, ring, it, base, c > 0, lane);  // dP += dO_c V_c^T
      }
      uint32_t ds[4][4];
      dq_ds(s, dp, ds, kt == qt, rows, scale, scale_log2, row, t4);
      const uint8_t* st = base + ring.wait(it) * kWideStage;  // K's columns 128 p ..
      wgmma_fence();
#pragma unroll
      for (int kk = 0; kk < 4; ++kk) wgmma_rs(dqa, ds[kk], Tile<128>::mnmajor(st, kk));
      wgmma_commit();
      wgmma_wait<0>();
      hold(dqa);
      hold(ds);
      ring.release(it++, lane);
    }
    store_frags<128>(head_ptr(dq, lay, 4, b, h), lay.s[4][2], qt * kFlashTile, 128 * p, dqa, 1.f, 1.f,
                     row, t4);
  }
}

// ---------------------------------------------------------------------------
// float32, wide heads, on the CUDA cores: 256 threads a block, one 64-row
// tile of one (b, h) on grid x, as the bf16 wide kernels.  Thread (ty, tx)
// = (tid / 16, tid % 16) holds rows ty + 16 i and columns tx + 16 j (i, j <
// 4) of each 64 x 64 product; the head width streams through shared memory
// 32 columns at a time for S (and dP), the outputs' columns 64 at a time,
// each output pass recomputing S (and dP) as the bf16 ones do.
// ---------------------------------------------------------------------------
constexpr int kF32WideThreads = 256;
constexpr int kChunkPitch = 33;                 // a [64][32] chunk, padded
constexpr int kChunkFloats = kFlashTile * kChunkPitch;
constexpr int kSqPitch = 65;                    // a [64][64] tile, padded
constexpr int kSqFloats = kFlashTile * kSqPitch;

// columns c0 .. c0 + 31 of rows r0 .. r0 + 63 of a (T, D) head into a chunk
__device__ __forceinline__ void f32_chunk(float* dst, const float* src, long long st, int r0,
                                          int c0) {
  for (int i = threadIdx.x; i < kFlashTile * 32; i += kF32WideThreads)
    dst[(i >> 5) * kChunkPitch + (i & 31)] = src[(r0 + (i >> 5)) * st + c0 + (i & 31)];
}
// columns c0 .. c0 + 63 of rows r0 .. r0 + 63 into a square tile
__device__ __forceinline__ void f32_square(float* dst, const float* src, long long st, int r0,
                                           int c0) {
  for (int i = threadIdx.x; i < kFlashTile * 64; i += kF32WideThreads)
    dst[(i >> 6) * kSqPitch + (i & 63)] = src[(r0 + (i >> 6)) * st + c0 + (i & 63)];
}
// acc[i][j] += sum_k a[ty + 16 i][k] b[tx + 16 j][k] over two chunks
__device__ __forceinline__ void f32_abt(float (&acc)[4][4], const float* a, const float* b, int ty,
                                        int tx) {
#pragma unroll 8
  for (int k = 0; k < 32; ++k) {
    float av[4], bv[4];
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      av[i] = a[(ty + 16 * i) * kChunkPitch + k];
      bv[i] = b[(tx + 16 * i) * kChunkPitch + k];
    }
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int j = 0; j < 4; ++j) acc[i][j] = fmaf(av[i], bv[j], acc[i][j]);
  }
}
// acc[i][j] += sum_k p[ty + 16 i][k] v[k][tx + 16 j] over two square tiles
__device__ __forceinline__ void f32_pv(float (&acc)[4][4], const float* p, const float* v, int ty,
                                       int tx) {
#pragma unroll 8
  for (int k = 0; k < kFlashTile; ++k) {
    float pv[4], vv[4];
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      pv[i] = p[(ty + 16 * i) * kSqPitch + k];
      vv[i] = v[k * kSqPitch + tx + 16 * i];
    }
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int j = 0; j < 4; ++j) acc[i][j] = fmaf(pv[i], vv[j], acc[i][j]);
  }
}
__device__ __forceinline__ void f32_zero(float (&acc)[4][4]) {
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int j = 0; j < 4; ++j) acc[i][j] = 0.f;
}
// s = a b^T over the whole head width (and, with `c`/`d`, dp = c d^T), the
// rows of tile ra of heads a, c against those of tile rb of heads b, d
template <bool TWO>
__device__ __forceinline__ void f32_scores(float (&s)[4][4], float (&dp)[4][4], float* sm,
                                           const float* a, long long sa, const float* b,
                                           long long sb, const float* c, long long sc,
                                           const float* d, long long sd, int ra, int rb, int D,
                                           int ty, int tx) {
  f32_zero(s);
  if constexpr (TWO) f32_zero(dp);
  for (int c0 = 0; c0 < D; c0 += 32) {
    __syncthreads();
    f32_chunk(sm, a, sa, ra, c0);
    f32_chunk(sm + kChunkFloats, b, sb, rb, c0);
    if constexpr (TWO) {
      f32_chunk(sm + 2 * kChunkFloats, c, sc, ra, c0);
      f32_chunk(sm + 3 * kChunkFloats, d, sd, rb, c0);
    }
    __syncthreads();
    f32_abt(s, sm, sm + kChunkFloats, ty, tx);
    if constexpr (TWO) f32_abt(dp, sm + 2 * kChunkFloats, sm + 3 * kChunkFloats, ty, tx);
  }
}
// a thread's 4 x 4 of a 64 x 64 output into rows r0 + ty + 16 i, columns
// c0 + tx + 16 j of a (T, D) head
__device__ __forceinline__ void f32_store(float* head, long long st, int r0, int c0,
                                          const float (&acc)[4][4], int ty, int tx) {
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int j = 0; j < 4; ++j) head[(r0 + ty + 16 * i) * st + c0 + tx + 16 * j] = acc[i][j];
}

// K7's scores of query tile qt against key tile kt, in log2 units, masked
// past the diagonal
__device__ __forceinline__ void f32_fwd_scores(float (&s)[4][4], float* sm, const float* qh,
                                               const float* kh, const FlashLayout& lay, int qt,
                                               int kt, int D, float scale_log2, int ty, int tx) {
  float unused[4][4];
  f32_scores<false>(s, unused, sm, qh, lay.s[0][2], kh, lay.s[1][2], nullptr, 0, nullptr, 0,
                    qt * kFlashTile, kt * kFlashTile, D, ty, tx);
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int j = 0; j < 4; ++j)
      s[i][j] = kt == qt && tx + 16 * j > ty + 16 * i ? -INFINITY : s[i][j] * scale_log2;
}

// K7, float32, wide heads
__global__ void __launch_bounds__(kF32WideThreads)
flash_fwd_f32_wide(const float* __restrict__ q, const float* __restrict__ k,
                   const float* __restrict__ v, float* __restrict__ o, float* __restrict__ lse,
                   int H, int T, int D, FlashLayout lay, float scale_log2) {
  extern __shared__ float fsm[];  // 2 chunks, then P and V's square tiles
  float* ps = fsm + 2 * kChunkFloats;
  float* vs = ps + kSqFloats;
  const int nt = T / kFlashTile, qt = nt - 1 - (int)(blockIdx.x % nt);
  const int bh = blockIdx.x / nt, b = bh / H, h = bh % H;
  const int ty = threadIdx.x >> 4, tx = threadIdx.x & 15;
  const float* qh = head_ptr(q, lay, 0, b, h);
  const float* kh = head_ptr(k, lay, 1, b, h);
  const float* vh = head_ptr(v, lay, 2, b, h);
  float s[4][4], m[4], l[4];
#pragma unroll
  for (int i = 0; i < 4; ++i) m[i] = -INFINITY, l[i] = 0.f;
  for (int kt = 0; kt <= qt; ++kt) {  // the row maxima and sums
    f32_fwd_scores(s, fsm, qh, kh, lay, qt, kt, D, scale_log2, ty, tx);
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      float r = fmaxf(fmaxf(s[i][0], s[i][1]), fmaxf(s[i][2], s[i][3]));
#pragma unroll
      for (int off = 1; off < 16; off <<= 1) r = fmaxf(r, __shfl_xor_sync(0xffffffffu, r, off));
      const float mx = fmaxf(m[i], r);
      float sum = 0.f;
#pragma unroll
      for (int j = 0; j < 4; ++j) sum += exp2f(s[i][j] - mx);
      l[i] = l[i] * exp2f(m[i] - mx) + sum;
      m[i] = mx;
    }
  }
#pragma unroll
  for (int i = 0; i < 4; ++i) {
#pragma unroll
    for (int off = 1; off < 16; off <<= 1) l[i] += __shfl_xor_sync(0xffffffffu, l[i], off);
    m[i] += log2f(l[i]);  // lse, log2 units
    if (tx == 0) lse[(long long)bh * T + qt * kFlashTile + ty + 16 * i] = m[i] * kLn2;
  }
  float* oh = head_ptr(o, lay, 3, b, h);
  for (int c0 = 0; c0 < D; c0 += 64) {
    float acc[4][4];
    f32_zero(acc);
    for (int kt = 0; kt <= qt; ++kt) {
      f32_fwd_scores(s, fsm, qh, kh, lay, qt, kt, D, scale_log2, ty, tx);
      __syncthreads();
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int j = 0; j < 4; ++j) ps[(ty + 16 * i) * kSqPitch + tx + 16 * j] = exp2f(s[i][j] - m[i]);
      f32_square(vs, vh, lay.s[2][2], kt * kFlashTile, c0);
      __syncthreads();
      f32_pv(acc, ps, vs, ty, tx);
    }
    f32_store(oh, lay.s[3][2], qt * kFlashTile, c0, acc, ty, tx);
  }
}

// K8, float32, wide heads: rows are keys of tile kt, columns queries
__global__ void __launch_bounds__(kF32WideThreads)
flash_bwd_dkv_f32_wide(const float* __restrict__ q, const float* __restrict__ k,
                       const float* __restrict__ v, const float* __restrict__ dout,
                       const float* __restrict__ lse, const float* __restrict__ di,
                       float* __restrict__ dk, float* __restrict__ dv, int H, int T, int D,
                       FlashLayout lay, float scale, float scale_log2) {
  extern __shared__ float fsm[];  // 4 chunks, then P^T, dS^T, dO's and Q's square tiles
  float* pts = fsm + 4 * kChunkFloats;
  float* dss = pts + kSqFloats;
  float* dos = dss + kSqFloats;
  float* qs = dos + kSqFloats;
  const int nt = T / kFlashTile, kt = (int)(blockIdx.x % nt);
  const int bh = blockIdx.x / nt, b = bh / H, h = bh % H;
  const int ty = threadIdx.x >> 4, tx = threadIdx.x & 15;
  const float* qh = head_ptr(q, lay, 0, b, h);
  const float* kh = head_ptr(k, lay, 1, b, h);
  const float* vh = head_ptr(v, lay, 2, b, h);
  const float* doh = head_ptr(dout, lay, 3, b, h);
  for (int c0 = 0; c0 < D; c0 += 64) {
    float dka[4][4], dva[4][4];
    f32_zero(dka);
    f32_zero(dva);
    for (int qt = kt; qt < nt; ++qt) {
      float sp[4][4], dp[4][4];
      f32_scores<true>(sp, dp, fsm, kh, lay.s[1][2], qh, lay.s[0][2], vh, lay.s[2][2], doh,
                       lay.s[3][2], kt * kFlashTile, qt * kFlashTile, D, ty, tx);
      const long long r0 = (long long)bh * T + qt * kFlashTile;
      __syncthreads();
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const int qc = tx + 16 * j;
        const float lq = lse[r0 + qc] * kLog2e, dd = di[r0 + qc];
#pragma unroll
        for (int i = 0; i < 4; ++i) {
          const int kr = ty + 16 * i;
          const float p = qt == kt && qc < kr ? 0.f : exp2f(fmaf(sp[i][j], scale_log2, -lq));
          pts[kr * kSqPitch + qc] = p;
          dss[kr * kSqPitch + qc] = p * (dp[i][j] - dd) * scale;
        }
      }
      f32_square(dos, doh, lay.s[3][2], qt * kFlashTile, c0);
      f32_square(qs, qh, lay.s[0][2], qt * kFlashTile, c0);
      __syncthreads();
      f32_pv(dva, pts, dos, ty, tx);
      f32_pv(dka, dss, qs, ty, tx);
    }
    f32_store(head_ptr(dk, lay, 4, b, h), lay.s[4][2], kt * kFlashTile, c0, dka, ty, tx);
    f32_store(head_ptr(dv, lay, 5, b, h), lay.s[5][2], kt * kFlashTile, c0, dva, ty, tx);
  }
}

// K9, float32, wide heads
__global__ void __launch_bounds__(kF32WideThreads)
flash_bwd_dq_f32_wide(const float* __restrict__ q, const float* __restrict__ k,
                      const float* __restrict__ v, const float* __restrict__ dout,
                      const float* __restrict__ lse, const float* __restrict__ di,
                      float* __restrict__ dq, int H, int T, int D, FlashLayout lay, float scale,
                      float scale_log2) {
  extern __shared__ float fsm[];  // 4 chunks, then dS's and K's square tiles
  float* dss = fsm + 4 * kChunkFloats;
  float* ks = dss + kSqFloats;
  const int nt = T / kFlashTile, qt = nt - 1 - (int)(blockIdx.x % nt);
  const int bh = blockIdx.x / nt, b = bh / H, h = bh % H;
  const int ty = threadIdx.x >> 4, tx = threadIdx.x & 15;
  const float* qh = head_ptr(q, lay, 0, b, h);
  const float* kh = head_ptr(k, lay, 1, b, h);
  const float* vh = head_ptr(v, lay, 2, b, h);
  const float* doh = head_ptr(dout, lay, 3, b, h);
  const long long r0 = (long long)bh * T + qt * kFlashTile;
  float lr[4], dr[4];
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    lr[i] = lse[r0 + ty + 16 * i] * kLog2e;
    dr[i] = di[r0 + ty + 16 * i];
  }
  for (int c0 = 0; c0 < D; c0 += 64) {
    float acc[4][4];
    f32_zero(acc);
    for (int kt = 0; kt <= qt; ++kt) {
      float s[4][4], dp[4][4];
      f32_scores<true>(s, dp, fsm, qh, lay.s[0][2], kh, lay.s[1][2], doh, lay.s[3][2], vh,
                       lay.s[2][2], qt * kFlashTile, kt * kFlashTile, D, ty, tx);
      __syncthreads();
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int j = 0; j < 4; ++j) {
          const float p = kt == qt && tx + 16 * j > ty + 16 * i
                              ? 0.f : exp2f(fmaf(s[i][j], scale_log2, -lr[i]));
          dss[(ty + 16 * i) * kSqPitch + tx + 16 * j] = p * (dp[i][j] - dr[i]) * scale;
        }
      f32_square(ks, kh, lay.s[1][2], kt * kFlashTile, c0);
      __syncthreads();
      f32_pv(acc, dss, ks, ty, tx);
    }
    f32_store(head_ptr(dq, lay, 4, b, h), lay.s[4][2], qt * kFlashTile, c0, acc, ty, tx);
  }
}

FlashLayout flash_layout(const long long* strides, int ops) {
  FlashLayout lay{};
  for (int i = 0; i < ops; ++i)
    for (int j = 0; j < 3; ++j) lay.s[i][j] = strides[3 * i + j];
  return lay;
}

// D 32, 64, 128 or 256, or a multiple of 128 above; T a multiple of 64;
// the B * H * T / 64 blocks of the float32 and wide grids within grid x
bool flash_shape_ok(int B, int H, int T, int d) {
  return (d == 32 || d == 64 || d == 128 || d % 128 == 0) && d > 0 && T > 0 &&
         T % kFlashTile == 0 && B > 0 && H > 0 &&
         (long long)B * H * (T / kFlashTile) <= 0x7fffffffLL;
}

// A 4-D map over (d, T, H, B) of a bf16 (B, H, T, d) operand whose batch,
// head and row strides (elements) are st[0..2], in boxes of a tile's 64
// rows by min(d, 64) columns, swizzled for wgmma (Tile<D>'s boxes; the
// wide kernels' at any d above 256)
inline cudaError_t head_map(CUtensorMap* map, const void* ptr, int d, int B, int H, int T,
                            const long long* st) {
  EncodeTiledFn encode;
  const cudaError_t err = tensor_map_encoder(&encode);
  if (err != cudaSuccess) return err;
  const cuuint64_t dims[4] = {(cuuint64_t)d, (cuuint64_t)T, (cuuint64_t)H, (cuuint64_t)B};
  const cuuint64_t strides[3] = {(cuuint64_t)st[2] * 2, (cuuint64_t)st[1] * 2,
                                 (cuuint64_t)st[0] * 2};
  const cuuint32_t box[4] = {(cuuint32_t)(d < 64 ? d : 64), (cuuint32_t)kFlashTile, 1, 1};
  const cuuint32_t unit[4] = {1, 1, 1, 1};
  const CUresult r = encode(map, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, 4, const_cast<void*>(ptr), dims,
                            strides, box, unit, CU_TENSOR_MAP_INTERLEAVE_NONE,
                            d == 32 ? CU_TENSOR_MAP_SWIZZLE_64B : CU_TENSOR_MAP_SWIZZLE_128B,
                            CU_TENSOR_MAP_L2_PROMOTION_L2_128B, CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE);
  return r == CUDA_SUCCESS ? cudaSuccess : cudaErrorInvalidValue;
}

inline cudaError_t head_maps(CUtensorMap* maps, const void* const* ptrs, int count, int d, int B,
                             int H, int T, const long long* strides) {
  for (int i = 0; i < count; ++i) {
    const cudaError_t err = head_map(&maps[i], ptrs[i], d, B, H, T, strides + 3 * i);
    if (err != cudaSuccess) return err;
  }
  return cudaSuccess;
}

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

// A float32 kernel's dynamic shared memory, allowed past the default 48 KB
// where it needs more (D 128 and 256)
template <typename Kernel>
inline cudaError_t f32_smem(Kernel kernel, size_t smem) {
  return smem > 48 * 1024
             ? cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem)
             : cudaSuccess;
}

// K7: q, k, v, o through strides[0..11]
template <int D>
cudaError_t flash_fwd(int dtype, const void* q, const void* k, const void* v, void* o, float* lse,
                      int B, int H, int T, const long long* strides, float scale_log2,
                      cudaStream_t stream) {
  if (dtype == kBF16) {
    CUtensorMap maps[3];
    const void* ptrs[3] = {q, k, v};
    cudaError_t err = head_maps(maps, ptrs, 3, D, B, H, T, strides);
    int grid;
    if constexpr (D == 256) {
      if (err == cudaSuccess) err = persistent_grid(flash_fwd_d256, Fwd256Cfg::kSmem, B * H, &grid);
      if (err != cudaSuccess) return err;
      flash_fwd_d256<<<grid, kHopperThreads, Fwd256Cfg::kSmem, stream>>>(
          maps[0], maps[1], maps[2], static_cast<bf16*>(o), lse, flash_layout(strides, 4), H,
          B * H, T, scale_log2);
    } else {
      if (err == cudaSuccess)
        err = persistent_grid(flash_fwd_hopper<D>, FwdCfg<D>::kSmem, B * H, &grid);
      if (err != cudaSuccess) return err;
      flash_fwd_hopper<D><<<grid, kHopperThreads, FwdCfg<D>::kSmem, stream>>>(
          maps[0], maps[1], maps[2], static_cast<bf16*>(o), lse, flash_layout(strides, 4), H,
          B * H, T, scale_log2);
    }
    return cudaGetLastError();
  }
  if (dtype != kF32) return cudaErrorInvalidValue;
  const size_t smem = 2 * F32Cfg<D>::kTileBytes;
  const cudaError_t err = f32_smem(flash_fwd_f32<D>, smem);
  if (err != cudaSuccess) return err;
  flash_fwd_f32<D><<<B * H * (T / kFlashTile), F32Cfg<D>::kThreads, smem, stream>>>(
      static_cast<const float*>(q), static_cast<const float*>(k), static_cast<const float*>(v),
      static_cast<float*>(o), lse, H, T, flash_layout(strides, 4), scale_log2);
  return cudaGetLastError();
}

// K8: q, k, v, do, dk, dv through strides[0..17]
template <int D>
cudaError_t flash_bwd_dkv(int dtype, const void* q, const void* k, const void* v,
                          const void* dout, const float* lse, const float* di, void* dk, void* dv,
                          int B, int H, int T, const long long* strides, float scale,
                          float scale_log2, cudaStream_t stream) {
  if (dtype == kBF16) {
    CUtensorMap maps[4];
    const void* ptrs[4] = {q, k, v, dout};
    cudaError_t err = head_maps(maps, ptrs, 4, D, B, H, T, strides);
    int grid;
    if (err == cudaSuccess)
      err = persistent_grid(flash_bwd_dkv_hopper<D>, DkvCfg<D>::kSmem, B * H, &grid);
    if (err != cudaSuccess) return err;
    flash_bwd_dkv_hopper<D><<<grid, kHopperThreads, DkvCfg<D>::kSmem, stream>>>(
        maps[0], maps[1], maps[2], maps[3], static_cast<bf16*>(dk), static_cast<bf16*>(dv), lse,
        di, flash_layout(strides, 6), H, B * H, T, scale, scale_log2);
    return cudaGetLastError();
  }
  if (dtype != kF32) return cudaErrorInvalidValue;
  const size_t smem = 2 * F32Cfg<D>::kTileBytes + 2 * kVecBytes;
  const cudaError_t err = f32_smem(flash_bwd_dkv_f32<D>, smem);
  if (err != cudaSuccess) return err;
  flash_bwd_dkv_f32<D><<<B * H * (T / kFlashTile), F32Cfg<D>::kThreads, smem, stream>>>(
      static_cast<const float*>(q), static_cast<const float*>(k), static_cast<const float*>(v),
      static_cast<const float*>(dout), lse, di, static_cast<float*>(dk), static_cast<float*>(dv),
      H, T, flash_layout(strides, 6), scale, scale_log2);
  return cudaGetLastError();
}

// K9: q, k, v, do, dq through strides[0..14]
template <int D>
cudaError_t flash_bwd_dq(int dtype, const void* q, const void* k, const void* v, const void* dout,
                         const float* lse, const float* di, void* dq, int B, int H, int T,
                         const long long* strides, float scale, float scale_log2,
                         cudaStream_t stream) {
  if (dtype == kBF16) {
    CUtensorMap maps[4];
    const void* ptrs[4] = {q, k, v, dout};
    cudaError_t err = head_maps(maps, ptrs, 4, D, B, H, T, strides);
    int grid;
    if (err == cudaSuccess)
      err = persistent_grid(flash_bwd_dq_hopper<D>, DqCfg<D>::kSmem, B * H, &grid);
    if (err != cudaSuccess) return err;
    flash_bwd_dq_hopper<D><<<grid, kHopperThreads, DqCfg<D>::kSmem, stream>>>(
        maps[0], maps[1], maps[2], maps[3], static_cast<bf16*>(dq), lse, di,
        flash_layout(strides, 5), H, B * H, T, scale, scale_log2);
    return cudaGetLastError();
  }
  if (dtype != kF32) return cudaErrorInvalidValue;
  const size_t smem = 2 * F32Cfg<D>::kTileBytes;
  const cudaError_t err = f32_smem(flash_bwd_dq_f32<D>, smem);
  if (err != cudaSuccess) return err;
  flash_bwd_dq_f32<D><<<B * H * (T / kFlashTile), F32Cfg<D>::kThreads, smem, stream>>>(
      static_cast<const float*>(q), static_cast<const float*>(k), static_cast<const float*>(v),
      static_cast<const float*>(dout), lse, di, static_cast<float*>(dq), H, T,
      flash_layout(strides, 5), scale, scale_log2);
  return cudaGetLastError();
}

// The wide kernels' launchers: d a multiple of 128 above 256, one block a
// 64-row tile of one (b, h) on grid x
inline cudaError_t wide_smem(const void* kernel, size_t smem) {
  return cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
}

cudaError_t flash_fwd_wide_at(int d, int dtype, const void* q, const void* k, const void* v,
                              void* o, float* lse, int B, int H, int T, const long long* strides,
                              float scale_log2, cudaStream_t stream) {
  const unsigned blocks = (unsigned)B * H * (T / kFlashTile);
  if (dtype == kBF16) {
    CUtensorMap maps[3];
    const void* ptrs[3] = {q, k, v};
    cudaError_t err = head_maps(maps, ptrs, 3, d, B, H, T, strides);
    if (err == cudaSuccess) err = wide_smem((const void*)flash_fwd_wide, kWideSmem);
    if (err != cudaSuccess) return err;
    flash_fwd_wide<<<blocks, kWideThreads, kWideSmem, stream>>>(
        maps[0], maps[1], maps[2], static_cast<bf16*>(o), lse, flash_layout(strides, 4), H, T, d,
        scale_log2);
    return cudaGetLastError();
  }
  if (dtype != kF32) return cudaErrorInvalidValue;
  const size_t smem = (2 * kChunkFloats + 2 * kSqFloats) * sizeof(float);
  const cudaError_t err = wide_smem((const void*)flash_fwd_f32_wide, smem);
  if (err != cudaSuccess) return err;
  flash_fwd_f32_wide<<<blocks, kF32WideThreads, smem, stream>>>(
      static_cast<const float*>(q), static_cast<const float*>(k), static_cast<const float*>(v),
      static_cast<float*>(o), lse, H, T, d, flash_layout(strides, 4), scale_log2);
  return cudaGetLastError();
}

cudaError_t flash_bwd_dkv_wide_at(int d, int dtype, const void* q, const void* k, const void* v,
                                  const void* dout, const float* lse, const float* di, void* dk,
                                  void* dv, int B, int H, int T, const long long* strides,
                                  float scale, float scale_log2, cudaStream_t stream) {
  const unsigned blocks = (unsigned)B * H * (T / kFlashTile);
  if (dtype == kBF16) {
    CUtensorMap maps[4];
    const void* ptrs[4] = {q, k, v, dout};
    cudaError_t err = head_maps(maps, ptrs, 4, d, B, H, T, strides);
    if (err == cudaSuccess) err = wide_smem((const void*)flash_bwd_dkv_wide, kWideSmem);
    if (err != cudaSuccess) return err;
    flash_bwd_dkv_wide<<<blocks, kWideThreads, kWideSmem, stream>>>(
        maps[0], maps[1], maps[2], maps[3], static_cast<bf16*>(dk), static_cast<bf16*>(dv), lse,
        di, flash_layout(strides, 6), H, T, d, scale, scale_log2);
    return cudaGetLastError();
  }
  if (dtype != kF32) return cudaErrorInvalidValue;
  const size_t smem = (4 * kChunkFloats + 4 * kSqFloats) * sizeof(float);
  const cudaError_t err = wide_smem((const void*)flash_bwd_dkv_f32_wide, smem);
  if (err != cudaSuccess) return err;
  flash_bwd_dkv_f32_wide<<<blocks, kF32WideThreads, smem, stream>>>(
      static_cast<const float*>(q), static_cast<const float*>(k), static_cast<const float*>(v),
      static_cast<const float*>(dout), lse, di, static_cast<float*>(dk), static_cast<float*>(dv),
      H, T, d, flash_layout(strides, 6), scale, scale_log2);
  return cudaGetLastError();
}

cudaError_t flash_bwd_dq_wide_at(int d, int dtype, const void* q, const void* k, const void* v,
                                 const void* dout, const float* lse, const float* di, void* dq,
                                 int B, int H, int T, const long long* strides, float scale,
                                 float scale_log2, cudaStream_t stream) {
  const unsigned blocks = (unsigned)B * H * (T / kFlashTile);
  if (dtype == kBF16) {
    CUtensorMap maps[4];
    const void* ptrs[4] = {q, k, v, dout};
    cudaError_t err = head_maps(maps, ptrs, 4, d, B, H, T, strides);
    if (err == cudaSuccess) err = wide_smem((const void*)flash_bwd_dq_wide, kWideSmem);
    if (err != cudaSuccess) return err;
    flash_bwd_dq_wide<<<blocks, kWideThreads, kWideSmem, stream>>>(
        maps[0], maps[1], maps[2], maps[3], static_cast<bf16*>(dq), lse, di,
        flash_layout(strides, 5), H, T, d, scale, scale_log2);
    return cudaGetLastError();
  }
  if (dtype != kF32) return cudaErrorInvalidValue;
  const size_t smem = (4 * kChunkFloats + 2 * kSqFloats) * sizeof(float);
  const cudaError_t err = wide_smem((const void*)flash_bwd_dq_f32_wide, smem);
  if (err != cudaSuccess) return err;
  flash_bwd_dq_f32_wide<<<blocks, kF32WideThreads, smem, stream>>>(
      static_cast<const float*>(q), static_cast<const float*>(k), static_cast<const float*>(v),
      static_cast<const float*>(dout), lse, di, static_cast<float*>(dq), H, T, d,
      flash_layout(strides, 5), scale, scale_log2);
  return cudaGetLastError();
}

}  // namespace mnx

// each launcher at the head width d (flash_shape_ok has taken it): the
// templates to 256, the wide kernels above
#define MNX_FLASH_AT_WIDTH(fn, ...)                                            \
  (d == 32    ? mnx::fn<32>(__VA_ARGS__)                                       \
   : d == 64  ? mnx::fn<64>(__VA_ARGS__)                                       \
   : d == 128 ? mnx::fn<128>(__VA_ARGS__)                                      \
   : d == 256 ? mnx::fn<256>(__VA_ARGS__)                                      \
              : mnx::fn##_wide_at(d, __VA_ARGS__))

extern "C" {

// q, k, v, o (B, H, T, d) in one dtype through their (batch, head, row)
// strides in `strides` (4 x 3 elements), each row contiguous and every
// stride and address 16-byte aligned; lse (B, H, T) float32 contiguous; d
// 32, 64, 128, or a multiple of 128; T a multiple of 64.  The wrapper
// checks these.  Returns a cudaError_t code.
int mnx_flash_attention_fwd(int dtype, const void* q, const void* k, const void* v, void* o,
                            float* lse, int B, int H, int T, int d, const long long* strides,
                            float sm_scale, void* stream) {
  if (!mnx::flash_shape_ok(B, H, T, d)) return cudaErrorInvalidValue;
  return MNX_FLASH_AT_WIDTH(flash_fwd, dtype, q, k, v, o, lse, B, H, T, strides,
                            sm_scale * mnx::kLog2e, static_cast<cudaStream_t>(stream));
}

// q, k, v, do, dk, dv (B, H, T, d) through their strides (6 x 3); lse and
// di (B, H, T) float32 contiguous, 16-byte aligned.
int mnx_flash_attention_bwd_dkv(int dtype, const void* q, const void* k, const void* v,
                                const void* dout, const float* lse, const float* di, void* dk,
                                void* dv, int B, int H, int T, int d, const long long* strides,
                                float sm_scale, void* stream) {
  if (!mnx::flash_shape_ok(B, H, T, d)) return cudaErrorInvalidValue;
  return MNX_FLASH_AT_WIDTH(flash_bwd_dkv, dtype, q, k, v, dout, lse, di, dk, dv, B, H, T, strides,
                            sm_scale, sm_scale * mnx::kLog2e, static_cast<cudaStream_t>(stream));
}

// q, k, v, do, dq (B, H, T, d) through their strides (5 x 3); lse and di
// (B, H, T) float32 contiguous, 16-byte aligned.
int mnx_flash_attention_bwd_dq(int dtype, const void* q, const void* k, const void* v,
                               const void* dout, const float* lse, const float* di, void* dq,
                               int B, int H, int T, int d, const long long* strides,
                               float sm_scale, void* stream) {
  if (!mnx::flash_shape_ok(B, H, T, d)) return cudaErrorInvalidValue;
  return MNX_FLASH_AT_WIDTH(flash_bwd_dq, dtype, q, k, v, dout, lse, di, dq, B, H, T, strides,
                            sm_scale, sm_scale * mnx::kLog2e, static_cast<cudaStream_t>(stream));
}

}  // extern "C"
