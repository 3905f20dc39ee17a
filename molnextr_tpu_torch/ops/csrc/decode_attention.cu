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
// The layer is an index into the stacked array: no per-layer copy.  Any
// head width d from 1 to 128.
//
// What bounds it on the card: bytes.  One call reads (pos + 1) * d elements
// of K and of V per (b, h) plus the scales, and does about 4 operations per
// element read: about 1 operation per byte at d 32 in bf16, far under the
// H100's ridge of 295 bf16 operations per byte.  One query per (b, h) is a
// matrix-vector product, so the tensor cores have nothing to do here; the
// CUDA cores keep up with the memory.  At the decoder's shapes (B 32, H 8,
// d 32, pos < 480) a call reads at most 15.7 MB in bf16 (8.9 MB in int8):
// a few microseconds at full bandwidth, so latency counts as much as bytes.
//
// Design:
//   * the positions of each (b, h) are split into `cluster` slices of
//     `slice_rows` positions, one CTA of 128 threads per slice, the CTAs of
//     one (b, h) forming a thread-block cluster (cudaLaunchKernelEx).  The
//     wrapper computes the split (ops/_launch.py::split_plan): the largest
//     cluster, up to 8, whose grid starts in one wave; 2 at B 32, H 8, so
//     512 CTAs, where one warp per (b, h) gave 64 blocks on under half the
//     SMs.  A grid of 1024 CTAs already starts in more than one wave, and
//     each wave costs a CTA's whole latency (chip_probe.py);
//   * in the (L, B, H, T, d) layout a slice's K rows are one contiguous run
//     of bytes, and so are its V rows and scales.  The CTA stages them into
//     shared memory with cp.async, 16 bytes a thread: K in up to 4 copy
//     groups, scored as each lands, and V after them, landing while the
//     scores are computed.  q's load is issued before the copies, so that it
//     does not queue behind them.  A chunk holds at most 16 KB each of K and
//     V, so shared memory does not grow with T;
//   * scores: a row is read by G lanes, 16 bytes each (G = 4 at d 32 bf16,
//     so a warp scores 8 positions per load, 16 with two rows a lane in
//     flight), and a shuffle over the G lanes completes the dot product;
//   * the softmax stays exact across the cluster.  Each CTA reduces its
//     slice's (max, sum of exp) and stores it into every peer's shared
//     memory (cluster.map_shared_rank), each store followed by an arrival
//     on the peer's mbarrier with release semantics at cluster scope; each
//     CTA waits on its own mbarrier and merges the pairs in rank order, so
//     every CTA holds the same global max M and sum S.  It then forms the
//     normalized p_t = exp(s_t - M) / S and rounds p_t (dense) or
//     p_t * sv_t (int8) to the model dtype exactly where the references do,
//     and runs PV on its slice with the same lane map;
//   * the partial contexts go the same way into rank 0's shared memory,
//     which sums them in rank order and writes out.  No cluster.sync():
//     one costs about 1.6 us at 8 CTAs a cluster and 2048 CTAs, as much
//     as the rest of a CTA's work (chip_probe.py).  The one cluster
//     barrier left, split into an arrive at the start and a wait just
//     before the first remote store, orders the mbarriers' initialisation
//     before any peer's arrival.  A CTA whose slice is empty (pos below the
//     split) stages nothing and sends (-inf, 0) and a zero context;
//   * one chunk holds the whole slice at the decoder's shapes (240 rows at
//     pos 479), so K and V are read from device memory once.  A longer
//     slice takes a second pass that stages K and V again and recomputes
//     the same scores; an online softmax cannot take its place, because the
//     int8 form rounds the *normalized* p * s_v before the PV product.
// Positions past pos are never read: masked positions contribute exactly 0
// in the reference, so skipping them is the same function.
//
// The design before this one ran one warp per (b, h), 4 warps per block:
// lanes strided over positions, each reading a whole 64-byte row one
// 2-byte element at a time (scalar, uncoalesced loads), and PV ran one lane
// per channel over every position in turn.  A variant with one 128-thread
// block per (b, h) measured slower than that, and only its total was
// recorded.  This kernel with the split forced to one CTA per (b, h)
// (cluster 1, chip_smoke.py phase timing) is twice as fast as the one-warp
// kernel, and the split is faster again: a CTA per (b, h) as such was not
// what lost.
#include <cooperative_groups.h>

#include "common.cuh"

namespace cg = cooperative_groups;

namespace mnx {

constexpr int kDecodeThreads = 128;
constexpr int kDecodeWarps = kDecodeThreads / 32;
constexpr int kMaxHead = 128;
constexpr int kMaxCluster = 8;
constexpr int kParts = 4;  // at most this many copy groups of a one-chunk slice's K

// byte offsets of the shared-memory regions, for a chunk of `rows` rows of
// `row_bytes` bytes; the same on the host (launch size) and the device
struct DecodeSmem {
  int bars, kst, vst, ksc, vsc, sc, qs, red, ml_all, ctx_all, total;
  __host__ __device__ static int up16(int x) { return (x + 15) & ~15; }
  __host__ __device__ DecodeSmem(int rows, int row_bytes) {
    bars = 0;  // two mbarriers
    kst = 16;
    vst = kst + up16(rows * row_bytes);
    ksc = vst + up16(rows * row_bytes);
    vsc = ksc + up16(rows * 4);
    sc = vsc + up16(rows * 4);
    qs = sc + up16(rows * 4);
    red = qs + 4 * kMaxHead;
    ml_all = red + 4 * kDecodeWarps * kMaxHead;
    ctx_all = ml_all + 4 * 2 * kMaxCluster;
    total = ctx_all + 4 * kMaxCluster * kMaxHead;
  }
};

template <typename T, bool Q8>
__global__ void __launch_bounds__(kDecodeThreads)
decode_attn_split_kernel(const T* __restrict__ q, const void* __restrict__ kc,
                         const void* __restrict__ vc, const float* __restrict__ k_scale,
                         const float* __restrict__ v_scale, T* __restrict__ out, int BH,
                         int Tc, int d, int pos, int layer, int slice_rows, int chunk_rows,
                         float sqrt_d) {
  using KT = typename std::conditional<Q8, int8_t, T>::type;
  constexpr int E = Vec16<KT>::n;  // channels a lane holds
  extern __shared__ __align__(16) unsigned char smem[];
  cg::cluster_group cluster = cg::this_cluster();
  const int C = (int)cluster.num_blocks(), rank = (int)cluster.block_rank();
  const int bh = blockIdx.x / C;
  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;

  const int row_bytes = d * (int)sizeof(KT);
  const DecodeSmem lay(chunk_rows, row_bytes);
  uint64_t* bar_ml = reinterpret_cast<uint64_t*>(smem + lay.bars);  // C (m, l) pairs in
  uint64_t* bar_ctx = bar_ml + 1;  // rank 0: C partial contexts in
  unsigned char* kst = smem + lay.kst;
  unsigned char* vst = smem + lay.vst;
  float* ksc = reinterpret_cast<float*>(smem + lay.ksc);
  float* vsc = reinterpret_cast<float*>(smem + lay.vsc);
  float* sc = reinterpret_cast<float*>(smem + lay.sc);
  float* qs = reinterpret_cast<float*>(smem + lay.qs);
  float* red = reinterpret_cast<float*>(smem + lay.red);
  float* ml_all = reinterpret_cast<float*>(smem + lay.ml_all);    // [C][2]
  float* ctx_all = reinterpret_cast<float*>(smem + lay.ctx_all);  // [C][kMaxHead]

  if (tid == 0) {
    mbar_init(bar_ml, C);
    mbar_init(bar_ctx, 32 * C);
  }
  cluster_arrive_after_init();

  // lane map: G lanes (a power of two) per row, E channels each
  int G = 1;
  while (G * E < d) G <<= 1;
  const int g = lane & (G - 1), sub = lane / G, c0 = g * E;
  const int rows_per_warp = 32 / G, rows_per_pass = kDecodeThreads / G;
  const bool full = d % E == 0;  // every lane's 16 bytes are whole channels

  int t0, t1;
  slice_bounds(rank, slice_rows, pos, &t0, &t1);
  const int nrows = t1 - t0;
  const int nchunks = (nrows + chunk_rows - 1) / chunk_rows;
  const size_t base = ((size_t)layer * BH + bh) * Tc;  // row of position 0
  const unsigned char* kb = static_cast<const unsigned char*>(kc) + base * row_bytes;
  const unsigned char* vb = static_cast<const unsigned char*>(vc) + base * row_bytes;
  const int unit = copy_unit(row_bytes, kc, vc);

  auto lane_row = [&](const unsigned char* stage, int r, float* f) {
    const KT* row = reinterpret_cast<const KT*>(stage + (size_t)r * row_bytes);
    if (full) {
      if (c0 < d) {
        unpack16<KT>(*reinterpret_cast<const uint4*>(row + c0), f);
      } else {
#pragma unroll
        for (int e = 0; e < E; ++e) f[e] = 0.f;
      }
    } else {
#pragma unroll
      for (int e = 0; e < E; ++e) f[e] = c0 + e < d ? elem_f32(row[c0 + e]) : 0.f;
    }
  };
  // rows r0 .. r0 + n - 1 of the slice's chunk starting at position p0
  // into staged rows r0 .. of K (and its scales), or of V
  auto stage_k = [&](int p0, int r0, int n) {
    stage_rows(kst + (size_t)r0 * row_bytes, kb + (size_t)(p0 + r0) * row_bytes,
               n * row_bytes, unit);
    if (Q8) stage_rows(ksc + r0, k_scale + base + p0 + r0, 4 * n, 4);
    cp_async_commit();
  };
  auto stage_v = [&](int p0, int n) {
    stage_rows(vst, vb + (size_t)p0 * row_bytes, n * row_bytes, unit);
    if (Q8) stage_rows(vsc, v_scale + base + p0, 4 * n, 4);
    cp_async_commit();
  };
  // scores of staged rows lo .. hi - 1 into sc, two rows a lane in flight
  // (r0 depends on the warp only, so every lane takes the shuffles)
  auto score = [&](int lo, int hi) {
    for (int r0 = lo + warp * rows_per_warp; r0 < hi; r0 += 2 * rows_per_pass) {
      const int ra = r0 + sub, rb = ra + rows_per_pass;
      float fa[E], fb[E];
      lane_row(kst, ra < hi ? ra : lo, fa);
      lane_row(kst, rb < hi ? rb : lo, fb);
      float da = 0.f, db = 0.f;
#pragma unroll
      for (int e = 0; e < E; ++e) {
        da += qs[c0 + e] * fa[e];
        db += qs[c0 + e] * fb[e];
      }
      for (int o = G >> 1; o > 0; o >>= 1) {
        da += __shfl_xor_sync(0xffffffffu, da, o);
        db += __shfl_xor_sync(0xffffffffu, db, o);
      }
      if (g == 0) {
        if (ra < hi) sc[ra] = Q8 ? da * ksc[ra] / sqrt_d : da / sqrt_d;
        if (rb < hi) sc[rb] = Q8 ? db * ksc[rb] / sqrt_d : db / sqrt_d;
      }
    }
  };

  // 1. scores and the slice's (max, sum of exp).  A slice of one chunk (the
  //    decoder's case) stages K in up to kParts copy groups of at least one
  //    pass of rows each and V after them, and scores each part as it
  //    lands.  q's load is issued first, so that it does not queue behind
  //    the copies.
  static_assert(kMaxHead == kDecodeThreads, "one channel of q a thread");
  const float qv = tid < d ? to_f32(q[(size_t)bh * d + tid]) : 0.f;
  const int nparts = max(1, min(kParts, nrows / rows_per_pass));
  const int part_rows = (nrows + nparts - 1) / nparts;
  if (nchunks == 1) {
    for (int p = 0; p < nparts; ++p) {
      const int lo = min(p * part_rows, nrows), hi = min(lo + part_rows, nrows);
      stage_k(t0, lo, hi - lo);
    }
    stage_v(t0, nrows);
  } else if (nchunks > 1) {
    stage_k(t0, 0, chunk_rows);
  }
  qs[tid] = qv;

  float m = -INFINITY, l = 0.f;
  if (nchunks == 1) {
    for (int p = 0; p < nparts; ++p) {
      cp_async_wait_upto(nparts - p);  // K parts p + 1 .. and V may be in flight
      __syncthreads();
      const int lo = min(p * part_rows, nrows);
      score(lo, min(lo + part_rows, nrows));
    }
    __syncthreads();
    // each warp's max first, then its sum of exp(s - max): no exp in the
    // shuffles
    for (int r = tid; r < nrows; r += kDecodeThreads) m = fmaxf(m, sc[r]);
    m = warp_max(m);
    if (m > -INFINITY)
      for (int r = tid; r < nrows; r += kDecodeThreads) l += expf(sc[r] - m);
    l = warp_sum(l);
  }
  for (int ch = 0; nchunks > 1 && ch < nchunks; ++ch) {
    const int p0 = t0 + ch * chunk_rows, n = min(chunk_rows, t1 - p0);
    if (ch) {
      __syncthreads();  // the last chunk's rows are consumed
      stage_k(p0, 0, n);
    }
    cp_async_wait<0>();
    __syncthreads();
    score(0, n);
    __syncthreads();
    for (int r = tid; r < n; r += kDecodeThreads) ml_push(m, l, sc[r]);
  }
  if (nchunks > 1) warp_ml(m, l);
  if (lane == 0) {
    red[2 * warp] = m;
    red[2 * warp + 1] = l;
  }
  __syncthreads();

  // 2. every CTA sends its (m, l) to every CTA of the cluster
  cluster_wait();  // every peer's mbarriers are initialised
  if (warp == 0) {
    m = red[0];
    l = red[1];
    for (int w = 1; w < kDecodeWarps; ++w) ml_merge(m, l, red[2 * w], red[2 * w + 1]);
    if (lane < C) {
      float* dst = cluster.map_shared_rank(ml_all, lane) + 2 * rank;
      dst[0] = m;
      dst[1] = l;
      mbar_arrive_remote(bar_ml, lane);
    }
  }
  mbar_wait(bar_ml, 0);
  float M = -INFINITY, S = 0.f;  // merged in rank order: the same in every CTA
  for (int r = 0; r < C; ++r) ml_merge(M, S, ml_all[2 * r], ml_all[2 * r + 1]);

  // 3. normalized, rounded probabilities and PV over the slice, two rows a
  //    lane in flight
  float acc[E];
#pragma unroll
  for (int e = 0; e < E; ++e) acc[e] = 0.f;
  for (int ch = 0; ch < nchunks; ++ch) {
    const int p0 = t0 + ch * chunk_rows, n = min(chunk_rows, t1 - p0);
    if (nchunks > 1) {  // stage K and V again; the scores come out the same
      __syncthreads();
      stage_k(p0, 0, n);
      stage_v(p0, n);
      cp_async_wait<0>();
      __syncthreads();
      score(0, n);
    } else {
      cp_async_wait<0>();
    }
    __syncthreads();
    // each lane forms its rows' weights: p (dense) or p * s_v (int8),
    // normalized, then rounded to the model dtype
    auto weight = [&](int r) {
      const float p = expf(sc[r] - M) / S;
      return Q8 ? round_to<T>(p * vsc[r]) : round_to<T>(p);
    };
    for (int r0 = warp * rows_per_warp; r0 < n; r0 += 2 * rows_per_pass) {
      const int ra = r0 + sub, rb = ra + rows_per_pass;
      float fa[E], fb[E];
      lane_row(vst, ra < n ? ra : 0, fa);
      lane_row(vst, rb < n ? rb : 0, fb);
      const float wa = ra < n ? weight(ra) : 0.f, wb = rb < n ? weight(rb) : 0.f;
#pragma unroll
      for (int e = 0; e < E; ++e) acc[e] += wa * fa[e] + wb * fb[e];
    }
  }
  // lanes g, g + G, ... of a warp hold the same channels
  for (int o = G; o < 32; o <<= 1)
#pragma unroll
    for (int e = 0; e < E; ++e) acc[e] += __shfl_xor_sync(0xffffffffu, acc[e], o);
  if (sub == 0)
#pragma unroll
    for (int e = 0; e < E; ++e) red[warp * kMaxHead + c0 + e] = acc[e];
  __syncthreads();

  // 4. warp 0 sends the CTA's partial context to rank 0 (each lane its
  //    channels, then its own arrival), which sums the cluster's in rank
  //    order and writes out
  if (warp == 0) {
    float* dst = cluster.map_shared_rank(ctx_all, 0) + rank * kMaxHead;
    for (int c = lane; c < d; c += 32) {
      float s = 0.f;
#pragma unroll
      for (int w = 0; w < kDecodeWarps; ++w) s += red[w * kMaxHead + c];
      dst[c] = s;
    }
    mbar_arrive_remote(bar_ctx, 0);
  }
  if (rank == 0) {
    mbar_wait(bar_ctx, 0);
    for (int c = tid; c < d; c += kDecodeThreads) {
      float s = 0.f;
      for (int r = 0; r < C; ++r) s += ctx_all[r * kMaxHead + c];
      out[(size_t)bh * d + c] = from_f32<T>(s);
    }
  }
  // A CTA of rank r > 0 leaves here: every store into its shared memory
  // (the (m, l) pairs) arrived before its wait on bar_ml returned, and what
  // it sent to rank 0 is rank 0's to wait for.
}

template <typename T, bool Q8>
cudaError_t decode_attn(const void* q, const void* k, const void* v, const float* ks,
                        const float* vs, void* out, int B, int H, int Tc, int d, int pos,
                        int layer, int cluster, int slice_rows, int chunk_rows,
                        cudaStream_t stream) {
  if (d < 1 || d > kMaxHead || cluster < 1 || cluster > kMaxCluster || slice_rows < 1 ||
      chunk_rows < 1 || (long long)cluster * slice_rows < pos + 1)
    return cudaErrorInvalidValue;
  const int BH = B * H;
  const int row_bytes = d * (Q8 ? 1 : (int)sizeof(T));
  const size_t smem = DecodeSmem(chunk_rows, row_bytes).total;
  auto kernel = decode_attn_split_kernel<T, Q8>;
  if (smem > 48 * 1024) {
    const cudaError_t e =
        cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (e != cudaSuccess) return e;
  }
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3(BH * cluster);
  cfg.blockDim = dim3(kDecodeThreads);
  cfg.dynamicSmemBytes = smem;
  cfg.stream = stream;
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeClusterDimension;
  attr[0].val.clusterDim.x = cluster;
  attr[0].val.clusterDim.y = 1;
  attr[0].val.clusterDim.z = 1;
  cfg.attrs = attr;
  cfg.numAttrs = 1;
  const cudaError_t e = cudaLaunchKernelEx(
      &cfg, kernel, static_cast<const T*>(q), k, v, ks, vs, static_cast<T*>(out), BH, Tc,
      d, pos, layer, slice_rows, chunk_rows, sqrtf((float)d));
  return e != cudaSuccess ? e : cudaGetLastError();
}

}  // namespace mnx

extern "C" {

// q (B, H, d) and out (B, H, d) in the model dtype; k/v (L, B, H, Tc, d) int8
// (q8 = 1, with f32 scales (L, B, H, Tc, 1)) or in the model dtype (q8 = 0,
// scales unused).  Requires 1 <= d <= 128, 0 <= pos < Tc, and a split plan
// (cluster <= 8 slices of slice_rows positions covering 0..pos, staged
// chunk_rows rows at a time) from ops/_launch.py::split_plan.  Returns a
// cudaError_t code.
int mnx_decode_attention_layered(int dtype, int q8, const void* q, const void* k,
                                 const void* v, const float* k_scale,
                                 const float* v_scale, void* out, int B, int H, int Tc,
                                 int d, int pos, int layer, int cluster, int slice_rows,
                                 int chunk_rows, void* stream) {
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
#define MNX_DECODE(T, Q)                                                                 \
  mnx::decode_attn<T, Q>(q, k, v, k_scale, v_scale, out, B, H, Tc, d, pos, layer, cluster, \
                         slice_rows, chunk_rows, st)
  if (dtype == mnx::kF32) return q8 ? MNX_DECODE(float, true) : MNX_DECODE(float, false);
  if (dtype == mnx::kBF16)
    return q8 ? MNX_DECODE(__nv_bfloat16, true) : MNX_DECODE(__nv_bfloat16, false);
#undef MNX_DECODE
  return cudaErrorInvalidValue;
}

}  // extern "C"
