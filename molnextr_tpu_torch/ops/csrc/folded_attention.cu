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
// them (about 1 per bf16 byte read), far under the H100's ridge of 295
// operations per byte: a matrix-vector product per head, nothing for the
// tensor cores.  At B 32, D 256, pos < 480 a call reads at most 15.7 MB.
//
// Design:
//   * the positions of each batch row are split into `cluster` slices, one
//     CTA of 8 warps per slice, the CTAs of a row forming a thread-block
//     cluster (size <= 8, cudaLaunchKernelEx; ops/_launch.py::split_plan
//     gives 8 at B 32: 256 CTAs).  The grid is B * cluster for every bb:
//     K6's batch block exists on the TPU to make each DMA larger; here it
//     would only serialize rows inside a CTA (the previous design ran bb
//     rows one after another in B / bb blocks, 4 blocks at bb 8, and took
//     6.3 times K5's time).  The rows of a bb group run side by side, each
//     in its own cluster, so K6 is K5's launch;
//   * a slice's K rows, and its V rows, are one contiguous run of bytes in
//     the (L, B, T, D) layout: the CTA stages them with cp.async, 16 bytes
//     a thread, K in 4 copy groups scored as each lands and V after them,
//     landing while the scores are computed; q's load is issued before the
//     copies.  A chunk holds at most 32 KB each of K and V (one chunk holds
//     a whole slice at the decoder's shapes), so shared memory does not grow
//     with T; the warps' partial contexts reuse the K rows' region, which
//     keeps a CTA at the decoder's shapes to 73 KB, 3 to an SM, so that the
//     256 CTAs in clusters of 8 start in one wave;
//   * the folded row suits a warp, as in the previous design: a lane reads
//     16 bytes (8 bf16 or 4 f32 channels), a warp whole rows, two rows in
//     flight, and one head's dot product is a shuffle reduction over the
//     hd / 8 (hd / 4) lanes that hold it.  Warps stride over the staged
//     rows;
//   * softmax across the cluster: flash-decoding.  Each CTA keeps, per
//     head, the running max m, the sum l of exp(s - m) and the context
//     sum acc of exp(s - m) * v over its slice, rescaled from chunk to
//     chunk, and stores its (m, l, acc) into rank 0's shared memory
//     (cluster.map_shared_rank), each lane's stores followed by its arrival
//     on rank 0's mbarrier with release semantics at cluster scope.  Rank 0
//     waits on the mbarrier and writes
//     sum_r acc_r e^(m_r - M) / sum_r l_r e^(m_r - M).  Since p is not
//     rounded, this is the reference's function up to float32 rounding,
//     with K and V each read once and one exchange; the exact two-pass form
//     would need a second exchange and, for long slices, a second read of
//     K.  No cluster.sync(): the one cluster barrier, split into an arrive
//     at the start and a wait before the first remote store, orders the
//     mbarrier's initialisation before any arrival.  An empty slice (pos
//     below the split) sends (-inf, 0, 0).
// Positions past pos are never read.
#include <cooperative_groups.h>

#include "common.cuh"

namespace cg = cooperative_groups;

namespace mnx {

constexpr int kFoldThreads = 256;
constexpr int kFoldWarps = kFoldThreads / 32;
constexpr int kMaxHeads = 32;
constexpr int kMaxCluster = 8;
constexpr int kParts = 4;  // copy groups of a chunk's K rows

// byte offsets of the shared-memory regions for a chunk of `rows` rows of
// D channels of `es` bytes, H heads and a cluster of C CTAs; the same on
// the host and the device
// (the warps' partial contexts, red, reuse the K rows' region, which the
// last scores have read before any warp writes them)
struct FoldSmem {
  int bar, kst, vst, sc, mrun, lrun, alpha, red, ml_all, ctx_all, total, ld;
  __host__ __device__ static int up16(int x) { return (x + 15) & ~15; }
  __host__ __device__ static int imax(int a, int b) { return a > b ? a : b; }
  __host__ __device__ FoldSmem(int rows, int D, int es, int H, int C) {
    ld = rows | 1;  // odd row stride: the heads' scores of one position
                    // fall in distinct banks
    bar = 0;
    kst = 16;
    red = kst;
    vst = kst + up16(imax(rows * D * es, 4 * kFoldWarps * D));
    sc = vst + up16(rows * D * es);
    mrun = sc + up16(4 * H * ld);
    lrun = mrun + 4 * kMaxHeads;
    alpha = lrun + 4 * kMaxHeads;
    ml_all = alpha + 4 * kMaxHeads;  // rank 0: [C][2][H]
    ctx_all = ml_all + up16(4 * 2 * C * H);  // rank 0: [C][D]
    total = ctx_all + 4 * C * D;
  }
};

// NI: 16-byte vectors per lane of a row (D / V / 32, rounded up to 1, 2 or 4)
template <typename T, int NI>
__global__ void __launch_bounds__(kFoldThreads)
folded_attn_split_kernel(const T* __restrict__ q, const T* __restrict__ kc,
                         const T* __restrict__ vc, T* __restrict__ out, int B, int Tc,
                         int D, int H, int hd, int pos, int layer, int slice_rows,
                         int chunk_rows, float sqrt_hd) {
  constexpr int V = Vec16<T>::n;
  extern __shared__ __align__(16) unsigned char smem[];
  cg::cluster_group cluster = cg::this_cluster();
  const int C = (int)cluster.num_blocks(), rank = (int)cluster.block_rank();
  const int b = blockIdx.x / C;
  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const int nvec = D / V;  // 16-byte vectors in a row
  const int G = hd / V;    // lanes holding one head: a power of two <= 32
  const int row_bytes = D * (int)sizeof(T);

  const FoldSmem lay(chunk_rows, D, (int)sizeof(T), H, C);
  const int ld = lay.ld;
  uint64_t* bar = reinterpret_cast<uint64_t*>(smem + lay.bar);  // rank 0: the cluster's parts in
  const uint4* kst = reinterpret_cast<const uint4*>(smem + lay.kst);
  const uint4* vst = reinterpret_cast<const uint4*>(smem + lay.vst);
  float* sc = reinterpret_cast<float*>(smem + lay.sc);  // [H][ld]
  float* mrun = reinterpret_cast<float*>(smem + lay.mrun);
  float* lrun = reinterpret_cast<float*>(smem + lay.lrun);
  float* alpha = reinterpret_cast<float*>(smem + lay.alpha);
  float* red = reinterpret_cast<float*>(smem + lay.red);  // [kFoldWarps][D]
  float* ml_all = reinterpret_cast<float*>(smem + lay.ml_all);
  float* ctx_all = reinterpret_cast<float*>(smem + lay.ctx_all);
  const uint4 zero = make_uint4(0u, 0u, 0u, 0u);

  if (tid == 0) mbar_init(bar, 32 * C);
  cluster_arrive_after_init();

  int t0, t1;
  slice_bounds(rank, slice_rows, pos, &t0, &t1);
  const int nchunks = (t1 - t0 + chunk_rows - 1) / chunk_rows;
  const size_t row0 = ((size_t)layer * B + b) * Tc;  // row of position 0
  const unsigned char* kb = reinterpret_cast<const unsigned char*>(kc) + row0 * row_bytes;
  const unsigned char* vb = reinterpret_cast<const unsigned char*>(vc) + row0 * row_bytes;
  const uint4* qr = reinterpret_cast<const uint4*>(q) + (size_t)b * nvec;

  // a chunk's K goes out in kParts copy groups, scored as each lands, and
  // its V after them (landing while the scores are computed).  q's load is
  // issued before the first chunk's copies, so that it does not queue
  // behind them.
  uint4 qraw[NI];
#pragma unroll
  for (int i = 0; i < NI; ++i) {
    const int j = lane + 32 * i;
    qraw[i] = j < nvec ? qr[j] : zero;
  }
  auto part = [&](int n, int p, int* lo, int* hi) {
    const int rows = (n + kParts - 1) / kParts;
    *lo = min(p * rows, n);
    *hi = min(*lo + rows, n);
  };
  auto stage = [&](int p0, int n) {
    for (int p = 0; p < kParts; ++p) {
      int lo, hi;
      part(n, p, &lo, &hi);
      stage_rows(smem + lay.kst + (size_t)lo * row_bytes, kb + (size_t)(p0 + lo) * row_bytes,
                 (hi - lo) * row_bytes, 16);
      cp_async_commit();
    }
    stage_rows(smem + lay.vst, vb + (size_t)p0 * row_bytes, n * row_bytes, 16);
    cp_async_commit();
  };
  if (nchunks > 0) stage(t0, min(chunk_rows, t1 - t0));
  for (int h = tid; h < H; h += kFoldThreads) {
    mrun[h] = -INFINITY;
    lrun[h] = 0.f;
  }
  float qf[NI][V], acc[NI][V];
#pragma unroll
  for (int i = 0; i < NI; ++i) {
    const int j = lane + 32 * i;
    unpack16<T>(qraw[i], qf[i]);
#pragma unroll
    for (int e = 0; e < V; ++e) acc[i][e] = 0.f;
  }

  for (int ch = 0; ch < nchunks; ++ch) {
    const int r0 = t0 + ch * chunk_rows, n = min(chunk_rows, t1 - r0);
    if (ch) {
      __syncthreads();  // the last chunk's rows and scores are consumed
      stage(r0, n);
    }
    // 1. scores of the chunk, part by part as the copies land, two rows a
    //    warp in flight (r depends on the warp only: every lane takes the
    //    shuffles)
    for (int p = 0; p < kParts; ++p) {
      cp_async_wait_upto(kParts - p);  // K parts p + 1 .. and V may be in flight
      __syncthreads();
      int lo, hi;
      part(n, p, &lo, &hi);
      for (int r = lo + warp; r < hi; r += 2 * kFoldWarps) {
        const int r2 = r + kFoldWarps;
#pragma unroll
        for (int i = 0; i < NI; ++i) {
          const int j = lane + 32 * i;
          float f[V], f2[V];
          unpack16<T>(j < nvec ? kst[(size_t)r * nvec + j] : zero, f);
          unpack16<T>(j < nvec && r2 < hi ? kst[(size_t)r2 * nvec + j] : zero, f2);
          float s = 0.f, s2 = 0.f;
#pragma unroll
          for (int e = 0; e < V; ++e) {
            s += qf[i][e] * f[e];
            s2 += qf[i][e] * f2[e];
          }
          for (int o = G >> 1; o > 0; o >>= 1) {
            s += __shfl_xor_sync(0xffffffffu, s, o);
            s2 += __shfl_xor_sync(0xffffffffu, s2, o);
          }
          if (j < nvec && (lane & (G - 1)) == 0) {
            sc[(j / G) * ld + r] = s / sqrt_hd;
            if (r2 < hi) sc[(j / G) * ld + r2] = s2 / sqrt_hd;
          }
        }
      }
    }
    __syncthreads();

    // 2. per head: the new running max, exp(s - m) in place, the running sum
    //    and the factor alpha that rescales what came before
    for (int h = warp; h < H; h += kFoldWarps) {
      float* s = sc + (size_t)h * ld;
      float cm = -INFINITY;
      for (int t = lane; t < n; t += 32) cm = fmaxf(cm, s[t]);
      cm = warp_max(cm);
      const float m_old = mrun[h], m_new = fmaxf(m_old, cm);
      float sum = 0.f;
      for (int t = lane; t < n; t += 32) {
        const float e = expf(s[t] - m_new);
        s[t] = e;
        sum += e;
      }
      sum = warp_sum(sum);
      if (lane == 0) {
        const float a = m_old == -INFINITY ? 0.f : expf(m_old - m_new);
        alpha[h] = a;
        lrun[h] = lrun[h] * a + sum;
        mrun[h] = m_new;
      }
    }
    cp_async_wait<0>();
    __syncthreads();

    // 3. PV: lane j's channels take their head's weights
#pragma unroll
    for (int i = 0; i < NI; ++i) {
      const int j = lane + 32 * i;
      if (j < nvec) {
        const float a = alpha[j / G];
#pragma unroll
        for (int e = 0; e < V; ++e) acc[i][e] *= a;
      }
    }
    for (int r = warp; r < n; r += 2 * kFoldWarps) {
      const int r2 = r + kFoldWarps;
#pragma unroll
      for (int i = 0; i < NI; ++i) {
        const int j = lane + 32 * i;
        if (j >= nvec) continue;
        const float p = sc[(j / G) * ld + r];
        const float p2 = r2 < n ? sc[(j / G) * ld + r2] : 0.f;
        float f[V], f2[V];
        unpack16<T>(vst[(size_t)r * nvec + j], f);
        unpack16<T>(r2 < n ? vst[(size_t)r2 * nvec + j] : zero, f2);
#pragma unroll
        for (int e = 0; e < V; ++e) acc[i][e] += p * f[e] + p2 * f2[e];
      }
    }
  }

  // the CTA's context sum over its warps
#pragma unroll
  for (int i = 0; i < NI; ++i) {
    const int j = lane + 32 * i;
    if (j < nvec)
#pragma unroll
      for (int e = 0; e < V; ++e) red[(size_t)warp * D + j * V + e] = acc[i][e];
  }
  __syncthreads();

  // warp 0 sends the CTA's (m, l, acc) to rank 0, each lane its channels
  // and heads, then its own arrival
  cluster_wait();  // every peer's mbarrier is initialised
  if (warp == 0) {
    float* ctx0 = cluster.map_shared_rank(ctx_all, 0) + (size_t)rank * D;
    float* ml0 = cluster.map_shared_rank(ml_all, 0) + (size_t)rank * 2 * H;
    for (int c = lane; c < D; c += 32) {
      float o = 0.f;
#pragma unroll
      for (int w = 0; w < kFoldWarps; ++w) o += red[(size_t)w * D + c];
      ctx0[c] = o;
    }
    if (lane < H) {
      ml0[lane] = mrun[lane];
      ml0[H + lane] = lrun[lane];
    }
    mbar_arrive_remote(bar, 0);
  }

  // rank 0 combines the cluster's (m, l, acc)
  if (rank == 0) {
    mbar_wait(bar, 0);
    for (int c = tid; c < D; c += kFoldThreads) {
      const int h = c / hd;
      float M = -INFINITY;
      for (int r = 0; r < C; ++r) M = fmaxf(M, ml_all[r * 2 * H + h]);
      float L = 0.f, o = 0.f;
      for (int r = 0; r < C; ++r) {
        const float m = ml_all[r * 2 * H + h];
        if (m == -INFINITY) continue;  // an empty slice
        const float w = expf(m - M);
        L += ml_all[r * 2 * H + H + h] * w;
        o += ctx_all[(size_t)r * D + c] * w;
      }
      out[(size_t)b * D + c] = from_f32<T>(o / L);
    }
  }
  // A CTA of rank r > 0 leaves here: nothing is stored into its shared
  // memory by a peer, and what it sent to rank 0 is rank 0's to wait for.
}

template <typename T, int NI>
cudaError_t folded_attn(const void* q, const void* k, const void* v, void* out, int B,
                        int Tc, int D, int H, int pos, int layer, int cluster,
                        int slice_rows, int chunk_rows, cudaStream_t stream) {
  const size_t smem = FoldSmem(chunk_rows, D, (int)sizeof(T), H, cluster).total;
  auto kernel = folded_attn_split_kernel<T, NI>;
  if (smem > 48 * 1024) {
    const cudaError_t e =
        cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (e != cudaSuccess) return e;
  }
  const int hd = D / H;
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3(B * cluster);
  cfg.blockDim = dim3(kFoldThreads);
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
      &cfg, kernel, static_cast<const T*>(q), static_cast<const T*>(k),
      static_cast<const T*>(v), static_cast<T*>(out), B, Tc, D, H, hd, pos, layer,
      slice_rows, chunk_rows, sqrtf((float)hd));
  return e != cudaSuccess ? e : cudaGetLastError();
}

template <typename T>
cudaError_t folded_attn_dispatch(const void* q, const void* k, const void* v, void* out,
                                 int B, int Tc, int D, int H, int pos, int layer,
                                 int cluster, int slice_rows, int chunk_rows,
                                 cudaStream_t st) {
  if (H < 1 || H > kMaxHeads || cluster < 1 || cluster > kMaxCluster || slice_rows < 1 ||
      chunk_rows < 1 || (long long)cluster * slice_rows < pos + 1)
    return cudaErrorInvalidValue;
  const int lanes_per_row = (D / Vec16<T>::n + 31) / 32;
#define MNX_FOLDED(NI)                                                                   \
  folded_attn<T, NI>(q, k, v, out, B, Tc, D, H, pos, layer, cluster, slice_rows,       \
                     chunk_rows, st)
  if (lanes_per_row <= 1) return MNX_FOLDED(1);
  if (lanes_per_row <= 2) return MNX_FOLDED(2);
  if (lanes_per_row <= 4) return MNX_FOLDED(4);
#undef MNX_FOLDED
  return cudaErrorInvalidValue;
}

}  // namespace mnx

extern "C" {

// q (B, D) and out (B, D), k/v (L, B, Tc, D), all in one dtype, 16-byte
// aligned; D = H * hd with hd / (16 / sizeof(dtype)) a power of two <= 32,
// at most 128 16-byte vectors in a row; 0 <= pos < Tc, 0 <= layer < L; a
// split plan (cluster <= 8 slices of slice_rows positions covering 0..pos,
// staged chunk_rows rows at a time) from ops/_launch.py::split_plan.  The
// wrapper checks these.  Returns a cudaError_t code.
int mnx_folded_decode_attention(int dtype, const void* q, const void* k, const void* v,
                                void* out, int B, int Tc, int D, int H, int pos, int layer,
                                int cluster, int slice_rows, int chunk_rows, void* stream) {
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (dtype == mnx::kF32)
    return mnx::folded_attn_dispatch<float>(q, k, v, out, B, Tc, D, H, pos, layer, cluster,
                                            slice_rows, chunk_rows, st);
  if (dtype == mnx::kBF16)
    return mnx::folded_attn_dispatch<__nv_bfloat16>(q, k, v, out, B, Tc, D, H, pos, layer,
                                                    cluster, slice_rows, chunk_rows, st);
  return cudaErrorInvalidValue;
}

}  // extern "C"
