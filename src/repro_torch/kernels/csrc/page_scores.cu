// Quest min-max page scoring and the page selection around it, fused.
//
// Replaces the Pallas TPU kernels repro/kernels/page_scores.py, function
// page_scores (body _kernel):
//   score[b, h, g, n] = scale * sum_d max(q[b,h,g,d] * lo[b,n,h,d],
//                                         q[b,h,g,d] * hi[b,n,h,d])
// and repro/kernels/centroid_scores.py, function centroid_scores (body
// _kernel): the same bound against the C cluster boxes (B, C, kv, 2, d),
// with a cluster of count[b, c, h] == 0 scoring exactly -1e30.
// Beyond the TPU kernels, two entry points run the selection around them in
// the same launch:
//   - freekv_select_pages: repro/core/selection.py:74-112 (select_pages
//     without select_top_p and q_pool): the scores of the G query rows, the
//     selectable mask, where(valid, s, -1e30), the group pooling (mean or
//     max over the G rows of the softmax over pages, or of the raw scores),
//     the final mask and the top-k with jax.lax.top_k's order (value
//     descending, equal values lower index first), -1 where the value is
//     <= -5e29 and -1 padding past the page count. With candidate ids it
//     is stage 2 of repro/core/centroid_index.py:289-330: each candidate's
//     summary is read by its page id in place, a -1 candidate is invalid and
//     never read, and the ids returned are the candidates'. Two variants
//     of the same launch: per query head (hg = G query heads a summary
//     row), each of the G heads of a (request, KV head) row makes its own
//     top-k over its own scores with no pooling (Quest,
//     repro/core/retrieval.py:508-513): the launch runs B * kv * G rows of
//     one query row each, every one reading its KV head's summaries in
//     place; and keep_invalid, where a lane whose value is -1e30 keeps the
//     page id jax.lax.top_k gives it (the lower ids first among the equal
//     -1e30 values) instead of -1 (Quest's raw top-k, RaaS's prefill
//     seeding, repro/core/retrieval.py:697).
//   - freekv_centroid_candidates: repro/core/centroid_index.py:254-287
//     (cluster_scores + candidate_pages): the bound against the boxes, the
//     max over the G rows, each selectable page inheriting its cluster's
//     score, the top m in page-id order among equal values.
// freekv_page_scores and freekv_centroid_scores remain as scores-only
// entries of the same kernel.
//
// What bounds it on an H100: neither bytes nor operations but latency. The
// summaries (B, N, kv, 2, d) are read once and each element feeds G
// multiply-max-adds, ~2 FLOP a byte; at the main path's shapes (B = 4,
// N = 259, kv = 8, d = 128, bf16) that is ~4.2 MB, ~1.3 us at 3.35 TB/s.
// What the selection costs instead is round trips: of the loads, and of
// the ~23 PyTorch ops (and their launches) that pooled, masked and sorted
// the scores on the host's schedule.
//
// Design: one (request, KV head) row per thread-block cluster of S <= 8
// blocks (ops.select_split: about one wave of the card at the main shape);
// block r of the cluster takes pages [N r / S, N (r + 1) / S).
//   - Loads and scoring: each page's lo and hi rows are 2 d contiguous
//     elements at a kv * 2 d stride. 16 threads take a page (32 for
//     d > 128), each owning 8 elements of d (16 bytes of bf16); a thread
//     puts the 16-byte loads of up to 5 pages in flight at once, straight
//     into registers, then q's G rows (fp32 registers), so a block's pages
//     (80 a pass) arrive in about one round trip. The partial sums reduce
//     across the page's threads with shuffles. (A two-stage ring of
//     cp.async.bulk copies, one 512-byte copy a page, took ~20% longer at
//     the main shape on an H100.) The scores stay in shared memory (a
//     workspace in device memory when a block's pages do not fit).
//   - Softmax: each block's max m_b goes to the cluster through
//     distributed shared memory and every block takes M = max_b m_b; then
//     each block's sum of exp(x - M), each term in fixed point (2^-46 a
//     unit, kFixedOne) so that the sums are integers, exact in any order,
//     and the cluster's total is the same whatever the split S: the
//     selection does not depend on how many rows a launch holds (S follows
//     the row count, ops.select_split; a tensor-parallel shard launches
//     half the rows). expf, not __expf; probabilities below FLT_MIN flush
//     to 0.0 as XLA's do; the G rows are summed in order and divided by G.
//   - Top-k: exact and deterministic on a 64-bit key (the value's bits in
//     an order-preserving form, then the complement of the index), so no
//     two keys are equal. Each block ranks its pages by counting the keys
//     that beat them and keeps its k best in order; a kept key's place in
//     the row is its own rank plus, for each other block, the number of
//     that block's kept keys above it (binary searches through distributed
//     shared memory, one a (key, block) pair, all at once). Each of the
//     first k places is written exactly once.
// No host synchronisation and no host-side state per launch; the wrapper
// allocates the outputs and any workspace.

#include <cooperative_groups.h>
#include <float.h>

#include "common.cuh"

namespace cg = cooperative_groups;

namespace freekv {
namespace {

constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;
constexpr int kMaxG = 16;
constexpr int kMaxD = 256;
constexpr int kMaxCluster = 8;          // ops.MAX_CLUSTER
constexpr int kSmemScores = 8192;       // G * pages a block keeps in shared memory (ops)
constexpr int kSmemKeys = 2048;         // pages a block ranks in shared memory (ops)
constexpr float kNegHalf = -5e29f;      // NEG_INF / 2: a value at or below it selects -1
// the softmax denominator's fixed-point unit: a term exp(x - M) <= 1 is at
// most 2^46, so up to kMaxFixedPages terms sum exactly in 64 bits
constexpr double kFixedOne = 70368744177664.0;   // 2^46
constexpr int kMaxFixedPages = 1 << 18;

enum Mode { kScores = 0, kSelect = 1, kCandidates = 2 };
enum Pool { kMeanSoftmax = 0, kMaxSoftmax = 1, kMeanQk = 2, kMaxQk = 3 };

struct Args {
  const void* q;               // (B, kv, G, d)
  const void* summ;            // (B, NP, kv, 2, d): page summaries, or cluster boxes
  const int32_t* count;        // (B, NP, kv) cluster sizes, or null
  const int32_t* length;       // (B,) tokens in each request
  const int32_t* cand;         // (B, kv, N) candidate page ids, or null
  const int32_t* assign;       // (B, N, kv) page -> cluster (candidates)
  float* scores;               // scores: the output (B, kv, G, N); select: workspace or null
  unsigned long long* keys;    // workspace (B, kv, S, 2 nl) or null
  int32_t* idx;                // (B, kv, n_sel)
  float* pooled;               // (B, kv, N) or null
  float* top;                  // (B, kv, n_sel) the kept ids' pooled values, or null
  int B, kv, G, N, NP, d, n_sel, k, S, nl;
  int page_size, n_sink, n_window, pool;
  int hg;                      // query heads a summary row: G per head, else 1
  int keep_invalid;            // 1: -1e30 lanes keep their page ids, not -1
  int page_lo;                 // select: item i is page page_lo + i (a page shard's range)
  float scale;
};

__host__ __device__ inline int imin(int a, int b) { return a < b ? a : b; }
__host__ __device__ inline int imax(int a, int b) { return a > b ? a : b; }
__host__ __device__ inline size_t align16(size_t x) { return (x + 15) & ~size_t(15); }

// Byte offsets into the block's dynamic shared memory.
struct Layout {
  size_t red, part, cs, sc, keys, total;
  __host__ __device__ Layout(int mode, int G, int nl, int k, int C, bool sc_smem,
                             bool keys_smem) {
    size_t off = 0;
    red = off;                                   // a 64-bit value a (warp, row)
    off += sizeof(unsigned long long) * kWarps * kMaxG;
    part = off;                                  // part_max, M, Sum (float); part_sum (u64)
    off += sizeof(float) * 4 * kMaxG + sizeof(unsigned long long) * kMaxG;
    cs = off;
    if (mode == kCandidates) off += sizeof(float) * (size_t)(G + 1) * C;
    off = align16(off);
    sc = off;
    if (mode == kSelect && sc_smem) off += sizeof(float) * (size_t)G * nl;
    off = align16(off);
    keys = off;
    if (mode != kScores && keys_smem) off += 8 * (size_t)(nl + imin(k, nl));
    total = off;
  }
};

__device__ __forceinline__ int floordiv(int x, int y) {
  const int q = x / y;
  return (x % y != 0 && ((x < 0) != (y < 0))) ? q - 1 : q;
}

// the value's bits made to order as unsigned ints, then the index's
// complement: a larger key is a larger value, or an equal one at a lower index
__device__ __forceinline__ unsigned long long make_key(float v, int i) {
  uint32_t u = __float_as_uint(v == 0.f ? 0.f : v);   // -0.0 ties +0.0
  u = (u & 0x80000000u) ? ~u : (u | 0x80000000u);
  return ((unsigned long long)u << 32) | (0xffffffffu - (uint32_t)i);
}

// the value a key was made from (make_key's order map undone; -0.0 comes back as 0.0)
__device__ __forceinline__ float key_value(unsigned long long key) {
  uint32_t u = (uint32_t)(key >> 32);
  u = (u & 0x80000000u) ? (u & 0x7fffffffu) : ~u;
  return __uint_as_float(u);
}

__device__ __forceinline__ int key_index(unsigned long long key) {
  return (int)(0xffffffffu - (uint32_t)key);
}

__device__ __forceinline__ bool key_selects(unsigned long long key) {
  return (uint32_t)(key >> 32) > (uint32_t)(make_key(kNegHalf, 0) >> 32);
}

// 8 elements of a row from element c0 on, as loaded: one 16-byte vector of
// bf16 or two of float (kVec), through the read-only path when `vec` (d % 8
// == 0, 16-byte aligned rows), else element by element, zeros past d
template <typename T>
__device__ __forceinline__ void load_raw(const T* p, int c0, int d, bool vec,
                                         uint4 (&r)[sizeof(T) / 2]) {
  if (vec) {
#pragma unroll
    for (int k = 0; k < (int)sizeof(T) / 2; ++k)
      r[k] = __ldg(reinterpret_cast<const uint4*>(p + c0) + k);
  } else {
    T* t = reinterpret_cast<T*>(r);
#pragma unroll
    for (int e = 0; e < 8; ++e) t[e] = c0 + e < d ? p[c0 + e] : from_f32<T>(0.f);
  }
}

__device__ __forceinline__ float elem(const uint4* r, int e, float) {
  return reinterpret_cast<const float*>(r)[e];
}
__device__ __forceinline__ float elem(const uint4* r, int e, __nv_bfloat16) {
  return __bfloat162float(reinterpret_cast<const __nv_bfloat16*>(r)[e]);
}

// pages a block scores in one pass: kLP threads a page, kDepth pages a thread
template <int kG, int kLP>
__host__ __device__ constexpr int pass_pages() {
  return kThreads / kLP * (kG <= 4 ? 5 : 2);
}

// Scores items [i0, i1) of row (b, h) against the G query rows at `q`
// (G x d): item i is page i of `src` (B, NP, kv, 2, d), or page ids[i] when
// ids is given (< 0: not read). Each pass of pass_pages() items puts every
// load in flight first: kLP threads a page, each thread 16 bytes of the lo
// row and 16 of the hi row for kDepth pages, straight into registers (on
// the first pass, q's G rows follow them). Then the kLP threads of each
// page compute its G bounds, reduce them with shuffles and call sink(i,
// lane, acc) with every row's sum in every lane (unscaled). Every thread of
// the block calls this.
template <typename T, int kG, int kLP, typename Sink>
__device__ __forceinline__ void score_items(const T* __restrict__ src, int NP, int kv, int b,
                                            int h, int d, const T* __restrict__ q, int G,
                                            const int32_t* __restrict__ ids, int i0, int i1,
                                            bool vec, Sink&& sink) {
  constexpr int kGroups = kThreads / kLP;
  constexpr int kDepth = pass_pages<kG, kLP>() / kGroups;
  constexpr int kVec = sizeof(T) / 2;
  const int tid = threadIdx.x, group = tid / kLP, lane = tid % kLP, c0 = lane * 8;
  const size_t row = 2 * (size_t)d;
  float qr[kG][8];
  bool have_q = false;
  for (int j0 = i0; j0 < i1; j0 += kGroups * kDepth) {
    uint4 lo[kDepth][kVec], hi[kDepth][kVec];
#pragma unroll
    for (int u = 0; u < kDepth; ++u) {
      if (j0 + u * kGroups >= i1) break;          // the block's last pass may be short
      const int j = j0 + u * kGroups + group;
      int p = -1;
      if (j < i1) p = ids == nullptr ? j : (ids[j] < 0 ? -1 : imin(ids[j], NP - 1));
      if (p >= 0 && c0 < d) {
        const T* pg = src + (((size_t)b * NP + p) * kv + h) * row;
        load_raw(pg, c0, d, vec, lo[u]);
        load_raw(pg + d, c0, d, vec, hi[u]);
      } else {
#pragma unroll
        for (int k = 0; k < kVec; ++k) lo[u][k] = hi[u][k] = make_uint4(0, 0, 0, 0);
      }
    }
    if (!have_q) {
      const bool vec_q = d % 8 == 0 && reinterpret_cast<uintptr_t>(q) % 16 == 0;
#pragma unroll
      for (int g = 0; g < kG; ++g) {
        if (g < G && c0 < d) {
          uint4 raw[kVec];
          load_raw(q + (size_t)g * d, c0, d, vec_q, raw);
#pragma unroll
          for (int e = 0; e < 8; ++e) qr[g][e] = elem(raw, e, T());
        } else {
#pragma unroll
          for (int e = 0; e < 8; ++e) qr[g][e] = 0.f;
        }
      }
      have_q = true;
    }
#pragma unroll
    for (int u = 0; u < kDepth; ++u) {
      if (j0 + u * kGroups >= i1) break;
      float acc[kG];
#pragma unroll
      for (int g = 0; g < kG; ++g) acc[g] = 0.f;
#pragma unroll
      for (int e = 0; e < 8; ++e) {
        const float l = elem(lo[u], e, T()), x = elem(hi[u], e, T());
#pragma unroll
        for (int g = 0; g < kG; ++g) acc[g] += fmaxf(qr[g][e] * l, qr[g][e] * x);
      }
#pragma unroll
      for (int off = kLP / 2; off > 0; off >>= 1)
#pragma unroll
        for (int g = 0; g < kG; ++g) acc[g] += __shfl_xor_sync(0xffffffffu, acc[g], off);
      const int j = j0 + u * kGroups + group;
      if (j < i1) sink(j, lane, acc);
    }
  }
}

// v[g] over the block into out[g] (g < G): an exact integer sum
template <int kG>
__device__ __forceinline__ void block_sum_u64(unsigned long long (&v)[kG],
                                              unsigned long long* red,
                                              unsigned long long* out, int G) {
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
#pragma unroll
  for (int g = 0; g < kG; ++g) {
    unsigned long long x = v[g];
#pragma unroll
    for (int off = 16; off > 0; off >>= 1) x += __shfl_xor_sync(0xffffffffu, x, off);
    if (lane == 0) red[warp * kMaxG + g] = x;
  }
  __syncthreads();
  if ((int)threadIdx.x < G) {
    unsigned long long a = 0;
    for (int w = 0; w < kWarps; ++w) a += red[w * kMaxG + threadIdx.x];
    out[threadIdx.x] = a;
  }
}

// v[g] over the block into out[g] (g < G), by max or by sum, warps in order
template <int kG, bool kMax>
__device__ __forceinline__ void block_reduce(float (&v)[kG], float* red, float* out, int G) {
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
#pragma unroll
  for (int g = 0; g < kG; ++g) {
    const float x = kMax ? warp_max(v[g]) : warp_sum(v[g]);
    if (lane == 0) red[warp * kMaxG + g] = x;
  }
  __syncthreads();
  if ((int)threadIdx.x < G) {
    float a = red[threadIdx.x];
    for (int w = 1; w < kWarps; ++w)
      a = kMax ? fmaxf(a, red[w * kMaxG + threadIdx.x]) : a + red[w * kMaxG + threadIdx.x];
    out[threadIdx.x] = a;
  }
}

template <typename T, int kG, int kLP, int kMode>
__global__ void __launch_bounds__(kThreads) select_kernel(const Args a) {
  extern __shared__ __align__(128) unsigned char smem[];
  // blockIdx.y: a (KV head, query head) row; the summaries are the KV head's
  const int h = blockIdx.y / a.hg, b = blockIdx.z, tid = threadIdx.x;
  const int r = blockIdx.x, S = a.S;
  const int i0 = (int)((long long)a.N * r / S), i1 = (int)((long long)a.N * (r + 1) / S);
  const int n_loc = i1 - i0;
  const size_t row = (size_t)b * gridDim.y + blockIdx.y;
  const int G = a.G, d = a.d;
  const bool sc_smem = G * a.nl <= kSmemScores, keys_smem = a.nl <= kSmemKeys;
  const Layout L(kMode, G, a.nl, a.k, a.NP, sc_smem, keys_smem);
  float* red = reinterpret_cast<float*>(smem + L.red);
  float* part_max = reinterpret_cast<float*>(smem + L.part);
  float* stat_m = part_max + kMaxG;
  float* stat_s = stat_m + kMaxG;
  unsigned long long* part_sum = reinterpret_cast<unsigned long long*>(part_max + 4 * kMaxG);
  const T* summ = static_cast<const T*>(a.summ);
  const bool vec = d % 8 == 0 && reinterpret_cast<uintptr_t>(summ) % 16 == 0;
  const T* qrow = static_cast<const T*>(a.q) + row * G * d;

  if constexpr (kMode == kScores) {
    // the bounds alone, straight to the output (B, kv, G, N); a box of an
    // empty cluster scores exactly -1e30
    float* out = a.scores + row * G * a.N;
    score_items<T, kG, kLP>(summ, a.NP, a.kv, b, h, d, qrow, G, nullptr, i0, i1, vec,
                            [&](int i, int lane, const float(&acc)[kG]) {
      const bool empty = a.count != nullptr && a.count[((size_t)b * a.NP + i) * a.kv + h] == 0;
#pragma unroll
      for (int g = 0; g < kG; ++g)
        if (g < G && g == lane) out[(size_t)g * a.N + i] = empty ? kNegInf : acc[g] * a.scale;
    });
    return;
  } else {
    cg::cluster_group cluster = cg::this_cluster();
    const int first = a.n_sink / a.page_size;
    const int len = a.length[b];
    const int lim = imin(floordiv(len, a.page_size),
                         imax(first, floordiv(len - a.n_window, a.page_size)));
    unsigned long long* keys;
    unsigned long long* list;
    const size_t ws_row = (row * S + r) * 2 * (size_t)a.nl;
    if (keys_smem) {
      keys = reinterpret_cast<unsigned long long*>(smem + L.keys);
      list = keys + a.nl;
    } else {
      keys = a.keys + ws_row;
      list = keys + a.nl;
    }

    if constexpr (kMode == kSelect) {
      const int32_t* cand = a.cand != nullptr ? a.cand + row * a.N : nullptr;
      // a page shard's items are pages page_lo + i, validity and ids global
      auto valid = [&](int i) {
        return cand != nullptr ? cand[i] >= 0 : i + a.page_lo >= first && i + a.page_lo < lim;
      };
      float* sc = sc_smem ? reinterpret_cast<float*>(smem + L.sc)
                          : a.scores + (row * S + r) * (size_t)G * a.nl;
      score_items<T, kG, kLP>(summ, a.NP, a.kv, b, h, d, qrow, G, cand, i0, i1, vec,
                              [&](int i, int lane, const float(&acc)[kG]) {
#pragma unroll
        for (int g = 0; g < kG; ++g)
          if (g < G && g == lane) sc[(size_t)g * a.nl + (i - i0)] = acc[g] * a.scale;
      });
      __syncthreads();
      const bool softmax = a.pool == kMeanSoftmax || a.pool == kMaxSoftmax;
      const bool mean = a.pool == kMeanSoftmax || a.pool == kMeanQk;
      if (softmax) {
        // the block's max m_b, then over the cluster M = max m_b; the
        // block's sum of exp(x - M) in fixed point, then over the cluster:
        // integer sums, so the total is the same in any order and split
        float v[kG];
#pragma unroll
        for (int g = 0; g < kG; ++g) v[g] = -FLT_MAX;
        for (int i = tid; i < n_loc; i += kThreads) {
          const bool ok = valid(i0 + i);
#pragma unroll
          for (int g = 0; g < kG; ++g)
            if (g < G) v[g] = fmaxf(v[g], ok ? sc[(size_t)g * a.nl + i] : kNegInf);
        }
        block_reduce<kG, true>(v, red, part_max, G);
        cluster.sync();
        if (tid < G) {
          float m = -FLT_MAX;
          for (int s = 0; s < S; ++s) m = fmaxf(m, *cluster.map_shared_rank(part_max + tid, s));
          stat_m[tid] = m;
        }
        __syncthreads();
        unsigned long long u[kG];
#pragma unroll
        for (int g = 0; g < kG; ++g) u[g] = 0ull;
        for (int i = tid; i < n_loc; i += kThreads) {
          const bool ok = valid(i0 + i);
#pragma unroll
          for (int g = 0; g < kG; ++g)
            if (g < G)
              u[g] += (unsigned long long)(
                  (double)expf((ok ? sc[(size_t)g * a.nl + i] : kNegInf) - stat_m[g]) * kFixedOne);
        }
        block_sum_u64<kG>(u, reinterpret_cast<unsigned long long*>(red), part_sum, G);
        cluster.sync();
        if (tid < G) {
          unsigned long long total = 0;
          for (int s = 0; s < S; ++s) total += *cluster.map_shared_rank(part_sum + tid, s);
          stat_s[tid] = (float)((double)total / kFixedOne);
        }
        __syncthreads();
      }
      // pooled value and key of each page
      for (int i = tid; i < n_loc; i += kThreads) {
        const bool ok = valid(i0 + i);
        float acc = 0.f;
        for (int g = 0; g < G; ++g) {
          float x = ok ? sc[(size_t)g * a.nl + i] : kNegInf;
          if (softmax) {
            x = expf(x - stat_m[g]) / stat_s[g];
            if (x < FLT_MIN) x = 0.f;
          }
          acc = g == 0 ? x : (mean ? acc + x : fmaxf(acc, x));
        }
        if (mean) acc = acc / (float)G;
        const float pv = ok ? acc : kNegInf;
        if (a.pooled != nullptr) a.pooled[row * a.N + i0 + i] = pv;
        keys[i] = make_key(pv, i0 + i);
      }
    } else {
      // kCandidates: the cluster boxes' bounds (every block of the cluster
      // scores all C), the max over the G rows, -1e30 for empty clusters
      const int C = a.NP;
      float* cs_g = reinterpret_cast<float*>(smem + L.cs);
      float* cs = cs_g + (size_t)G * C;
      score_items<T, kG, kLP>(summ, C, a.kv, b, h, d, qrow, G, nullptr, 0, C, vec,
                              [&](int i, int lane, const float(&acc)[kG]) {
#pragma unroll
        for (int g = 0; g < kG; ++g)
          if (g < G && g == lane) cs_g[(size_t)g * C + i] = acc[g] * a.scale;
      });
      __syncthreads();
      for (int c = tid; c < C; c += kThreads) {
        float m = cs_g[c];
        for (int g = 1; g < G; ++g) m = fmaxf(m, cs_g[(size_t)g * C + c]);
        cs[c] = a.count[((size_t)b * C + c) * a.kv + h] == 0 ? kNegInf : m;
      }
      __syncthreads();
      for (int i = tid; i < n_loc; i += kThreads) {
        const int p = i0 + i;
        const int c = a.assign[((size_t)b * a.N + p) * a.kv + h];
        const bool ok = c >= 0 && p >= first && p < lim;
        keys[i] = make_key(ok ? cs[c] : kNegInf, p);
      }
    }
    __syncthreads();

    // the block's k best, in order: a key's rank is the count of keys above it
    const int k = a.k, kk = imin(k, n_loc);
    for (int i = tid; i < n_loc; i += kThreads) {
      const unsigned long long key = keys[i];
      int rank = 0;
      for (int j = 0; j < n_loc; ++j) rank += keys[j] > key;
      if (rank < k) list[rank] = key;
    }
    __syncthreads();
    // a kept key's place in the row: its rank plus, for every other block,
    // that block's kept keys above it (each list is sorted, descending);
    // the ranked keys' room holds the places, one binary search a (key,
    // block) pair, all in parallel
    int* place = reinterpret_cast<int*>(keys);
    for (int j = tid; j < kk; j += kThreads) place[j] = j;
    cluster.sync();
    for (int t = tid; t < kk * S; t += kThreads) {
      const int s = t / kk, j = t % kk;
      if (s == r) continue;
      const int n_s = (int)((long long)a.N * (s + 1) / S) - (int)((long long)a.N * s / S);
      const unsigned long long* ls =
          keys_smem ? cluster.map_shared_rank(list, s)
                    : a.keys + (row * S + s) * 2 * (size_t)a.nl + a.nl;
      const unsigned long long key = list[j];
      int lo = 0, hi = imin(k, n_s);
      while (lo < hi) {
        const int mid = (lo + hi) >> 1;
        if (ls[mid] > key) lo = mid + 1;
        else hi = mid;
      }
      if (lo > 0) atomicAdd(&place[j], lo);
    }
    __syncthreads();
    const int32_t* cand = kMode == kSelect && a.cand != nullptr ? a.cand + row * a.N : nullptr;
    int32_t* out = a.idx + row * a.n_sel;
    float* top = a.top != nullptr ? a.top + row * a.n_sel : nullptr;
    const int lo = kMode == kSelect ? a.page_lo : 0;
    for (int j = tid; j < kk; j += kThreads) {
      if (place[j] < k) {
        const unsigned long long key = list[j];
        const int i = key_index(key);
        out[place[j]] =
            key_selects(key) || a.keep_invalid ? (cand != nullptr ? cand[i] : lo + i) : -1;
        if (top != nullptr) top[place[j]] = key_value(key);
      }
    }
    if (r == 0)
      for (int j = k + tid; j < a.n_sel; j += kThreads) {
        out[j] = -1;
        if (top != nullptr) top[j] = kNegInf;
      }
    cluster.sync();                               // no block leaves while its list is read
  }
}

template <typename T, int kG, int kLP, int kMode>
cudaError_t launch_t(Args a, int device, cudaStream_t st) {
  if (kMode == kScores) {                         // one pass a block, no cluster
    a.S = (a.N + pass_pages<kG, kLP>() - 1) / pass_pages<kG, kLP>();
    a.nl = (a.N + a.S - 1) / a.S;
  }
  const bool sc_smem = a.G * a.nl <= kSmemScores, keys_smem = a.nl <= kSmemKeys;
  if (kMode == kSelect && !sc_smem && a.scores == nullptr) return cudaErrorInvalidValue;
  if (kMode != kScores && !keys_smem && a.keys == nullptr) return cudaErrorInvalidValue;
  const Layout L(kMode, a.G, a.nl, a.k, a.NP, sc_smem, keys_smem);
  cudaError_t err = allow_smem<select_kernel<T, kG, kLP, kMode>>(L.total, device);
  if (err != cudaSuccess) return err;
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3(a.S, a.kv * a.hg, a.B);
  cfg.blockDim = dim3(kThreads);
  cfg.dynamicSmemBytes = L.total;
  cfg.stream = st;
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeClusterDimension;
  attr[0].val.clusterDim.x = a.S;
  attr[0].val.clusterDim.y = 1;
  attr[0].val.clusterDim.z = 1;
  cfg.attrs = attr;
  cfg.numAttrs = kMode == kScores ? 0 : 1;
  err = cudaLaunchKernelEx(&cfg, select_kernel<T, kG, kLP, kMode>, a);
  if (err != cudaSuccess) return err;
  return cudaGetLastError();
}

template <int kMode>
int launch(Args a, int dtype, int device, void* stream) {
  if (a.G < 1 || a.G > kMaxG || a.d < 1 || a.d > kMaxD || a.N < 1 || a.NP < 1 || a.B < 1 ||
      a.kv < 1 || a.hg < 1 || a.kv * a.hg > 65535)
    return cudaErrorInvalidValue;
  if (kMode != kScores && (a.S < 1 || a.S > kMaxCluster || a.S > a.N || a.k < 1 ||
                           a.k > a.N || a.n_sel < a.k || a.page_size < 1 ||
                           a.nl != (a.N + a.S - 1) / a.S))
    return cudaErrorInvalidValue;
  if (kMode == kCandidates && (size_t)(a.G + 1) * a.NP > kSmemScores) return cudaErrorInvalidValue;
  if (kMode == kSelect && a.N > kMaxFixedPages) return cudaErrorInvalidValue;
  const DeviceGuard guard(device);
  if (guard.error() != cudaSuccess) return guard.error();
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const bool g4 = a.G <= 4, d128 = a.d <= 128;
  if (dtype == kFloat32) {
    if (g4) return d128 ? launch_t<float, 4, 16, kMode>(a, device, st)
                        : launch_t<float, 4, 32, kMode>(a, device, st);
    return d128 ? launch_t<float, 16, 16, kMode>(a, device, st)
                : launch_t<float, 16, 32, kMode>(a, device, st);
  }
  if (dtype == kBFloat16) {
    if (g4) return d128 ? launch_t<__nv_bfloat16, 4, 16, kMode>(a, device, st)
                        : launch_t<__nv_bfloat16, 4, 32, kMode>(a, device, st);
    return d128 ? launch_t<__nv_bfloat16, 16, 16, kMode>(a, device, st)
                : launch_t<__nv_bfloat16, 16, 32, kMode>(a, device, st);
  }
  return cudaErrorInvalidValue;
}

}  // namespace
}  // namespace freekv

// q (B, kv, G, d), summ (B, N, kv, 2, d) in the dtype given by `dtype`;
// out (B, kv, G, N) fp32, allocated by the caller. Returns cudaGetLastError().
extern "C" int freekv_page_scores(const void* q, const void* summ, void* out, int B, int kv,
                                  int G, int N, int d, float scale, int dtype, int device,
                                  void* stream) {
  freekv::Args a = {};
  a.q = q, a.summ = summ, a.scores = static_cast<float*>(out);
  a.B = B, a.kv = kv, a.G = G, a.N = N, a.NP = N, a.d = d, a.hg = 1, a.scale = scale;
  return freekv::launch<freekv::kScores>(a, dtype, device, stream);
}

// q (B, kv, G, d), cent (B, C, kv, 2, d) in the dtype given by `dtype`, count
// (B, C, kv) int32; out (B, kv, G, C) fp32. Returns cudaGetLastError().
extern "C" int freekv_centroid_scores(const void* q, const void* cent, const void* count,
                                      void* out, int B, int kv, int G, int C, int d,
                                      float scale, int dtype, int device, void* stream) {
  if (count == nullptr) return cudaErrorInvalidValue;
  freekv::Args a = {};
  a.q = q, a.summ = cent, a.count = static_cast<const int32_t*>(count);
  a.scores = static_cast<float*>(out);
  a.B = B, a.kv = kv, a.G = G, a.N = C, a.NP = C, a.d = d, a.hg = 1, a.scale = scale;
  return freekv::launch<freekv::kScores>(a, dtype, device, stream);
}

// q (B, kv, G, d), summ (B, NP, kv, 2, d) in the dtype given by `dtype`,
// length (B,) int32; cand (B, kv, N) int32 candidate page ids or null (then
// N == NP and item i is page i); idx (B, kv, n_sel) int32 and pooled (B, kv,
// N) fp32 (or null) out. S blocks a row (a cluster), k = min(n_sel, N),
// nl = ceil(N / S); ws_scores (B, kv, S, G, nl) fp32 when G * nl > 8192 and
// ws_keys (B, kv, S, 2 nl) uint64 when nl > 2048, else null. pool: 0
// mean_softmax, 1 max_softmax, 2 mean_qk, 3 max_qk. per_head 1: each of
// the G query heads is a row of its own (G = 1 of them, B * kv * G rows;
// idx (B, kv, G, n_sel), pooled (B, kv, G, N), the workspaces as for
// kv * G KV heads; no candidates); keep_invalid 1: lanes at -1e30 keep
// their page ids. page_lo: summ holds pages page_lo .. page_lo + NP - 1 of
// the request (a page shard's range; 0 for the whole pool): the mask and
// the ids are the global pages'. top (B, kv, n_sel) fp32 or null: each
// kept id's pooled value (-1e30 past the valid lanes). Returns
// cudaGetLastError().
extern "C" int freekv_select_pages(const void* q, const void* summ, const void* length,
                                   const void* cand, void* idx, void* pooled, void* top,
                                   void* ws_scores, void* ws_keys, int B, int kv, int G, int N,
                                   int NP, int d, int n_sel, int k, int S, int nl,
                                   int page_size, int n_sink, int n_window, int pool,
                                   int per_head, int keep_invalid, int page_lo, float scale,
                                   int dtype, int device, void* stream) {
  if (length == nullptr || idx == nullptr || pool < 0 || pool > 3 ||
      (cand == nullptr && N != NP) || (per_head && cand != nullptr) || page_lo < 0 ||
      (page_lo > 0 && (cand != nullptr || per_head)))
    return cudaErrorInvalidValue;
  freekv::Args a = {};
  a.q = q, a.summ = summ, a.length = static_cast<const int32_t*>(length);
  a.cand = static_cast<const int32_t*>(cand);
  a.idx = static_cast<int32_t*>(idx), a.pooled = static_cast<float*>(pooled);
  a.top = static_cast<float*>(top), a.page_lo = page_lo;
  a.scores = static_cast<float*>(ws_scores);
  a.keys = static_cast<unsigned long long*>(ws_keys);
  a.B = B, a.kv = kv, a.G = G, a.N = N, a.NP = NP, a.d = d, a.n_sel = n_sel, a.k = k;
  a.S = S, a.nl = nl, a.page_size = page_size, a.n_sink = n_sink, a.n_window = n_window;
  a.pool = pool, a.scale = scale, a.keep_invalid = keep_invalid != 0;
  a.hg = per_head ? G : 1;
  if (per_head) a.G = 1;
  return freekv::launch<freekv::kSelect>(a, dtype, device, stream);
}

// q (B, kv, G, d), cent (B, C, kv, 2, d) in the dtype given by `dtype`,
// count (B, C, kv), cent_assign (B, N, kv) and length (B,) int32; cand
// (B, kv, m) int32 out. S blocks a row, nl = ceil(N / S), ws_keys as for
// freekv_select_pages. Returns cudaGetLastError().
extern "C" int freekv_centroid_candidates(const void* q, const void* cent, const void* count,
                                          const void* assign, const void* length, void* cand,
                                          void* ws_keys, int B, int kv, int G, int C, int N,
                                          int d, int m, int S, int nl, int page_size,
                                          int n_sink, int n_window, float scale, int dtype,
                                          int device, void* stream) {
  if (count == nullptr || assign == nullptr || length == nullptr || cand == nullptr)
    return cudaErrorInvalidValue;
  freekv::Args a = {};
  a.q = q, a.summ = cent, a.count = static_cast<const int32_t*>(count);
  a.assign = static_cast<const int32_t*>(assign), a.length = static_cast<const int32_t*>(length);
  a.idx = static_cast<int32_t*>(cand), a.keys = static_cast<unsigned long long*>(ws_keys);
  a.B = B, a.kv = kv, a.G = G, a.N = N, a.NP = C, a.d = d, a.n_sel = m, a.k = m;
  a.S = S, a.nl = nl, a.page_size = page_size, a.n_sink = n_sink, a.n_window = n_window;
  a.hg = 1, a.scale = scale;
  return freekv::launch<freekv::kCandidates>(a, dtype, device, stream);
}
