// Decode attention over per-KV-head page sets, split over the page axis.
//
// Replaces the Pallas TPU kernel repro/kernels/paged_attention.py,
// function paged_attention (body _kernel): one query token per request
// attends to its sink, window and selected pages; a position is valid when
// pos >= 0 && pos <= cur_pos; optional tanh softcap; online softmax.
//
// What bounds it on an H100: bytes. Every K and V page is read once per
// (request, KV head) and each element feeds G query rows (G = 4 for
// llama31-8b), i.e. ~1 FLOP per byte, far below the ~295 FLOP/byte the card
// needs before compute matters. At the main path's shapes (B = 4, kv = 8,
// L = 2080 tokens, d = 128, bf16) that is ~34 MB per launch, ~10 us at
// 3.35 TB/s. So the design is about keeping bytes in flight.
//
// Design: the TPU kernel walks pages sequentially per (b, kv) grid cell and
// carries (m, l, acc) in VMEM scratch. On Hopper one block per (b, kv) is
// only 32 blocks on 132 SMs, so the page axis is split across blocks (up
// to four per SM, each taking at least four pages: ops.split_pages). Each
// block runs the online softmax over its slice of pages and writes fp32
// partials (m, l, acc); the last block of a (b, kv) to finish, found by an
// atomic ticket, merges the slices with the log-sum-exp rule, so one
// launch does both. A slice whose pages are all masked keeps m = -1e30 and
// drops out of the merge with weight 2^(-1e30 - M) = 0.
//
// In the (B, kv, N, p, d) layout a slice's K is one contiguous run of
// tokens, and so is its V. The block streams both in chunks of up to 8 KB
// each (32 tokens at d = 128 in bf16) with cp.async.bulk (the copy engine,
// no registers or threads spent) into a two-stage ring in shared memory,
// in the input's own dtype, tracked by full and empty mbarriers: the next
// chunk is in flight while one is computed, and four blocks share an SM. Each of the four warps takes
// its share of every chunk's tokens and keeps its own online softmax:
//   - scores: lanes across the 16-byte vectors of a key row, q held in
//     registers as float32 for all G rows, so each K element is read from
//     shared memory once for all rows; the dot products reduce with warp
//     shuffles, the positions are loaded a chunk ahead;
//   - P @ V: the same lanes read the same token's V vectors and accumulate
//     all G rows in registers.
// No __syncthreads runs in the loop: each warp releases a stage with one
// arrival. The warps' states merge once, at the end of the slice. The
// statistics are kept in the log2 domain (scores times log2 e, then
// ex2.approx). Accumulation is fp32 throughout.
//
// With `lse` given, the merge also writes each (b, KV head, query row)'s
// log-sum-exp of its scaled (softcapped) scores in fp32, natural log, and
// the output in fp32 (`out32`, not rounded to the inputs' dtype): the
// page-sharded decode step (core/sharded_retrieval) merges the page
// shards' (output, lse) partials, as the reference merges its fp32
// numerators and denominators. The merge has the lse already, M + log2(L)
// in the log2 domain. A row whose positions are all masked scores -1e30 in
// the log2 domain and reports about -6.9e29, which weighs 0 against any
// shard with a valid position.

#include <algorithm>

#include "common.cuh"

namespace freekv {
namespace {

constexpr int kThreads = 128;
constexpr int kWarps = kThreads / 32;
constexpr int kMaxG = 16;
constexpr int kMaxD = 256;
constexpr int kMaxP = 64;
constexpr int kMaxSplit = 256;   // merge weights: kMaxSplit * kMaxG floats in the ring
constexpr int kStages = 2;
constexpr int kStageBytes = 8192;   // K (and again V) bytes a stage holds at most
constexpr int kMaxChunk = 64;       // tokens a stage holds at most
constexpr int kMaxPasses = 4;       // tokens a lane takes per chunk
constexpr size_t kRingBytes = 2 * kStages * kStageBytes;

__host__ __device__ constexpr int pow2_ceil(int x) {
  int r = 1;
  while (r < x) r <<= 1;
  return r;
}

// A key row of `row_bytes` is nv = row_bytes / 16 vectors of 16 bytes; a
// warp gives each token lpt = min(32, pow2_ceil(nv)) lanes, so it takes
// tpw = 32 / lpt tokens at a time.
struct RowSplit {
  int nv, lpt, tpw, chunk;
  __host__ __device__ explicit RowSplit(int row_bytes) {
    nv = row_bytes / 16;
    const int nvp = pow2_ceil(nv);
    lpt = nvp < 32 ? nvp : 32;
    tpw = 32 / lpt;
    chunk = kStageBytes / row_bytes;
    if (chunk > kMaxChunk) chunk = kMaxChunk;
    if (chunk > kMaxPasses * kWarps * tpw) chunk = kMaxPasses * kWarps * tpw;
  }
};

__device__ __forceinline__ void to_floats(const uint4& raw, float* out, float) {
  const float* f = reinterpret_cast<const float*>(&raw);
#pragma unroll
  for (int i = 0; i < 4; ++i) out[i] = f[i];
}

__device__ __forceinline__ void to_floats(const uint4& raw, float* out, __nv_bfloat16) {
  const __nv_bfloat162* h = reinterpret_cast<const __nv_bfloat162*>(&raw);
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const float2 f = __bfloat1622float2(h[i]);
    out[2 * i] = f.x;
    out[2 * i + 1] = f.y;
  }
}

// Pass 1. Each warp runs its own online softmax over its share of every
// chunk's tokens (so no __syncthreads in the loop), for all G rows: a lane
// holds q's and the output's columns of its vectors as float32, in
// registers. The four warps' states merge once, at the end, through the
// idle ring. kG: G rounded up to 4, 8 or 16.
template <typename T, int kG>
__global__ void __launch_bounds__(kThreads, kG == 4 ? 4 : 1)   // G <= 4: 128 registers, 4 an SM
paged_attention_split(const T* __restrict__ q, const T* __restrict__ k,
                      const T* __restrict__ v, const int32_t* __restrict__ pos,
                      const int32_t* __restrict__ cur, float* __restrict__ part_m,
                      float* __restrict__ part_l, float* __restrict__ part_acc,
                      int* __restrict__ tickets, T* __restrict__ out, float* __restrict__ lse,
                      float* __restrict__ out32, int kv, int G, int N, int p, int d,
                      int n_split, float scale, float softcap) {
  constexpr int kVec = 16 / sizeof(T);             // elements per 16-byte vector
  constexpr int kVPL = sizeof(T) == 4 ? 2 : 1;     // vectors per lane (nv <= 32 * kVPL)
  extern __shared__ uint4 ring[];   // K stages | V stages; then the warps' sums, the weights
  __shared__ __align__(8) uint64_t bars[2 * kStages];   // full, then empty
  __shared__ float w_m[kWarps][kG], w_l[kWarps][kG];

  const int s = blockIdx.x, h = blockIdx.y, b = blockIdx.z;
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const size_t bh = (size_t)b * kv + h;
  const int n0 = (int)((long long)N * s / n_split), n1 = (int)((long long)N * (s + 1) / n_split);
  const int tok0 = n0 * p, n_tok = (n1 - n0) * p;
  const int row_bytes = d * (int)sizeof(T);
  const RowSplit rs(row_bytes);
  const int ch = rs.chunk, lpt = rs.lpt, tpw = rs.tpw, nv = rs.nv;
  const int n_ch = (n_tok + ch - 1) / ch;
  const char* kb = reinterpret_cast<const char*>(k + (bh * N * p + tok0) * d);
  const char* vb = reinterpret_cast<const char*>(v + (bh * N * p + tok0) * d);
  const int32_t* pb = pos + bh * N * p + tok0;
  const uint32_t ring0 = smem_addr(ring);
  const uint32_t full0 = smem_addr(bars), empty0 = full0 + 8 * kStages;

  auto issue = [&](int c) {                        // one thread: chunk c into stage c % kStages
    const int st = c % kStages;
    const int nt = min(ch, n_tok - c * ch);
    const uint32_t bytes = (uint32_t)(nt * row_bytes);
    mbar_expect_tx(full0 + 8 * st, 2 * bytes);
    bulk_load(ring0 + st * kStageBytes, kb + (size_t)c * ch * row_bytes, bytes, full0 + 8 * st);
    bulk_load(ring0 + (kStages + st) * kStageBytes, vb + (size_t)c * ch * row_bytes, bytes,
              full0 + 8 * st);
  };
  if (tid == 0) {
    for (int i = 0; i < kStages; ++i) {
      mbar_init(full0 + 8 * i, 1);
      mbar_init(empty0 + 8 * i, kWarps);
    }
    fence_barrier_init();
  }
  __syncthreads();
  if (tid == 0)
    for (int c = 0; c < min(kStages, n_ch); ++c) issue(c);

  // this lane's token in pass i of a chunk: i * kWarps * tpw + warp * tpw + lane / lpt,
  // and its vectors sub, sub + lpt, ...
  const int sub = lane % lpt;
  const int slot = warp * tpw + lane / lpt, stride = kWarps * tpw;
  float qr[kG][kVPL][kVec];
#pragma unroll
  for (int g = 0; g < kG; ++g)
#pragma unroll
    for (int j = 0; j < kVPL; ++j) {
      const int vi = sub + j * lpt;
      if (g < G && vi < nv) {
        to_floats(reinterpret_cast<const uint4*>(q + (bh * G + g) * d)[vi], qr[g][j], T());
      } else {
#pragma unroll
        for (int e = 0; e < kVec; ++e) qr[g][j][e] = 0.f;
      }
    }
  float acc[kG][kVPL][kVec];
#pragma unroll
  for (int g = 0; g < kG; ++g)
#pragma unroll
    for (int j = 0; j < kVPL; ++j)
#pragma unroll
      for (int e = 0; e < kVec; ++e) acc[g][j][e] = 0.f;
  float m[kG], l[kG];                              // l: this lane's tokens only
#pragma unroll
  for (int g = 0; g < kG; ++g) {
    m[g] = kNegInf;
    l[g] = 0.f;
  }
  const int cur_pos = cur[b];
  constexpr float kLog2e = 1.4426950408889634f;   // statistics in the log2 domain
  // positions one chunk ahead, so their loads overlap the chunk before
  int pos_next[kMaxPasses];
  auto load_pos = [&](int c) {
    const int nt = min(ch, n_tok - c * ch);
#pragma unroll
    for (int i = 0; i < kMaxPasses; ++i) {
      const int t = i * stride + slot;
      pos_next[i] = t < nt ? pb[c * ch + t] : -1;
    }
  };
  load_pos(0);

  for (int c = 0; c < n_ch; ++c) {
    const int st = c % kStages;
    const int nt = min(ch, n_tok - c * ch);
    int pos_c[kMaxPasses];
#pragma unroll
    for (int i = 0; i < kMaxPasses; ++i) pos_c[i] = pos_next[i];
    if (c + 1 < n_ch) load_pos(c + 1);
    const char* ks = reinterpret_cast<const char*>(ring) + st * kStageBytes;
    const char* vs = reinterpret_cast<const char*>(ring) + (kStages + st) * kStageBytes;
    mbar_wait(full0 + 8 * st, (c / kStages) & 1);

    // scores of this lane's tokens, masked
    float sc[kMaxPasses][kG];
#pragma unroll
    for (int i = 0; i < kMaxPasses; ++i) {
      const int t = i * stride + slot;
      const bool live = i * stride < nt;           // warp-uniform: the shuffles below run
#pragma unroll
      for (int g = 0; g < kG; ++g) sc[i][g] = 0.f;
      if (live) {
#pragma unroll
        for (int j = 0; j < kVPL; ++j) {
          const int vi = sub + j * lpt;
          if (t < nt && vi < nv) {
            float kf[kVec];
            to_floats(*reinterpret_cast<const uint4*>(ks + t * row_bytes + vi * 16), kf, T());
#pragma unroll
            for (int g = 0; g < kG; ++g)
#pragma unroll
              for (int e = 0; e < kVec; ++e) sc[i][g] = fmaf(qr[g][j][e], kf[e], sc[i][g]);
          }
        }
        for (int off = lpt >> 1; off > 0; off >>= 1)
#pragma unroll
          for (int g = 0; g < kG; ++g) sc[i][g] += __shfl_xor_sync(0xffffffffu, sc[i][g], off);
      }
      const bool ok = t < nt && pos_c[i] >= 0 && pos_c[i] <= cur_pos;
#pragma unroll
      for (int g = 0; g < kG; ++g) {
        float x = sc[i][g] * scale;
        if (softcap > 0.f) x = softcap * tanhf(x / softcap);
        sc[i][g] = ok ? x * kLog2e : kNegInf;
      }
    }
    // online softmax over the chunk: the max across this warp's tokens
    float alpha[kG];
#pragma unroll
    for (int g = 0; g < kG; ++g) {
      float mx = sc[0][g];
#pragma unroll
      for (int i = 1; i < kMaxPasses; ++i) mx = fmaxf(mx, sc[i][g]);
      for (int off = lpt; off < 32; off <<= 1) mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, off));
      const float m_new = fmaxf(m[g], mx);
      alpha[g] = fast_exp2(m[g] - m_new);
      m[g] = m_new;
      l[g] *= alpha[g];
#pragma unroll
      for (int j = 0; j < kVPL; ++j)
#pragma unroll
        for (int e = 0; e < kVec; ++e) acc[g][j][e] *= alpha[g];
    }
    // acc += P @ V over this lane's tokens and vectors
#pragma unroll
    for (int i = 0; i < kMaxPasses; ++i) {
      const int t = i * stride + slot;
      if (t < nt) {
        float pg[kG];
#pragma unroll
        for (int g = 0; g < kG; ++g) {
          pg[g] = fast_exp2(sc[i][g] - m[g]);
          l[g] += pg[g];
        }
#pragma unroll
        for (int j = 0; j < kVPL; ++j) {
          const int vi = sub + j * lpt;
          if (vi < nv) {
            float vf[kVec];
            to_floats(*reinterpret_cast<const uint4*>(vs + t * row_bytes + vi * 16), vf, T());
#pragma unroll
            for (int g = 0; g < kG; ++g)
#pragma unroll
              for (int e = 0; e < kVec; ++e) acc[g][j][e] = fmaf(pg[g], vf[e], acc[g][j][e]);
          }
        }
      }
    }
    // release the stage; thread 0 refills it once all four warps have
    __syncwarp();
    if (lane == 0) mbar_arrive(empty0 + 8 * st);
    if (tid == 0 && c + kStages < n_ch) {
      mbar_wait(empty0 + 8 * st, (c / kStages) & 1);
      fence_proxy_async();
      issue(c + kStages);
    }
  }

  // this warp's sums across its token lanes, then the four warps merged
  for (int off = lpt; off < 32; off <<= 1)
#pragma unroll
    for (int g = 0; g < kG; ++g) {
      l[g] += __shfl_xor_sync(0xffffffffu, l[g], off);
#pragma unroll
      for (int j = 0; j < kVPL; ++j)
#pragma unroll
        for (int e = 0; e < kVec; ++e)
          acc[g][j][e] += __shfl_xor_sync(0xffffffffu, acc[g][j][e], off);
    }
  __syncthreads();                                 // every warp is done with the ring
  float* w_acc = reinterpret_cast<float*>(ring);   // (kWarps, G, d)
  if (lane < lpt) {
#pragma unroll
    for (int g = 0; g < kG; ++g) {
      if (g < G) {
#pragma unroll
        for (int j = 0; j < kVPL; ++j) {
          const int vi = sub + j * lpt;
          if (vi < nv)
#pragma unroll
            for (int e = 0; e < kVec; ++e)
              w_acc[(warp * G + g) * d + vi * kVec + e] = acc[g][j][e];
        }
      }
    }
  }
  if (lane == 0) {
#pragma unroll
    for (int g = 0; g < kG; ++g) {
      w_m[warp][g] = m[g];
      w_l[warp][g] = l[g];
    }
  }
  __syncthreads();
  const size_t base = bh * n_split + s;
  for (int e = tid; e < G * d; e += kThreads) {
    const int g = e / d, col = e % d;
    float M = kNegInf;
#pragma unroll
    for (int w = 0; w < kWarps; ++w) M = fmaxf(M, w_m[w][g]);
    float L = 0.f, o = 0.f;
#pragma unroll
    for (int w = 0; w < kWarps; ++w) {
      const float wt = fast_exp2(w_m[w][g] - M);
      L += w_l[w][g] * wt;
      o += w_acc[(w * G + g) * d + col] * wt;
    }
    part_acc[(base * G + g) * d + col] = o;
    if (col == 0) {
      part_m[base * G + g] = M;
      part_l[base * G + g] = L;
    }
  }

  // the last slice of (b, kv) to finish merges all of them (log-sum-exp):
  // a ticket per (b, kv), taken after this block's partials are visible
  __shared__ int last;
  __threadfence();
  __syncthreads();
  if (tid == 0) last = atomicAdd(tickets + bh, 1) == n_split - 1;
  __syncthreads();
  if (!last) return;
  __threadfence();
  float* w_s = reinterpret_cast<float*>(ring);     // (n_split, G) slice weights
  for (int g = warp; g < G; g += kWarps) {
    float M = kNegInf;
    for (int j = lane; j < n_split; j += 32) M = fmaxf(M, __ldcg(part_m + (bh * n_split + j) * G + g));
    M = warp_max(M);
    float L = 0.f;
    for (int j = lane; j < n_split; j += 32) {
      const size_t row = (bh * n_split + j) * G + g;
      const float w = fast_exp2(__ldcg(part_m + row) - M);
      w_s[j * G + g] = w;
      L += __ldcg(part_l + row) * w;
    }
    L = fmaxf(warp_sum(L), 1e-30f);
    if (lse != nullptr && lane == 0) lse[bh * G + g] = (M + log2f(L)) * 0.6931471805599453f;
    __syncwarp();
    for (int j = lane; j < n_split; j += 32) w_s[j * G + g] /= L;
  }
  __syncthreads();
  for (int e = tid; e < G * d; e += kThreads) {
    const int g = e / d, col = e % d;
    float o = 0.f;
    for (int j = 0; j < n_split; ++j)
      o += __ldcg(part_acc + ((bh * n_split + j) * G + g) * d + col) * w_s[j * G + g];
    if (out32 != nullptr)
      out32[bh * G * d + e] = o;
    else
      out[bh * G * d + e] = from_f32<T>(o);
  }
  if (tid == 0) tickets[bh] = 0;                  // ready for the next launch
}
template <typename T, int kG>
cudaError_t launch_split(const void* q, const void* k, const void* v, const void* pos,
                         const void* cur, void* part_m, void* part_l, void* part_acc,
                         void* tickets, void* out, void* lse, void* out32, int B, int kv,
                         int G, int N, int p, int d, int n_split, float scale, float softcap,
                         int device, cudaStream_t stream) {
  // the ring, or the warps' sums and the merge weights where those are larger
  const size_t smem = std::max({kRingBytes, sizeof(float) * kWarps * G * d,
                                sizeof(float) * n_split * G});
  const cudaError_t err = allow_smem<paged_attention_split<T, kG>>(smem, device);
  if (err != cudaSuccess) return err;
  paged_attention_split<T, kG><<<dim3(n_split, kv, B), kThreads, smem, stream>>>(
      static_cast<const T*>(q), static_cast<const T*>(k), static_cast<const T*>(v),
      static_cast<const int32_t*>(pos), static_cast<const int32_t*>(cur),
      static_cast<float*>(part_m), static_cast<float*>(part_l), static_cast<float*>(part_acc),
      static_cast<int*>(tickets), static_cast<T*>(out), static_cast<float*>(lse),
      static_cast<float*>(out32), kv, G, N, p, d, n_split, scale, softcap);
  return cudaGetLastError();
}

template <typename T>
cudaError_t launch(const void* q, const void* k, const void* v, const void* pos,
                   const void* cur, void* part_m, void* part_l, void* part_acc, void* tickets,
                   void* out, void* lse, void* out32, int B, int kv, int G, int N, int p, int d,
                   int n_split, float scale, float softcap, int device, cudaStream_t stream) {
  if (G <= 4)
    return launch_split<T, 4>(q, k, v, pos, cur, part_m, part_l, part_acc, tickets, out, lse,
                              out32, B, kv, G, N, p, d, n_split, scale, softcap, device, stream);
  if (G <= 8)
    return launch_split<T, 8>(q, k, v, pos, cur, part_m, part_l, part_acc, tickets, out, lse,
                              out32, B, kv, G, N, p, d, n_split, scale, softcap, device, stream);
  return launch_split<T, 16>(q, k, v, pos, cur, part_m, part_l, part_acc, tickets, out, lse,
                             out32, B, kv, G, N, p, d, n_split, scale, softcap, device, stream);
}

}  // namespace
}  // namespace freekv

// Partials: part_m / part_l (B, kv, n_split, G) and part_acc
// (B, kv, n_split, G, d), fp32, allocated by the caller; split s takes pages
// [N * s / n_split, N * (s + 1) / n_split). tickets: B * kv int32 zeros,
// which the launch leaves zero again (so one buffer serves every launch on
// a stream). softcap <= 0 means no softcap. lse (B, kv, G) fp32 or null:
// each row's log-sum-exp, natural log. out32 (B, kv, G, d) fp32 or null:
// the output in fp32, written instead of out. Returns the launch's error.
extern "C" int freekv_paged_attention(const void* q, const void* k, const void* v,
                                      const void* pos, const void* cur, void* part_m,
                                      void* part_l, void* part_acc, void* tickets, void* out,
                                      void* lse, void* out32, int B, int kv, int G, int N, int p,
                                      int d, int n_split, float scale, float softcap, int dtype,
                                      int device, void* stream) {
  using namespace freekv;
  const int elem = dtype == kBFloat16 ? 2 : 4;
  if (G < 1 || G > kMaxG || d < 1 || d > kMaxD || (d * elem) % 16 || p < 1 || p > kMaxP ||
      N < 1 || (reinterpret_cast<uintptr_t>(q) | reinterpret_cast<uintptr_t>(k) |
                reinterpret_cast<uintptr_t>(v)) % 16 ||
      n_split < 1 || n_split > kMaxSplit || n_split > N)
    return cudaErrorInvalidValue;
  const DeviceGuard guard(device);
  if (guard.error() != cudaSuccess) return guard.error();
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (dtype == kFloat32)
    return launch<float>(q, k, v, pos, cur, part_m, part_l, part_acc, tickets, out, lse, out32,
                         B, kv, G, N, p, d, n_split, scale, softcap, device, st);
  if (dtype == kBFloat16)
    return launch<__nv_bfloat16>(q, k, v, pos, cur, part_m, part_l, part_acc, tickets, out, lse,
                                 out32, B, kv, G, N, p, d, n_split, scale, softcap, device, st);
  return cudaErrorInvalidValue;
}
