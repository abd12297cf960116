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
// 3.35 TB/s.
//
// Design: the TPU kernel walks pages sequentially per (b, kv) grid cell and
// carries (m, l, acc) in VMEM scratch. On Hopper one block per (b, kv) is
// only 32 blocks on 132 SMs, so the page axis is split across blocks: pass 1
// (paged_attention_split) runs the online softmax over a contiguous slice of
// pages and writes fp32 partials (m, l, acc); pass 2 (paged_attention_merge)
// merges the slices with the log-sum-exp rule. The G query rows of a group
// stay in one block so each K/V element is loaded once for all G rows. A
// slice whose pages are all masked keeps m = -1e30 and drops out of the
// merge with weight exp(-1e30 - M) = 0. Accumulation is fp32 throughout.
// Each page of K and V is staged into shared memory as fp32 with
// independent 16-byte loads; scores are then one thread per (row, token)
// over a padded K tile, so no step waits on a chain of global loads. No
// tensor cores, no TMA, no double buffering: this is the simple first
// kernel; wgmma/TMA come later.

#include "common.cuh"

namespace freekv {
namespace {

constexpr int kThreads = 128;
constexpr int kWarps = kThreads / 32;
constexpr int kMaxG = 16;
constexpr int kMaxD = 256;
constexpr int kMaxP = 64;
constexpr int kDPerThread = kMaxD / kThreads;
constexpr int kMaxSplit = 256;   // merge weights: kMaxSplit * kMaxG floats of smem

// Copies one (p, d) page into shared memory as fp32 rows of `stride`
// floats, with 16-byte loads that are all independent, so one page costs
// about one memory latency. Needs d * sizeof(T) % 16 == 0.
template <typename T>
__device__ __forceinline__ void stage_page(const T* __restrict__ src, float* dst,
                                           int stride, int p, int d) {
  constexpr int kVec = 16 / sizeof(T);
  const int per_row = d / kVec;
  const uint4* src4 = reinterpret_cast<const uint4*>(src);
#pragma unroll 4
  for (int i = threadIdx.x; i < p * per_row; i += kThreads) {
    const int t = i / per_row, c0 = (i % per_row) * kVec;
    const uint4 raw = src4[i];
    const T* vals = reinterpret_cast<const T*>(&raw);
#pragma unroll
    for (int j = 0; j < kVec; ++j) dst[t * stride + c0 + j] = to_f32(vals[j]);
  }
}

template <typename T>
__global__ void __launch_bounds__(kThreads)
paged_attention_split(const T* __restrict__ q, const T* __restrict__ k,
                      const T* __restrict__ v, const int32_t* __restrict__ pos,
                      const int32_t* __restrict__ cur, float* __restrict__ part_m,
                      float* __restrict__ part_l, float* __restrict__ part_acc,
                      int kv, int G, int N, int p, int d, int pages_per_split,
                      int n_split, float scale, float softcap) {
  const int s = blockIdx.x, h = blockIdx.y, b = blockIdx.z;
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  // dynamic shared memory: q (G, d) | K page (p, d + 1) | V page (p, d) | scores (G, p)
  extern __shared__ float smem[];
  const int kst = d + 1;     // padded K rows: the 32 tokens a warp reads sit in 32 banks
  float* q_s = smem;
  float* k_s = q_s + G * d;
  float* v_s = k_s + p * kst;
  float* s_s = v_s + p * d;
  __shared__ float m_s[kMaxG], l_s[kMaxG], a_s[kMaxG];

  const size_t bh = (size_t)b * kv + h;
  const T* qb = q + bh * G * d;
  for (int e = tid; e < G * d; e += kThreads) q_s[e] = to_f32(qb[e]);
  if (tid < G) {
    m_s[tid] = kNegInf;
    l_s[tid] = 0.f;
  }
  float acc[kMaxG][kDPerThread];
#pragma unroll
  for (int g = 0; g < kMaxG; ++g)
#pragma unroll
    for (int j = 0; j < kDPerThread; ++j) acc[g][j] = 0.f;

  const int cur_pos = cur[b];
  const int n0 = s * pages_per_split;
  const int n1 = min(N, n0 + pages_per_split);

  for (int n = n0; n < n1; ++n) {
    const size_t page = bh * N + n;
    const int32_t* pp = pos + page * p;
    stage_page(k + page * p * d, k_s, kst, p, d);
    stage_page(v + page * p * d, v_s, d, p, d);
    __syncthreads();
    // scores: one thread per (query row, token), the d-reduction from shared memory
    for (int e = tid; e < G * p; e += kThreads) {
      const int g = e / p, t = e % p;
      const float* qr = q_s + g * d;
      const float* kr = k_s + t * kst;
      float dot = 0.f;
#pragma unroll 8
      for (int c = 0; c < d; ++c) dot += qr[c] * kr[c];
      float x = dot * scale;
      if (softcap > 0.f) x = softcap * tanhf(x / softcap);
      const int tp = pp[t];
      s_s[g * p + t] = (tp >= 0 && tp <= cur_pos) ? x : kNegInf;
    }
    __syncthreads();
    // online-softmax statistics: one warp per query row, lanes across tokens
    for (int g = warp; g < G; g += kWarps) {
      float mx = kNegInf;
      for (int t = lane; t < p; t += 32) mx = fmaxf(mx, s_s[g * p + t]);
      const float m_prev = m_s[g];
      const float m_new = fmaxf(m_prev, warp_max(mx));
      float sum = 0.f;
      for (int t = lane; t < p; t += 32) {
        const float e = expf(s_s[g * p + t] - m_new);
        s_s[g * p + t] = e;
        sum += e;
      }
      sum = warp_sum(sum);
      if (lane == 0) {
        const float alpha = expf(m_prev - m_new);
        l_s[g] = l_s[g] * alpha + sum;
        m_s[g] = m_new;
        a_s[g] = alpha;
      }
    }
    __syncthreads();
    // acc = acc * alpha + P @ V, threads across d, all G rows per thread
#pragma unroll
    for (int j = 0; j < kDPerThread; ++j) {
      const int c = tid + j * kThreads;
      if (c < d) {
        float pv[kMaxG];
#pragma unroll
        for (int g = 0; g < kMaxG; ++g) pv[g] = 0.f;
#pragma unroll 8
        for (int t = 0; t < p; ++t) {
          const float vv = v_s[t * d + c];
#pragma unroll
          for (int g = 0; g < kMaxG; ++g)
            if (g < G) pv[g] += s_s[g * p + t] * vv;
        }
#pragma unroll
        for (int g = 0; g < kMaxG; ++g)
          if (g < G) acc[g][j] = acc[g][j] * a_s[g] + pv[g];
      }
    }
    __syncthreads();
  }

  const size_t base = bh * n_split + s;
  if (tid < G) {
    part_m[base * G + tid] = m_s[tid];
    part_l[base * G + tid] = l_s[tid];
  }
#pragma unroll
  for (int j = 0; j < kDPerThread; ++j) {
    const int c = tid + j * kThreads;
    if (c < d) {
#pragma unroll
      for (int g = 0; g < kMaxG; ++g)
        if (g < G) part_acc[(base * G + g) * d + c] = acc[g][j];
    }
  }
}

// Log-sum-exp merge of the slices: one warp per query row computes the
// slice weights exp(m_s - M) / L into shared memory (lanes across slices),
// then every thread sums its output elements over the slices.
template <typename T>
__global__ void __launch_bounds__(kThreads)
paged_attention_merge(const float* __restrict__ part_m, const float* __restrict__ part_l,
                      const float* __restrict__ part_acc, T* __restrict__ out,
                      int G, int d, int n_split) {
  extern __shared__ float w_s[];                     // (n_split, G)
  const size_t bh = blockIdx.x;
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  for (int g = warp; g < G; g += kWarps) {
    float M = kNegInf;
    for (int s = lane; s < n_split; s += 32) M = fmaxf(M, part_m[(bh * n_split + s) * G + g]);
    M = warp_max(M);
    float L = 0.f;
    for (int s = lane; s < n_split; s += 32) {
      const size_t row = (bh * n_split + s) * G + g;
      const float w = expf(part_m[row] - M);
      w_s[s * G + g] = w;
      L += part_l[row] * w;
    }
    L = fmaxf(warp_sum(L), 1e-30f);
    __syncwarp();
    for (int s = lane; s < n_split; s += 32) w_s[s * G + g] /= L;
  }
  __syncthreads();
  for (int e = threadIdx.x; e < G * d; e += kThreads) {
    const int g = e / d, c = e % d;
    float O = 0.f;
#pragma unroll 8
    for (int s = 0; s < n_split; ++s)
      O += part_acc[((bh * n_split + s) * G + g) * d + c] * w_s[s * G + g];
    out[bh * G * d + e] = from_f32<T>(O);
  }
}

template <typename T>
void launch(const void* q, const void* k, const void* v, const void* pos, const void* cur,
            void* part_m, void* part_l, void* part_acc, void* out, int B, int kv, int G,
            int N, int p, int d, int pages_per_split, int n_split, float scale,
            float softcap, cudaStream_t stream) {
  const size_t smem = sizeof(float) * ((size_t)G * d + (size_t)p * (d + 1) +
                                       (size_t)p * d + (size_t)G * p);
  if (smem > 48 * 1024)
    cudaFuncSetAttribute(paged_attention_split<T>,
                         cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  paged_attention_split<T><<<dim3(n_split, kv, B), kThreads, smem, stream>>>(
      static_cast<const T*>(q), static_cast<const T*>(k), static_cast<const T*>(v),
      static_cast<const int32_t*>(pos), static_cast<const int32_t*>(cur),
      static_cast<float*>(part_m), static_cast<float*>(part_l),
      static_cast<float*>(part_acc), kv, G, N, p, d, pages_per_split, n_split, scale,
      softcap);
  paged_attention_merge<T><<<B * kv, kThreads, n_split * G * sizeof(float), stream>>>(
      static_cast<const float*>(part_m), static_cast<const float*>(part_l),
      static_cast<const float*>(part_acc), static_cast<T*>(out), G, d, n_split);
}

}  // namespace
}  // namespace freekv

// Partials: part_m / part_l (B, kv, n_split, G) and part_acc
// (B, kv, n_split, G, d), fp32, allocated by the caller. softcap <= 0 means
// no softcap. Returns cudaGetLastError() after the launches.
extern "C" int freekv_paged_attention(const void* q, const void* k, const void* v,
                                      const void* pos, const void* cur, void* part_m,
                                      void* part_l, void* part_acc, void* out, int B,
                                      int kv, int G, int N, int p, int d,
                                      int pages_per_split, int n_split, float scale,
                                      float softcap, int dtype, int device,
                                      void* stream) {
  using namespace freekv;
  const int elem = dtype == kBFloat16 ? 2 : 4;
  if (G < 1 || G > kMaxG || d < 1 || d > kMaxD || (d * elem) % 16 || p < 1 || p > kMaxP ||
      N < 1 || (reinterpret_cast<uintptr_t>(k) | reinterpret_cast<uintptr_t>(v)) % 16 ||
      n_split < 1 || n_split > kMaxSplit || pages_per_split < 1 ||
      (long long)pages_per_split * n_split < N)
    return cudaErrorInvalidValue;
  const DeviceGuard guard(device);
  if (guard.error() != cudaSuccess) return guard.error();
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (dtype == kFloat32)
    launch<float>(q, k, v, pos, cur, part_m, part_l, part_acc, out, B, kv, G, N, p, d,
                  pages_per_split, n_split, scale, softcap, st);
  else if (dtype == kBFloat16)
    launch<__nv_bfloat16>(q, k, v, pos, cur, part_m, part_l, part_acc, out, B, kv, G, N,
                          p, d, pages_per_split, n_split, scale, softcap, st);
  else
    return cudaErrorInvalidValue;
  return cudaGetLastError();
}
