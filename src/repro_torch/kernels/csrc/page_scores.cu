// Quest min-max page scoring for speculative page selection, and the same
// bound against the centroid retriever's cluster boxes.
//
// Replaces the Pallas TPU kernel repro/kernels/page_scores.py, function
// page_scores (body _kernel):
//   score[b, h, g, n] = scale * sum_d max(q[b,h,g,d] * lo[b,n,h,d],
//                                         q[b,h,g,d] * hi[b,n,h,d])
// which equals relu(q) . hi + min(q, 0) . lo because lo <= hi.
// freekv_centroid_scores replaces repro/kernels/centroid_scores.py, function
// centroid_scores (body _kernel): the same bound against the C cluster
// boxes (B, C, kv, 2, d), which share the summaries' layout, with a cluster
// of count[b, c, h] == 0 scoring exactly -1e30 (never -inf) so it cannot
// win a candidate slot. At C = 16 it is one tile per (b, kv head): ~0.3 MB,
// bound by its launch.
//
// What bounds it on an H100: bytes. The summaries (B, n_pages, kv, 2, d)
// are read once and each element feeds G multiply-max-adds, ~2 FLOP per
// byte. At the main path's shapes (B = 4, ~260 pages, kv = 8, d = 128,
// bf16) that is ~4.2 MB, ~1.3 us at 3.35 TB/s; the launch costs more.
//
// Design: one block per (b, kv head, tile of 32 pages); the G query rows
// sit in shared memory as fp32; one warp per page, lanes across d with
// coalesced loads of the lo and hi rows, fp32 accumulation of the
// coordinate-wise max (the form kernels/ref.page_scores_ref computes), a
// warp-shuffle reduction, and one fp32 store per (row, page).

#include "common.cuh"

namespace freekv {
namespace {

constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;
constexpr int kTilePages = 32;
constexpr int kMaxG = 16;
constexpr int kMaxD = 256;

template <typename T>
__global__ void __launch_bounds__(kThreads)
page_scores_kernel(const T* __restrict__ q, const T* __restrict__ summ,
                   const int32_t* __restrict__ count, float* __restrict__ out, int kv, int G,
                   int N, int d, float scale) {
  const int tile = blockIdx.x, h = blockIdx.y, b = blockIdx.z;
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  __shared__ float q_s[kMaxG * kMaxD];
  const size_t bh = (size_t)b * kv + h;
  const T* qb = q + bh * G * d;
  for (int e = tid; e < G * d; e += kThreads) q_s[e] = to_f32(qb[e]);
  __syncthreads();

  const int n_end = min(N, (tile + 1) * kTilePages);
  for (int n = tile * kTilePages + warp; n < n_end; n += kWarps) {
    // summ[b, n, h, 0|1, :]
    const T* lo = summ + (((size_t)b * N + n) * kv + h) * 2 * d;
    const T* hi = lo + d;
    float acc[kMaxG];
#pragma unroll
    for (int g = 0; g < kMaxG; ++g) acc[g] = 0.f;
    for (int c = lane; c < d; c += 32) {
      const float l = to_f32(lo[c]);
      const float u = to_f32(hi[c]);
#pragma unroll
      for (int g = 0; g < kMaxG; ++g) {
        if (g < G) {
          const float x = q_s[g * d + c];
          acc[g] += fmaxf(x * l, x * u);
        }
      }
    }
    // count (B, N, kv) masks empty clusters; null for page scores
    const bool empty = count != nullptr && count[((size_t)b * N + n) * kv + h] == 0;
#pragma unroll
    for (int g = 0; g < kMaxG; ++g) {
      if (g < G) {
        const float s = warp_sum(acc[g]);
        if (lane == 0) out[(bh * G + g) * N + n] = empty ? kNegInf : s * scale;
      }
    }
  }
}

}  // namespace
}  // namespace freekv

namespace freekv {
namespace {

int launch(const void* q, const void* summ, const void* count, void* out, int B, int kv, int G,
           int N, int d, float scale, int dtype, int device, void* stream) {
  if (G < 1 || G > kMaxG || d < 1 || d > kMaxD || N < 1) return cudaErrorInvalidValue;
  const DeviceGuard guard(device);
  if (guard.error() != cudaSuccess) return guard.error();
  const dim3 grid((N + kTilePages - 1) / kTilePages, kv, B);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const int32_t* cnt = static_cast<const int32_t*>(count);
  if (dtype == kFloat32)
    page_scores_kernel<float><<<grid, kThreads, 0, st>>>(
        static_cast<const float*>(q), static_cast<const float*>(summ), cnt,
        static_cast<float*>(out), kv, G, N, d, scale);
  else if (dtype == kBFloat16)
    page_scores_kernel<__nv_bfloat16><<<grid, kThreads, 0, st>>>(
        static_cast<const __nv_bfloat16*>(q), static_cast<const __nv_bfloat16*>(summ), cnt,
        static_cast<float*>(out), kv, G, N, d, scale);
  else
    return cudaErrorInvalidValue;
  return cudaGetLastError();
}

}  // namespace
}  // namespace freekv

// q (B, kv, G, d), summ (B, N, kv, 2, d) in the dtype given by `dtype`;
// out (B, kv, G, N) fp32, allocated by the caller. Returns cudaGetLastError().
extern "C" int freekv_page_scores(const void* q, const void* summ, void* out, int B, int kv,
                                  int G, int N, int d, float scale, int dtype, int device,
                                  void* stream) {
  return freekv::launch(q, summ, nullptr, out, B, kv, G, N, d, scale, dtype, device, stream);
}

// q (B, kv, G, d), cent (B, C, kv, 2, d) in the dtype given by `dtype`, count
// (B, C, kv) int32; out (B, kv, G, C) fp32. Returns cudaGetLastError().
extern "C" int freekv_centroid_scores(const void* q, const void* cent, const void* count,
                                      void* out, int B, int kv, int G, int C, int d,
                                      float scale, int dtype, int device, void* stream) {
  if (count == nullptr) return cudaErrorInvalidValue;
  return freekv::launch(q, cent, count, out, B, kv, G, C, d, scale, dtype, device, stream);
}
