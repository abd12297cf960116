// Per-page min/max summaries of post-RoPE keys.
//
// Replaces the Pallas TPU kernel repro/kernels/page_summary.py, function
// page_summary (body _kernel: one grid step reduces one (p, d) key page of
// one KV head to its (2, d) bounding box). Contract: k (B, T, kv, d), T a
// whole number of pages of p tokens -> out (B, T/p, kv, 2, d) in k's dtype,
// out[..., 0, :] the minimum and out[..., 1, :] the maximum over the page's
// p tokens. Exact: min and max of float32 (or of bfloat16 widened exactly to
// float32 and narrowed back) round nothing.
//
// What bounds it on an H100: bytes. Each key is read once and the summary
// is 2/p of that: at the main path's prefill (B = 4, T = 8192, kv = 8,
// d = 128, bf16) ~67 MB in and ~2 MB out, ~20 us at 3.35 TB/s; a decode
// step's completed page is a few KiB.
//
// Design: one block per (page, request). The p token rows of a page are
// contiguous (kv * d elements each, token-major NHD layout), so each thread
// owns one 16-byte column chunk of the row (8 bf16 or 4 fp32 channels of
// one KV head) and walks the p tokens with independent 16-byte loads,
// keeping the running min and max in registers; the chunk's min and max go
// out as two 16-byte stores. The TPU kernel's grid over KV heads is folded
// into the row: one block covers every head of the page. The batch stride is
// a parameter, so a prefix of a longer prompt (the whole pages of a prefill)
// is read in place.

#include "common.cuh"

namespace freekv {
namespace {

constexpr int kMaxThreads = 256;

template <typename T>
__global__ void __launch_bounds__(kMaxThreads)
page_summary_kernel(const T* __restrict__ k, T* __restrict__ out, int n_pages, int p,
                    int kv, int d, long long batch_stride) {
  constexpr int kVec = 16 / sizeof(T);
  const int n = blockIdx.x, b = blockIdx.y;
  const int row = kv * d;                       // elements per token
  const int nvec = row / kVec;
  const uint4* src = reinterpret_cast<const uint4*>(k + b * batch_stride + (size_t)n * p * row);
  for (int i = threadIdx.x; i < nvec; i += blockDim.x) {
    float lo[kVec], hi[kVec];
    {
      const uint4 raw = src[i];
      const T* vals = reinterpret_cast<const T*>(&raw);
#pragma unroll
      for (int j = 0; j < kVec; ++j) lo[j] = hi[j] = to_f32(vals[j]);
    }
#pragma unroll 4
    for (int t = 1; t < p; ++t) {
      const uint4 raw = src[(size_t)t * nvec + i];
      const T* vals = reinterpret_cast<const T*>(&raw);
#pragma unroll
      for (int j = 0; j < kVec; ++j) {
        const float x = to_f32(vals[j]);
        lo[j] = fminf(lo[j], x);
        hi[j] = fmaxf(hi[j], x);
      }
    }
    // the chunk's channels c0 .. c0 + kVec - 1 of head h (d % kVec == 0)
    const int e = i * kVec, h = e / d, c0 = e % d;
    T* dst = out + (((size_t)b * n_pages + n) * kv + h) * 2 * d + c0;
    uint4 lo_raw, hi_raw;
    T* lo_out = reinterpret_cast<T*>(&lo_raw);
    T* hi_out = reinterpret_cast<T*>(&hi_raw);
#pragma unroll
    for (int j = 0; j < kVec; ++j) {
      lo_out[j] = from_f32<T>(lo[j]);
      hi_out[j] = from_f32<T>(hi[j]);
    }
    *reinterpret_cast<uint4*>(dst) = lo_raw;
    *reinterpret_cast<uint4*>(dst + d) = hi_raw;
  }
}

}  // namespace
}  // namespace freekv

// k: B rows of n_pages * p tokens of kv * d elements, rows batch_stride
// elements apart; out (B, n_pages, kv, 2, d) contiguous. Needs d * itemsize
// % 16 == 0, batch_stride * itemsize % 16 == 0 and 16-byte aligned
// pointers. Returns cudaGetLastError().
extern "C" int freekv_page_summary(const void* k, void* out, int B, int n_pages, int p,
                                   int kv, int d, long long batch_stride, int dtype,
                                   int device, void* stream) {
  using namespace freekv;
  const int elem = dtype == kBFloat16 ? 2 : 4;
  if (B < 1 || n_pages < 1 || p < 1 || kv < 1 || d < 1 || (d * elem) % 16 ||
      (batch_stride * elem) % 16 ||
      (reinterpret_cast<uintptr_t>(k) | reinterpret_cast<uintptr_t>(out)) % 16)
    return cudaErrorInvalidValue;
  const DeviceGuard guard(device);
  if (guard.error() != cudaSuccess) return guard.error();
  const int nvec = kv * d * elem / 16;
  const int threads = nvec >= kMaxThreads ? kMaxThreads : ((nvec + 31) / 32) * 32;
  const dim3 grid(n_pages, B);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (dtype == kFloat32)
    page_summary_kernel<float><<<grid, threads, 0, st>>>(
        static_cast<const float*>(k), static_cast<float*>(out), n_pages, p, kv, d,
        batch_stride);
  else if (dtype == kBFloat16)
    page_summary_kernel<__nv_bfloat16><<<grid, threads, 0, st>>>(
        static_cast<const __nv_bfloat16*>(k), static_cast<__nv_bfloat16*>(out), n_pages, p,
        kv, d, batch_stride);
  else
    return cudaErrorInvalidValue;
  return cudaGetLastError();
}
