// Gather of the selected K+V pages out of the packed int8 / int4 HND pool,
// dequantized on the way; and of their V halves only.
//
// Replaces the Pallas TPU kernel repro/kernels/recall_gather.py, function
// recall_gather_quant (body _quant_kernel: the packed page and its float32
// scales DMA'd through a 2-deep VMEM ring, dequantized on drain), with
// values_only False (freekv_recall_gather_quant) and True
// (freekv_recall_values_quant, ShadowKV on the quantized tier: only the V
// half of the packed page and the V half of its scales are read, and only v
// is written). Contract:
// pool (B, n_pages, kv, 2, p, d * bits / 8) int8, scales (B, n_pages, kv, 2,
// n_g) float32, idx (B, kv, n_sel) int32 -> k, v (B, kv, n_sel, p, d) in the
// output dtype. An idx < 0 lane reads nothing and writes zeros; ids >=
// n_pages are clamped as in the reference. Channel c of a half is scaled by
// scales[..., c / (d / n_g)]. int4 bytes hold channel j in the low nibble
// and channel j + d/2 in the high nibble; both are sign-extended with
// arithmetic shifts. Dequantization is int -> float32 * scale -> output
// dtype with one correctly rounded multiply (no reciprocal, no fused
// contraction), so the result equals the reference's dequant_block bit for
// bit; a bfloat16 output is the float32 product rounded once, to nearest
// even, as torch's cast does.
//
// What bounds it on an H100: bytes over the link the pool sits behind. With
// offload="host" the pool is pinned host memory read at its mapped device
// address, so every payload and scale byte crosses PCIe (~64 GB/s each
// way): at the main path's shape (4 x 8 x 56 pages, p = 32, d = 128) the
// int8 payload is ~14.7 MB, ~0.23 ms, and int4 ~7.3 MB, ~0.12 ms, when every
// lane is valid. The bf16 output (~29 MB) goes to device memory. The V-only
// entry moves half of each: int8 ~0.115 ms, int4 ~0.058 ms.
//
// Design: recall_gather.cu's, one block per (lane, kv head, request). The
// block first copies the page's 2 * n_g scales into shared memory with
// scalar loads (a page's scale row is only 8-byte aligned at n_g = 1, and
// its V scale, 4 bytes into that pair, only 4-byte aligned), then
// each thread takes 16-byte chunks of the packed (2, p, d * bits / 8) block,
// a 16-byte load each, and writes the 16 (int8) or 32 (int4) dequantized
// values as 16-byte stores.

#include "common.cuh"

namespace freekv {
namespace {

constexpr int kThreads = 256;
constexpr int kMaxGroups = 256;

template <typename T, int kN>
__device__ __forceinline__ void store_vals(T* dst, const float (&x)[kN]) {
  static_assert((kN * sizeof(T)) % 16 == 0, "whole 16-byte stores");
  constexpr int kPer = 16 / sizeof(T);
#pragma unroll
  for (int s = 0; s < kN / kPer; ++s) {
    uint4 raw;
    T* vals = reinterpret_cast<T*>(&raw);
#pragma unroll
    for (int j = 0; j < kPer; ++j) vals[j] = from_f32<T>(x[s * kPer + j]);
    reinterpret_cast<uint4*>(dst)[s] = raw;
  }
}

// kValuesOnly: only half 1 (V) is read and written; k_out is unused (null)
template <typename T, int kBits, bool kValuesOnly>
__global__ void __launch_bounds__(kThreads)
recall_gather_quant_kernel(const uint4* __restrict__ pool, const float* __restrict__ scales,
                           const int32_t* __restrict__ idx, T* __restrict__ k_out,
                           T* __restrict__ v_out, int n_pages, int kv, int n_sel, int p,
                           int d, int n_g) {
  __shared__ float sc[2 * kMaxGroups];
  const int lane = blockIdx.x, h = blockIdx.y, b = blockIdx.z;
  const size_t out_off = (((size_t)b * kv + h) * n_sel + lane) * p * d;
  const int dp = d * kBits / 8;                 // packed bytes per token row
  const int half_vec = p * dp / 16;             // 16-byte chunks per K or V half
  const int first = kValuesOnly ? 1 : 0;        // first half read and written
  const int page = idx[((size_t)b * kv + h) * n_sel + lane];
  if (page < 0) {
    const uint4 zero = make_uint4(0u, 0u, 0u, 0u);
    const int n = p * d * (int)sizeof(T) / 16;
    uint4* vd = reinterpret_cast<uint4*>(v_out + out_off);
    for (int i = threadIdx.x; i < n; i += kThreads) {
      if constexpr (!kValuesOnly) reinterpret_cast<uint4*>(k_out + out_off)[i] = zero;
      vd[i] = zero;
    }
    return;
  }
  const size_t blk = ((size_t)b * n_pages + min(page, n_pages - 1)) * kv + h;
  for (int i = first * n_g + threadIdx.x; i < 2 * n_g; i += kThreads)
    sc[i] = scales[blk * 2 * n_g + i];
  __syncthreads();
  const uint4* src = pool + blk * 2 * half_vec;
  const int g = d / n_g;
  for (int i = first * half_vec + threadIdx.x; i < 2 * half_vec; i += kThreads) {
    const int half = i / half_vec;
    const int byte0 = (i % half_vec) * 16;
    const int t = byte0 / dp, c0 = byte0 % dp;  // dp % 16 == 0: one token row per chunk
    const float* hs = sc + half * n_g;
    T* row = (half ? v_out : k_out) + out_off + (size_t)t * d;
    const uint4 raw = src[i];
    const int8_t* q = reinterpret_cast<const int8_t*>(&raw);
    if (kBits == 8) {
      float x[16];
#pragma unroll
      for (int j = 0; j < 16; ++j) x[j] = __fmul_rn((float)q[j], hs[(c0 + j) / g]);
      store_vals<T>(row + c0, x);
    } else {
      const int d2 = d / 2;
      float lo[16], hi[16];
#pragma unroll
      for (int j = 0; j < 16; ++j) {
        const int8_t byte = q[j];
        const int8_t l4 = (int8_t)(byte << 4) >> 4;
        const int8_t h4 = byte >> 4;
        lo[j] = __fmul_rn((float)l4, hs[(c0 + j) / g]);
        hi[j] = __fmul_rn((float)h4, hs[(c0 + d2 + j) / g]);
      }
      store_vals<T>(row + c0, lo);
      store_vals<T>(row + c0 + d2, hi);
    }
  }
}

template <typename T, bool kValuesOnly>
void launch(int bits, dim3 grid, cudaStream_t st, const void* pool, const void* scales,
            const void* idx, void* k_out, void* v_out, int n_pages, int kv, int n_sel,
            int p, int d, int n_g) {
  const uint4* pl = static_cast<const uint4*>(pool);
  const float* sc = static_cast<const float*>(scales);
  const int32_t* ix = static_cast<const int32_t*>(idx);
  if (bits == 8)
    recall_gather_quant_kernel<T, 8, kValuesOnly><<<grid, kThreads, 0, st>>>(
        pl, sc, ix, static_cast<T*>(k_out), static_cast<T*>(v_out), n_pages, kv, n_sel, p,
        d, n_g);
  else
    recall_gather_quant_kernel<T, 4, kValuesOnly><<<grid, kThreads, 0, st>>>(
        pl, sc, ix, static_cast<T*>(k_out), static_cast<T*>(v_out), n_pages, kv, n_sel, p,
        d, n_g);
}

template <bool kValuesOnly>
int launch_checked(const void* pool_dev, const void* scales_dev, const void* idx, void* k_out,
                   void* v_out, int B, int n_pages, int kv, int n_sel, int p, int d, int n_g,
                   int bits, int dtype, int device, void* stream) {
  if ((bits != 8 && bits != 4) || n_pages < 1 || n_sel < 1 || p < 1 || d < 2 ||
      (d * bits / 8) % 16 || n_g < 1 || n_g > kMaxGroups || d % n_g)
    return cudaErrorInvalidValue;
  if ((reinterpret_cast<uintptr_t>(pool_dev) | reinterpret_cast<uintptr_t>(k_out) |
       reinterpret_cast<uintptr_t>(v_out)) % 16)
    return cudaErrorMisalignedAddress;
  const DeviceGuard guard(device);
  if (guard.error() != cudaSuccess) return guard.error();
  const dim3 grid(n_sel, kv, B);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (dtype == kFloat32)
    launch<float, kValuesOnly>(bits, grid, st, pool_dev, scales_dev, idx, k_out, v_out,
                               n_pages, kv, n_sel, p, d, n_g);
  else if (dtype == kBFloat16)
    launch<__nv_bfloat16, kValuesOnly>(bits, grid, st, pool_dev, scales_dev, idx, k_out,
                                       v_out, n_pages, kv, n_sel, p, d, n_g);
  else
    return cudaErrorInvalidValue;
  return cudaGetLastError();
}

}  // namespace
}  // namespace freekv

// pool_dev and scales_dev must be dereferenceable on the device (see
// freekv_device_pointer in recall_gather.cu); bits 8 or 4; d * bits / 8 a
// multiple of 16; n_g divides d, at most 256; 16-byte aligned pool and
// outputs. Returns cudaGetLastError().
extern "C" int freekv_recall_gather_quant(const void* pool_dev, const void* scales_dev,
                                          const void* idx, void* k_out, void* v_out, int B,
                                          int n_pages, int kv, int n_sel, int p, int d,
                                          int n_g, int bits, int dtype, int device,
                                          void* stream) {
  return freekv::launch_checked<false>(pool_dev, scales_dev, idx, k_out, v_out, B, n_pages,
                                       kv, n_sel, p, d, n_g, bits, dtype, device, stream);
}

// The V halves only, into v_out (B, kv, n_sel, p, d); same requirements.
extern "C" int freekv_recall_values_quant(const void* pool_dev, const void* scales_dev,
                                          const void* idx, void* v_out, int B, int n_pages,
                                          int kv, int n_sel, int p, int d, int n_g, int bits,
                                          int dtype, int device, void* stream) {
  return freekv::launch_checked<true>(pool_dev, scales_dev, idx, nullptr, v_out, B, n_pages,
                                      kv, n_sel, p, d, n_g, bits, dtype, device, stream);
}
