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
// address, so every payload and scale byte crosses PCIe (64 GB/s each way
// on the data sheet): at the main path's shape (4 x 8 x 56 pages, p = 32,
// d = 128) the int8 payload is ~14.7 MB, ~0.23 ms, and int4 ~7.3 MB, ~0.12
// ms, when every lane is valid; the V-only entry moves half of each. The
// bf16 output (~29 MB) goes to device memory. The link's measured ceiling,
// one contiguous copy_ of the same bytes from pinned memory (timed beside
// each gather by chip_smoke.py), took 0.27-0.38 ms for the int8 payload on
// the H100s measured (PERF.md).
//
// Design: recall_gather.cu's persistent grid of walking warps (same grid
// rule and SM cap, -1 items' zeros written as they are met, same .nc safety
// argument: nothing writes the pool while a gather reads it; a unit is one
// K or V half of an item). A warp takes one valid half at a time: it issues
// the half's payload loads (kLoads 16-byte loads in flight per thread: an
// int8 half page at p = 32, d = 128) and, in the same breath, the half's
// n_g scales as 4-byte cp.async copies straight into the warp's own slice
// of shared memory (a scale row is only 8-byte aligned at n_g = 1 and its V
// half only 4-byte aligned, so no wider or bulk copy takes them), so
// payload and scales share one PCIe round trip and the scales hold no
// register. Each 16-byte payload chunk then becomes 16 (int8) or 32 (int4)
// values written as 16-byte stores, its scale index found with one divide a
// chunk, not one a value.

#include "common.cuh"

namespace freekv {
namespace {

constexpr int kThreads = 256;  // eight warps, each walking its own units
constexpr int kWarps = kThreads / 32;
constexpr int kLoads = 8;      // 16-byte payload loads in flight per thread (4 KiB a warp)
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

// the scales of the 16 channels c .. c + 15: s[j] = hs[(c + j) / g], with
// one divide for all sixteen
__device__ __forceinline__ void chunk_scales(const float* hs, int c, int g, float (&s)[16]) {
  int gi = c / g, next = (gi + 1) * g;
#pragma unroll
  for (int j = 0; j < 16; ++j) {
    if (c + j == next) {
      ++gi;
      next += g;
    }
    s[j] = hs[gi];
  }
}

// kValuesOnly: only half 1 (V) is read and written; k_out is unused (null)
template <typename T, int kBits, bool kValuesOnly>
__global__ void __launch_bounds__(kThreads, 2)
recall_gather_quant_kernel(const uint4* __restrict__ pool, const float* __restrict__ scales,
                           const int32_t* __restrict__ idx, T* __restrict__ k_out,
                           T* __restrict__ v_out, int n_pages, int kv, int n_sel,
                           int n_items, int p, int d, int n_g) {
  constexpr int kHalves = kValuesOnly ? 1 : 2;
  __shared__ float sc_all[kWarps][kMaxGroups];
  float* sc = sc_all[threadIdx.x >> 5];            // this warp's half-page scales
  const int lane = threadIdx.x & 31;
  const int row_vec = d * kBits / 128;             // 16-byte chunks per packed token row
  const int half_vec = p * row_vec;                // 16-byte chunks per K or V half
  const int g = d / n_g;
  const int d2 = d / 2;
  walk_items<kHalves>(idx, n_items, [&](int unit, int page) {
    const int item = unit / kHalves;
    const int half = kValuesOnly ? 1 : unit % 2;   // 0: K, 1: V
    T* out = (half ? v_out : k_out) + (size_t)item * p * d;
    if (page < 0) {
      const int n = p * d * (int)sizeof(T) / 16;
      for (int i = lane; i < n; i += 32)
        reinterpret_cast<uint4*>(out)[i] = make_uint4(0u, 0u, 0u, 0u);
      return;
    }
    const int bh = item / n_sel;                   // b * kv + h
    const size_t blk = ((size_t)(bh / kv) * n_pages + min(page, n_pages - 1)) * kv + bh % kv;
    const uint4* src = pool + (2 * blk + half) * half_vec;
    const float* srow = scales + (2 * blk + half) * n_g;
    __syncwarp();                                  // the warp's last page is done with sc
    for (int c = lane; c < n_g; c += 32) cp_async_4(sc + c, srow + c);
    for (int base = 0; base < half_vec; base += 32 * kLoads) {
      uint4 r[kLoads];
#pragma unroll
      for (int u = 0; u < kLoads; ++u) {
        const int i = base + 32 * u + lane;
        if (i < half_vec) r[u] = ld_stream(src + i);
      }
      if (base == 0) {                             // the scales rode with the first loads
        cp_async_wait_all();
        __syncwarp();
      }
#pragma unroll
      for (int u = 0; u < kLoads; ++u) {
        const int i = base + 32 * u + lane;
        if (i >= half_vec) continue;
        const int t = i / row_vec, c0 = (i - t * row_vec) * 16;
        T* row = out + (size_t)t * d;
        const int8_t* q = reinterpret_cast<const int8_t*>(&r[u]);
        float s[16], x[16];
        chunk_scales(sc, c0, g, s);
        if constexpr (kBits == 8) {
#pragma unroll
          for (int j = 0; j < 16; ++j) x[j] = __fmul_rn((float)q[j], s[j]);
          store_vals<T>(row + c0, x);
        } else {                                   // low nibbles: channels c0 + j
#pragma unroll
          for (int j = 0; j < 16; ++j)
            x[j] = __fmul_rn((float)((int8_t)(q[j] << 4) >> 4), s[j]);
          store_vals<T>(row + c0, x);
          chunk_scales(sc, c0 + d2, g, s);         // high nibbles: channels c0 + d/2 + j
#pragma unroll
          for (int j = 0; j < 16; ++j) x[j] = __fmul_rn((float)(q[j] >> 4), s[j]);
          store_vals<T>(row + c0 + d2, x);
        }
      }
    }
  });
}

template <typename T, bool kValuesOnly>
void launch(int bits, int n_blocks, cudaStream_t st, const void* pool, const void* scales,
            const void* idx, void* k_out, void* v_out, int n_pages, int kv, int n_sel,
            int n_items, int p, int d, int n_g) {
  const uint4* pl = static_cast<const uint4*>(pool);
  const float* sc = static_cast<const float*>(scales);
  const int32_t* ix = static_cast<const int32_t*>(idx);
  if (bits == 8)
    recall_gather_quant_kernel<T, 8, kValuesOnly><<<n_blocks, kThreads, 0, st>>>(
        pl, sc, ix, static_cast<T*>(k_out), static_cast<T*>(v_out), n_pages, kv, n_sel,
        n_items, p, d, n_g);
  else
    recall_gather_quant_kernel<T, 4, kValuesOnly><<<n_blocks, kThreads, 0, st>>>(
        pl, sc, ix, static_cast<T*>(k_out), static_cast<T*>(v_out), n_pages, kv, n_sel,
        n_items, p, d, n_g);
}

template <bool kValuesOnly>
int launch_checked(const void* pool_dev, const void* scales_dev, const void* idx, void* k_out,
                   void* v_out, int B, int n_pages, int kv, int n_sel, int p, int d, int n_g,
                   int bits, int dtype, int n_blocks, int device, void* stream) {
  if ((bits != 8 && bits != 4) || n_pages < 1 || n_sel < 1 || p < 1 || d < 2 ||
      (d * bits / 8) % 16 || n_g < 1 || n_g > kMaxGroups || d % n_g || n_blocks < 1)
    return cudaErrorInvalidValue;
  if ((reinterpret_cast<uintptr_t>(pool_dev) | reinterpret_cast<uintptr_t>(k_out) |
       reinterpret_cast<uintptr_t>(v_out)) % 16)
    return cudaErrorMisalignedAddress;
  const DeviceGuard guard(device);
  if (guard.error() != cudaSuccess) return guard.error();
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const int n_items = B * kv * n_sel;
  if (dtype == kFloat32)
    launch<float, kValuesOnly>(bits, n_blocks, st, pool_dev, scales_dev, idx, k_out,
                               v_out, n_pages, kv, n_sel, n_items, p, d, n_g);
  else if (dtype == kBFloat16)
    launch<__nv_bfloat16, kValuesOnly>(bits, n_blocks, st, pool_dev, scales_dev, idx, k_out,
                                       v_out, n_pages, kv, n_sel, n_items, p, d, n_g);
  else
    return cudaErrorInvalidValue;
  return cudaGetLastError();
}

template <typename T, int kBits>
cudaError_t min_blocks(int* out) {
  int a = 0, b = 0;
  cudaError_t err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(
      &a, recall_gather_quant_kernel<T, kBits, false>, kThreads, 0);
  if (err == cudaSuccess)
    err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(
        &b, recall_gather_quant_kernel<T, kBits, true>, kThreads, 0);
  if (a < *out) *out = a;
  if (b < *out) *out = b;
  return err;
}

}  // namespace
}  // namespace freekv

// pool_dev and scales_dev must be dereferenceable on the device (see
// freekv_device_pointer in recall_gather.cu); bits 8 or 4; d * bits / 8 a
// multiple of 16; n_g divides d, at most 256; 16-byte aligned pool and
// outputs; n_blocks from ops.gather_grid. Returns cudaGetLastError().
extern "C" int freekv_recall_gather_quant(const void* pool_dev, const void* scales_dev,
                                          const void* idx, void* k_out, void* v_out, int B,
                                          int n_pages, int kv, int n_sel, int p, int d,
                                          int n_g, int bits, int dtype, int n_blocks,
                                          int device, void* stream) {
  return freekv::launch_checked<false>(pool_dev, scales_dev, idx, k_out, v_out, B, n_pages,
                                       kv, n_sel, p, d, n_g, bits, dtype, n_blocks, device,
                                       stream);
}

// The V halves only, into v_out (B, kv, n_sel, p, d); same requirements.
extern "C" int freekv_recall_values_quant(const void* pool_dev, const void* scales_dev,
                                          const void* idx, void* v_out, int B, int n_pages,
                                          int kv, int n_sel, int p, int d, int n_g, int bits,
                                          int dtype, int n_blocks, int device,
                                          void* stream) {
  return freekv::launch_checked<true>(pool_dev, scales_dev, idx, nullptr, v_out, B, n_pages,
                                      kv, n_sel, p, d, n_g, bits, dtype, n_blocks, device,
                                      stream);
}

// The blocks an SM holds at once of any of the gathers above, by registers
// and shared memory (the least over output dtypes, bits and V-only), into
// *out; ops.gather_grid sizes the grid from it.
extern "C" int freekv_recall_gather_quant_blocks_per_sm(int device, int* out) {
  using namespace freekv;
  const DeviceGuard guard(device);
  if (guard.error() != cudaSuccess) return guard.error();
  int n = 1 << 30;
  cudaError_t err = min_blocks<float, 8>(&n);
  if (err == cudaSuccess) err = min_blocks<float, 4>(&n);
  if (err == cudaSuccess) err = min_blocks<__nv_bfloat16, 8>(&n);
  if (err == cudaSuccess) err = min_blocks<__nv_bfloat16, 4>(&n);
  if (err != cudaSuccess) return err;
  *out = n;
  return cudaSuccess;
}
