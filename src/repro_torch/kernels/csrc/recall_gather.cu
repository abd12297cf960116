// Gather of the selected (2, p, d) K+V page blocks out of the HND pool, and
// of their V halves only.
//
// Replaces the Pallas TPU kernel repro/kernels/recall_gather.py, function
// recall_gather (body _kernel: a 2-deep VMEM ring, one DMA per selected
// page, no DMA for -1 lanes), with values_only False (freekv_recall_gather)
// and True (freekv_recall_values, ShadowKV's V-only recall). Contract: pool
// (B, n_pages, kv, 2, p, d), idx (B, kv, n_sel) int32 -> k, v (B, kv, n_sel,
// p, d), or v alone; an idx < 0 lane writes zeros and reads nothing; ids >=
// n_pages are clamped as in the reference. The copy is byte-for-byte, so
// the output is bit-exact for any dtype. The V-only entry reads only the
// second half (p * d * itemsize bytes at offset p * d) of each block and
// has no K output at all: the reference's zero K is discarded by its
// caller (repro/kernels/ops.py recall_values).
//
// What bounds it on an H100: bytes over the link the pool sits behind. For
// offload="host" the pool is pinned host memory mapped into the device's
// address space and every byte crosses PCIe: Gen5 x16 is 64 GB/s each way
// on the data sheet, so 4 x 8 x 56 pages x 16 KiB ~ 29 MB is ~0.46 ms when
// every lane is valid (the V-only gather ~0.23 ms). No PCIe read reaches
// the data sheet's rate: one contiguous copy_ of the same 29 MB from pinned
// memory (the link's measured ceiling, timed beside each gather by
// chip_smoke.py) took 0.53-0.69 ms on the H100s measured (43-55 GB/s;
// PERF.md), and SM-issued reads of pinned memory ran at 30-50 GB/s by
// machine, whatever the grid or load depth. For offload="sim" the pool is
// in device memory (3.35 TB/s).
//
// Design: a persistent grid of walking warps (common.cuh walk_items). Each
// item splits into two units, its K and V halves (one, the V half, for the
// V-only entry). A warp takes its units in turn: it copies a valid unit's
// half page with kLoads 16-byte non-allocating loads in flight per thread
// (8 KiB a warp: a bf16 half page at p = 32, d = 128), straight from the
// source (device memory, or the mapped host pointer: the loads become PCIe
// reads) into its output, and writes the zeros of a -1 lane's unit, which
// cross no link, as it meets it. A run of -1 lanes costs one index load a
// warp per 32 units and their stores, no round trip; a lone page's halves
// go to two warps and come in one round trip. The wrapper sizes the grid
// (ops.gather_grid): from a pinned host pool, the blocks HOST_GATHER_SMS =
// 32 SMs hold at once, which keep the link as full as the whole card does;
// from a device pool, every SM's worth. One walk, every block reading: on
// the H100s measured (PERF.md, launch/kernel_ablation.py), host reads in
// flight from 16 SMs or more slow the HBM-bound kernels beside a gather on
// the main stream about as much as from the whole card, and letting fewer
// SMs or blocks read cut that but slowed the launches the decode sends,
// whose lanes are mostly -1. Bulk copies (cp.async.bulk) read the mapped
// address too, but no faster; plain loads need no ring and no barrier, and
// let recall_gather_quant.cu dequantize from registers.
//
// The non-coherent (.nc) loads are safe because nothing writes the pool
// while a gather reads it: the pool's pages are written on the main stream
// (offload of a completed page), the top-up gather runs on the main stream
// after them, and the staged gather's side stream waits for the main stream
// before each launch (core/recall_pipeline.py RecallExecutor.step).

#include "common.cuh"

namespace freekv {
namespace {

constexpr int kThreads = 256;  // eight warps, each walking its own units
constexpr int kLoads = 16;     // 16-byte loads in flight per thread (8 KiB a warp)

// kValuesOnly: k_out is unused (may be null) and only the V half is read
template <bool kValuesOnly>
__global__ void __launch_bounds__(kThreads)
recall_gather_kernel(const uint4* __restrict__ pool, const int32_t* __restrict__ idx,
                     uint4* __restrict__ k_out, uint4* __restrict__ v_out, int n_pages,
                     int kv, int n_sel, int n_items, int half_vec) {
  constexpr int kHalves = kValuesOnly ? 1 : 2;
  const int lane = threadIdx.x & 31;
  walk_items<kHalves>(idx, n_items, [&](int unit, int page) {
    const int item = unit / kHalves;
    const int half = kValuesOnly ? 1 : unit % 2;   // 0: K, 1: V
    uint4* out = (half ? v_out : k_out) + (size_t)item * half_vec;
    if (page < 0) {
      for (int i = lane; i < half_vec; i += 32) out[i] = make_uint4(0u, 0u, 0u, 0u);
      return;
    }
    const int bh = item / n_sel;                   // b * kv + h
    const size_t blk = ((size_t)(bh / kv) * n_pages + min(page, n_pages - 1)) * kv + bh % kv;
    const uint4* src = pool + (2 * blk + half) * half_vec;
    for (int base = 0; base < half_vec; base += 32 * kLoads) {
      uint4 r[kLoads];
#pragma unroll
      for (int u = 0; u < kLoads; ++u) {
        const int i = base + 32 * u + lane;
        if (i < half_vec) r[u] = ld_stream(src + i);
      }
#pragma unroll
      for (int u = 0; u < kLoads; ++u) {
        const int i = base + 32 * u + lane;
        if (i < half_vec) out[i] = r[u];
      }
    }
  });
}

template <bool kValuesOnly>
int launch(const void* pool_dev, const void* idx, void* k_out, void* v_out, int B,
           int n_pages, int kv, int n_sel, long long half_bytes, int n_blocks, int device,
           void* stream) {
  if (half_bytes <= 0 || half_bytes % 16 || n_pages < 1 || n_sel < 1 || n_blocks < 1)
    return cudaErrorInvalidValue;
  if ((reinterpret_cast<uintptr_t>(pool_dev) | reinterpret_cast<uintptr_t>(k_out) |
       reinterpret_cast<uintptr_t>(v_out)) % 16)
    return cudaErrorMisalignedAddress;
  const DeviceGuard guard(device);
  if (guard.error() != cudaSuccess) return guard.error();
  recall_gather_kernel<kValuesOnly><<<n_blocks, kThreads, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const uint4*>(pool_dev), static_cast<const int32_t*>(idx),
      static_cast<uint4*>(k_out), static_cast<uint4*>(v_out), n_pages, kv, n_sel,
      B * kv * n_sel, static_cast<int>(half_bytes / 16));
  return cudaGetLastError();
}

}  // namespace
}  // namespace freekv

// pool_dev must be dereferenceable on the device (see freekv_device_pointer);
// half_bytes = p * d * itemsize, a multiple of 16; all pointers 16-byte
// aligned; n_blocks from ops.gather_grid. Returns cudaGetLastError().
extern "C" int freekv_recall_gather(const void* pool_dev, const void* idx, void* k_out,
                                    void* v_out, int B, int n_pages, int kv, int n_sel,
                                    long long half_bytes, int n_blocks, int device,
                                    void* stream) {
  return freekv::launch<false>(pool_dev, idx, k_out, v_out, B, n_pages, kv, n_sel,
                               half_bytes, n_blocks, device, stream);
}

// The V halves only, into v_out (B, kv, n_sel, p, d); same requirements.
extern "C" int freekv_recall_values(const void* pool_dev, const void* idx, void* v_out, int B,
                                    int n_pages, int kv, int n_sel, long long half_bytes,
                                    int n_blocks, int device, void* stream) {
  return freekv::launch<true>(pool_dev, idx, nullptr, v_out, B, n_pages, kv, n_sel,
                              half_bytes, n_blocks, device, stream);
}

// The blocks of either gather an SM holds at once, by registers and shared
// memory (the smaller of the two), into *out; ops.gather_grid sizes the grid
// from it.
extern "C" int freekv_recall_gather_blocks_per_sm(int device, int* out) {
  using namespace freekv;
  const DeviceGuard guard(device);
  if (guard.error() != cudaSuccess) return guard.error();
  int a = 0, b = 0;
  cudaError_t err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(
      &a, recall_gather_kernel<false>, kThreads, 0);
  if (err == cudaSuccess)
    err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&b, recall_gather_kernel<true>,
                                                        kThreads, 0);
  if (err != cudaSuccess) return err;
  *out = a < b ? a : b;
  return cudaSuccess;
}

// The address at which the device may dereference `ptr`: the pointer itself
// for device memory, the mapped address for pinned host memory. Fails for
// pageable host memory, which the device cannot read. The wrapper resolves a
// pool once and keeps the result (ops._pool_pointer).
extern "C" int freekv_device_pointer(const void* ptr, int device, void** out) {
  using namespace freekv;
  const DeviceGuard guard(device);
  if (guard.error() != cudaSuccess) return guard.error();
  cudaPointerAttributes attr;
  cudaError_t err = cudaPointerGetAttributes(&attr, ptr);
  if (err != cudaSuccess) {
    cudaGetLastError();
    return err;
  }
  if (attr.type == cudaMemoryTypeUnregistered || attr.devicePointer == nullptr)
    return cudaErrorInvalidValue;
  *out = attr.devicePointer;
  return cudaSuccess;
}
