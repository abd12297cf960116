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
// address space and every byte crosses PCIe (Gen5 x16, ~64 GB/s each way):
// 4 x 8 x 56 pages x 16 KiB ~ 29 MB is ~0.46 ms when every lane is valid.
// For offload="sim" the pool is in device memory (3.35 TB/s). The V-only
// gather moves half of that: ~14.7 MB, ~0.23 ms over PCIe.
//
// Design: one block per (lane, kv head, request). The (2, p, d) block of a
// page is contiguous in the HND layout, so the block copies it with 16-byte
// loads straight from the source pointer (device memory, or the mapped host
// pointer: the loads become PCIe reads) into the K and V outputs. Many
// blocks in flight keep many 16-byte reads outstanding, which is what hides
// the link latency; the TPU kernel's explicit DMA ring has no counterpart
// here. -1 lanes issue no load at all, so the top-up / staged / reused split
// of the recall executor is a real traffic split.

#include "common.cuh"

namespace freekv {
namespace {

constexpr int kThreads = 256;

// kValuesOnly: k_out is unused (may be null) and only the V half is read
template <bool kValuesOnly>
__global__ void __launch_bounds__(kThreads)
recall_gather_kernel(const uint4* __restrict__ pool, const int32_t* __restrict__ idx,
                     uint4* __restrict__ k_out, uint4* __restrict__ v_out, int n_pages,
                     int kv, int n_sel, int half_vec) {
  const int lane = blockIdx.x, h = blockIdx.y, b = blockIdx.z;
  const size_t out_off = (((size_t)b * kv + h) * n_sel + lane) * half_vec;
  uint4* vd = v_out + out_off;
  const int page = idx[((size_t)b * kv + h) * n_sel + lane];
  if (page < 0) {
    const uint4 zero = make_uint4(0u, 0u, 0u, 0u);
    for (int i = threadIdx.x; i < half_vec; i += kThreads) {
      if constexpr (!kValuesOnly) k_out[out_off + i] = zero;
      vd[i] = zero;
    }
    return;
  }
  const int safe = min(page, n_pages - 1);
  const uint4* src = pool + (((size_t)b * n_pages + safe) * kv + h) * 2 * half_vec;
  for (int i = threadIdx.x; i < half_vec; i += kThreads) {
    if constexpr (kValuesOnly) {
      vd[i] = src[half_vec + i];
    } else {
      const uint4 a = src[i];
      const uint4 c = src[half_vec + i];
      k_out[out_off + i] = a;
      vd[i] = c;
    }
  }
}

template <bool kValuesOnly>
int launch(const void* pool_dev, const void* idx, void* k_out, void* v_out, int B,
           int n_pages, int kv, int n_sel, long long half_bytes, int device, void* stream) {
  if (half_bytes <= 0 || half_bytes % 16 || n_pages < 1 || n_sel < 1)
    return cudaErrorInvalidValue;
  if ((reinterpret_cast<uintptr_t>(pool_dev) | reinterpret_cast<uintptr_t>(k_out) |
       reinterpret_cast<uintptr_t>(v_out)) % 16)
    return cudaErrorMisalignedAddress;
  const DeviceGuard guard(device);
  if (guard.error() != cudaSuccess) return guard.error();
  recall_gather_kernel<kValuesOnly>
      <<<dim3(n_sel, kv, B), kThreads, 0, static_cast<cudaStream_t>(stream)>>>(
          static_cast<const uint4*>(pool_dev), static_cast<const int32_t*>(idx),
          static_cast<uint4*>(k_out), static_cast<uint4*>(v_out), n_pages, kv, n_sel,
          static_cast<int>(half_bytes / 16));
  return cudaGetLastError();
}

}  // namespace
}  // namespace freekv

// pool_dev must be dereferenceable on the device (see freekv_device_pointer);
// half_bytes = p * d * itemsize, a multiple of 16; all pointers 16-byte
// aligned. Returns cudaGetLastError().
extern "C" int freekv_recall_gather(const void* pool_dev, const void* idx, void* k_out,
                                    void* v_out, int B, int n_pages, int kv, int n_sel,
                                    long long half_bytes, int device, void* stream) {
  return freekv::launch<false>(pool_dev, idx, k_out, v_out, B, n_pages, kv, n_sel,
                               half_bytes, device, stream);
}

// The V halves only, into v_out (B, kv, n_sel, p, d); same requirements.
extern "C" int freekv_recall_values(const void* pool_dev, const void* idx, void* v_out, int B,
                                    int n_pages, int kv, int n_sel, long long half_bytes,
                                    int device, void* stream) {
  return freekv::launch<true>(pool_dev, idx, nullptr, v_out, B, n_pages, kv, n_sel,
                              half_bytes, device, stream);
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
