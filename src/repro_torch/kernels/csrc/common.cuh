// Shared helpers for the FreeKV CUDA kernels (plain C interface, bound with
// ctypes from kernels/build.py).
#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace freekv {

// dtype codes passed by the Python wrappers
constexpr int kFloat32 = 0;
constexpr int kBFloat16 = 1;

// the -1e30 sentinel of the reference: exp(-1e30 - m) == 0 for any finite m,
// so a fully masked region drops out of every online-softmax merge
constexpr float kNegInf = -1e30f;

// Makes `device` current for the scope of an entry point and puts the
// caller's device back on exit, so a launch never changes the current device
// under PyTorch. Costs one cudaGetDevice when the device is already current.
class DeviceGuard {
 public:
  explicit DeviceGuard(int device) {
    err_ = cudaGetDevice(&prev_);
    if (err_ == cudaSuccess && prev_ != device) {
      err_ = cudaSetDevice(device);
      switched_ = err_ == cudaSuccess;
    }
  }
  ~DeviceGuard() {
    if (switched_) cudaSetDevice(prev_);
  }
  cudaError_t error() const { return err_; }

 private:
  int prev_ = 0;
  bool switched_ = false;
  cudaError_t err_;
};

__device__ __forceinline__ float to_f32(float x) { return x; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 x) { return __bfloat162float(x); }

template <typename T> __device__ __forceinline__ T from_f32(float x);
template <> __device__ __forceinline__ float from_f32<float>(float x) { return x; }
template <> __device__ __forceinline__ __nv_bfloat16 from_f32<__nv_bfloat16>(float x) {
  return __float2bfloat16(x);
}

__device__ __forceinline__ float warp_sum(float x) {
#pragma unroll
  for (int off = 16; off > 0; off >>= 1) x += __shfl_xor_sync(0xffffffffu, x, off);
  return x;
}

__device__ __forceinline__ float warp_max(float x) {
#pragma unroll
  for (int off = 16; off > 0; off >>= 1) x = fmaxf(x, __shfl_xor_sync(0xffffffffu, x, off));
  return x;
}

// 2^x by the special-function unit (relative error ~2^-22; 0 for x <= -126)
__device__ __forceinline__ float fast_exp2(float x) {
  float y;
  asm("ex2.approx.ftz.f32 %0, %1;\n" : "=f"(y) : "f"(x));
  return y;
}

// 16 bytes through the read-only path, not kept in L1. Only for data that no
// thread writes while the kernel runs (the host-pool gathers: see the note
// in recall_gather.cu). Volatile, so the compiler keeps each load where the
// source issues it: ahead of the waits that follow it.
__device__ __forceinline__ uint4 ld_stream(const uint4* p) {
  uint4 r;
  asm volatile("ld.global.nc.L1::no_allocate.v4.u32 {%0, %1, %2, %3}, [%4];\n"
               : "=r"(r.x), "=r"(r.y), "=r"(r.z), "=r"(r.w)
               : "l"(p));
  return r;
}

// The gathers' walk. An item is one (request, KV head, lane), numbered as
// the flat idx; it splits into kHalves units, its K and V halves (1 for the
// V-only gathers), so a page's halves go to two warps and come in one round
// trip. Every warp of the grid walks: warp `walker` takes units walker,
// walker + walkers, ... (ops.gather_items computes the same partition).
// Their page ids come 32 at a time, one load a lane, so a run of -1 lanes
// costs one index load, not one per lane; then fn(unit, page) runs for each
// in order, on the whole warp.
template <int kHalves, typename Fn>
__device__ __forceinline__ void walk_items(const int32_t* __restrict__ idx, int n_items,
                                           Fn&& fn) {
  const int lane = threadIdx.x & 31;
  const int warps = blockDim.x >> 5;
  const int walkers = gridDim.x * warps;
  const int walker = blockIdx.x * warps + (threadIdx.x >> 5);
  const int n_units = n_items * kHalves;
  for (int u0 = walker; u0 < n_units; u0 += 32 * walkers) {
    const int mine = u0 + lane * walkers;
    const int page = mine < n_units ? idx[mine / kHalves] : -1;
    const int n = min(32, (n_units - u0 + walkers - 1) / walkers);
    for (int k = 0; k < n; ++k) fn(u0 + k * walkers, __shfl_sync(0xffffffffu, page, k));
  }
}

// ---------------------------------------------------------------------------
// Hopper's asynchronous copies and the shared-memory barriers that track them
// ---------------------------------------------------------------------------
__device__ __forceinline__ uint32_t smem_addr(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

// 4 bytes from global to shared memory with no register in between
// (cp.async); this thread's copies are complete after cp_async_wait_all
__device__ __forceinline__ void cp_async_4(void* dst, const void* src) {
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4;\n" ::"r"(smem_addr(dst)), "l"(src)
               : "memory");
}

__device__ __forceinline__ void cp_async_wait_all() {
  asm volatile("cp.async.wait_all;\n" ::: "memory");
}

// an mbarrier expecting `count` arrivals per phase; call from one thread,
// then fence_barrier_init() and a __syncthreads before any thread uses it
__device__ __forceinline__ void mbar_init(uint32_t bar, int count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;\n" ::"r"(bar), "r"(count) : "memory");
}

__device__ __forceinline__ void fence_barrier_init() {
  asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
}

// one arrival that also tells the barrier to wait for `bytes` of copies
__device__ __forceinline__ void mbar_expect_tx(uint32_t bar, uint32_t bytes) {
  asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n" ::"r"(bar), "r"(bytes)
               : "memory");
}

__device__ __forceinline__ void mbar_arrive(uint32_t bar) {
  asm volatile("mbarrier.arrive.shared::cta.b64 _, [%0];\n" ::"r"(bar) : "memory");
}

// returns once the barrier's phase of parity `parity` has completed
__device__ __forceinline__ void mbar_wait(uint32_t bar, uint32_t parity) {
  uint32_t done = 0;
  while (!done)
    asm volatile(
        "{\n.reg .pred p;\nmbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n"
        "selp.u32 %0, 1, 0, p;\n}\n"
        : "=r"(done)
        : "r"(bar), "r"(parity)
        : "memory");
}

// orders this thread's earlier generic-proxy shared-memory accesses before
// later async-proxy ones (a copy into a buffer the block has just read)
__device__ __forceinline__ void fence_proxy_async() {
  asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
}

// `bytes` (a multiple of 16, both ends 16-byte aligned) from global to
// shared memory by the copy engine; completion is counted on `bar`
__device__ __forceinline__ void bulk_load(uint32_t dst, const void* src, uint32_t bytes,
                                          uint32_t bar) {
  asm volatile(
      "cp.async.bulk.shared::cluster.global.mbarrier::complete_tx::bytes [%0], [%1], %2, [%3];\n"
      ::"r"(dst), "l"(src), "r"(bytes), "r"(bar)
      : "memory");
}

// Lets `Kernel` take `bytes` of dynamic shared memory on `device` (the
// current device), beside its static shared memory, and prefer the largest
// shared-memory carveout (so as many blocks fit on an SM as the shared
// memory allows): cudaFuncSetAttribute runs once per device and kernel, and
// again only for a larger request.
constexpr int kMaxDevices = 64;
template <auto Kernel>
cudaError_t allow_smem(size_t bytes, int device) {
  static int granted[kMaxDevices] = {};
  if (device < 0 || device >= kMaxDevices) return cudaErrorInvalidDevice;
  if (granted[device] >= static_cast<int>(bytes)) return cudaSuccess;
  cudaError_t err = cudaFuncSetAttribute(Kernel, cudaFuncAttributePreferredSharedMemoryCarveout,
                                         static_cast<int>(cudaSharedmemCarveoutMaxShared));
  if (err == cudaSuccess)
    err = cudaFuncSetAttribute(Kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                               static_cast<int>(bytes));
  if (err == cudaSuccess) granted[device] = static_cast<int>(bytes);
  return err;
}

}  // namespace freekv
