// Per-page min/max summaries of post-RoPE keys, alone or fused with the
// pool fill.
//
// Replaces the Pallas TPU kernel repro/kernels/page_summary.py, function
// page_summary (body _kernel: one grid step reduces one (p, d) key page of
// one KV head to its (2, d) bounding box). Contract: k (B, T, kv, d), T a
// whole number of pages of p tokens -> out (B, T/p, kv, 2, d), out[..., 0,
// :] the minimum and out[..., 1, :] the maximum over the page's p tokens.
// Exact: min and max of float32 (or of bfloat16 widened exactly to float32
// and narrowed back) round nothing.
//
// Three entries:
//   freekv_page_summary   the TPU kernel's contract alone, in k's dtype. Off
//                         the main path; held against its plain version.
//   freekv_fill_pages     the prefill (core/paging.py prefill_fill_pool):
//                         every whole page of K and V (B, T, kv, d) in one
//                         pass -> its summary, in place in the state's
//                         summaries, and its HND pool block (kv, 2, p, d),
//                         quantized under the int8/int4 tier with its
//                         float32 scales (quant/quantizers.py
//                         quantize_block, bit for bit).
//   freekv_complete_page  the decode (core/paging.py append_token): reads
//                         the post-append lengths on the card; a row whose
//                         length is a whole number of pages gathers that
//                         page from its window ring, slot (page * p + t) %
//                         n_win, and writes its summary, its block and its
//                         scales to pool[b, page]; every other row writes
//                         nothing. No host input, so one launch a layer
//                         whatever the lengths (the reference's masked
//                         where, repro/core/paging.py:206-254).
//
// What bounds them on an H100: bytes. fill_pages reads K and V once and
// writes the block (as many bytes in bf16, half in int8, a quarter in int4)
// and the summaries (2/p of K): at a continuous admission (B = 1, T = 8192,
// kv = 8, d = 128, bf16) ~33.5 MB in, ~33.5 MB out, ~20 us at 3.35 TB/s.
// complete_page writes 128 KiB a completing row at those widths; with the
// pool in pinned host memory the link bounds it (~8 us for 4 rows at 64
// GB/s); on a step where no row completes it is launch latency.
//
// Where the block goes. The prefill writes a card-side block (the device
// pool itself under offload="sim", a staging block under "host") that the
// caller moves to the pinned pool with one copy-engine copy per row: 33.5
// MB a layer at the copy engine's rate, where SM traffic to pinned memory
// is slower (SM reads measured 20-50 GB/s) or not measured (SM writes). The
// decode writes the pinned pool straight from the SMs, at its mapped device
// address: 128 KiB a row, and no host-side index, copy or branch.
//
// Design: one block per (page, group of hpb KV heads, request). A thread
// owns one 16-byte chunk (8 bf16 or 4 fp32 channels) of one head's K or V
// row and walks the page's p tokens with 16-byte loads, kUnroll in flight.
// Token rows are NHD (kv * d elements); the block is HND, where a head's
// K or V row of a token is the same d contiguous elements, so the
// transpose is a change of address per 256-byte row, never a shuffle. The
// K threads keep the running min and max in registers. Unquantized, each
// chunk is stored as it is read (one pass). Quantized, the pass keeps each
// channel's running amax; the block merges them into the group maxima in
// shared memory (atomicMax on the bits of non-negative floats, in any
// order, so exact), computes the scales, and a second pass re-reads the
// page (from L1/L2, where the first pass just brought it) to quantize:
// x / scale with IEEE division, rintf (half to even), clamp, int8; under
// int4 a thread takes channels j and j + d/2 of every other token, the two
// nibbles of one byte. Staging the page in shared memory instead holds a
// block's whole page there (64 KiB for 4 heads of bf16), three blocks an
// SM, and ran no faster.

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

// ---------------------------------------------------------------------------
// fill_pages and complete_page
// ---------------------------------------------------------------------------
constexpr int kFillMaxThreads = 512;   // ops.FILL_MAX_THREADS
constexpr int kUnroll = 8;             // 16-byte loads a thread keeps in flight

// kBytes stored by one instruction (or two, for 32)
template <int kBytes> struct Raw;
template <> struct Raw<4> { uint32_t v; };
template <> struct Raw<8> { uint2 v; };
template <> struct Raw<16> { uint4 v; };
template <> struct Raw<32> { uint4 v[2]; };

// kN values narrowed to S (round to nearest even) and stored together
template <typename S, int kN>
__device__ __forceinline__ void store_values(S* dst, const float* x) {
  Raw<kN * sizeof(S)> raw;
  S* s = reinterpret_cast<S*>(&raw);
#pragma unroll
  for (int j = 0; j < kN; ++j) s[j] = from_f32<S>(x[j]);
  *reinterpret_cast<Raw<kN * sizeof(S)>*>(dst) = raw;
}

template <int kN>
__device__ __forceinline__ void store_bytes(int8_t* dst, const int* q) {
  Raw<kN> raw;
  int8_t* s = reinterpret_cast<int8_t*>(&raw);
#pragma unroll
  for (int j = 0; j < kN; ++j) s[j] = static_cast<int8_t>(q[j]);
  *reinterpret_cast<Raw<kN>*>(dst) = raw;
}

// quantize_block's arithmetic: clamp(round_half_even(x / scale), -qmax, qmax)
__device__ __forceinline__ int quantize(float x, float scale, float qmax) {
  return static_cast<int>(fminf(fmaxf(rintf(__fdiv_rn(x, scale)), -qmax), qmax));
}

__device__ __forceinline__ float group_scale(const int* amax_bits, float qmax) {
  const float m = __int_as_float(*amax_bits);
  return m > 0.f ? __fdiv_rn(m, qmax) : 1.f;
}

struct FillArgs {
  const void* k;                  // token rows of kv * d elements of T
  const void* v;
  long long k_bs, v_bs;           // elements between the batch rows of k and v
  const int32_t* length;          // decode: post-append lengths (B,); prefill: null
  int n_win;                      // decode: ring slots, token i at slot i % n_win; prefill: 0
  void* summ;                     // a row: (n_dst, kv, 2, d) of S
  long long summ_bs;
  void* pool;                     // a row: (n_dst, kv, 2, p, dp) of S, or int8
  long long pool_bs;
  float* scale;                   // a row: (n_dst, kv, 2, n_g); null unquantized
  long long scale_bs;
  int n_dst, p, kv, d, n_g, hpb;  // hpb: KV heads a block
  int page_lo;                    // decode: the outputs hold pages page_lo .. + n_dst - 1
};

// Loads the 16-byte chunk at `base` of tokens t0, t0 + step, ... (kN of
// them, those below p) of the page into raw: kN loads in flight.
template <int kN, typename T>
__device__ __forceinline__ void load_tokens(const FillArgs& a, const T* base, int page,
                                            int t0, int step, uint4 (&raw)[kN]) {
  const int row = a.kv * a.d;
#pragma unroll
  for (int i = 0; i < kN; ++i) {
    const int t = t0 + i * step;
    if (t < a.p) {
      long long pos = (long long)page * a.p + t;
      if (a.n_win) pos %= a.n_win;
      raw[i] = *reinterpret_cast<const uint4*>(base + pos * row);
    }
  }
}

template <typename T, typename S, int kBits>
__global__ void __launch_bounds__(kFillMaxThreads)
fill_pages_kernel(const FillArgs a) {
  constexpr int kVec = 16 / sizeof(T);
  constexpr float kQmax = kBits == 8 ? 127.f : 7.f;
  extern __shared__ int amax_bits[];    // (hpb, 2, n_g) group maxima, as float bits
  const int b = blockIdx.y;
  const int groups = a.kv / a.hpb;
  const int h0 = (blockIdx.x % groups) * a.hpb;
  int page = blockIdx.x / groups;       // the source page: its tokens' ring slots
  if (a.length != nullptr) {            // decode: only a row whose page just completed
    const int len = a.length[b];
    if (len < a.p || len % a.p != 0) return;
    page = len / a.p - 1;
  }
  // the destination page: a page shard writes only the pages of its range
  const int dpage = page - a.page_lo;
  if (dpage < 0 || dpage >= a.n_dst) return;
  const int cpr = a.d / kVec;           // chunks in a head's row
  const int u = threadIdx.x;            // blockDim.x == hpb * 2 * cpr
  const int hl = u / (2 * cpr), half = (u / cpr) & 1, cc = u % cpr;
  const int h = h0 + hl, c0 = cc * kVec;
  const T* head = static_cast<const T*>(half ? a.v : a.k) + b * (half ? a.v_bs : a.k_bs)
                  + h * a.d;
  // this (page, head, half)'s (p, dp) block
  const size_t blk = ((size_t)dpage * a.kv + h) * 2 + half;

  float lo[kVec], hi[kVec], amax[kVec];
#pragma unroll
  for (int j = 0; j < kVec; ++j) {
    lo[j] = __int_as_float(0x7f800000);    // +inf
    hi[j] = -lo[j];
    amax[j] = 0.f;
  }
  for (int t0 = 0; t0 < a.p; t0 += kUnroll) {
    uint4 raw[kUnroll];
    load_tokens(a, head + c0, page, t0, 1, raw);
#pragma unroll
    for (int i = 0; i < kUnroll; ++i) {
      if (t0 + i >= a.p) break;
      const T* vals = reinterpret_cast<const T*>(&raw[i]);
      float x[kVec];
#pragma unroll
      for (int j = 0; j < kVec; ++j) {
        x[j] = to_f32(vals[j]);
        lo[j] = fminf(lo[j], x[j]);
        hi[j] = fmaxf(hi[j], x[j]);
        amax[j] = fmaxf(amax[j], fabsf(x[j]));
      }
      if constexpr (kBits == 0)
        store_values<S, kVec>(static_cast<S*>(a.pool) + b * a.pool_bs
                              + (blk * a.p + t0 + i) * a.d + c0, x);
    }
  }
  if (half == 0) {                      // the K threads: the summary
    S* dst = static_cast<S*>(a.summ) + b * a.summ_bs + ((size_t)dpage * a.kv + h) * 2 * a.d + c0;
    store_values<S, kVec>(dst, lo);
    store_values<S, kVec>(dst + a.d, hi);
  }
  if constexpr (kBits != 0) {
    const int g = a.d / a.n_g;
    const int slots = a.hpb * 2 * a.n_g;
    for (int i = u; i < slots; i += blockDim.x) amax_bits[i] = 0;
    __syncthreads();
    // this chunk's channels into their groups' maxima (non-negative floats
    // order as their bits do)
    int* mine = amax_bits + (hl * 2 + half) * a.n_g;
    int gi = c0 / g;
    float run = 0.f;
#pragma unroll
    for (int j = 0; j < kVec; ++j) {
      if ((c0 + j) / g != gi) {
        atomicMax(mine + gi, __float_as_int(run));
        gi = (c0 + j) / g;
        run = 0.f;
      }
      run = fmaxf(run, amax[j]);
    }
    atomicMax(mine + gi, __float_as_int(run));
    __syncthreads();
    for (int i = u; i < slots; i += blockDim.x) {
      const int hh = i / (2 * a.n_g), rest = i % (2 * a.n_g);   // rest: half * n_g + group
      a.scale[b * a.scale_bs + ((size_t)dpage * a.kv + h0 + hh) * 2 * a.n_g + rest] =
          group_scale(amax_bits + i, kQmax);
    }
    int8_t* pool = static_cast<int8_t*>(a.pool) + b * a.pool_bs;
    if constexpr (kBits == 8) {
      float sc[kVec];
#pragma unroll
      for (int j = 0; j < kVec; ++j) sc[j] = group_scale(mine + (c0 + j) / g, kQmax);
      int8_t* dst = pool + blk * a.p * a.d + c0;
      for (int t0 = 0; t0 < a.p; t0 += kUnroll) {
        uint4 raw[kUnroll];
        load_tokens(a, head + c0, page, t0, 1, raw);
#pragma unroll
        for (int i = 0; i < kUnroll; ++i) {
          if (t0 + i >= a.p) break;
          const T* vals = reinterpret_cast<const T*>(&raw[i]);
          int q[kVec];
#pragma unroll
          for (int j = 0; j < kVec; ++j) q[j] = quantize(to_f32(vals[j]), sc[j], kQmax);
          store_bytes<kVec>(dst + (size_t)(t0 + i) * a.d, q);
        }
      }
    } else {
      // byte j of a packed row: channel j in the low nibble, j + d/2 in the
      // high one (pack_int4). The chunks of the first d/2 channels pair
      // with those d/2 later; the row's two halves of threads take the
      // even and the odd tokens.
      const int pairs = cpr / 2;
      const int c_lo = (cc % pairs) * kVec, c_hi = c_lo + a.d / 2, first = cc / pairs;
      float s_lo[kVec], s_hi[kVec];
#pragma unroll
      for (int j = 0; j < kVec; ++j) {
        s_lo[j] = group_scale(mine + (c_lo + j) / g, kQmax);
        s_hi[j] = group_scale(mine + (c_hi + j) / g, kQmax);
      }
      const int dp = a.d / 2;
      int8_t* dst = pool + blk * a.p * dp + c_lo;
      constexpr int kN = kUnroll / 2;   // two loads a token: as many in flight
      for (int t0 = first; t0 < a.p; t0 += 2 * kN) {
        uint4 raw_lo[kN], raw_hi[kN];
        load_tokens(a, head + c_lo, page, t0, 2, raw_lo);
        load_tokens(a, head + c_hi, page, t0, 2, raw_hi);
#pragma unroll
        for (int i = 0; i < kN; ++i) {
          if (t0 + 2 * i >= a.p) break;
          const T* vl = reinterpret_cast<const T*>(&raw_lo[i]);
          const T* vh = reinterpret_cast<const T*>(&raw_hi[i]);
          int q[kVec];
#pragma unroll
          for (int j = 0; j < kVec; ++j)
            q[j] = (quantize(to_f32(vl[j]), s_lo[j], kQmax) & 0xF)
                   | ((quantize(to_f32(vh[j]), s_hi[j], kQmax) & 0xF) << 4);
          store_bytes<kVec>(dst + (size_t)(t0 + 2 * i) * dp, q);
        }
      }
    }
  }
}

template <typename T, typename S>
void launch_typed(const FillArgs& a, int bits, dim3 grid, int threads, size_t smem,
                  cudaStream_t st) {
  if (bits == 8)
    fill_pages_kernel<T, S, 8><<<grid, threads, smem, st>>>(a);
  else if (bits == 4)
    fill_pages_kernel<T, S, 4><<<grid, threads, smem, st>>>(a);
  else
    fill_pages_kernel<T, S, 0><<<grid, threads, smem, st>>>(a);
}

// Checks shared by both entries, then one launch over grid (pages *
// kv / hpb, B). Returns cudaGetLastError().
int launch_fill(const FillArgs& a, int B, int grid_pages, int bits, int in_dtype, int out_dtype,
                int device, void* stream) {
  const int in_elem = in_dtype == kBFloat16 ? 2 : 4;
  const int summ_elem = out_dtype == kBFloat16 ? 2 : 4;
  const int pool_elem = bits ? 1 : summ_elem;
  const int kvec = 16 / in_elem;
  const bool types_ok = (in_dtype == kFloat32 || in_dtype == kBFloat16)
                        && (out_dtype == kFloat32 || out_dtype == kBFloat16)
                        && (bits == 0 || bits == 8 || bits == 4);
  if (!types_ok || B < 1 || grid_pages < 1 || a.n_dst < 1 || a.p < 1 || a.kv < 1 || a.d < 1
      || a.hpb < 1 || a.kv % a.hpb || a.d % kvec || (bits == 4 && (a.d / 2) % kvec)
      || (bits && (a.n_g < 1 || a.d % a.n_g || a.scale == nullptr))
      || a.hpb * 2 * (a.d / kvec) > kFillMaxThreads
      || (a.k_bs * in_elem) % 16 || (a.v_bs * in_elem) % 16 || (a.summ_bs * summ_elem) % 16
      || (a.pool_bs * pool_elem) % 16
      || (reinterpret_cast<uintptr_t>(a.k) | reinterpret_cast<uintptr_t>(a.v)
          | reinterpret_cast<uintptr_t>(a.summ) | reinterpret_cast<uintptr_t>(a.pool)) % 16)
    return cudaErrorInvalidValue;
  const size_t smem = bits ? sizeof(int) * a.hpb * 2 * a.n_g : 0;
  if (smem > 48 * 1024) return cudaErrorInvalidValue;
  const DeviceGuard guard(device);
  if (guard.error() != cudaSuccess) return guard.error();
  const dim3 grid(grid_pages * (a.kv / a.hpb), B);
  const int threads = a.hpb * 2 * (a.d / kvec);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (in_dtype == kFloat32 && out_dtype == kFloat32)
    launch_typed<float, float>(a, bits, grid, threads, smem, st);
  else if (in_dtype == kFloat32)
    launch_typed<float, __nv_bfloat16>(a, bits, grid, threads, smem, st);
  else if (out_dtype == kFloat32)
    launch_typed<__nv_bfloat16, float>(a, bits, grid, threads, smem, st);
  else
    launch_typed<__nv_bfloat16, __nv_bfloat16>(a, bits, grid, threads, smem, st);
  return cudaGetLastError();
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

// The prefill: the first n_pages whole pages of k and v (B rows of tokens
// of kv * d elements of in_dtype, rows k_bs / v_bs elements apart) -> summ
// (B, n_pages, kv, 2, d) of out_dtype and pool (B, n_pages, kv, 2, p, dp),
// out_dtype with bits 0, else int8 (dp = d * bits / 8) with float32 scale
// (B, n_pages, kv, 2, n_g); each output's rows *_bs elements apart, the
// rest contiguous. heads_per_block KV heads a block (a divisor of kv).
// Needs 16-byte aligned pointers and row strides, d a whole number of
// 16-byte chunks (and d / 2 under int4). Returns cudaGetLastError().
extern "C" int freekv_fill_pages(const void* k, const void* v, long long k_bs, long long v_bs,
                                 void* summ, long long summ_bs, void* pool, long long pool_bs,
                                 void* scale, long long scale_bs, int B, int n_pages, int p,
                                 int kv, int d, int n_g, int bits, int in_dtype, int out_dtype,
                                 int heads_per_block, int device, void* stream) {
  freekv::FillArgs a{k, v, k_bs, v_bs, nullptr, 0, summ, summ_bs, pool, pool_bs,
                     static_cast<float*>(scale), scale_bs, n_pages, p, kv, d, n_g,
                     heads_per_block};
  return freekv::launch_fill(a, B, n_pages, bits, in_dtype, out_dtype, device, stream);
}

// The decode, after the token append: win_k / win_v (B, n_win, kv, d) rings
// of dtype, length (B,) int32 the post-append lengths. Row b with length a
// whole number of pages writes page length / p - 1 (if below n_pages) to
// summ (B, n_pages, kv, 2, d), pool (B, n_pages, kv, 2, p, dp) and, with
// bits, scale (B, n_pages, kv, 2, n_g), each at its address on `device`
// (a pinned host pool's mapped one); other rows write nothing. page_lo:
// the outputs hold pages page_lo .. page_lo + n_pages - 1 (a page shard's
// range; 0 for the whole pool), and a row writes only a page of that range,
// at its place there. Returns cudaGetLastError().
extern "C" int freekv_complete_page(const void* win_k, const void* win_v, const void* length,
                                    void* summ, long long summ_bs, void* pool, long long pool_bs,
                                    void* scale, long long scale_bs, int B, int n_win,
                                    int n_pages, int p, int kv, int d, int n_g, int bits,
                                    int dtype, int heads_per_block, int page_lo, int device,
                                    void* stream) {
  const long long ring = static_cast<long long>(n_win) * kv * d;
  if (n_win < 1 || length == nullptr || page_lo < 0) return cudaErrorInvalidValue;
  freekv::FillArgs a{win_k, win_v, ring, ring, static_cast<const int32_t*>(length), n_win,
                     summ, summ_bs, pool, pool_bs, static_cast<float*>(scale), scale_bs,
                     n_pages, p, kv, d, n_g, heads_per_block, page_lo};
  return freekv::launch_fill(a, B, 1, bits, dtype, dtype, device, stream);
}
