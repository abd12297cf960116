// Causal GQA flash attention for prefill.
//
// Replaces the Pallas TPU kernel repro/kernels/flash_prefill.py, function
// flash_prefill (body _kernel: grid (B, H, T/blq, T/blk), the K/V index map
// folding the GQA group, running (m, l, acc) in VMEM scratch, KV blocks that
// are wholly masked skipped with pl.when). Contract: q (B, H, Tq, d), k and v
// (B, kv, Tk, d) with Tq <= Tk, head h reading KV head h / (H / kv) -> out
// (B, H, Tq, d) in q's dtype. Query row i sits at absolute position
// Tk - Tq + i (a prompt's suffix over its cached prefix and itself: the
// causal mask aligns bottom-right; Tq == Tk is a whole prompt). Scores are
// (q . k) * scale, then softcap * tanh(s / softcap) when softcap > 0, then
// masked to -1e30 where the key is past the query's position (causal), at
// or before that position - window (window > 0), or past Tk. Online
// softmax exactly as the TPU kernel: m_new = max(m, rowmax s), alpha =
// exp(m - m_new), l = l * alpha + rowsum exp(s - m_new), acc = acc * alpha +
// exp(s - m_new) @ v; out = acc / max(l, 1e-30). Scores, statistics and
// accumulators are float32. Unlike the TPU kernel, Tq and Tk need not be
// multiples of the block: the tail rows and keys are masked. Key blocks are
// aligned to absolute key 0 whatever Tq, and a block wholly masked for a row
// leaves it exactly as it was (a first one is wiped by the next one's alpha
// of 0), so on the FMA path a row's result does not depend on where a chunk
// of the prompt began.
//
// What bounds it on an H100: operations. At the main path's prefill (B = 4,
// H = 32, kv = 8, T = 8192, d = 128) the causal half of Q K^T and P V is
// ~2.2e12 FLOP (~2.2 ms at the bf16 tensor-core peak of 989 TFLOP/s) against
// ~0.5 GB of bytes.
//
// Both paths: one block per query block (64 rows on the FMA path, 128 on
// the tensor-core path) of one head and request, looping over 64-key blocks
// from the first one the window reaches to the last one the causal mask
// reaches from the block's last row, so the upper triangle is never computed
// (the TPU kernel's block skip). The grid walks query blocks from the last
// (the longest causal row) to the first, so the heaviest blocks start
// first. Strides are parameters (the last dim contiguous), so the model
// hands over its (B, T, H, d) tensors as transposed views and gets its
// output in the same layout, without a copy.
//
// bfloat16 inputs with d = 64 or 128 (the main path) take the tensor cores
// through Hopper's wgmma, fed by TMA: one block per 128 query rows of one
// head, three warpgroups. Warpgroup 2 is the producer: one thread loads the
// Q tile once, then K and V tiles of 64 keys into a ring of 5 stages (6 at
// d = 64) guarded by full and empty mbarriers, so the loads of the next
// tiles are in flight while the current one is computed and no consumer
// calls __syncthreads in the key loop. Tiles arrive 128-byte swizzled in
// panels of 64 channels (the swizzle's row limit), from tensor maps built
// on the views' own strides (Q's extent Tq rows, K's and V's Tk); rows past
// either arrive as zeros. Warpgroups 0 and
// 1 own 64 query rows each: S = Q K^T by wgmma m64n64k16 with both
// operands read from shared memory, the online softmax in registers on the
// accumulator layout in the log2 domain (on a tile that needs no mask and
// no softcap, scale * log2 e folds into the exponent's FMA; with a softcap
// the tanh acts on the scaled score first; row maxima and sums reduce as
// trees, for the instruction-level parallelism two warps an SM partition
// need), then
// O += P V by wgmma m64nDk16 with P from registers and V read MN-major
// (the descriptor's transpose), so no transposed copy exists. P goes as
// its bfloat16 rounding plus the bfloat16 rounding of the remainder, two
// products into one accumulator: hi + lo carries 16 significant bits, so
// the result stays within float32-level error of the plain version; a
// single bfloat16 P misses the tolerance (1.5x the tensor work, kept on
// purpose). Each warpgroup pipelines its tiles: it issues S of tile i and
// then P V of tile i - 1, and runs tile i's softmax while the second
// product is on the tensor cores (setmaxnreg gives a consumer thread 240
// registers, the producer 24). Blocks run heaviest query block first, and
// the G heads of one KV head sit next to each other in the launch order, so
// their K/V tiles are read from device memory about once and from L2 after.
//
// float32 inputs, and d = 256, take the float32 FMA units (67 TFLOP/s peak):
// 256 threads per block; Q, K, V tiles and the probability tile live in
// shared memory as float32 (rows padded by 4 floats: 16-byte aligned, and
// the 16-byte column reads of 16 neighbouring rows spread over all banks).
// Each thread holds a 4 x 4 tile of scores (rows 4*ty .. 4*ty+3, keys tx +
// 16*j) and a 4 x (d/16) tile of the output (columns 4*tx + 64*c ..), so
// every 16-byte shared-memory read feeds 4 to 8 FMAs; the row statistics
// reduce over the 16 tx lanes of a half-warp with shuffles.
//
// d = 80 (stablelm-3b) runs either path's d = 128 instance with dv = 80 valid
// channels: 160-byte rows do not fill the 128-byte swizzle's panels of 64
// channels, so the tiles stay 128 channels wide and the channels past 80
// arrive as zeros (TMA fills the columns past the tensor map's extent of 80
// with zeros; the FMA path's staging writes zeros there). Zeros add nothing
// to Q K^T and give zero output columns, which are not written: the result
// is the d = 80 attention, at the tensor work of d = 128.

#include <cuda.h>   // CUtensorMap and its enums only: libcuda is not linked

#include <type_traits>

#include "common.cuh"

namespace freekv {
namespace {

constexpr int kBQ = 64;
constexpr int kBK = 64;
constexpr int kThreads = 256;     // 16 x 16
constexpr int kPS = kBK + 4;      // probability tile row stride (floats)

// rows [r0, r0 + n) of a (rows, dv) slab at `base` (row stride `rs`
// elements, dv <= D contiguous) into shared memory as float32 rows of
// `D + 4`; rows at or past `limit`, and channels at or past dv, become zeros.
template <typename T, int D, int kRows>
__device__ __forceinline__ void stage(const T* __restrict__ base, long long rs, int r0,
                                      int limit, int dv, float* __restrict__ dst) {
  constexpr int kVec = 16 / sizeof(T);
  constexpr int kPerRow = D / kVec;
  constexpr int kST = D + 4;
  for (int i = threadIdx.x; i < kRows * kPerRow; i += kThreads) {
    const int r = i / kPerRow, c0 = (i % kPerRow) * kVec;
    float4* out = reinterpret_cast<float4*>(dst + r * kST + c0);
    if (r0 + r < limit && c0 < dv) {
      const uint4 raw = *reinterpret_cast<const uint4*>(base + (r0 + r) * rs + c0);
      const T* vals = reinterpret_cast<const T*>(&raw);
#pragma unroll
      for (int j = 0; j < kVec / 4; ++j)
        out[j] = make_float4(to_f32(vals[4 * j]), to_f32(vals[4 * j + 1]),
                             to_f32(vals[4 * j + 2]), to_f32(vals[4 * j + 3]));
    } else {
#pragma unroll
      for (int j = 0; j < kVec / 4; ++j) out[j] = make_float4(0.f, 0.f, 0.f, 0.f);
    }
  }
}

__device__ __forceinline__ float half_warp_max(float x) {
#pragma unroll
  for (int off = 8; off > 0; off >>= 1) x = fmaxf(x, __shfl_xor_sync(0xffffffffu, x, off));
  return x;
}

__device__ __forceinline__ float half_warp_sum(float x) {
#pragma unroll
  for (int off = 8; off > 0; off >>= 1) x += __shfl_xor_sync(0xffffffffu, x, off);
  return x;
}

struct Strides {
  long long b, h, t;
};

template <typename T, int D>
__global__ void __launch_bounds__(kThreads)
flash_prefill_kernel(const T* __restrict__ q, const T* __restrict__ k, const T* __restrict__ v,
                     T* __restrict__ out, int G, int Tq, int Tk, Strides qs, Strides ks,
                     Strides vs, Strides os, float scale, float softcap, int causal,
                     int window, int dv) {
  constexpr int kST = D + 4;
  constexpr int kCols = D / 64;   // float4 output columns per thread
  extern __shared__ float4 smem4[];
  float* Qs = reinterpret_cast<float*>(smem4);
  float* Ks = Qs + kBQ * kST;
  float* Vs = Ks + kBK * kST;
  float* Ps = Vs + kBK * kST;

  const int n_qb = (Tq + kBQ - 1) / kBQ;
  const int qb = n_qb - 1 - blockIdx.x;
  const int h = blockIdx.y, b = blockIdx.z, hk = h / G;
  const int q0 = qb * kBQ;          // the block's first query row
  const int a0 = Tk - Tq + q0;      // and its absolute position
  const int tx = threadIdx.x & 15, ty = threadIdx.x >> 4;

  const T* kb_base = k + b * ks.b + hk * ks.h;
  const T* vb_base = v + b * vs.b + hk * vs.h;
  stage<T, D, kBQ>(q + b * qs.b + h * qs.h, qs.t, q0, Tq, dv, Qs);

  float m[4], l[4], acc[4][4 * kCols];
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    m[i] = kNegInf;
    l[i] = 0.f;
#pragma unroll
    for (int c = 0; c < 4 * kCols; ++c) acc[i][c] = 0.f;
  }

  // key blocks: from the first one inside the window to the last one at or
  // before the block's last query (causal); the rest are wholly masked
  const int n_kb = (Tk + kBK - 1) / kBK;
  const int kb_end = causal ? min(n_kb, (a0 + kBQ - 1) / kBK + 1) : n_kb;
  int kb_begin = 0;
  if (window > 0) {
    const int x = a0 - window - kBK + 1;
    if (x >= 0) kb_begin = x / kBK + 1;
  }

  for (int kb = kb_begin; kb < kb_end; ++kb) {
    const int k0 = kb * kBK;
    __syncthreads();                                  // previous tiles consumed
    stage<T, D, kBK>(kb_base, ks.t, k0, Tk, dv, Ks);
    stage<T, D, kBK>(vb_base, vs.t, k0, Tk, dv, Vs);
    __syncthreads();

    float s[4][4];
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int j = 0; j < 4; ++j) s[i][j] = 0.f;
#pragma unroll 2
    for (int c = 0; c < D; c += 4) {
      float4 qv[4], kv4[4];
#pragma unroll
      for (int i = 0; i < 4; ++i)
        qv[i] = *reinterpret_cast<const float4*>(Qs + (ty * 4 + i) * kST + c);
#pragma unroll
      for (int j = 0; j < 4; ++j)
        kv4[j] = *reinterpret_cast<const float4*>(Ks + (tx + 16 * j) * kST + c);
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int j = 0; j < 4; ++j) {
          s[i][j] = fmaf(qv[i].x, kv4[j].x, s[i][j]);
          s[i][j] = fmaf(qv[i].y, kv4[j].y, s[i][j]);
          s[i][j] = fmaf(qv[i].z, kv4[j].z, s[i][j]);
          s[i][j] = fmaf(qv[i].w, kv4[j].w, s[i][j]);
        }
    }

#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const int tq = a0 + ty * 4 + i;
      float mx = kNegInf;
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const int tk = k0 + tx + 16 * j;
        float x = s[i][j] * scale;
        if (softcap > 0.f) x = softcap * tanhf(x / softcap);
        const bool ok = tk < Tk && (!causal || tk <= tq) && (window <= 0 || tk > tq - window);
        s[i][j] = ok ? x : kNegInf;
        mx = fmaxf(mx, s[i][j]);
      }
      const float m_new = fmaxf(m[i], half_warp_max(mx));
      const float alpha = expf(m[i] - m_new);
      float sum = 0.f;
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        s[i][j] = expf(s[i][j] - m_new);
        sum += s[i][j];
      }
      l[i] = l[i] * alpha + half_warp_sum(sum);
      m[i] = m_new;
#pragma unroll
      for (int c = 0; c < 4 * kCols; ++c) acc[i][c] *= alpha;
#pragma unroll
      for (int j = 0; j < 4; ++j) Ps[(ty * 4 + i) * kPS + tx + 16 * j] = s[i][j];
    }
    __syncthreads();

#pragma unroll 2
    for (int kk = 0; kk < kBK; kk += 4) {
      float4 pv[4];
#pragma unroll
      for (int i = 0; i < 4; ++i)
        pv[i] = *reinterpret_cast<const float4*>(Ps + (ty * 4 + i) * kPS + kk);
#pragma unroll
      for (int u = 0; u < 4; ++u) {
#pragma unroll
        for (int cc = 0; cc < kCols; ++cc) {
          const float4 vv =
              *reinterpret_cast<const float4*>(Vs + (kk + u) * kST + cc * 64 + tx * 4);
#pragma unroll
          for (int i = 0; i < 4; ++i) {
            const float pw = u == 0 ? pv[i].x : u == 1 ? pv[i].y : u == 2 ? pv[i].z : pv[i].w;
            acc[i][cc * 4 + 0] = fmaf(pw, vv.x, acc[i][cc * 4 + 0]);
            acc[i][cc * 4 + 1] = fmaf(pw, vv.y, acc[i][cc * 4 + 1]);
            acc[i][cc * 4 + 2] = fmaf(pw, vv.z, acc[i][cc * 4 + 2]);
            acc[i][cc * 4 + 3] = fmaf(pw, vv.w, acc[i][cc * 4 + 3]);
          }
        }
      }
    }
  }

  T* ob = out + b * os.b + h * os.h;
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int r = q0 + ty * 4 + i;
    if (r >= Tq) continue;
    const float li = fmaxf(l[i], 1e-30f);
    T* orow = ob + r * os.t;
#pragma unroll
    for (int cc = 0; cc < kCols; ++cc)
#pragma unroll
      for (int e = 0; e < 4; ++e)
        if (cc * 64 + tx * 4 + e < dv) orow[cc * 64 + tx * 4 + e] = from_f32<T>(acc[i][cc * 4 + e] / li);
  }
}

// ---------------------------------------------------------------------------
// bfloat16 inputs, d in {64, 128}: warp-specialised wgmma + TMA
// ---------------------------------------------------------------------------
constexpr int kWBQ = 128;        // query rows per block: two consumer warpgroups of 64
constexpr int kWBK = 64;         // keys per tile
constexpr int kWThreads = 384;   // warpgroups 0 and 1 compute, warpgroup 2 loads
constexpr int kPanel = 64;       // bf16 columns per 128-byte swizzled row: one TMA box
constexpr int kRowBytes = 128;

// d channels; a ring of kStages K and V tiles, as deep as shared memory
// allows
template <int D>
struct WgmmaCfg {
  static constexpr int kPanels = D / kPanel;
  static constexpr int kStages = D == 64 ? 6 : 5;
  static constexpr int kQPanel = kWBQ * kRowBytes;       // bytes of one Q panel
  static constexpr int kTPanel = kWBK * kRowBytes;       // bytes of one K or V panel
  static constexpr int kTile = kPanels * kTPanel;        // one K (or V) tile
  static constexpr int kKOff = kPanels * kQPanel;
  static constexpr int kVOff = kKOff + kStages * kTile;
  static constexpr int kBarOff = kVOff + kStages * kTile;
  static constexpr size_t kSmem = kBarOff + (2 * kStages + 1) * 8 + 1024;   // + alignment
};

__device__ __forceinline__ void wgmma_fence() {
  asm volatile("wgmma.fence.sync.aligned;\n" ::: "memory");
}
__device__ __forceinline__ void wgmma_commit() {
  asm volatile("wgmma.commit_group.sync.aligned;\n" ::: "memory");
}
// returns once at most N committed wgmma groups are still running
template <int N>
__device__ __forceinline__ void wgmma_wait() {
  asm volatile("wgmma.wait_group.sync.aligned %0;\n" ::"n"(N) : "memory");
}
// keeps the compiler from moving reads or writes of an accumulator across
// the asynchronous wgmma that owns it
template <int N>
__device__ __forceinline__ void reg_fence(float (&r)[N]) {
#pragma unroll
  for (int i = 0; i < N; ++i) asm volatile("" : "+f"(r[i])::"memory");
}

// wgmma shared-memory descriptor, 128-byte swizzle: start address, leading
// and stride byte offsets, all in 16-byte units
__device__ __forceinline__ uint64_t sw128_desc(uint32_t addr, uint32_t lbo, uint32_t sbo) {
  return static_cast<uint64_t>((addr & 0x3FFFF) >> 4) | (static_cast<uint64_t>(lbo >> 4) << 16) |
         (static_cast<uint64_t>(sbo >> 4) << 32) | (1ull << 62);
}

__device__ __forceinline__ void tma_load_4d(uint32_t dst, const CUtensorMap* map, uint32_t bar,
                                            int c0, int c1, int c2, int c3) {
  asm volatile(
      "cp.async.bulk.tensor.4d.shared::cluster.global.mbarrier::complete_tx::bytes "
      "[%0], [%1, {%3, %4, %5, %6}], [%2];\n" ::"r"(dst),
      "l"(reinterpret_cast<uint64_t>(map)), "r"(bar), "r"(c0), "r"(c1), "r"(c2), "r"(c3)
      : "memory");
}

__device__ __forceinline__ uint32_t pack_bf16(__nv_bfloat16 lo, __nv_bfloat16 hi) {
  return static_cast<uint32_t>(__bfloat16_as_ushort(lo)) |
         (static_cast<uint32_t>(__bfloat16_as_ushort(hi)) << 16);
}

// (x, y) -> their bfloat16 roundings (hi) and the bfloat16 roundings of what
// those missed (lo): hi + lo carries 16 significant bits, so P @ V from the
// two products is within ~2^-17 of the float32 product
__device__ __forceinline__ void split_bf16(float x, float y, uint32_t& hi, uint32_t& lo) {
  const __nv_bfloat162 h = __floats2bfloat162_rn(x, y);
  const float2 hf = __bfloat1622float2(h);
  const __nv_bfloat162 r = __floats2bfloat162_rn(x - hf.x, y - hf.y);
  hi = *reinterpret_cast<const uint32_t*>(&h);
  lo = *reinterpret_cast<const uint32_t*>(&r);
}

// D (64 x 64, float32) (+)= A (64 x 16) * B (64 x 16)^T, both bf16 K-major in
// shared memory behind 128B-swizzled descriptors; scale_d 0 overwrites D
__device__ __forceinline__ void wgmma_ss_n64(float (&d)[32], uint64_t da, uint64_t db,
                                             int scale_d) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %34, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31}"
      ", %32, %33, p, 1, 1, 0, 0;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]),
        "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]),
        "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]), "+f"(d[16]), "+f"(d[17]),
        "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]),
        "+f"(d[30]), "+f"(d[31])
      : "l"(da), "l"(db), "r"(scale_d));
}

// D (64 x 64, float32) += A (64 x 16, bf16 fragments in registers) * B (16 x 64),
// B bf16 MN-major in shared memory (transposed on the way) behind a
// 128B-swizzled descriptor
__device__ __forceinline__ void wgmma_rs_n64(float (&d)[32], const uint32_t (&a)[4],
                                             uint64_t db) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %37, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31}"
      ", {%32, %33, %34, %35}, %36, p, 1, 1, 1;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]),
        "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]),
        "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]), "+f"(d[16]), "+f"(d[17]),
        "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]),
        "+f"(d[30]), "+f"(d[31])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db), "r"(1));
}

// D (64 x 128, float32) += A (64 x 16, bf16 fragments in registers) * B (16 x 128),
// B bf16 MN-major in shared memory (transposed on the way) behind a
// 128B-swizzled descriptor
__device__ __forceinline__ void wgmma_rs_n128(float (&d)[64], const uint32_t (&a)[4],
                                             uint64_t db) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %69, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31, "
      "%32, %33, %34, %35, %36, %37, %38, %39, %40, %41, %42, %43, %44, %45, %46, %47, "
      "%48, %49, %50, %51, %52, %53, %54, %55, %56, %57, %58, %59, %60, %61, %62, %63}"
      ", {%64, %65, %66, %67}, %68, p, 1, 1, 1;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]),
        "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]),
        "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]), "+f"(d[16]), "+f"(d[17]),
        "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]),
        "+f"(d[30]), "+f"(d[31]), "+f"(d[32]), "+f"(d[33]), "+f"(d[34]), "+f"(d[35]),
        "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]), "+f"(d[40]), "+f"(d[41]),
        "+f"(d[42]), "+f"(d[43]), "+f"(d[44]), "+f"(d[45]), "+f"(d[46]), "+f"(d[47]),
        "+f"(d[48]), "+f"(d[49]), "+f"(d[50]), "+f"(d[51]), "+f"(d[52]), "+f"(d[53]),
        "+f"(d[54]), "+f"(d[55]), "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]),
        "+f"(d[60]), "+f"(d[61]), "+f"(d[62]), "+f"(d[63])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db), "r"(1));
}

// One block: 128 query rows of one head. Warpgroup 2 loads (one thread
// issues every TMA copy); warpgroups 0 and 1 each own 64 of the rows.
// Shared memory (1024-byte aligned for the swizzle): Q as D/64 panels of
// 128 rows x 128 bytes, then kStages K tiles and kStages V tiles, each
// D/64 panels of 64 rows x 128 bytes, then the barriers.
template <int D>
__global__ void __launch_bounds__(kWThreads, 1)
flash_prefill_wgmma_kernel(const __grid_constant__ CUtensorMap tm_q,
                           const __grid_constant__ CUtensorMap tm_k,
                           const __grid_constant__ CUtensorMap tm_v,
                           __nv_bfloat16* __restrict__ out, int B, int H, int G, int Tq,
                           int Tk, Strides os, float scale, float softcap, int causal,
                           int window, int dv) {
  using C = WgmmaCfg<D>;
  constexpr int kS = C::kStages;
  extern __shared__ uint8_t smem_w[];
  const uint32_t base = (smem_addr(smem_w) + 1023u) & ~1023u;
  const uint32_t sQ = base, sK = base + C::kKOff, sV = base + C::kVOff;
  const uint32_t bar_full = base + C::kBarOff;    // kS barriers of 8 bytes: tile arrived
  const uint32_t bar_empty = bar_full + 8 * kS;   // kS: tile consumed by all 8 compute warps
  const uint32_t bar_q = bar_empty + 8 * kS;

  // block -> (query block, heaviest first; request; KV head; head of the
  // group): the G heads sharing a KV head and query block are neighbours,
  // so they meet the same K/V tiles in L2
  const int n_qb = (Tq + kWBQ - 1) / kWBQ;
  int id = blockIdx.x;
  const int g = id % G;
  id /= G;
  const int n_kv = H / G;
  const int hk = id % n_kv;
  id /= n_kv;
  const int b = id % B;
  const int qb = n_qb - 1 - id / B;
  const int h = hk * G + g;
  const int q0 = qb * kWBQ;         // the block's first query row
  const int off = Tk - Tq;          // query row r sits at absolute position off + r

  const int n_kb = (Tk + kWBK - 1) / kWBK;
  const int kb_end = causal ? min(n_kb, (off + q0 + kWBQ - 1) / kWBK + 1) : n_kb;
  int kb_begin = 0;
  if (window > 0) {
    const int x = off + q0 - window - kWBK + 1;
    if (x >= 0) kb_begin = x / kWBK + 1;
  }
  const int n_tiles = kb_end - kb_begin;

  if (threadIdx.x == 0) {
    for (int s = 0; s < kS; ++s) {
      mbar_init(bar_full + 8 * s, 1);
      mbar_init(bar_empty + 8 * s, 8);
    }
    mbar_init(bar_q, 1);
    fence_barrier_init();
  }
  __syncthreads();

  if (threadIdx.x >= 256) {
    // producer: Q once, then K and V tiles into the ring; rows past Tq (Q)
    // or Tk (K, V) arrive as zeros
    asm volatile("setmaxnreg.dec.sync.aligned.u32 24;\n" ::: "memory");
    if (threadIdx.x == 256) {
      mbar_expect_tx(bar_q, C::kPanels * C::kQPanel);
      for (int c = 0; c < C::kPanels; ++c)
        tma_load_4d(sQ + c * C::kQPanel, &tm_q, bar_q, c * kPanel, q0, h, b);
      for (int i = 0; i < n_tiles; ++i) {
        const int s = i % kS;
        mbar_wait(bar_empty + 8 * s, ((i / kS) & 1) ^ 1);
        mbar_expect_tx(bar_full + 8 * s, 2 * C::kTile);
        const int k0 = (kb_begin + i) * kWBK;
        for (int c = 0; c < C::kPanels; ++c) {
          tma_load_4d(sK + s * C::kTile + c * C::kTPanel, &tm_k, bar_full + 8 * s, c * kPanel,
                      k0, hk, b);
          tma_load_4d(sV + s * C::kTile + c * C::kTPanel, &tm_v, bar_full + 8 * s, c * kPanel,
                      k0, hk, b);
        }
      }
    }
    return;
  }
  asm volatile("setmaxnreg.inc.sync.aligned.u32 240;\n" ::: "memory");

  // consumers: the wgmma accumulator layout gives each thread rows row0 and
  // row0 + 8, and in each 8-key (or 8-channel) column block j the columns
  // 8 j + 2 t4 and 8 j + 2 t4 + 1
  const int wg = threadIdx.x >> 7;
  const int warp = (threadIdx.x >> 5) & 3, lane = threadIdx.x & 31;
  const int gq = lane >> 2, t4 = lane & 3;
  const int w0 = q0 + wg * 64;                    // this warpgroup's first row
  const int row0 = w0 + warp * 16 + gq, row1 = row0 + 8;
  const int wa0 = off + w0;                       // their absolute positions
  const int pos0 = off + row0, pos1 = pos0 + 8;
  constexpr float kLog2e = 1.4426950408889634f;
  const bool capped = softcap > 0.f;
  // scores in the log2 domain: s * scale * log2(e), or with a softcap
  // softcap * tanh(s * scale / softcap) * log2(e)
  const float pre = capped ? scale / softcap : scale * kLog2e;
  const float post = softcap * kLog2e;

  // the tiles some row of this warpgroup may see: [lb, le); the others add
  // exactly nothing, and are only waited for and released
  int lb = kb_begin, le = kb_end;
  if (window > 0) {
    const int x = wa0 - window - (kWBK - 1);
    if (x >= 0) lb = max(lb, x / kWBK + 1);
  }
  if (causal) le = min(le, (wa0 + 63) / kWBK + 1);
  // at least one tile, so no wgmma sits behind a branch on the warpgroup;
  // it only ever adds to rows past Tq, which are not written
  lb = min(lb, kb_end - 1);
  le = max(le, lb + 1);
  auto stage = [&](int kb) { return (kb - kb_begin) % kS; };
  auto phase = [&](int kb) { return (uint32_t)(((kb - kb_begin) / kS) & 1); };
  auto release = [&](int kb) {
    __syncwarp();
    if (lane == 0) mbar_arrive(bar_empty + 8 * stage(kb));
  };

  float o[D / 2];
#pragma unroll
  for (int i = 0; i < D / 2; ++i) o[i] = 0.f;
  float m[2] = {kNegInf, kNegInf}, l[2] = {0.f, 0.f};
  float sc[kWBK / 2];                               // scores, then probabilities, of one tile
  uint32_t ph[kWBK / 16][4], pl[kWBK / 16][4];        // P as A fragments, bfloat16 hi + lo
  float alpha[2];
  const uint32_t q_wg = sQ + wg * 64 * kRowBytes;

  // S = Q K^T over d in steps of 16 (32 bytes into the swizzled rows)
  auto issue_s = [&](int kb) {
    const uint32_t k_s = sK + stage(kb) * C::kTile;
#pragma unroll
    for (int ks = 0; ks < D / 16; ++ks) {
      const uint32_t off = (ks & 3) * 32;
      const uint64_t dq = sw128_desc(q_wg + (ks >> 2) * C::kQPanel + off, 16, 1024);
      const uint64_t dk = sw128_desc(k_s + (ks >> 2) * C::kTPanel + off, 16, 1024);
      wgmma_ss_n64(sc, dq, dk, ks > 0);
    }
    wgmma_commit();
  };
  // O += P V: V's tile read MN-major (16 keys = 2048 bytes a step; the
  // second 64-channel panel kTPanel bytes on)
  auto issue_pv = [&](int kb) {
    const uint32_t v_s = sV + stage(kb) * C::kTile;
#pragma unroll
    for (int kk = 0; kk < kWBK / 16; ++kk) {
      const uint64_t dv = sw128_desc(v_s + kk * 16 * kRowBytes, C::kTPanel, 1024);
      if constexpr (D == 128) {
        wgmma_rs_n128(o, ph[kk], dv);
        wgmma_rs_n128(o, pl[kk], dv);
      } else {
        wgmma_rs_n64(o, ph[kk], dv);
        wgmma_rs_n64(o, pl[kk], dv);
      }
    }
    wgmma_commit();
  };
  // scale, softcap, mask (only on tiles that cross an edge); the online
  // softmax's statistics; sc becomes the tile's probabilities
  auto softmax = [&](int kb) {
    const int k0 = kb * kWBK;
    // a tile that needs no softcap and crosses no edge keeps its raw scores:
    // the scale folds into the exponent's FMA (max commutes with scale > 0)
    const bool plain = !capped && pre > 0.f && !(causal && k0 + kWBK - 1 > wa0) &&
                       k0 + kWBK <= Tk && !(window > 0 && k0 <= wa0 + 63 - window);
    if (!plain) {
#pragma unroll
      for (int j = 0; j < kWBK / 8; ++j)
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          float x = capped ? post * tanhf(sc[4 * j + e] * pre) : sc[4 * j + e] * pre;
          const int tq = e < 2 ? pos0 : pos1;
          const int tk = k0 + 8 * j + 2 * t4 + (e & 1);
          const bool ok = tk < Tk && (!causal || tk <= tq) && (window <= 0 || tk > tq - window);
          sc[4 * j + e] = ok ? x : kNegInf;
        }
    }
    const float f = plain ? pre : 1.f;
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      // a thread's 16 values of row r: sc[4 j + 2 r] and sc[4 j + 2 r + 1]
      float t[kWBK / 8];
#pragma unroll
      for (int j = 0; j < kWBK / 8; ++j) t[j] = fmaxf(sc[4 * j + 2 * r], sc[4 * j + 2 * r + 1]);
#pragma unroll
      for (int w = kWBK / 16; w > 0; w >>= 1)
#pragma unroll
        for (int j = 0; j < w; ++j) t[j] = fmaxf(t[j], t[j + w]);
      float mx = fmaxf(t[0], __shfl_xor_sync(0xffffffffu, t[0], 1));
      mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, 2));
      const float m_new = fmaxf(m[r], mx * f);
      alpha[r] = fast_exp2(m[r] - m_new);
      m[r] = m_new;
#pragma unroll
      for (int j = 0; j < kWBK / 8; ++j) {
        sc[4 * j + 2 * r] = fast_exp2(fmaf(sc[4 * j + 2 * r], f, -m_new));
        sc[4 * j + 2 * r + 1] = fast_exp2(fmaf(sc[4 * j + 2 * r + 1], f, -m_new));
        t[j] = sc[4 * j + 2 * r] + sc[4 * j + 2 * r + 1];
      }
#pragma unroll
      for (int w = kWBK / 16; w > 0; w >>= 1)
#pragma unroll
        for (int j = 0; j < w; ++j) t[j] += t[j + w];
      l[r] = l[r] * alpha[r] + t[0];
    }
  };
  // O *= alpha, and P into A fragments (the accumulator layout is the A
  // operand's)
  auto rescale_split = [&]() {
#pragma unroll
    for (int j = 0; j < D / 8; ++j) {
      o[4 * j] *= alpha[0];
      o[4 * j + 1] *= alpha[0];
      o[4 * j + 2] *= alpha[1];
      o[4 * j + 3] *= alpha[1];
    }
#pragma unroll
    for (int kk = 0; kk < kWBK / 16; ++kk)
#pragma unroll
      for (int r = 0; r < 4; ++r)
        split_bf16(sc[8 * kk + 2 * r], sc[8 * kk + 2 * r + 1], ph[kk][r], pl[kk][r]);
  };

  // ping-pong: the two warpgroups take turns to issue their products
  // (named barriers 1 and 2), so one's softmax runs under the other's
  // products. Each takes one turn per tile of the block and one more;
  // warpgroup 1 opens warpgroup 0's first turn and sends its own last
  // arrival to barrier 3, which it alone completes (no branch on wg: a
  // wgmma behind a branch the compiler sees as divergent is serialized).
  auto turn_take = [&]() {
    asm volatile("bar.sync %0, 256;\n" ::"r"(1 + wg) : "memory");
  };
  auto turn_give = [&](bool last) {
    const bool alone = last && wg == 1;
    asm volatile("bar.arrive %0, %1;\n" ::"r"(alone ? 3 : 2 - wg), "r"(alone ? 128 : 256)
                 : "memory");
  };
  auto skip = [&](int kb) {                       // a tile this warpgroup does not compute
    mbar_wait(bar_full + 8 * stage(kb), phase(kb));
    turn_take();
    turn_give(false);
    release(kb);
  };

  mbar_wait(bar_q, 0);
  // warpgroup 1 opens warpgroup 0's first turn; warpgroup 0 arrives at 3 alone
  asm volatile("bar.arrive %0, %1;\n" ::"r"(wg == 1 ? 1 : 3), "r"(wg == 1 ? 256 : 128)
               : "memory");
  for (int kb = kb_begin; kb < lb; ++kb) skip(kb);
  {
    mbar_wait(bar_full + 8 * stage(lb), phase(lb));
    wgmma_fence();
    turn_take();
    issue_s(lb);
    turn_give(false);
    wgmma_wait<0>();
    reg_fence(sc);
    softmax(lb);
    rescale_split();
    // software pipeline: the tensor cores run S of tile kb, then P V of tile
    // kb - 1, while this warpgroup does tile kb's softmax
    for (int kb = lb + 1; kb < le; ++kb) {
      mbar_wait(bar_full + 8 * stage(kb), phase(kb));
      reg_fence(sc);
      reg_fence(o);
      wgmma_fence();
      turn_take();
      issue_s(kb);
      issue_pv(kb - 1);
      turn_give(false);
      wgmma_wait<1>();
      reg_fence(sc);
      softmax(kb);
      wgmma_wait<0>();
      reg_fence(o);
      release(kb - 1);
      rescale_split();
    }
  }
  for (int kb = le; kb < kb_end; ++kb) skip(kb);
  turn_take();
  reg_fence(o);
  wgmma_fence();
  issue_pv(le - 1);
  turn_give(true);
  wgmma_wait<0>();
  reg_fence(o);
  release(le - 1);

#pragma unroll
  for (int r = 0; r < 2; ++r) {
    l[r] += __shfl_xor_sync(0xffffffffu, l[r], 1);
    l[r] += __shfl_xor_sync(0xffffffffu, l[r], 2);
  }
  __nv_bfloat16* oh = out + b * os.b + h * os.h;
  const float inv_l[2] = {1.f / fmaxf(l[0], 1e-30f), 1.f / fmaxf(l[1], 1e-30f)};
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    const int tq = r ? row1 : row0;
    if (tq >= Tq) continue;
    __nv_bfloat16* orow = oh + tq * os.t;
#pragma unroll
    for (int j = 0; j < D / 8; ++j)
      if (8 * j < dv)
        *reinterpret_cast<uint32_t*>(orow + 8 * j + 2 * t4) =
          pack_bf16(__float2bfloat16_rn(o[4 * j + 2 * r] * inv_l[r]),
                    __float2bfloat16_rn(o[4 * j + 2 * r + 1] * inv_l[r]));
  }
}

// cuTensorMapEncodeTiled, reached through the runtime so that no library
// beyond the CUDA runtime is linked
using EncodeTiled = CUresult (*)(CUtensorMap*, CUtensorMapDataType, cuuint32_t, void*,
                                 const cuuint64_t*, const cuuint64_t*, const cuuint32_t*,
                                 const cuuint32_t*, CUtensorMapInterleave, CUtensorMapSwizzle,
                                 CUtensorMapL2promotion, CUtensorMapFloatOOBfill);

EncodeTiled encode_tiled() {
  static const EncodeTiled fn = [] {
    void* p = nullptr;
    cudaDriverEntryPointQueryResult found;
#if CUDART_VERSION >= 12050
    const cudaError_t err = cudaGetDriverEntryPointByVersion("cuTensorMapEncodeTiled", &p, 12000,
                                                             cudaEnableDefault, &found);
#else
    const cudaError_t err =
        cudaGetDriverEntryPoint("cuTensorMapEncodeTiled", &p, cudaEnableDefault, &found);
#endif
    return err == cudaSuccess && found == cudaDriverEntryPointSuccess
               ? reinterpret_cast<EncodeTiled>(p)
               : nullptr;
  }();
  return fn;
}

// a (B, heads, T_len, D) bf16 view with element strides `st` (D contiguous)
// as a 4-D tensor map whose box is 64 channels x `rows` tokens of one head,
// 128-byte swizzled; rows past T_len, and channels past D, read as zeros
bool make_map(EncodeTiled encode, CUtensorMap* map, const void* ptr, int B, int heads, int T_len,
              int D, Strides st, int rows) {
  const cuuint64_t dims[4] = {(cuuint64_t)D, (cuuint64_t)T_len, (cuuint64_t)heads,
                              (cuuint64_t)B};
  const cuuint64_t strides[3] = {(cuuint64_t)st.t * 2, (cuuint64_t)st.h * 2,
                                 (cuuint64_t)st.b * 2};
  const cuuint32_t box[4] = {(cuuint32_t)kPanel, (cuuint32_t)rows, 1, 1};
  const cuuint32_t unit[4] = {1, 1, 1, 1};
  return encode(map, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, 4, const_cast<void*>(ptr), dims, strides,
                box, unit, CU_TENSOR_MAP_INTERLEAVE_NONE, CU_TENSOR_MAP_SWIZZLE_128B,
                CU_TENSOR_MAP_L2_PROMOTION_L2_256B,
                CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE) == CUDA_SUCCESS;
}

template <int D>
cudaError_t launch_wgmma(const void* q, const void* k, const void* v, void* out, int B, int H,
                         int G, int Tq, int Tk, Strides qs, Strides ks, Strides vs, Strides os,
                         float scale, float softcap, int causal, int window, int dv, int device,
                         cudaStream_t st) {
  using C = WgmmaCfg<D>;
  constexpr auto kernel = flash_prefill_wgmma_kernel<D>;
  const EncodeTiled encode = encode_tiled();
  if (encode == nullptr) return cudaErrorSymbolNotFound;
  // TMA takes strides below 2^40 bytes and a (B, heads, T) grid of boxes
  for (long long s : {qs.b, qs.h, qs.t, ks.b, ks.h, ks.t, vs.b, vs.h, vs.t})
    if (s <= 0 || s >= (1ll << 39)) return cudaErrorInvalidValue;
  CUtensorMap tm_q, tm_k, tm_v;
  if (!make_map(encode, &tm_q, q, B, H, Tq, dv, qs, kWBQ) ||
      !make_map(encode, &tm_k, k, B, H / G, Tk, dv, ks, kWBK) ||
      !make_map(encode, &tm_v, v, B, H / G, Tk, dv, vs, kWBK))
    return cudaErrorInvalidValue;
  const cudaError_t err = allow_smem<kernel>(C::kSmem, device);
  if (err != cudaSuccess) return err;
  const long long blocks = (long long)((Tq + kWBQ - 1) / kWBQ) * B * H;
  if (blocks > 0x7fffffffll) return cudaErrorInvalidValue;
  kernel<<<(unsigned)blocks, kWThreads, C::kSmem, st>>>(
      tm_q, tm_k, tm_v, static_cast<__nv_bfloat16*>(out), B, H, G, Tq, Tk, os, scale, softcap,
      causal, window, dv);
  return cudaGetLastError();
}

template <typename T, int D>
cudaError_t launch(const void* q, const void* k, const void* v, void* out, int B, int H,
                   int G, int Tq, int Tk, Strides qs, Strides ks, Strides vs, Strides os,
                   float scale, float softcap, int causal, int window, int dv, int device,
                   cudaStream_t st) {
  constexpr size_t kSmem = sizeof(float) * ((size_t)(kBQ + 2 * kBK) * (D + 4) + kBQ * kPS);
  const cudaError_t err = allow_smem<flash_prefill_kernel<T, D>>(kSmem, device);
  if (err != cudaSuccess) return err;
  const dim3 grid((Tq + kBQ - 1) / kBQ, H, B);
  flash_prefill_kernel<T, D><<<grid, kThreads, kSmem, st>>>(
      static_cast<const T*>(q), static_cast<const T*>(k), static_cast<const T*>(v),
      static_cast<T*>(out), G, Tq, Tk, qs, ks, vs, os, scale, softcap, causal, window, dv);
  return cudaGetLastError();
}

// float32: the FMA path at every d; bfloat16: the wgmma path at d = 64, 80
// and 128, the FMA path at d = 256; d = 80 runs the d = 128 instances with
// the channels past 80 as zeros
template <typename T>
cudaError_t dispatch_d(int d, const void* q, const void* k, const void* v, void* out, int B,
                       int H, int G, int Tq, int Tk, Strides qs, Strides ks, Strides vs,
                       Strides os, float scale, float softcap, int causal, int window,
                       int device, cudaStream_t st) {
  constexpr bool kTensor = std::is_same<T, __nv_bfloat16>::value;
  switch (d) {
    case 64:
      return kTensor ? launch_wgmma<64>(q, k, v, out, B, H, G, Tq, Tk, qs, ks, vs, os, scale,
                                        softcap, causal, window, d, device, st)
                     : launch<float, 64>(q, k, v, out, B, H, G, Tq, Tk, qs, ks, vs, os, scale,
                                         softcap, causal, window, d, device, st);
    case 80:
    case 128:
      return kTensor ? launch_wgmma<128>(q, k, v, out, B, H, G, Tq, Tk, qs, ks, vs, os, scale,
                                         softcap, causal, window, d, device, st)
                     : launch<float, 128>(q, k, v, out, B, H, G, Tq, Tk, qs, ks, vs, os, scale,
                                          softcap, causal, window, d, device, st);
    case 256:
      return launch<T, 256>(q, k, v, out, B, H, G, Tq, Tk, qs, ks, vs, os, scale, softcap,
                            causal, window, d, device, st);
    default:
      return cudaErrorInvalidValue;
  }
}

}  // namespace
}  // namespace freekv

// strides: (batch, head, token) of q, k, v, out in elements, the last dim
// contiguous; every row 16-byte aligned. q and out hold Tq tokens, k and v
// Tk >= Tq (the query rows are the last Tq positions). d in {64, 80, 128, 256};
// H a multiple of kv (G = H / kv). softcap <= 0 means none, window <= 0
// none, causal 0 / 1. Returns the launch's cudaError_t.
extern "C" int freekv_flash_prefill(const void* q, const void* k, const void* v, void* out,
                                    int B, int H, int G, int Tq, int Tk, int d,
                                    const long long* strides, float scale, float softcap,
                                    int causal, int window, int dtype, int device,
                                    void* stream) {
  using namespace freekv;
  const int elem = dtype == kBFloat16 ? 2 : 4;
  if (B < 1 || H < 1 || G < 1 || H % G || Tq < 1 || Tk < Tq || B > 65535 || H > 65535)
    return cudaErrorInvalidValue;
  if ((reinterpret_cast<uintptr_t>(q) | reinterpret_cast<uintptr_t>(k) |
       reinterpret_cast<uintptr_t>(v) | reinterpret_cast<uintptr_t>(out)) % 16)
    return cudaErrorMisalignedAddress;
  for (int i = 0; i < 12; ++i)
    if ((strides[i] * elem) % 16) return cudaErrorMisalignedAddress;
  const Strides qs{strides[0], strides[1], strides[2]}, ks{strides[3], strides[4], strides[5]},
      vs{strides[6], strides[7], strides[8]}, os{strides[9], strides[10], strides[11]};
  const DeviceGuard guard(device);
  if (guard.error() != cudaSuccess) return guard.error();
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (dtype == kFloat32)
    return dispatch_d<float>(d, q, k, v, out, B, H, G, Tq, Tk, qs, ks, vs, os, scale, softcap,
                             causal, window, device, st);
  if (dtype == kBFloat16)
    return dispatch_d<__nv_bfloat16>(d, q, k, v, out, B, H, G, Tq, Tk, qs, ks, vs, os, scale,
                                     softcap, causal, window, device, st);
  return cudaErrorInvalidValue;
}
