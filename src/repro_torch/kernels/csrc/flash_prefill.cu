// Causal GQA flash attention for prefill.
//
// Replaces the Pallas TPU kernel repro/kernels/flash_prefill.py, function
// flash_prefill (body _kernel: grid (B, H, T/blq, T/blk), the K/V index map
// folding the GQA group, running (m, l, acc) in VMEM scratch, KV blocks that
// are wholly masked skipped with pl.when). Contract: q (B, H, T, d), k and v
// (B, kv, T, d), head h reading KV head h / (H / kv) -> out (B, H, T, d) in
// q's dtype. Scores are (q . k) * scale, then softcap * tanh(s / softcap)
// when softcap > 0, then masked to -1e30 where the key is past the query
// (causal), at or before query - window (window > 0), or past T. Online
// softmax exactly as the TPU kernel: m_new = max(m, rowmax s), alpha =
// exp(m - m_new), l = l * alpha + rowsum exp(s - m_new), acc = acc * alpha +
// exp(s - m_new) @ v; out = acc / max(l, 1e-30). Scores, statistics and
// accumulators are float32. Unlike the TPU kernel, T need not be a multiple
// of the block: the tail rows and keys are masked.
//
// What bounds it on an H100: operations. At the main path's prefill (B = 4,
// H = 32, kv = 8, T = 8192, d = 128) the causal half of Q K^T and P V is
// ~2.2e12 FLOP (~2.2 ms at the bf16 tensor-core peak of 989 TFLOP/s) against
// ~0.5 GB of bytes.
//
// Both paths: one block per (query block of 64 rows, head, request),
// looping over 64-key blocks from the first one the window reaches to the
// last one the causal mask reaches, so the upper triangle is never computed
// (the TPU kernel's block skip). The grid walks query blocks from the last
// (the longest causal row) to the first, so the heaviest blocks start
// first. Strides are parameters (the last dim contiguous), so the model
// hands over its (B, T, H, d) tensors as transposed views and gets its
// output in the same layout, without a copy.
//
// bfloat16 inputs with d = 64 or 128 (the main path) take the tensor cores:
// four warps of 16 query rows each, mma.sync m16n8k16 with float32 sums.
// Q K^T is exact products summed in float32. For P @ V the float32
// probabilities are split into a bfloat16 part and the bfloat16 rounding of
// the remainder, two products whose sum carries 16 significant bits, so the
// result stays within float32-level error of the plain version instead of
// bfloat16's 2^-9 (a 1.5x cost in tensor-core work). K and V tiles arrive by
// cp.async into a two-stage shared-memory ring (rows padded by 8 elements:
// the fragment loads of 8 rows x 4 lanes, and ldmatrix's 8 rows, hit 32
// distinct banks); the probabilities go from the score accumulators to the
// A operand in registers, and V's B operand comes through ldmatrix.trans.
// wgmma and TMA are the later step toward the bound.
//
// float32 inputs, and d = 256, take the float32 FMA units (67 TFLOP/s peak):
// 256 threads per block; Q, K, V tiles and the probability tile live in
// shared memory as float32 (rows padded by 4 floats: 16-byte aligned, and
// the 16-byte column reads of 16 neighbouring rows spread over all banks).
// Each thread holds a 4 x 4 tile of scores (rows 4*ty .. 4*ty+3, keys tx +
// 16*j) and a 4 x (d/16) tile of the output (columns 4*tx + 64*c ..), so
// every 16-byte shared-memory read feeds 4 to 8 FMAs; the row statistics
// reduce over the 16 tx lanes of a half-warp with shuffles.

#include <type_traits>

#include "common.cuh"

namespace freekv {
namespace {

constexpr int kBQ = 64;
constexpr int kBK = 64;
constexpr int kThreads = 256;     // 16 x 16
constexpr int kPS = kBK + 4;      // probability tile row stride (floats)

// rows [r0, r0 + n) of a (rows, D) slab at `base` (row stride `rs`
// elements, D contiguous) into shared memory as float32 rows of `D + 4`;
// rows at or past `limit` become zeros.
template <typename T, int D, int kRows>
__device__ __forceinline__ void stage(const T* __restrict__ base, long long rs, int r0,
                                      int limit, float* __restrict__ dst) {
  constexpr int kVec = 16 / sizeof(T);
  constexpr int kPerRow = D / kVec;
  constexpr int kST = D + 4;
  for (int i = threadIdx.x; i < kRows * kPerRow; i += kThreads) {
    const int r = i / kPerRow, c0 = (i % kPerRow) * kVec;
    float4* out = reinterpret_cast<float4*>(dst + r * kST + c0);
    if (r0 + r < limit) {
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
                     T* __restrict__ out, int G, int T_len, Strides qs, Strides ks,
                     Strides vs, Strides os, float scale, float softcap, int causal,
                     int window) {
  constexpr int kST = D + 4;
  constexpr int kCols = D / 64;   // float4 output columns per thread
  extern __shared__ float4 smem4[];
  float* Qs = reinterpret_cast<float*>(smem4);
  float* Ks = Qs + kBQ * kST;
  float* Vs = Ks + kBK * kST;
  float* Ps = Vs + kBK * kST;

  const int n_qb = (T_len + kBQ - 1) / kBQ;
  const int qb = n_qb - 1 - blockIdx.x;
  const int h = blockIdx.y, b = blockIdx.z, hk = h / G;
  const int q0 = qb * kBQ;
  const int tx = threadIdx.x & 15, ty = threadIdx.x >> 4;

  const T* kb_base = k + b * ks.b + hk * ks.h;
  const T* vb_base = v + b * vs.b + hk * vs.h;
  stage<T, D, kBQ>(q + b * qs.b + h * qs.h, qs.t, q0, T_len, Qs);

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
  const int n_kb = (T_len + kBK - 1) / kBK;
  const int kb_end = causal ? min(n_kb, (q0 + kBQ - 1) / kBK + 1) : n_kb;
  int kb_begin = 0;
  if (window > 0) {
    const int x = q0 - window - kBK + 1;
    if (x >= 0) kb_begin = x / kBK + 1;
  }

  for (int kb = kb_begin; kb < kb_end; ++kb) {
    const int k0 = kb * kBK;
    __syncthreads();                                  // previous tiles consumed
    stage<T, D, kBK>(kb_base, ks.t, k0, T_len, Ks);
    stage<T, D, kBK>(vb_base, vs.t, k0, T_len, Vs);
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
      const int tq = q0 + ty * 4 + i;
      float mx = kNegInf;
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const int tk = k0 + tx + 16 * j;
        float x = s[i][j] * scale;
        if (softcap > 0.f) x = softcap * tanhf(x / softcap);
        const bool ok = tk < T_len && (!causal || tk <= tq) && (window <= 0 || tk > tq - window);
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
    const int tq = q0 + ty * 4 + i;
    if (tq >= T_len) continue;
    const float li = fmaxf(l[i], 1e-30f);
    T* orow = ob + tq * os.t;
#pragma unroll
    for (int cc = 0; cc < kCols; ++cc)
#pragma unroll
      for (int e = 0; e < 4; ++e)
        orow[cc * 64 + tx * 4 + e] = from_f32<T>(acc[i][cc * 4 + e] / li);
  }
}

// ---------------------------------------------------------------------------
// bfloat16 inputs, d in {64, 128}: tensor-core tiles (mma.sync m16n8k16)
// ---------------------------------------------------------------------------
constexpr int kMBQ = 64;          // 4 warps x 16 query rows
constexpr int kMBK = 64;
constexpr int kMThreads = 128;

__device__ __forceinline__ void mma_bf16(float (&c)[4], const uint32_t (&a)[4], uint32_t b0,
                                         uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 {%0,%1,%2,%3}, {%4,%5,%6,%7}, "
      "{%8,%9}, {%0,%1,%2,%3};\n"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

// four 8 x 8 b16 matrices, transposed on the way (the B operand of P @ V
// out of V's row-major (key, channel) tile)
__device__ __forceinline__ void ldsm_x4_trans(uint32_t (&r)[4], const void* row) {
  const uint32_t a = static_cast<uint32_t>(__cvta_generic_to_shared(row));
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0,%1,%2,%3}, [%4];\n"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
               : "r"(a));
}

// 16 bytes global -> shared without the registers; `valid` false fills zeros
__device__ __forceinline__ void cp_async16(void* dst, const void* src, bool valid) {
  const uint32_t s = static_cast<uint32_t>(__cvta_generic_to_shared(dst));
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(s), "l"(src),
               "r"(valid ? 16 : 0));
}

__device__ __forceinline__ uint32_t pack_bf16(__nv_bfloat16 lo, __nv_bfloat16 hi) {
  return static_cast<uint32_t>(__bfloat16_as_ushort(lo)) |
         (static_cast<uint32_t>(__bfloat16_as_ushort(hi)) << 16);
}

// (x, y) -> their bfloat16 roundings (hi) and the bfloat16 roundings of what
// those missed (lo): hi + lo carries 16 significant bits, so P @ V from the
// two products is within ~2^-17 of the float32 product
__device__ __forceinline__ void split_bf16(float x, float y, uint32_t& hi, uint32_t& lo) {
  const __nv_bfloat16 hx = __float2bfloat16_rn(x), hy = __float2bfloat16_rn(y);
  hi = pack_bf16(hx, hy);
  lo = pack_bf16(__float2bfloat16_rn(x - __bfloat162float(hx)),
                 __float2bfloat16_rn(y - __bfloat162float(hy)));
}

__device__ __forceinline__ uint32_t ld32(const __nv_bfloat16* p) {
  return *reinterpret_cast<const uint32_t*>(p);
}

template <int D>
__global__ void __launch_bounds__(kMThreads)
flash_prefill_mma_kernel(const __nv_bfloat16* __restrict__ q, const __nv_bfloat16* __restrict__ k,
                         const __nv_bfloat16* __restrict__ v, __nv_bfloat16* __restrict__ out,
                         int G, int T_len, Strides qs, Strides ks, Strides vs, Strides os,
                         float scale, float softcap, int causal, int window) {
  constexpr int kS = D + 8;           // smem row stride (bf16): 16-byte rows, no bank conflict
  constexpr int kQK = D / 16;         // k-steps of Q K^T
  constexpr int kNT = D / 8;          // 8-channel output tiles
  constexpr int kChunks = D / 8;      // 16-byte chunks per K/V row
  extern __shared__ uint4 smem_m[];
  __nv_bfloat16* Ks = reinterpret_cast<__nv_bfloat16*>(smem_m);   // [2][kMBK][kS]
  __nv_bfloat16* Vs = Ks + 2 * kMBK * kS;

  const int n_qb = (T_len + kMBQ - 1) / kMBQ;
  const int qb = n_qb - 1 - blockIdx.x;
  const int h = blockIdx.y, b = blockIdx.z, hk = h / G;
  const int q0 = qb * kMBQ;
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int gq = lane >> 2, tq4 = lane & 3;          // mma fragment coordinates
  const int row0 = q0 + warp * 16 + gq, row1 = row0 + 8;
  const __nv_bfloat16* kb_base = k + b * ks.b + hk * ks.h;
  const __nv_bfloat16* vb_base = v + b * vs.b + hk * vs.h;

  const int n_kb = (T_len + kMBK - 1) / kMBK;
  const int kb_end = causal ? min(n_kb, (q0 + kMBQ - 1) / kMBK + 1) : n_kb;
  int kb_begin = 0;
  if (window > 0) {
    const int x = q0 - window - kMBK + 1;
    if (x >= 0) kb_begin = x / kMBK + 1;
  }

  auto load_tile = [&](int kb, int buf) {
    const int k0 = kb * kMBK;
    for (int i = threadIdx.x; i < kMBK * kChunks; i += kMThreads) {
      const int r = i / kChunks, c = (i % kChunks) * 8;
      const bool ok = k0 + r < T_len;
      const long long src = (long long)(ok ? k0 + r : 0);
      cp_async16(Ks + (buf * kMBK + r) * kS + c, kb_base + src * ks.t + c, ok);
      cp_async16(Vs + (buf * kMBK + r) * kS + c, vb_base + src * vs.t + c, ok);
    }
    asm volatile("cp.async.commit_group;\n" ::);
  };
  load_tile(kb_begin, 0);

  // this warp's 16 query rows as A fragments, held for the whole loop
  uint32_t qf[kQK][4];
  {
    const __nv_bfloat16* qh = q + b * qs.b + h * qs.h;
    const bool ok0 = row0 < T_len, ok1 = row1 < T_len;
#pragma unroll
    for (int s = 0; s < kQK; ++s) {
      const int c = s * 16 + 2 * tq4;
      qf[s][0] = ok0 ? ld32(qh + row0 * qs.t + c) : 0u;
      qf[s][1] = ok1 ? ld32(qh + row1 * qs.t + c) : 0u;
      qf[s][2] = ok0 ? ld32(qh + row0 * qs.t + c + 8) : 0u;
      qf[s][3] = ok1 ? ld32(qh + row1 * qs.t + c + 8) : 0u;
    }
  }

  float m[2] = {kNegInf, kNegInf}, l[2] = {0.f, 0.f};
  float o[kNT][4];
#pragma unroll
  for (int n = 0; n < kNT; ++n) o[n][0] = o[n][1] = o[n][2] = o[n][3] = 0.f;

  for (int kb = kb_begin; kb < kb_end; ++kb) {
    const int buf = (kb - kb_begin) & 1;
    if (kb + 1 < kb_end) {
      load_tile(kb + 1, buf ^ 1);                     // next tile in flight
      asm volatile("cp.async.wait_group 1;\n" ::);
    } else {
      asm volatile("cp.async.wait_group 0;\n" ::);
    }
    __syncthreads();
    const __nv_bfloat16* Kt = Ks + buf * kMBK * kS;
    const __nv_bfloat16* Vt = Vs + buf * kMBK * kS;

    // S = Q K^T: 16 rows x 64 keys per warp, float32 sums of exact products
    float s[8][4];
#pragma unroll
    for (int n = 0; n < 8; ++n) s[n][0] = s[n][1] = s[n][2] = s[n][3] = 0.f;
#pragma unroll
    for (int st = 0; st < kQK; ++st)
#pragma unroll
      for (int n = 0; n < 8; ++n) {
        const __nv_bfloat16* kp = Kt + (n * 8 + gq) * kS + st * 16 + 2 * tq4;
        mma_bf16(s[n], qf[st], ld32(kp), ld32(kp + 8));
      }

    // scale, softcap, mask; online softmax over the two rows this thread holds
    const int k0 = kb * kMBK;
    float mx[2] = {kNegInf, kNegInf};
#pragma unroll
    for (int n = 0; n < 8; ++n)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int tq = e < 2 ? row0 : row1;
        const int tk = k0 + n * 8 + 2 * tq4 + (e & 1);
        float x = s[n][e] * scale;
        if (softcap > 0.f) x = softcap * tanhf(x / softcap);
        const bool ok = tk < T_len && (!causal || tk <= tq) && (window <= 0 || tk > tq - window);
        s[n][e] = ok ? x : kNegInf;
        mx[e >> 1] = fmaxf(mx[e >> 1], s[n][e]);
      }
    float alpha[2], sum[2] = {0.f, 0.f};
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      mx[r] = fmaxf(mx[r], __shfl_xor_sync(0xffffffffu, mx[r], 1));
      mx[r] = fmaxf(mx[r], __shfl_xor_sync(0xffffffffu, mx[r], 2));
      const float m_new = fmaxf(m[r], mx[r]);
      alpha[r] = expf(m[r] - m_new);
      m[r] = m_new;
    }
#pragma unroll
    for (int n = 0; n < 8; ++n)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        s[n][e] = expf(s[n][e] - m[e >> 1]);
        sum[e >> 1] += s[n][e];
      }
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      sum[r] += __shfl_xor_sync(0xffffffffu, sum[r], 1);
      sum[r] += __shfl_xor_sync(0xffffffffu, sum[r], 2);
      l[r] = l[r] * alpha[r] + sum[r];
    }
#pragma unroll
    for (int n = 0; n < kNT; ++n) {
      o[n][0] *= alpha[0];
      o[n][1] *= alpha[0];
      o[n][2] *= alpha[1];
      o[n][3] *= alpha[1];
    }

    // O += P V, P as bfloat16 hi + lo fragments straight from the score
    // accumulators (their layout is the A operand's)
#pragma unroll
    for (int kk = 0; kk < kMBK / 16; ++kk) {
      uint32_t ph[4], pl[4];
      split_bf16(s[2 * kk][0], s[2 * kk][1], ph[0], pl[0]);
      split_bf16(s[2 * kk][2], s[2 * kk][3], ph[1], pl[1]);
      split_bf16(s[2 * kk + 1][0], s[2 * kk + 1][1], ph[2], pl[2]);
      split_bf16(s[2 * kk + 1][2], s[2 * kk + 1][3], ph[3], pl[3]);
#pragma unroll
      for (int np = 0; np < kNT / 2; ++np) {
        uint32_t vb[4];
        ldsm_x4_trans(vb, Vt + (kk * 16 + (lane & 15)) * kS + np * 16 + (lane >> 4) * 8);
        mma_bf16(o[2 * np], ph, vb[0], vb[1]);
        mma_bf16(o[2 * np], pl, vb[0], vb[1]);
        mma_bf16(o[2 * np + 1], ph, vb[2], vb[3]);
        mma_bf16(o[2 * np + 1], pl, vb[2], vb[3]);
      }
    }
    __syncthreads();                                  // tile consumed before its reload
  }

  __nv_bfloat16* oh = out + b * os.b + h * os.h;
  const float inv_l[2] = {1.f / fmaxf(l[0], 1e-30f), 1.f / fmaxf(l[1], 1e-30f)};
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    const int tq = r ? row1 : row0;
    if (tq >= T_len) continue;
    __nv_bfloat16* orow = oh + tq * os.t;
#pragma unroll
    for (int n = 0; n < kNT; ++n)
      *reinterpret_cast<uint32_t*>(orow + n * 8 + 2 * tq4) =
          pack_bf16(__float2bfloat16_rn(o[n][2 * r] * inv_l[r]),
                    __float2bfloat16_rn(o[n][2 * r + 1] * inv_l[r]));
  }
}

template <int D>
cudaError_t launch_mma(const void* q, const void* k, const void* v, void* out, int B, int H,
                       int G, int T_len, Strides qs, Strides ks, Strides vs, Strides os,
                       float scale, float softcap, int causal, int window, cudaStream_t st) {
  constexpr size_t kSmem = sizeof(__nv_bfloat16) * 4 * kMBK * (D + 8);
  static bool opted_in = false;
  if (!opted_in) {
    const cudaError_t err = cudaFuncSetAttribute(
        flash_prefill_mma_kernel<D>, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)kSmem);
    if (err != cudaSuccess) return err;
    opted_in = true;
  }
  const dim3 grid((T_len + kMBQ - 1) / kMBQ, H, B);
  flash_prefill_mma_kernel<D><<<grid, kMThreads, kSmem, st>>>(
      static_cast<const __nv_bfloat16*>(q), static_cast<const __nv_bfloat16*>(k),
      static_cast<const __nv_bfloat16*>(v), static_cast<__nv_bfloat16*>(out), G, T_len, qs, ks,
      vs, os, scale, softcap, causal, window);
  return cudaGetLastError();
}

template <typename T, int D>
cudaError_t launch(const void* q, const void* k, const void* v, void* out, int B, int H,
                   int G, int T_len, Strides qs, Strides ks, Strides vs, Strides os,
                   float scale, float softcap, int causal, int window, cudaStream_t st) {
  constexpr size_t kSmem = sizeof(float) * ((size_t)(kBQ + 2 * kBK) * (D + 4) + kBQ * kPS);
  static bool opted_in = false;   // per instantiation; the attribute is per function
  if (!opted_in) {
    const cudaError_t err = cudaFuncSetAttribute(
        flash_prefill_kernel<T, D>, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)kSmem);
    if (err != cudaSuccess) return err;
    opted_in = true;
  }
  const dim3 grid((T_len + kBQ - 1) / kBQ, H, B);
  flash_prefill_kernel<T, D><<<grid, kThreads, kSmem, st>>>(
      static_cast<const T*>(q), static_cast<const T*>(k), static_cast<const T*>(v),
      static_cast<T*>(out), G, T_len, qs, ks, vs, os, scale, softcap, causal, window);
  return cudaGetLastError();
}

// float32: the FMA path at every d; bfloat16: the tensor-core path at d = 64
// and 128, the FMA path at d = 256
template <typename T>
cudaError_t dispatch_d(int d, const void* q, const void* k, const void* v, void* out, int B,
                       int H, int G, int T_len, Strides qs, Strides ks, Strides vs,
                       Strides os, float scale, float softcap, int causal, int window,
                       cudaStream_t st) {
  constexpr bool kMma = std::is_same<T, __nv_bfloat16>::value;
  switch (d) {
    case 64:
      return kMma ? launch_mma<64>(q, k, v, out, B, H, G, T_len, qs, ks, vs, os, scale, softcap,
                                   causal, window, st)
                  : launch<float, 64>(q, k, v, out, B, H, G, T_len, qs, ks, vs, os, scale,
                                      softcap, causal, window, st);
    case 128:
      return kMma ? launch_mma<128>(q, k, v, out, B, H, G, T_len, qs, ks, vs, os, scale,
                                    softcap, causal, window, st)
                  : launch<float, 128>(q, k, v, out, B, H, G, T_len, qs, ks, vs, os, scale,
                                       softcap, causal, window, st);
    case 256:
      return launch<T, 256>(q, k, v, out, B, H, G, T_len, qs, ks, vs, os, scale, softcap,
                            causal, window, st);
    default:
      return cudaErrorInvalidValue;
  }
}

}  // namespace
}  // namespace freekv

// strides: (batch, head, token) of q, k, v, out in elements, the last dim
// contiguous; every row 16-byte aligned. d in {64, 128, 256}; H a multiple
// of kv (G = H / kv). softcap <= 0 means none, window <= 0 none, causal
// 0 / 1. Returns the launch's cudaError_t.
extern "C" int freekv_flash_prefill(const void* q, const void* k, const void* v, void* out,
                                    int B, int H, int G, int T_len, int d,
                                    const long long* strides, float scale, float softcap,
                                    int causal, int window, int dtype, int device,
                                    void* stream) {
  using namespace freekv;
  const int elem = dtype == kBFloat16 ? 2 : 4;
  if (B < 1 || H < 1 || G < 1 || H % G || T_len < 1 || B > 65535 || H > 65535)
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
    return dispatch_d<float>(d, q, k, v, out, B, H, G, T_len, qs, ks, vs, os, scale, softcap,
                             causal, window, st);
  if (dtype == kBFloat16)
    return dispatch_d<__nv_bfloat16>(d, q, k, v, out, B, H, G, T_len, qs, ks, vs, os, scale,
                                     softcap, causal, window, st);
  return cudaErrorInvalidValue;
}
