// Flash attention for Hopper (sm_90a): tiled online-softmax attention.
//
// Replaces repro/kernels/flash_attention.py:flash_attention (the Pallas
// _attn_kernel).  It computes what that kernel computes:
//
//   out[b, h, i] = sum_j p_ij v[b, h / group, j] / sum_j p_ij,
//   s_ij = sm_scale * q_i . k_j, optionally softcap * tanh(s_ij / softcap),
//   p_ij = exp(s_ij - m_i) over the keys j that the mask keeps:
//   j < Skv, causal (top-left) j <= i, sliding window j > i - window.
//
// GQA: query head h reads kv head h / (Hq / Hkv).  A row with no key
// left gives 0.  Accumulation is in f32; the output is in q's dtype.
//
// The TPU kernel walked a sequential (bh, q-block, k-block) grid and
// carried (m, l, acc) in VMEM scratch from one k step to the next.  Here
// one CTA owns one (b*Hq + h, q-block) and loops over the k-blocks the
// visit predicate keeps (causal: none wholly above the diagonal; window:
// none wholly before the window), so (m, l, acc) live in registers.
// Masked lanes take DEFAULT_MASK_VALUE and then an exact 0 after the
// exponential (as at flash_attention.py:79-87), so a row whose first
// visited tile is fully masked never produces NaN; the final division
// happens only where l > 0.  Ragged Sq / Skv are bounds masks: nothing
// is padded or copied.  Strides are taken for every axis but the last.
//
// The CUDA-core path: 256 threads as a 16 x 16 grid.  Thread (ty, tx)
// owns query rows 4*ty .. 4*ty+3 of the 64-row block and, for the
// scores, key columns tx + 16*c (c < 4) of the 64-key block; for the
// output, head-dim columns tx + 16*c (c < D/16).  Q stays in shared
// memory as f32 for the whole loop; K and then V of the current key
// block share one f32 tile (rows padded by one word against bank
// conflicts); P goes through a 64 x 65 f32 tile.  Both products are f32
// FMA loops.
//
// Two paths, chosen per call from what the inputs allow:
//
// * bf16 / f16 with D = 64, 128 or 192 and 16-byte aligned rows (the
//   prefills' case; 192 is MLA's qk_nope + qk_rope head, with V padded
//   to it): the products run on the tensor cores, as
//   mma.sync.m16n8k16 with f32 accumulation.  4 warps, each owning 16
//   query rows; S = Q K^T stays in registers, where the online softmax
//   reads it in the accumulator layout (rows g and g+8 of the warp's
//   tile, columns 2*tig, 2*tig+1 of each 8-key slice).  P feeds P V as
//   the A operand straight from those registers, split into a high and
//   a low half in the input type (P = hi + lo), so the product keeps
//   ~16 bits of P where one rounding to bf16 would keep 8: the result
//   stays as close to flash_ref's f32 product as the CUDA-core path.
//   Q and K are row-major in shared memory, V transposed, each row
//   padded by 16 bytes so the fragment loads hit 32 distinct banks.
// * everything else (f32, D = 256, unaligned views): the CUDA-core path.
//
// Head dims 64, 128, 192 and 256 are instantiated.  At D = 192 a warp of
// the tensor-core path holds 24 output accumulator tiles (96 floats a
// thread) beside its 32 score registers, inside the 255 a thread that
// 128-thread blocks leave.
//
// Bound on an H100 SXM: 4 * B * Hq * D * (visited q.k pairs) operations
// at 989 TFLOP/s (bf16/f16 tensor-core peak; 67 TFLOP/s for f32 inputs)
// against (q + k + v + out) bytes at 3.35 TB/s; at prefill lengths the
// operations bound it by far.  The tensor-core path issues mma.sync from
// registers with no copy/compute overlap and spends three products per
// tile where one would do (the P split), so it sits several times above
// that bound; TMA, wgmma and warp specialization are later work.

#include <cuda_bf16.h>
#include <cuda_fp16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace {

constexpr int kBQ = 64;        // query rows per CTA
constexpr int kBK = 64;        // keys per tile
constexpr int kThreads = 256;  // 16 x 16
constexpr int kRows = 4;       // query rows per thread
constexpr int kCols = 4;       // score columns per thread
constexpr float kMaskValue = -0.7f * 3.4028234663852886e38f;

template <typename T> __device__ __forceinline__ float to_f32(T x);
template <> __device__ __forceinline__ float to_f32<float>(float x) {
  return x;
}
template <> __device__ __forceinline__ float to_f32<__half>(__half x) {
  return __half2float(x);
}
template <>
__device__ __forceinline__ float to_f32<__nv_bfloat16>(__nv_bfloat16 x) {
  return __bfloat162float(x);
}

template <typename T> __device__ __forceinline__ T from_f32(float x);
template <> __device__ __forceinline__ float from_f32<float>(float x) {
  return x;
}
template <> __device__ __forceinline__ __half from_f32<__half>(float x) {
  return __float2half_rn(x);
}
template <>
__device__ __forceinline__ __nv_bfloat16 from_f32<__nv_bfloat16>(float x) {
  return __float2bfloat16_rn(x);
}

struct Params {
  const void* q;
  const void* k;
  const void* v;
  void* out;  // contiguous (B, Hq, Sq, D)
  long long B, Hq, Hkv, Sq, Skv;
  long long qsb, qsh, qss;  // element strides; the last axis is unit
  long long ksb, ksh, kss;
  long long vsb, vsh, vss;
  float sm_scale;
  int causal;
  long long window;  // <= 0: none
  float softcap;     // 0: none
};

// rows [row0, row0 + kBQ) of a (rows, D) head slice -> f32 tile with a
// pitch of D + 1 words; rows at or past n read as 0
template <typename T, int D>
__device__ __forceinline__ void load_tile(float* tile, const T* base,
                                          long long stride, long long row0,
                                          long long n) {
  constexpr int P = D + 1;
  for (int e = threadIdx.x; e < kBQ * D; e += kThreads) {
    const int r = e / D;
    const int c = e - r * D;
    const long long row = row0 + r;
    tile[r * P + c] = row < n ? to_f32<T>(base[row * stride + c]) : 0.f;
  }
}

template <typename T, int D>
__global__ void __launch_bounds__(kThreads)
flash_fwd_kernel(const Params p) {
  constexpr int P = D + 1;       // pitch of the Q and K/V tiles
  constexpr int PP = kBK + 1;    // pitch of the P tile
  constexpr int kOut = D / 16;   // output columns per thread
  extern __shared__ float smem[];
  float* q_s = smem;                 // kBQ x P
  float* kv_s = q_s + kBQ * P;       // kBK x P (K, then V)
  float* p_s = kv_s + kBK * P;       // kBQ x PP

  const long long bh = blockIdx.x;
  const long long b = bh / p.Hq;
  const long long h = bh - b * p.Hq;
  const long long hk = h / (p.Hq / p.Hkv);
  const long long q0 = static_cast<long long>(blockIdx.y) * kBQ;
  const int tx = threadIdx.x % 16;
  const int ty = threadIdx.x / 16;

  const T* qh = static_cast<const T*>(p.q) + b * p.qsb + h * p.qsh;
  const T* kh = static_cast<const T*>(p.k) + b * p.ksb + hk * p.ksh;
  const T* vh = static_cast<const T*>(p.v) + b * p.vsb + hk * p.vsh;

  load_tile<T, D>(q_s, qh, p.qss, q0, p.Sq);

  float m[kRows], l[kRows], acc[kRows][kOut];
#pragma unroll
  for (int i = 0; i < kRows; ++i) {
    m[i] = -INFINITY;
    l[i] = 0.f;
#pragma unroll
    for (int c = 0; c < kOut; ++c) acc[i][c] = 0.f;
  }

  // the k-blocks the visit predicate keeps (flash_attention.py:53-57)
  const long long nk = (p.Skv + kBK - 1) / kBK;
  long long k_hi = nk;
  if (p.causal) {
    const long long last = (q0 + kBQ - 1) / kBK + 1;
    k_hi = last < nk ? last : nk;
  }
  long long k_lo = 0;
  if (p.window > 0) {
    // first block with k_start + kBK > q0 - window
    const long long lo = q0 - p.window - kBK + 1;
    k_lo = lo > 0 ? (lo + kBK - 1) / kBK : 0;
  }

  for (long long kb = k_lo; kb < k_hi; ++kb) {
    const long long k0 = kb * kBK;
    __syncthreads();  // the previous block's V and P reads are done
    load_tile<T, D>(kv_s, kh, p.kss, k0, p.Skv);
    __syncthreads();

    // scores: s[i][c] = q[4*ty + i] . k[tx + 16*c]
    float s[kRows][kCols];
#pragma unroll
    for (int i = 0; i < kRows; ++i)
#pragma unroll
      for (int c = 0; c < kCols; ++c) s[i][c] = 0.f;
#pragma unroll 4
    for (int d = 0; d < D; ++d) {
      float qv[kRows], kv[kCols];
#pragma unroll
      for (int i = 0; i < kRows; ++i) qv[i] = q_s[(4 * ty + i) * P + d];
#pragma unroll
      for (int c = 0; c < kCols; ++c) kv[c] = kv_s[(tx + 16 * c) * P + d];
#pragma unroll
      for (int i = 0; i < kRows; ++i)
#pragma unroll
        for (int c = 0; c < kCols; ++c) s[i][c] = fmaf(qv[i], kv[c], s[i][c]);
    }

    // mask, online softmax; the 16 threads of a row group are 16
    // consecutive lanes of one warp
    float alpha[kRows];
#pragma unroll
    for (int i = 0; i < kRows; ++i) {
      const long long row = q0 + 4 * ty + i;
      bool keep[kCols];
      float mx = -INFINITY;
#pragma unroll
      for (int c = 0; c < kCols; ++c) {
        const long long col = k0 + tx + 16 * c;
        float x = s[i][c] * p.sm_scale;
        if (p.softcap > 0.f) x = p.softcap * tanhf(x / p.softcap);
        bool ok = col < p.Skv;
        if (p.causal) ok = ok && col <= row;
        if (p.window > 0) ok = ok && col > row - p.window;
        keep[c] = ok;
        s[i][c] = ok ? x : kMaskValue;
        mx = fmaxf(mx, s[i][c]);
      }
#pragma unroll
      for (int off = 8; off > 0; off >>= 1)
        mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, off));
      const float m_new = fmaxf(m[i], mx);
      alpha[i] = expf(m[i] - m_new);  // exp(-inf) = 0 on the first block
      float sum = 0.f;
#pragma unroll
      for (int c = 0; c < kCols; ++c) {
        const float e = keep[c] ? expf(s[i][c] - m_new) : 0.f;
        sum += e;
        p_s[(4 * ty + i) * PP + tx + 16 * c] = e;
      }
#pragma unroll
      for (int off = 8; off > 0; off >>= 1)
        sum += __shfl_xor_sync(0xffffffffu, sum, off);
      l[i] = alpha[i] * l[i] + sum;
      m[i] = m_new;
    }
    __syncthreads();  // P is written, K is no longer read
    load_tile<T, D>(kv_s, vh, p.vss, k0, p.Skv);
    __syncthreads();

    // acc = acc * alpha + P V
#pragma unroll
    for (int i = 0; i < kRows; ++i)
#pragma unroll
      for (int c = 0; c < kOut; ++c) acc[i][c] *= alpha[i];
#pragma unroll 4
    for (int j = 0; j < kBK; ++j) {
      float pv[kRows];
#pragma unroll
      for (int i = 0; i < kRows; ++i) pv[i] = p_s[(4 * ty + i) * PP + j];
#pragma unroll
      for (int c = 0; c < kOut; ++c) {
        const float vv = kv_s[j * P + tx + 16 * c];
#pragma unroll
        for (int i = 0; i < kRows; ++i) acc[i][c] = fmaf(pv[i], vv, acc[i][c]);
      }
    }
  }

  T* oh = static_cast<T*>(p.out) + (b * p.Hq + h) * p.Sq * D;
#pragma unroll
  for (int i = 0; i < kRows; ++i) {
    const long long row = q0 + 4 * ty + i;
    if (row >= p.Sq) continue;
    const float inv = l[i] > 0.f ? 1.f / l[i] : 1.f;
#pragma unroll
    for (int c = 0; c < kOut; ++c)
      oh[row * D + tx + 16 * c] = from_f32<T>(acc[i][c] * inv);
  }
}

// ---------------------------------------------------------------------------
// tensor-core path (bf16 / f16, D = 64 or 128)
// ---------------------------------------------------------------------------
constexpr int kMmaThreads = 128;  // 4 warps x 16 query rows

template <typename T>
__device__ __forceinline__ void mma16816(float (&c)[4], uint32_t a0,
                                         uint32_t a1, uint32_t a2,
                                         uint32_t a3, uint32_t b0,
                                         uint32_t b1);
template <>
__device__ __forceinline__ void mma16816<__nv_bfloat16>(
    float (&c)[4], uint32_t a0, uint32_t a1, uint32_t a2, uint32_t a3,
    uint32_t b0, uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};\n"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a0), "r"(a1), "r"(a2), "r"(a3), "r"(b0), "r"(b1));
}
template <>
__device__ __forceinline__ void mma16816<__half>(
    float (&c)[4], uint32_t a0, uint32_t a1, uint32_t a2, uint32_t a3,
    uint32_t b0, uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.f16.f16.f32 "
      "{%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};\n"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a0), "r"(a1), "r"(a2), "r"(a3), "r"(b0), "r"(b1));
}

// two floats -> one register of two T (x in the low half)
template <typename T>
__device__ __forceinline__ uint32_t pack2(float x, float y);
template <>
__device__ __forceinline__ uint32_t pack2<__nv_bfloat16>(float x, float y) {
  __nv_bfloat162 v = __floats2bfloat162_rn(x, y);
  return *reinterpret_cast<uint32_t*>(&v);
}
template <>
__device__ __forceinline__ uint32_t pack2<__half>(float x, float y) {
  __half2 v = __floats2half2_rn(x, y);
  return *reinterpret_cast<uint32_t*>(&v);
}

// (x, y) = hi + lo, each a register of two T: hi the rounded pair, lo
// the pair of residuals
template <typename T>
__device__ __forceinline__ void split2(float x, float y, uint32_t& hi,
                                       uint32_t& lo) {
  hi = pack2<T>(x, y);
  const T* h = reinterpret_cast<const T*>(&hi);
  lo = pack2<T>(x - to_f32<T>(h[0]), y - to_f32<T>(h[1]));
}

__device__ __forceinline__ uint32_t lds32(const void* p) {
  return *reinterpret_cast<const uint32_t*>(p);
}

// rows [row0, row0 + 64) of a (rows, D) head slice -> a T tile with a
// pitch of P elements, 16 bytes per load; rows at or past n read as 0.
// ``transpose`` stores the tile as (D, 64) instead (V: key-contiguous).
template <typename T, int D, int P, bool transpose>
__device__ __forceinline__ void load_tile16(T* tile, const T* base,
                                            long long stride, long long row0,
                                            long long n) {
  constexpr int kChunks = D / 8;  // 16-byte chunks in a row
  for (int e = threadIdx.x; e < kBK * kChunks; e += kMmaThreads) {
    const int r = e / kChunks;
    const int c = (e - r * kChunks) * 8;
    const long long row = row0 + r;
    uint4 v = make_uint4(0u, 0u, 0u, 0u);
    if (row < n) v = *reinterpret_cast<const uint4*>(base + row * stride + c);
    if (transpose) {
      const T* x = reinterpret_cast<const T*>(&v);
#pragma unroll
      for (int i = 0; i < 8; ++i) tile[(c + i) * P + r] = x[i];
    } else {
      *reinterpret_cast<uint4*>(tile + r * P + c) = v;
    }
  }
}

template <typename T, int D>
__global__ void __launch_bounds__(kMmaThreads)
flash_mma_kernel(const Params p) {
  constexpr int PQ = D + 8;     // pitch of Q and K (elements)
  constexpr int PV = kBK + 8;   // pitch of transposed V
  constexpr int kNT = kBK / 8;  // 8-key slices of a score tile
  constexpr int kOT = D / 8;    // 8-dim slices of the output
  extern __shared__ __align__(16) unsigned char smem_raw[];
  T* q_s = reinterpret_cast<T*>(smem_raw);  // kBQ x PQ
  T* k_s = q_s + kBQ * PQ;                   // kBK x PQ
  T* vt_s = k_s + kBK * PQ;                  // D x PV

  const long long bh = blockIdx.x;
  const long long b = bh / p.Hq;
  const long long h = bh - b * p.Hq;
  const long long hk = h / (p.Hq / p.Hkv);
  const long long q0 = static_cast<long long>(blockIdx.y) * kBQ;
  const int warp = threadIdx.x / 32;
  const int lane = threadIdx.x % 32;
  const int g = lane >> 2;   // accumulator row within the 8-row half
  const int tig = lane & 3;  // accumulator column pair
  const int r0 = warp * 16 + g;
  const long long row_a = q0 + r0;  // rows of c0/c1 and of c2/c3
  const long long row_b = row_a + 8;

  const T* qh = static_cast<const T*>(p.q) + b * p.qsb + h * p.qsh;
  const T* kh = static_cast<const T*>(p.k) + b * p.ksb + hk * p.ksh;
  const T* vh = static_cast<const T*>(p.v) + b * p.vsb + hk * p.vsh;

  load_tile16<T, D, PQ, false>(q_s, qh, p.qss, q0, p.Sq);

  float m[2] = {-INFINITY, -INFINITY};
  float l[2] = {0.f, 0.f};  // this thread's share; summed over the quad last
  float acc[kOT][4];
#pragma unroll
  for (int t = 0; t < kOT; ++t)
#pragma unroll
    for (int e = 0; e < 4; ++e) acc[t][e] = 0.f;

  const long long nk = (p.Skv + kBK - 1) / kBK;
  long long k_hi = nk;
  if (p.causal) {
    const long long last = (q0 + kBQ - 1) / kBK + 1;
    k_hi = last < nk ? last : nk;
  }
  long long k_lo = 0;
  if (p.window > 0) {
    const long long lo = q0 - p.window - kBK + 1;
    k_lo = lo > 0 ? (lo + kBK - 1) / kBK : 0;
  }

  for (long long kb = k_lo; kb < k_hi; ++kb) {
    const long long k0 = kb * kBK;
    __syncthreads();  // the previous block's K and V reads are done
    load_tile16<T, D, PQ, false>(k_s, kh, p.kss, k0, p.Skv);
    load_tile16<T, D, PV, true>(vt_s, vh, p.vss, k0, p.Skv);
    __syncthreads();

    // S = Q K^T: a 16 x 64 tile per warp, 8 accumulators of 16 x 8
    float s[kNT][4];
#pragma unroll
    for (int t = 0; t < kNT; ++t)
#pragma unroll
      for (int e = 0; e < 4; ++e) s[t][e] = 0.f;
#pragma unroll
    for (int kk = 0; kk < D; kk += 16) {
      const T* qa = q_s + r0 * PQ + kk + 2 * tig;
      const uint32_t a0 = lds32(qa), a1 = lds32(qa + 8 * PQ);
      const uint32_t a2 = lds32(qa + 8), a3 = lds32(qa + 8 * PQ + 8);
#pragma unroll
      for (int t = 0; t < kNT; ++t) {
        const T* kb_ = k_s + (t * 8 + g) * PQ + kk + 2 * tig;
        mma16816<T>(s[t], a0, a1, a2, a3, lds32(kb_), lds32(kb_ + 8));
      }
    }

    // mask and online softmax; a row's 64 scores live in the 4 lanes of
    // one quad (16 each)
    uint32_t keep = 0u;
    float mx[2] = {kMaskValue, kMaskValue};
#pragma unroll
    for (int t = 0; t < kNT; ++t)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const long long row = e < 2 ? row_a : row_b;
        const long long col = k0 + t * 8 + 2 * tig + (e & 1);
        float x = s[t][e] * p.sm_scale;
        if (p.softcap > 0.f) x = p.softcap * tanhf(x / p.softcap);
        bool ok = col < p.Skv;
        if (p.causal) ok = ok && col <= row;
        if (p.window > 0) ok = ok && col > row - p.window;
        if (ok) keep |= 1u << (t * 4 + e);
        s[t][e] = ok ? x : kMaskValue;
        mx[e >> 1] = fmaxf(mx[e >> 1], s[t][e]);
      }
    float alpha[2];
#pragma unroll
    for (int i = 0; i < 2; ++i) {
      mx[i] = fmaxf(mx[i], __shfl_xor_sync(0xffffffffu, mx[i], 1));
      mx[i] = fmaxf(mx[i], __shfl_xor_sync(0xffffffffu, mx[i], 2));
      const float m_new = fmaxf(m[i], mx[i]);
      alpha[i] = expf(m[i] - m_new);  // exp(-inf) = 0 on the first block
      m[i] = m_new;
      l[i] *= alpha[i];
    }
#pragma unroll
    for (int t = 0; t < kNT; ++t)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const float pe = (keep >> (t * 4 + e)) & 1u
                             ? expf(s[t][e] - m[e >> 1]) : 0.f;
        s[t][e] = pe;
        l[e >> 1] += pe;
      }
#pragma unroll
    for (int t = 0; t < kOT; ++t) {
      acc[t][0] *= alpha[0];
      acc[t][1] *= alpha[0];
      acc[t][2] *= alpha[1];
      acc[t][3] *= alpha[1];
    }

    // O += P V, 16 keys at a time; P = hi + lo in the input type
#pragma unroll
    for (int j = 0; j < kBK / 16; ++j) {
      uint32_t h0, h1, h2, h3, l0, l1, l2, l3;
      split2<T>(s[2 * j][0], s[2 * j][1], h0, l0);
      split2<T>(s[2 * j][2], s[2 * j][3], h1, l1);
      split2<T>(s[2 * j + 1][0], s[2 * j + 1][1], h2, l2);
      split2<T>(s[2 * j + 1][2], s[2 * j + 1][3], h3, l3);
#pragma unroll
      for (int t = 0; t < kOT; ++t) {
        const T* vb = vt_s + (t * 8 + g) * PV + j * 16 + 2 * tig;
        const uint32_t b0 = lds32(vb), b1 = lds32(vb + 8);
        mma16816<T>(acc[t], h0, h1, h2, h3, b0, b1);
        mma16816<T>(acc[t], l0, l1, l2, l3, b0, b1);
      }
    }
  }

#pragma unroll
  for (int i = 0; i < 2; ++i) {
    l[i] += __shfl_xor_sync(0xffffffffu, l[i], 1);
    l[i] += __shfl_xor_sync(0xffffffffu, l[i], 2);
  }
  T* oh = static_cast<T*>(p.out) + (b * p.Hq + h) * p.Sq * D;
#pragma unroll
  for (int i = 0; i < 2; ++i) {
    const long long row = i ? row_b : row_a;
    if (row >= p.Sq) continue;
    const float inv = l[i] > 0.f ? 1.f / l[i] : 1.f;
#pragma unroll
    for (int t = 0; t < kOT; ++t)
      *reinterpret_cast<uint32_t*>(oh + row * D + t * 8 + 2 * tig) =
          pack2<T>(acc[t][2 * i] * inv, acc[t][2 * i + 1] * inv);
  }
}

template <typename T, int D>
int launch_mma(const Params& p, cudaStream_t st) {
  constexpr size_t smem =
      sizeof(T) * (static_cast<size_t>(kBQ + kBK) * (D + 8) +
                   static_cast<size_t>(D) * (kBK + 8));
  const cudaError_t e = cudaFuncSetAttribute(
      flash_mma_kernel<T, D>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      static_cast<int>(smem));
  if (e != cudaSuccess) return static_cast<int>(e);
  const dim3 grid(static_cast<unsigned>(p.B * p.Hq),
                  static_cast<unsigned>((p.Sq + kBQ - 1) / kBQ));
  flash_mma_kernel<T, D><<<grid, kMmaThreads, smem, st>>>(p);
  return static_cast<int>(cudaGetLastError());
}

// the tensor-core path reads 16-byte chunks: every row start must be
// 16-byte aligned
inline bool rows_aligned16(const Params& p) {
  const auto al = [](const void* x) {
    return reinterpret_cast<uintptr_t>(x) % 16 == 0;
  };
  const long long s[9] = {p.qsb, p.qsh, p.qss, p.ksb, p.ksh,
                          p.kss, p.vsb, p.vsh, p.vss};
  for (long long x : s)
    if (x % 8) return false;
  return al(p.q) && al(p.k) && al(p.v) && al(p.out);
}

// ---------------------------------------------------------------------------
// CUDA-core path
// ---------------------------------------------------------------------------
template <int D>
constexpr size_t smem_bytes() {
  return sizeof(float) * (static_cast<size_t>(kBQ) * (D + 1) +
                          static_cast<size_t>(kBK) * (D + 1) +
                          static_cast<size_t>(kBQ) * (kBK + 1));
}

template <typename T, int D>
int launch(const Params& p, cudaStream_t st) {
  constexpr size_t smem = smem_bytes<D>();
  const cudaError_t e = cudaFuncSetAttribute(
      flash_fwd_kernel<T, D>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      static_cast<int>(smem));
  if (e != cudaSuccess) return static_cast<int>(e);
  const dim3 grid(static_cast<unsigned>(p.B * p.Hq),
                  static_cast<unsigned>((p.Sq + kBQ - 1) / kBQ));
  flash_fwd_kernel<T, D><<<grid, kThreads, smem, st>>>(p);
  return static_cast<int>(cudaGetLastError());
}

template <typename T>
int dispatch_d(const Params& p, long long D, cudaStream_t st) {
  switch (D) {
    case 64: return launch<T, 64>(p, st);
    case 128: return launch<T, 128>(p, st);
    case 192: return launch<T, 192>(p, st);
    case 256: return launch<T, 256>(p, st);
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
}

template <typename T>
int dispatch_tc(const Params& p, long long D, cudaStream_t st) {
  if (rows_aligned16(p)) {
    if (D == 64) return launch_mma<T, 64>(p, st);
    if (D == 128) return launch_mma<T, 128>(p, st);
    if (D == 192) return launch_mma<T, 192>(p, st);
  }
  return dispatch_d<T>(p, D, st);
}

}  // namespace

extern "C" {

// dtype: 0 float32, 1 bfloat16, 2 float16.  Returns cudaGetLastError()
// after the launch (cudaErrorInvalidValue for a shape or dtype the kernel
// does not take).
int flash_attention_fwd(const void* q, const void* k, const void* v,
                        void* out, int dtype, long long B, long long Hq,
                        long long Hkv, long long Sq, long long Skv,
                        long long D, long long qsb, long long qsh,
                        long long qss, long long ksb, long long ksh,
                        long long kss, long long vsb, long long vsh,
                        long long vss, float sm_scale, int causal,
                        long long window, float softcap, void* stream) {
  if (B <= 0 || Hq <= 0 || Hkv <= 0 || Hq % Hkv || Sq <= 0 || Skv <= 0 ||
      B * Hq > 2147483647LL || (Sq + kBQ - 1) / kBQ > 65535)
    return static_cast<int>(cudaErrorInvalidValue);
  Params p{q, k, v, out, B, Hq, Hkv, Sq, Skv, qsb, qsh, qss, ksb, ksh, kss,
           vsb, vsh, vss, sm_scale, causal, window, softcap};
  const auto st = static_cast<cudaStream_t>(stream);
  switch (dtype) {
    case 0: return dispatch_d<float>(p, D, st);
    case 1: return dispatch_tc<__nv_bfloat16>(p, D, st);
    case 2: return dispatch_tc<__half>(p, D, st);
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
}

}  // extern "C"
