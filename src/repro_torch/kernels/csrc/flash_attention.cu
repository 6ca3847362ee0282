// Flash attention for Hopper (sm_90a): tiled online-softmax attention.
//
// Replaces src/repro/kernels/flash_attention.py:34 (the Pallas
// _attn_kernel behind flash_attention).  It computes what that kernel
// computes:
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
// Masked lanes take kMaskValue and then an exact 0 after the
// exponential (as at flash_attention.py:79-87), so a row whose first
// visited tile is fully masked never produces NaN; the final division
// happens only where l > 0.
//
// Which path serves which inputs (decided from dtype, head dim and
// alignment before the launch; a refused launch or a tensor map that
// fails to encode returns non-zero and the wrapper raises):
//
// * bf16 / f16, head dim 64, 128, 192 or 256, every base and stride a
//   16-byte multiple (the prefills' case, transposed (B, S, H, D) views
//   included): TMA + wgmma, warp-specialized (flash_tma_kernel).
// * everything else (float32, unaligned views): f32 FMA tiles
//   (flash_fwd_kernel).
//
// The TMA + wgmma path.  One CTA of 3 warpgroups per (b*Hq + h, 128-row
// q-block); q-blocks run last to first, so the longest causal blocks
// start first and the short ones fill the tail.
// * Warpgroup 0 is the producer: it gives up registers (setmaxnreg.dec
//   to 24) and one thread issues every TMA load.  Q is loaded once; K
//   and V go through a 2-stage ring with a full and an empty mbarrier
//   per stage and operand, so K of the next tile lands while the
//   consumers still read V of this one.  The tensor maps are built on
//   the host at each call: 4-D (D, S, H, B) with the views' own strides,
//   boxes of 64 columns (128 bytes, 128-byte swizzle) by the tile's
//   rows, the kv head coordinate h / group.  TMA fills rows past Sq or
//   Skv with zeros, so no load is bounds-checked; the mask decides which
//   keys count.  cuTensorMapEncodeTiled comes through
//   cudaGetDriverEntryPoint, so the library needs no -lcuda.
// * Warpgroups 1 and 2 are the consumers (setmaxnreg.inc to 240), 64
//   query rows each.  S = Q K^T is wgmma m64nBKk16 with both operands in
//   shared memory (K-major, 128-byte swizzle descriptors), f32
//   accumulators.  The online softmax runs on the accumulator fragment:
//   a row's scores live in the 4 lanes of one quad, so the row max and
//   sum take 2 shuffles; it works in the log2 domain (exp2 of scores
//   pre-scaled by log2 e), and only tiles that cross the diagonal, the
//   window's edge or Skv evaluate the mask.  O += P V is wgmma with A
//   from registers (P in the accumulator layout is already wgmma's A
//   fragment) and B = V as TMA laid it down, read through the
//   descriptor's transpose (MN-major) bit: no hand transpose.
// * P is split into an input-type hi + lo (hi the rounded P, lo the
//   rounded residual) and both halves go through the product: it keeps
//   ~16 bits of P where one rounding would keep 8 (bf16), so the result
//   stays as close to flash_ref's f32 P V as the FMA path
//   (tests/test_torch_attention.py holds an emulation of this contract
//   against flash_ref).  The cost is a third product per tile.
// * Per head dim: keys per tile BK = 128 at D <= 128 and 64 at D = 192
//   and 256, so that Q (128 x D) and 2 stages of K and V (2 x BK x D
//   each) fit in shared memory (80, 160, 144 and 192 KB) and a
//   consumer thread holds O (D / 2 floats), S (BK / 2) and P hi + lo
//   (BK / 2 registers) within 240 registers.
// * Epilogue: O / l where l > 0 (and, when asked, the row log-sum-exp
//   (m + log2 l) ln 2 for the backward), staged through the warpgroup's own rows
//   of the Q tile (128-byte swizzled, no bank conflicts) and written
//   with coalesced 16-byte stores.
//
// The FMA path: 256 threads as a 16 x 16 grid.  Thread (ty, tx) owns
// query rows 4*ty .. 4*ty+3 of a 64-row block and, for the scores, key
// columns tx + 16*c (c < 4) of the 64-key block; for the output,
// head-dim columns tx + 16*c (c < D/16).  Q stays in shared memory as
// f32; K and then V of the current key block share one f32 tile (rows
// padded by one word against bank conflicts); P goes through a 64 x 65
// f32 tile.  Ragged Sq / Skv are bounds masks; strides are taken for
// every axis but the last.
//
// Bound on an H100 SXM: 4 * B * Hq * D * (kept q.k pairs) operations at
// 989 TFLOP/s (bf16/f16 tensor-core peak; 67 TFLOP/s for f32 inputs)
// against (q + k + v + out) bytes at 3.35 TB/s; at prefill lengths the
// operations bound it by far.  The P split makes the tensor-core path
// do 3 products of 2 * D operations per pair where the bound counts 2,
// so its floor is 1.5x the bound.  Not done here: ping-pong scheduling
// of the two consumer warpgroups, intra-warpgroup overlap of softmax
// and the products, a persistent tile scheduler, GQA head packing.
//
// The Hopper building blocks (mbarriers, TMA, wgmma descriptors and
// wrappers, the hi + lo split, the tensor-map encoder) live in
// hopper.cuh, shared with the backward (flash_attention_bwd.cu).

#include "hopper.cuh"

namespace {

constexpr int kBQ = 64;        // FMA path: query rows per CTA
constexpr int kBK = 64;        // FMA path: keys per tile
constexpr int kThreads = 256;  // FMA path: 16 x 16
constexpr int kRows = 4;       // FMA path: query rows per thread
constexpr int kCols = 4;       // FMA path: score columns per thread
constexpr float kMaskValue = -0.7f * 3.4028234663852886e38f;

struct Params {
  const void* q;
  const void* k;
  const void* v;
  void* out;  // contiguous (B, Hq, Sq, D)
  float* lse;  // contiguous (B, Hq, Sq) row log-sum-exp, or null: no write
  long long B, Hq, Hkv, Sq, Skv;
  long long qsb, qsh, qss;  // element strides; the last axis is unit
  long long ksb, ksh, kss;
  long long vsb, vsh, vss;
  float sm_scale;
  int causal;
  long long window;  // keys j > i - window; no window travels as Sq
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
  // first block with k_start + kBK > q0 - window (past k_hi when the
  // window leaves no key: the rows then give 0)
  const long long lo = q0 - p.window - kBK + 1;
  const long long k_lo = lo > 0 ? (lo + kBK - 1) / kBK : 0;

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
        ok = ok && col > row - p.window;
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
    if (p.lse != nullptr && tx == 0)
      p.lse[(b * p.Hq + h) * p.Sq + row] =
          l[i] > 0.f ? m[i] + logf(l[i]) : -INFINITY;
#pragma unroll
    for (int c = 0; c < kOut; ++c)
      oh[row * D + tx + 16 * c] = from_f32<T>(acc[i][c] * inv);
  }
}

// ---------------------------------------------------------------------------
// TMA + wgmma path (bf16 / f16, aligned rows)
// ---------------------------------------------------------------------------
constexpr int kTmaBQ = 128;       // query rows per CTA: 2 consumer warpgroups
constexpr int kTmaThreads = 384;  // producer warpgroup + 2 consumers

template <int D>
struct TmaTile {
  static constexpr int kBK = D <= 128 ? 128 : 64;  // keys per tile
  static constexpr int kStages = 2;                // depth of the K/V ring
  static constexpr int kPanels = D / 64;           // 64-column panels
  // every tile is kPanels panels of (rows x 128 bytes), 128-byte swizzled
  static constexpr uint32_t kQPanel = kTmaBQ * 128;
  static constexpr uint32_t kQBytes = kQPanel * kPanels;
  static constexpr uint32_t kKVPanel = kBK * 128;
  static constexpr uint32_t kKVBytes = kKVPanel * kPanels;
  static constexpr uint32_t kBars = kQBytes + 2 * kStages * kKVBytes;
  // barriers: q_full, then k_full, v_full, k_empty, v_empty per stage;
  // 1024 bytes of slack align the tiles to the swizzle's 1024-byte atom
  static constexpr uint32_t kSmem = kBars + 8 * (1 + 4 * kStages) + 1024;
};

// Mask (when kMasked), online softmax and the l update on one score tile
// in the wgmma accumulator layout: s[4 t + e] is row r0 + 8 (e >> 1),
// column k0 + 8 t + 2 tig + (e & 1).  Scores leave as p = exp2(x - m)
// in the log2 domain, masked lanes exactly 0; alpha rescales O.
template <int BK, bool kMasked>
__device__ __forceinline__ void softmax_tile(float (&s)[BK / 2],
                                             float (&m)[2], float (&l)[2],
                                             float (&alpha)[2],
                                             const Params& p, float qk_scale,
                                             float cap_log2, int win, int r0,
                                             int k0, int tig) {
  uint32_t keep[BK / 64];
  float mx[2] = {kMaskValue, kMaskValue};
#pragma unroll
  for (int w = 0; w < BK / 64; ++w) keep[w] = 0u;
#pragma unroll
  for (int i = 0; i < BK / 2; ++i) {
    float x = s[i] * qk_scale;
    if (p.softcap > 0.f) x = cap_log2 * tanhf(x);
    if (kMasked) {
      const int row = r0 + 8 * ((i & 3) >> 1);
      const int col = k0 + 8 * (i >> 2) + 2 * tig + (i & 1);
      bool ok = col < p.Skv;
      if (p.causal) ok = ok && col <= row;
      ok = ok && col > row - win;
      if (ok) keep[i / 32] |= 1u << (i % 32);
      x = ok ? x : kMaskValue;
    }
    s[i] = x;
    mx[(i & 3) >> 1] = fmaxf(mx[(i & 3) >> 1], x);
  }
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    mx[r] = fmaxf(mx[r], __shfl_xor_sync(0xffffffffu, mx[r], 1));
    mx[r] = fmaxf(mx[r], __shfl_xor_sync(0xffffffffu, mx[r], 2));
    const float m_new = fmaxf(m[r], mx[r]);
    alpha[r] = fast_exp2(m[r] - m_new);  // exp2(-inf) = 0 on the first tile
    m[r] = m_new;
    l[r] *= alpha[r];
  }
#pragma unroll
  for (int i = 0; i < BK / 2; ++i) {
    const int r = (i & 3) >> 1;
    float e = fast_exp2(s[i] - m[r]);
    if (kMasked) e = (keep[i / 32] >> (i % 32)) & 1u ? e : 0.f;
    s[i] = e;
    l[r] += e;
  }
}

template <typename T, int D>
__global__ void __launch_bounds__(kTmaThreads, 1)
flash_tma_kernel(const __grid_constant__ CUtensorMap qmap,
                 const __grid_constant__ CUtensorMap kmap,
                 const __grid_constant__ CUtensorMap vmap, const Params p) {
  using C = TmaTile<D>;
  constexpr int BK = C::kBK;
  constexpr int S = C::kStages;
  extern __shared__ unsigned char smem_raw[];
  const uint32_t q_s = (smem_addr(smem_raw) + 1023u) & ~1023u;
  const uint32_t k_s = q_s + C::kQBytes;          // stage s at + s * kKVBytes
  const uint32_t v_s = k_s + S * C::kKVBytes;
  const uint32_t q_full = q_s + C::kBars;
  const uint32_t k_full = q_full + 8;             // stage s at + 8 * s
  const uint32_t v_full = k_full + 8 * S;
  const uint32_t k_empty = v_full + 8 * S;
  const uint32_t v_empty = k_empty + 8 * S;

  const int bh = blockIdx.x;
  const int Hq = static_cast<int>(p.Hq);
  const int b = bh / Hq;
  const int h = bh - b * Hq;
  const int hk = h / (Hq / static_cast<int>(p.Hkv));
  // last q-block first: causal blocks with the most keys start first
  const int q0 = (gridDim.y - 1 - blockIdx.y) * kTmaBQ;
  const int Skv = static_cast<int>(p.Skv);
  const int win = static_cast<int>(p.window);  // in [-Skv, Sq]

  // the k-blocks the visit predicate keeps (flash_attention.py:53-57)
  const int nk = (Skv + BK - 1) / BK;
  int k_hi = nk;
  if (p.causal) k_hi = min(nk, (q0 + kTmaBQ - 1) / BK + 1);
  const int lo = q0 - win - BK + 1;  // first block with k0 + BK > q0 - win
  const int k_lo = lo > 0 ? (lo + BK - 1) / BK : 0;
  const int n = k_hi > k_lo ? k_hi - k_lo : 0;

  if (threadIdx.x == 0) {
    mbar_init(q_full, 1);
#pragma unroll
    for (int s = 0; s < S; ++s) {
      mbar_init(k_full + 8 * s, 1);
      mbar_init(v_full + 8 * s, 1);
      mbar_init(k_empty + 8 * s, 8);  // one arrival per consumer warp
      mbar_init(v_empty + 8 * s, 8);
    }
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();

  if (threadIdx.x < 128) {
    // ---- producer warpgroup: one thread keeps the TMA ring full ----
    asm volatile("setmaxnreg.dec.sync.aligned.u32 24;\n");
    if (threadIdx.x == 0 && n > 0) {
      mbar_expect_tx(q_full, C::kQBytes);
#pragma unroll
      for (int c = 0; c < C::kPanels; ++c)
        tma_load(q_s + c * C::kQPanel, &qmap, q_full, 64 * c, q0, h, b);
      for (int i = 0; i < n; ++i) {
        const int s = i % S;
        const uint32_t ph = (i / S) & 1;
        const int k0 = (k_lo + i) * BK;
        const uint32_t off = s * C::kKVBytes;
        mbar_wait(k_empty + 8 * s, ph ^ 1);  // the first round passes
        mbar_expect_tx(k_full + 8 * s, C::kKVBytes);
#pragma unroll
        for (int c = 0; c < C::kPanels; ++c)
          tma_load(k_s + off + c * C::kKVPanel, &kmap, k_full + 8 * s,
                   64 * c, k0, hk, b);
        mbar_wait(v_empty + 8 * s, ph ^ 1);
        mbar_expect_tx(v_full + 8 * s, C::kKVBytes);
#pragma unroll
        for (int c = 0; c < C::kPanels; ++c)
          tma_load(v_s + off + c * C::kKVPanel, &vmap, v_full + 8 * s,
                   64 * c, k0, hk, b);
      }
    }
  } else {
    // ---- consumer warpgroups: 64 query rows each ----
    asm volatile("setmaxnreg.inc.sync.aligned.u32 240;\n");
    const int wg = threadIdx.x / 128 - 1;
    const int t = threadIdx.x % 128;
    const int warp = t / 32;
    const int lane = t % 32;
    const int tig = lane & 3;
    const int w_lo = q0 + 64 * wg;               // the warpgroup's first row
    const int r0 = w_lo + 16 * warp + (lane >> 2);  // and r0 + 8
    const uint32_t q_wg = q_s + 64 * 128 * wg;   // its rows of each Q panel

    const bool capped = p.softcap > 0.f;
    const float qk_scale = capped ? p.sm_scale / p.softcap
                                  : p.sm_scale * kLog2e;
    const float cap_log2 = p.softcap * kLog2e;

    // O as one accumulator fragment per 64-column panel
    float o[C::kPanels][32];
#pragma unroll
    for (int c = 0; c < C::kPanels; ++c)
#pragma unroll
      for (int j = 0; j < 32; ++j) o[c][j] = 0.f;
    float m[2] = {-INFINITY, -INFINITY};
    float l[2] = {0.f, 0.f};  // this thread's share; summed over the quad last

    if (n > 0) mbar_wait(q_full, 0);
    for (int i = 0; i < n; ++i) {
      const int s = i % S;
      const uint32_t ph = (i / S) & 1;
      const int k0 = (k_lo + i) * BK;
      const uint32_t off = s * C::kKVBytes;

      // S = Q K^T.  The descriptors are built from bases made opaque
      // here, so that no step's descriptor is hoisted out of the loop and
      // held in registers across it.
      uint32_t q_base = q_wg;
      asm volatile("" : "+r"(q_base));
      const uint64_t qd = sw128_desc(q_base, 16, 1024);
      const uint64_t kd = sw128_desc(k_s + off, 16, 1024);
      float sc[BK / 2];
      mbar_wait(k_full + 8 * s, ph);
      wgmma_fence();
#pragma unroll
      for (int kk = 0; kk < D / 16; ++kk) {
        // 16 columns: panel kk / 4, bytes 32 (kk % 4) of each 128-byte row
        const uint32_t col = (kk % 4) * 32;
        Wgmma<T>::ss(sc, qd + (((kk / 4) * C::kQPanel + col) >> 4),
                     kd + (((kk / 4) * C::kKVPanel + col) >> 4), kk > 0);
      }
      wgmma_commit();
      wgmma_wait_all();
      reg_fence(sc);
      if (lane == 0) mbar_arrive(k_empty + 8 * s);

      // mask and online softmax; only tiles that cross the diagonal, the
      // window's edge or Skv evaluate the mask
      const bool full = k0 + BK <= Skv &&
                        (!p.causal || k0 + BK - 1 <= w_lo) &&
                        k0 > w_lo + 63 - win;
      float alpha[2];
      if (full)
        softmax_tile<BK, false>(sc, m, l, alpha, p, qk_scale, cap_log2, win,
                                r0, k0, tig);
      else
        softmax_tile<BK, true>(sc, m, l, alpha, p, qk_scale, cap_log2, win,
                               r0, k0, tig);
#pragma unroll
      for (int c = 0; c < C::kPanels; ++c)
#pragma unroll
        for (int j = 0; j < 32; ++j) o[c][j] *= alpha[(j >> 1) & 1];

      // P = hi + lo in the input type, in wgmma's A-fragment layout: the
      // 16 keys of step kt are score columns 16 kt .. 16 kt + 15
      uint32_t p_hi[BK / 16][4], p_lo[BK / 16][4];
#pragma unroll
      for (int kt = 0; kt < BK / 16; ++kt)
#pragma unroll
        for (int r = 0; r < 4; ++r)
          split2<T>(sc[8 * kt + 2 * r], sc[8 * kt + 2 * r + 1], p_hi[kt][r],
                    p_lo[kt][r]);

      // O += P V; V's tile is (BK keys x D) with D contiguous: MN-major
      // B (leading offset: the next 64-column panel, unused at N = 64;
      // stride offset: the next 8 keys), 16 keys = 2048 bytes per step
      const uint64_t vd = sw128_desc(v_s + off, C::kKVPanel, 1024);
      mbar_wait(v_full + 8 * s, ph);
      wgmma_fence();
#pragma unroll
      for (int kt = 0; kt < BK / 16; ++kt)
#pragma unroll
        for (int c = 0; c < C::kPanels; ++c) {
          const uint64_t d = vd + ((c * C::kKVPanel + kt * 2048) >> 4);
          Wgmma<T>::rs(o[c], p_hi[kt], d);
          Wgmma<T>::rs(o[c], p_lo[kt], d);
        }
      wgmma_commit();
      wgmma_wait_all();
#pragma unroll
      for (int c = 0; c < C::kPanels; ++c) reg_fence(o[c]);
      reg_fence(p_hi);
      reg_fence(p_lo);
      if (lane == 0) mbar_arrive(v_empty + 8 * s);
    }

    // epilogue: O / l, staged through this warpgroup's rows of the Q
    // tile (its wgmmas have retired) in the same swizzled panels, then
    // written with 16-byte stores; the tile is contiguous in ``out``
    float inv[2];
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      l[r] += __shfl_xor_sync(0xffffffffu, l[r], 1);
      l[r] += __shfl_xor_sync(0xffffffffu, l[r], 2);
      inv[r] = l[r] > 0.f ? 1.f / l[r] : 1.f;
    }
    // the row log-sum-exp for the backward, from the log2 domain
    if (p.lse != nullptr && tig == 0) {
#pragma unroll
      for (int r = 0; r < 2; ++r)
        if (r0 + 8 * r < p.Sq)
          p.lse[static_cast<long long>(bh) * p.Sq + r0 + 8 * r] =
              l[r] > 0.f ? (m[r] + log2f(l[r])) * kLn2 : -INFINITY;
    }
#pragma unroll
    for (int c = 0; c < C::kPanels; ++c)
#pragma unroll
      for (int j = 0; j < 8; ++j)
#pragma unroll
        for (int r = 0; r < 2; ++r) {
          const int row = 16 * warp + (lane >> 2) + 8 * r;
          const uint32_t a = q_wg + c * C::kQPanel + row * 128 +
                             ((j ^ (row & 7)) << 4) + tig * 4;
          const uint32_t v = pack2<T>(o[c][4 * j + 2 * r] * inv[r],
                                      o[c][4 * j + 2 * r + 1] * inv[r]);
          asm volatile("st.shared.u32 [%0], %1;\n" ::"r"(a), "r"(v)
                       : "memory");
        }
    asm volatile("bar.sync %0, 128;\n" ::"r"(1 + wg) : "memory");
    constexpr int kChunks = D / 8;  // 16-byte chunks in a row
    const int rows = min(64, static_cast<int>(p.Sq) - w_lo);
    T* out = static_cast<T*>(p.out) +
             (static_cast<long long>(bh) * p.Sq + w_lo) * D;
    for (int e = t; e < rows * kChunks; e += 128) {
      const int row = e / kChunks;
      const int ch = e - row * kChunks;
      const uint32_t a = q_wg + (ch / 8) * C::kQPanel + row * 128 +
                         (((ch % 8) ^ (row & 7)) << 4);
      uint4 v;
      asm volatile("ld.shared.v4.u32 {%0, %1, %2, %3}, [%4];\n"
                   : "=r"(v.x), "=r"(v.y), "=r"(v.z), "=r"(v.w)
                   : "r"(a)
                   : "memory");
      *reinterpret_cast<uint4*>(out + static_cast<long long>(row) * D +
                                ch * 8) = v;
    }
  }
}

// ---------------------------------------------------------------------------
// host side
// ---------------------------------------------------------------------------
// the TMA path reads every row through a tensor map, which takes
// 16-byte aligned bases and strides that are 16-byte multiples in
// [16, 2^40): every row start must be 16-byte aligned
inline bool rows_aligned16(const Params& p) {
  return view_aligned16(p.q, p.qsb, p.qsh, p.qss) &&
         view_aligned16(p.k, p.ksb, p.ksh, p.kss) &&
         view_aligned16(p.v, p.vsb, p.vsh, p.vss) &&
         reinterpret_cast<uintptr_t>(p.out) % 16 == 0;
}

template <typename T, int D>
int launch_tma(const Params& p, cudaStream_t st) {
  using C = TmaTile<D>;
  if (p.Sq >= (1LL << 30) || p.Skv >= (1LL << 30))
    return static_cast<int>(cudaErrorInvalidValue);  // int tile coordinates
  CUtensorMap qm, km, vm;
  int rc = encode_map<T>(&qm, p.q, p.B, p.Hq, p.Sq, D, p.qsb, p.qsh, p.qss,
                         kTmaBQ);
  if (rc == 0)
    rc = encode_map<T>(&km, p.k, p.B, p.Hkv, p.Skv, D, p.ksb, p.ksh, p.kss,
                       C::kBK);
  if (rc == 0)
    rc = encode_map<T>(&vm, p.v, p.B, p.Hkv, p.Skv, D, p.vsb, p.vsh, p.vss,
                       C::kBK);
  if (rc != 0) return rc;
  const cudaError_t e = cudaFuncSetAttribute(
      flash_tma_kernel<T, D>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      static_cast<int>(C::kSmem));
  if (e != cudaSuccess) return static_cast<int>(e);
  const dim3 grid(static_cast<unsigned>(p.B * p.Hq),
                  static_cast<unsigned>((p.Sq + kTmaBQ - 1) / kTmaBQ));
  flash_tma_kernel<T, D><<<grid, kTmaThreads, C::kSmem, st>>>(qm, km, vm, p);
  return static_cast<int>(cudaGetLastError());
}

// ---------------------------------------------------------------------------
// FMA path
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

// bf16 / f16: the TMA path wherever the views allow it
template <typename T>
int dispatch_tc(const Params& p, long long D, cudaStream_t st) {
  if (!rows_aligned16(p)) return dispatch_d<T>(p, D, st);
  switch (D) {
    case 64: return launch_tma<T, 64>(p, st);
    case 128: return launch_tma<T, 128>(p, st);
    case 192: return launch_tma<T, 192>(p, st);
    case 256: return launch_tma<T, 256>(p, st);
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
}

}  // namespace

extern "C" {

// dtype: 0 float32, 1 bfloat16, 2 float16.  ``lse``, when not null,
// receives each row's natural-log log-sum-exp of its kept scores,
// (B, Hq, Sq) float32, -inf for a row that keeps no key: what the
// backward (flash_attention_bwd.cu) recomputes P from.  Returns
// cudaGetLastError() after the launch (cudaErrorInvalidValue for a shape
// or dtype the kernel does not take), or -CUresult when a TMA tensor map
// fails to encode.
int flash_attention_fwd(const void* q, const void* k, const void* v,
                        void* out, float* lse, int dtype, long long B,
                        long long Hq, long long Hkv, long long Sq,
                        long long Skv,
                        long long D, long long qsb, long long qsh,
                        long long qss, long long ksb, long long ksh,
                        long long kss, long long vsb, long long vsh,
                        long long vss, float sm_scale, int causal,
                        long long window, float softcap, void* stream) {
  if (B <= 0 || Hq <= 0 || Hkv <= 0 || Hq % Hkv || Sq <= 0 || Skv <= 0 ||
      B * Hq > 2147483647LL || (Sq + kBQ - 1) / kBQ > 65535)
    return static_cast<int>(cudaErrorInvalidValue);
  // the same mask, in a range the kernels hold in int: i - j < Sq always,
  // so a window >= Sq keeps every key (no window is passed as Sq), and
  // j > i + Skv never holds, so a window <= -Skv keeps none
  if (window > Sq) window = Sq;
  if (window < -Skv) window = -Skv;
  Params p{q, k, v, out, lse, B, Hq, Hkv, Sq, Skv, qsb, qsh, qss, ksb, ksh, kss,
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
