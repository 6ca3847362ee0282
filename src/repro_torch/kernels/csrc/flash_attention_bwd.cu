// Flash attention's backward for Hopper (sm_90a): FlashAttention-2's
// gradient, recomputing P from the forward's row log-sum-exp.
//
// The gradient of src/repro/kernels/flash_attention.py:34: the JAX
// package has no Pallas backward and takes jax.grad of its plain
// flash_ref; this computes the same from the forward's output O and row
// log-sum-exp L (csrc/flash_attention.cu writes both):
//
//   s_ij = sm_scale * q_i . k_j  (softcap c: x_ij = c tanh(s_ij / c))
//   P_ij = exp(x_ij - L_i) over the keys j the mask keeps, else 0
//   dV_j = sum_i P_ij dO_i              dP_ij = dO_i . v_j
//   D_i  = dO_i . O_i                   dX_ij = P_ij (dP_ij - D_i)
//   dS_ij = sm_scale dX_ij (1 - (x_ij / c)^2)   (no softcap: sm_scale dX_ij)
//   dQ_i = sum_j dS_ij k_j              dK_j = sum_i dS_ij q_i
//
// over the forward's masks (causal top-left, keys j > i - window for any
// integer window, clamped to [-Skv, Sq] as the forward clamps it), GQA
// (dK, dV of kv head hk sum over the q-heads of its group), float32,
// bfloat16 and float16 inputs with f32 arithmetic, head dims 64 and 128.
// A row whose L is -inf (it keeps no key) gives 0 everywhere.
//
// No atomics on either route, so the result is the same bits on every
// run.  The route is picked from dtype, head dim and alignment before
// the launch (tc_route; flash_bwd_scratch_floats tells the wrapper the
// route and the scratch it allocates); a refused launch or a tensor map
// that fails to encode returns non-zero and the wrapper raises.
//
// The tensor-core route: bfloat16 / float16 at head dims 64 and 128,
// every base and (b, h, s) stride a 16-byte multiple (the models'
// transposed (B, S, H, D) views included).  Four launches:
//  (a) flash_bwd_rows: L2 = L log2 e and Dl = rowsum(dO * O) into the
//      wrapper's scratch, padded to 128 rows a head (+inf and 0 past Sq
//      or where the row keeps no key, so that P is exactly 0 there);
//  (b) flash_bwd_dkdv_tc: one CTA per (b, q-head, 128-key block), key
//      block 0 first (the causal mask gives it the most rows): B Hq
//      Skv / 128 CTAs, 768 at qwen2's training shape, ~6 waves on 132
//      SMs.  A producer warpgroup (setmaxnreg 24) loads K and V of the
//      block once by TMA and streams the kept 32-row q tiles' Q and dO
//      (TMA, one thread) and their L2 and Dl rows (bulk copies, a second
//      thread) through a 4-stage ring of full / empty mbarriers.  Two
//      consumer warpgroups (240 registers) own 64 keys each, the keys as
//      wgmma's M rows as in FlashAttention-3's backward: S^T = K Q^T and
//      dP^T = V dO^T are SS wgmmas (m64n32k16, both K-major); P^T and
//      dS^T are built in registers (mask only on tiles that cross the
//      diagonal or the window's edge, softcap, exp2(x - L2), dS = P (dP
//      - Dl) dcap sm_scale), split into input-type hi + lo, and dV +=
//      P^T dO and dK += dS^T Q are register-A wgmmas with dO and Q read
//      as MN-major B through the descriptor (no transpose): two
//      products each, since dO and Q are exact in 16 bits.  Under GQA the CTA
//      writes its q-head's f32 dK and dV to the scratch;
//  (c) flash_bwd_gsum (GQA only): dK and dV of each kv head, the group's
//      partials summed in q-head order and rounded once;
//  (d) flash_bwd_dq_tc: one CTA per (b, q-head, 128-row q-block), last
//      block first.  Q and dO of the block are loaded once; 64-key K
//      and V tiles stream through a 2-stage ring; two consumer
//      warpgroups of 64 rows recompute S = Q K^T and dP = dO V^T (SS,
//      m64n64k16) and accumulate dQ += dS K with dS split hi + lo as
//      the register A and K as an MN-major B.
// P and dS keep ~16 bits through the hi + lo split where one rounding
// to 16 bits would keep 8 and land ~1e-3 beyond half an output ulp of
// the f32 gradient (tests/test_torch_attention.py emulates this
// arithmetic against jax.grad).  Register budget of a dK/dV consumer at
// D = 128: dK and dV 128 floats, S^T and dP^T 32, their hi + lo 32; with
// 64-row q tiles (64 + 64) ptxas spilled.
//
// The FMA route: float32, and 16-bit views that are not aligned (f32
// arithmetic on every input type), three kernels:
//  (a) flash_bwd_delta: D_i = rowsum(dO * O) in f32, one warp per row;
//  (b) flash_bwd_dkdv: one CTA per (b, kv head, 64-key block).  K and V
//      of the block stay in shared memory; the CTA walks the group's
//      q-heads and the 64-row q-blocks the forward's visit predicate
//      keeps for this key block, recomputes S and dP for the tile, and
//      accumulates dV += P^T dO and dK += dS^T Q in registers;
//  (c) flash_bwd_dq: one CTA per (b, q head, 64-row q-block).  Q and dO
//      stay in shared memory; it walks the kept key blocks, recomputes S
//      and dP, and accumulates dQ += dS K in registers.
// Layout: 256 threads as a 16 x 16 grid.  For the scores, thread (ty,
// tx) owns rows 4 ty .. 4 ty + 3 and key columns tx + 16 c (c < 4) of
// the 64 x 64 tile; for an accumulator, its 4 rows (keys in (b), query
// rows in (c)) and head-dim columns tx + 16 c (c < D / 16).  Tiles are
// f32 in shared memory with rows padded by one word (no bank conflicts);
// P and dS pass between the phases through 64 x 65 f32 tiles.  Inputs
// are read in place through their strides, outputs written through
// theirs.
//
// Bound on an H100 SXM: 2.5x the forward's 4 * B * Hq * D * (kept pairs)
// operations (five products per pair) at 989 TFLOP/s (bf16/f16
// tensor-core peak; 67 TFLOP/s f32).  Each kernel recomputes the scores
// it needs instead of carrying dQ partial sums between CTAs, and P and
// dS go in as hi + lo pairs: the tensor-core route runs ten products per
// pair, so its floor is 2x the bound; the FMA route runs seven on f32
// FMAs.  Not done here: ping-pong scheduling of the consumers, overlap
// of the elementwise work with the products, a persistent scheduler,
// running (b) and (d) side by side.

#include "hopper.cuh"

namespace {

constexpr int kT = 64;         // query rows and keys per tile
constexpr int kThreads = 256;  // 16 x 16
constexpr int kRows = 4;       // tile rows per thread
constexpr int kCols = 4;       // score columns per thread
constexpr int kPP = kT + 1;    // pitch of the P and dS tiles

// element strides (b, h, s) of one (B, H, S, D) view; the last axis unit
struct View {
  long long sb, sh, ss;
};

struct Params {
  const void *q, *k, *v, *o, *dout;
  const float* lse;  // contiguous (B, Hq, Sq)
  float* delta;      // contiguous (B, Hq, Sq): rowsum(dO * O)
  void *dq, *dk, *dv;
  View vq, vk, vv, vo, vdo, vdq, vdk, vdv;
  long long B, Hq, Hkv, Sq, Skv;
  float sm_scale;
  int causal;
  long long window;  // keys j > i - window, in [-Skv, Sq]
  float softcap;     // 0: none
  // the tensor-core route's scratch (see tc_scratch_floats)
  float* l2;          // (B Hq, sq_pad): L log2 e; +inf past Sq or no key
  float* dl;          // (B Hq, sq_pad): rowsum(dO * O); 0 past Sq
  float* pdk;         // (B Hq, Skv, D) f32 dK of each q-head (GQA only)
  float* pdv;         // likewise dV
  long long sq_pad;   // Sq rounded up to kTcPad
};

// the forward's visit predicate (flash_attention.cu, FMA path): the
// key blocks [k_lo, k_hi) that q-block ``qb`` reads; no other pair of
// blocks keeps any (row, key)
__device__ __forceinline__ void key_blocks(const Params& p, long long qb,
                                           long long& k_lo,
                                           long long& k_hi) {
  const long long q0 = qb * kT;
  const long long nk = (p.Skv + kT - 1) / kT;
  k_hi = nk;
  if (p.causal) {
    const long long last = (q0 + kT - 1) / kT + 1;
    k_hi = last < nk ? last : nk;
  }
  const long long lo = q0 - p.window - kT + 1;
  k_lo = lo > 0 ? (lo + kT - 1) / kT : 0;
}

// rows [row0, row0 + kT) of a (rows, D) head slice -> f32 tile of pitch
// D + 1; rows at or past n read as 0
template <typename T, int D>
__device__ __forceinline__ void load_tile(float* tile, const T* base,
                                          long long stride, long long row0,
                                          long long n) {
  constexpr int P = D + 1;
  for (int e = threadIdx.x; e < kT * D; e += kThreads) {
    const int r = e / D;
    const int c = e - r * D;
    const long long row = row0 + r;
    tile[r * P + c] = row < n ? to_f32<T>(base[row * stride + c]) : 0.f;
  }
}

// s = Q K^T and dp = dO V^T for this thread's 4 x 4 share of the tile:
// rows 4 ty + i of q_s / do_s, keys tx + 16 c of k_s / v_s
template <int D>
__device__ __forceinline__ void scores(const float* q_s, const float* do_s,
                                       const float* k_s, const float* v_s,
                                       int ty, int tx,
                                       float (&s)[kRows][kCols],
                                       float (&dp)[kRows][kCols]) {
  constexpr int P = D + 1;
#pragma unroll
  for (int i = 0; i < kRows; ++i)
#pragma unroll
    for (int c = 0; c < kCols; ++c) s[i][c] = dp[i][c] = 0.f;
#pragma unroll 4
  for (int d = 0; d < D; ++d) {
    float qv[kRows], dov[kRows], kv[kCols], vv[kCols];
#pragma unroll
    for (int i = 0; i < kRows; ++i) {
      qv[i] = q_s[(4 * ty + i) * P + d];
      dov[i] = do_s[(4 * ty + i) * P + d];
    }
#pragma unroll
    for (int c = 0; c < kCols; ++c) {
      kv[c] = k_s[(tx + 16 * c) * P + d];
      vv[c] = v_s[(tx + 16 * c) * P + d];
    }
#pragma unroll
    for (int i = 0; i < kRows; ++i)
#pragma unroll
      for (int c = 0; c < kCols; ++c) {
        s[i][c] = fmaf(qv[i], kv[c], s[i][c]);
        dp[i][c] = fmaf(dov[i], vv[c], dp[i][c]);
      }
  }
}

// P and dS of one score: the mask, the softcap, exp(x - L) and the
// chain rule back to the raw product q . k (sm_scale included)
__device__ __forceinline__ void grad_score(const Params& p, long long row,
                                           long long col, float s, float dp,
                                           float lse, float delta, float& pr,
                                           float& ds) {
  bool keep = row < p.Sq && col < p.Skv && col > row - p.window;
  if (p.causal) keep = keep && col <= row;
  if (!keep || lse == -INFINITY) {
    pr = 0.f;
    ds = 0.f;
    return;
  }
  float x = s * p.sm_scale;
  float dcap = 1.f;
  if (p.softcap > 0.f) {
    const float t = tanhf(x / p.softcap);
    x = p.softcap * t;
    dcap = 1.f - t * t;
  }
  pr = expf(x - lse);
  ds = pr * (dp - delta) * dcap * p.sm_scale;
}

// (a) D_i = dO_i . O_i, one warp per (b, h, i) row
template <typename T, int D>
__global__ void __launch_bounds__(kThreads)
flash_bwd_delta(const Params p) {
  const long long row = static_cast<long long>(blockIdx.x) * (kThreads / 32) +
                        threadIdx.x / 32;
  const int lane = threadIdx.x % 32;
  if (row >= p.B * p.Hq * p.Sq) return;
  const long long bh = row / p.Sq;
  const long long i = row - bh * p.Sq;
  const long long b = bh / p.Hq;
  const long long h = bh - b * p.Hq;
  const T* o = static_cast<const T*>(p.o) + b * p.vo.sb + h * p.vo.sh +
               i * p.vo.ss;
  const T* dout = static_cast<const T*>(p.dout) + b * p.vdo.sb +
                  h * p.vdo.sh + i * p.vdo.ss;
  float acc = 0.f;
#pragma unroll
  for (int d = lane; d < D; d += 32)
    acc = fmaf(to_f32<T>(o[d]), to_f32<T>(dout[d]), acc);
#pragma unroll
  for (int off = 16; off > 0; off >>= 1)
    acc += __shfl_xor_sync(0xffffffffu, acc, off);
  if (lane == 0) p.delta[row] = acc;
}

template <int D>
constexpr size_t dkdv_smem() {
  return sizeof(float) * (4 * static_cast<size_t>(kT) * (D + 1) +
                          2 * static_cast<size_t>(kT) * kPP + 2 * kT);
}

template <int D>
constexpr size_t dq_smem() {
  return sizeof(float) * (4 * static_cast<size_t>(kT) * (D + 1) +
                          static_cast<size_t>(kT) * kPP);
}

// (b) dK and dV of one (b, kv head, key block)
template <typename T, int D>
__global__ void __launch_bounds__(kThreads)
flash_bwd_dkdv(const Params p) {
  constexpr int P = D + 1;
  constexpr int kOut = D / 16;
  extern __shared__ float smem[];
  float* k_s = smem;                // kT x P
  float* v_s = k_s + kT * P;
  float* q_s = v_s + kT * P;
  float* do_s = q_s + kT * P;
  float* p_s = do_s + kT * P;       // kT x kPP: P[query row][key]
  float* ds_s = p_s + kT * kPP;     // kT x kPP: dS[query row][key]
  float* lse_s = ds_s + kT * kPP;   // kT
  float* dl_s = lse_s + kT;         // kT

  const long long bhk = blockIdx.x;
  const long long b = bhk / p.Hkv;
  const long long hk = bhk - b * p.Hkv;
  const long long kb = blockIdx.y;  // causal: the first blocks work most
  const long long k0 = kb * kT;
  const long long group = p.Hq / p.Hkv;
  const int tx = threadIdx.x % 16;
  const int ty = threadIdx.x / 16;

  load_tile<T, D>(k_s, static_cast<const T*>(p.k) + b * p.vk.sb +
                           hk * p.vk.sh, p.vk.ss, k0, p.Skv);
  load_tile<T, D>(v_s, static_cast<const T*>(p.v) + b * p.vv.sb +
                           hk * p.vv.sh, p.vv.ss, k0, p.Skv);

  float dk[kRows][kOut], dv[kRows][kOut];
#pragma unroll
  for (int a = 0; a < kRows; ++a)
#pragma unroll
    for (int c = 0; c < kOut; ++c) dk[a][c] = dv[a][c] = 0.f;

  const long long nq = (p.Sq + kT - 1) / kT;
  for (long long h = hk * group; h < (hk + 1) * group; ++h) {
    const long long bh = b * p.Hq + h;
    for (long long qb = 0; qb < nq; ++qb) {
      long long k_lo, k_hi;
      key_blocks(p, qb, k_lo, k_hi);
      if (kb < k_lo || kb >= k_hi) continue;
      const long long q0 = qb * kT;
      __syncthreads();  // the previous tile's reads are done
      load_tile<T, D>(q_s, static_cast<const T*>(p.q) + b * p.vq.sb +
                               h * p.vq.sh, p.vq.ss, q0, p.Sq);
      load_tile<T, D>(do_s, static_cast<const T*>(p.dout) + b * p.vdo.sb +
                                h * p.vdo.sh, p.vdo.ss, q0, p.Sq);
      if (threadIdx.x < kT) {
        const long long row = q0 + threadIdx.x;
        lse_s[threadIdx.x] = row < p.Sq ? p.lse[bh * p.Sq + row] : -INFINITY;
        dl_s[threadIdx.x] = row < p.Sq ? p.delta[bh * p.Sq + row] : 0.f;
      }
      __syncthreads();

      float s[kRows][kCols], dp[kRows][kCols];
      scores<D>(q_s, do_s, k_s, v_s, ty, tx, s, dp);
#pragma unroll
      for (int i = 0; i < kRows; ++i) {
        const int r = 4 * ty + i;
#pragma unroll
        for (int c = 0; c < kCols; ++c) {
          float pr, ds;
          grad_score(p, q0 + r, k0 + tx + 16 * c, s[i][c], dp[i][c],
                     lse_s[r], dl_s[r], pr, ds);
          p_s[r * kPP + tx + 16 * c] = pr;
          ds_s[r * kPP + tx + 16 * c] = ds;
        }
      }
      __syncthreads();

      // dV[key] += sum_rows P[row][key] dO[row]; dK likewise with dS, Q
#pragma unroll 4
      for (int j = 0; j < kT; ++j) {
        float pv[kRows], dsv[kRows];
#pragma unroll
        for (int a = 0; a < kRows; ++a) {
          pv[a] = p_s[j * kPP + 4 * ty + a];
          dsv[a] = ds_s[j * kPP + 4 * ty + a];
        }
#pragma unroll
        for (int c = 0; c < kOut; ++c) {
          const float dov = do_s[j * P + tx + 16 * c];
          const float qv = q_s[j * P + tx + 16 * c];
#pragma unroll
          for (int a = 0; a < kRows; ++a) {
            dv[a][c] = fmaf(pv[a], dov, dv[a][c]);
            dk[a][c] = fmaf(dsv[a], qv, dk[a][c]);
          }
        }
      }
    }
  }

  T* dkh = static_cast<T*>(p.dk) + b * p.vdk.sb + hk * p.vdk.sh;
  T* dvh = static_cast<T*>(p.dv) + b * p.vdv.sb + hk * p.vdv.sh;
#pragma unroll
  for (int a = 0; a < kRows; ++a) {
    const long long key = k0 + 4 * ty + a;
    if (key >= p.Skv) continue;
#pragma unroll
    for (int c = 0; c < kOut; ++c) {
      dkh[key * p.vdk.ss + tx + 16 * c] = from_f32<T>(dk[a][c]);
      dvh[key * p.vdv.ss + tx + 16 * c] = from_f32<T>(dv[a][c]);
    }
  }
}

// (c) dQ of one (b, q head, q-block)
template <typename T, int D>
__global__ void __launch_bounds__(kThreads)
flash_bwd_dq(const Params p) {
  constexpr int P = D + 1;
  constexpr int kOut = D / 16;
  extern __shared__ float smem[];
  float* q_s = smem;                // kT x P
  float* do_s = q_s + kT * P;
  float* k_s = do_s + kT * P;
  float* v_s = k_s + kT * P;
  float* ds_s = v_s + kT * P;       // kT x kPP: dS[query row][key]

  const long long bh = blockIdx.x;
  const long long b = bh / p.Hq;
  const long long h = bh - b * p.Hq;
  const long long hk = h / (p.Hq / p.Hkv);
  // last q-block first: under a causal mask those read the most keys
  const long long qb = static_cast<long long>(gridDim.y) - 1 - blockIdx.y;
  const long long q0 = qb * kT;
  const int tx = threadIdx.x % 16;
  const int ty = threadIdx.x / 16;

  load_tile<T, D>(q_s, static_cast<const T*>(p.q) + b * p.vq.sb +
                           h * p.vq.sh, p.vq.ss, q0, p.Sq);
  load_tile<T, D>(do_s, static_cast<const T*>(p.dout) + b * p.vdo.sb +
                            h * p.vdo.sh, p.vdo.ss, q0, p.Sq);
  float lse[kRows], dl[kRows];
#pragma unroll
  for (int i = 0; i < kRows; ++i) {
    const long long row = q0 + 4 * ty + i;
    lse[i] = row < p.Sq ? p.lse[bh * p.Sq + row] : -INFINITY;
    dl[i] = row < p.Sq ? p.delta[bh * p.Sq + row] : 0.f;
  }

  float dq[kRows][kOut];
#pragma unroll
  for (int i = 0; i < kRows; ++i)
#pragma unroll
    for (int c = 0; c < kOut; ++c) dq[i][c] = 0.f;

  const T* kh = static_cast<const T*>(p.k) + b * p.vk.sb + hk * p.vk.sh;
  const T* vh = static_cast<const T*>(p.v) + b * p.vv.sb + hk * p.vv.sh;
  long long k_lo, k_hi;
  key_blocks(p, qb, k_lo, k_hi);
  for (long long kb = k_lo; kb < k_hi; ++kb) {
    const long long k0 = kb * kT;
    __syncthreads();  // the previous tile's reads are done
    load_tile<T, D>(k_s, kh, p.vk.ss, k0, p.Skv);
    load_tile<T, D>(v_s, vh, p.vv.ss, k0, p.Skv);
    __syncthreads();

    float s[kRows][kCols], dp[kRows][kCols];
    scores<D>(q_s, do_s, k_s, v_s, ty, tx, s, dp);
#pragma unroll
    for (int i = 0; i < kRows; ++i)
#pragma unroll
      for (int c = 0; c < kCols; ++c) {
        float pr, ds;
        grad_score(p, q0 + 4 * ty + i, k0 + tx + 16 * c, s[i][c], dp[i][c],
                   lse[i], dl[i], pr, ds);
        ds_s[(4 * ty + i) * kPP + tx + 16 * c] = ds;
      }
    __syncthreads();

    // dQ[row] += sum_keys dS[row][key] K[key]
#pragma unroll 4
    for (int j = 0; j < kT; ++j) {
      float dsv[kRows];
#pragma unroll
      for (int i = 0; i < kRows; ++i) dsv[i] = ds_s[(4 * ty + i) * kPP + j];
#pragma unroll
      for (int c = 0; c < kOut; ++c) {
        const float kv = k_s[j * P + tx + 16 * c];
#pragma unroll
        for (int i = 0; i < kRows; ++i) dq[i][c] = fmaf(dsv[i], kv, dq[i][c]);
      }
    }
  }

  T* dqh = static_cast<T*>(p.dq) + b * p.vdq.sb + h * p.vdq.sh;
#pragma unroll
  for (int i = 0; i < kRows; ++i) {
    const long long row = q0 + 4 * ty + i;
    if (row >= p.Sq) continue;
#pragma unroll
    for (int c = 0; c < kOut; ++c)
      dqh[row * p.vdq.ss + tx + 16 * c] = from_f32<T>(dq[i][c]);
  }
}

template <typename T, int D>
int launch(const Params& p, cudaStream_t st) {
  constexpr size_t s_dkdv = dkdv_smem<D>();
  constexpr size_t s_dq = dq_smem<D>();
  cudaError_t e = cudaFuncSetAttribute(
      flash_bwd_dkdv<T, D>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      static_cast<int>(s_dkdv));
  if (e != cudaSuccess) return static_cast<int>(e);
  e = cudaFuncSetAttribute(flash_bwd_dq<T, D>,
                           cudaFuncAttributeMaxDynamicSharedMemorySize,
                           static_cast<int>(s_dq));
  if (e != cudaSuccess) return static_cast<int>(e);
  const long long rows = p.B * p.Hq * p.Sq;
  constexpr int kWarps = kThreads / 32;
  flash_bwd_delta<T, D><<<static_cast<unsigned>((rows + kWarps - 1) / kWarps),
                          kThreads, 0, st>>>(p);
  e = cudaGetLastError();
  if (e != cudaSuccess) return static_cast<int>(e);
  const dim3 g_kv(static_cast<unsigned>(p.B * p.Hkv),
                  static_cast<unsigned>((p.Skv + kT - 1) / kT));
  flash_bwd_dkdv<T, D><<<g_kv, kThreads, s_dkdv, st>>>(p);
  e = cudaGetLastError();
  if (e != cudaSuccess) return static_cast<int>(e);
  const dim3 g_q(static_cast<unsigned>(p.B * p.Hq),
                 static_cast<unsigned>((p.Sq + kT - 1) / kT));
  flash_bwd_dq<T, D><<<g_q, kThreads, s_dq, st>>>(p);
  return static_cast<int>(cudaGetLastError());
}

template <typename T>
int dispatch_d(const Params& p, long long D, cudaStream_t st) {
  switch (D) {
    case 64: return launch<T, 64>(p, st);
    case 128: return launch<T, 128>(p, st);
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
}

// ---------------------------------------------------------------------------
// tensor-core route (bf16 / f16, head dim 64 or 128, aligned rows)
// ---------------------------------------------------------------------------
constexpr int kTcThreads = 384;  // producer warpgroup + 2 consumers
constexpr int kStages = 2;       // depth of the dQ kernel's K / V ring
constexpr int kKvStages = 4;     // depth of the dK/dV kernel's Q / dO ring
constexpr int kKvBN = 128;       // dK/dV: keys per CTA, 64 per consumer
constexpr int kKvBQ = 32;        // dK/dV: query rows per streamed tile
constexpr int kQBQ = 128;        // dQ: query rows per CTA, 64 per consumer
constexpr int kQBK = 64;         // dQ: keys per streamed tile
constexpr int kTcPad = 128;      // the row arrays' padding (>= kQBQ)

template <int D>
struct TcTile {
  static constexpr int kPanels = D / 64;  // 64-column (128-byte) panels
  // every tile is kPanels panels of (rows x 128 bytes), 128-byte swizzled.
  // dK/dV: K and V of the block, then per stage Q, dO, L and Dl
  static constexpr uint32_t kKvPanel = kKvBN * 128;
  static constexpr uint32_t kKvBytes = kKvPanel * kPanels;
  static constexpr uint32_t kQtPanel = kKvBQ * 128;
  static constexpr uint32_t kQtBytes = kQtPanel * kPanels;
  static constexpr uint32_t kRowBytes = kKvBQ * 4;
  static constexpr uint32_t kKvQ = 2 * kKvBytes;
  static constexpr uint32_t kKvDO = kKvQ + kKvStages * kQtBytes;
  static constexpr uint32_t kKvL = kKvDO + kKvStages * kQtBytes;
  static constexpr uint32_t kKvDl = kKvL + kKvStages * kRowBytes;
  static constexpr uint32_t kKvBars = kKvDl + kKvStages * kRowBytes;
  // barriers: kv_full, then full, rows_full and empty per stage; 1024
  // bytes of slack align the tiles to the swizzle's 1024-byte atom
  static constexpr uint32_t kKvSmem =
      kKvBars + 8 * (1 + 3 * kKvStages) + 1024;
  // dQ: Q and dO of the block, then per stage K and V
  static constexpr uint32_t kQqPanel = kQBQ * 128;
  static constexpr uint32_t kQqBytes = kQqPanel * kPanels;
  static constexpr uint32_t kKtPanel = kQBK * 128;
  static constexpr uint32_t kKtBytes = kKtPanel * kPanels;
  static constexpr uint32_t kQK = 2 * kQqBytes;
  static constexpr uint32_t kQV = kQK + kStages * kKtBytes;
  static constexpr uint32_t kQBars = kQV + kStages * kKtBytes;
  static constexpr uint32_t kQSmem = kQBars + 8 * (1 + 2 * kStages) + 1024;
};

// the scratch of the route, in f32 words: L2 and Dl (B Hq rows of sq_pad
// each), then under GQA the f32 dK and dV of every q-head
long long tc_scratch_floats(long long B, long long Hq, long long Hkv,
                            long long Sq, long long Skv, long long D) {
  const long long sq_pad = (Sq + kTcPad - 1) / kTcPad * kTcPad;
  return 2 * B * Hq * sq_pad + (Hq != Hkv ? 2 * B * Hq * Skv * D : 0);
}

// every view goes through a tensor map or 16-byte vectors
inline bool tc_route(const Params& p, long long D) {
  const void* ptrs[8] = {p.q, p.k, p.v, p.o, p.dout, p.dq, p.dk, p.dv};
  const View* views[8] = {&p.vq, &p.vk, &p.vv, &p.vo, &p.vdo, &p.vdq,
                          &p.vdk, &p.vdv};
  if (D != 64 && D != 128) return false;
  for (int i = 0; i < 8; ++i)
    if (!view_aligned16(ptrs[i], views[i]->sb, views[i]->sh, views[i]->ss))
      return false;
  return true;
}

__device__ __forceinline__ float2 ld_shared_f2(uint32_t addr) {
  float2 v;
  asm volatile("ld.shared.v2.f32 {%0, %1}, [%2];\n"
               : "=f"(v.x), "=f"(v.y)
               : "r"(addr));
  return v;
}

// (a) L2 = L log2 e (+inf where the row keeps no key or lies past Sq, so
// that P = exp2(x - L2) is exactly 0 there) and Dl = rowsum(dO * O) (0
// past Sq): one warp per (b, h, row < sq_pad), D / 32 elements of a row
// per lane in one vector load
template <typename T, int D>
__global__ void __launch_bounds__(256)
flash_bwd_rows(const Params p) {
  constexpr int E = D / 32;
  using Vec = typename std::conditional<E == 4, uint2, uint32_t>::type;
  const long long row = static_cast<long long>(blockIdx.x) * 8 +
                        threadIdx.x / 32;
  const int lane = threadIdx.x % 32;
  if (row >= p.B * p.Hq * p.sq_pad) return;
  const long long bh = row / p.sq_pad;
  const long long i = row - bh * p.sq_pad;
  float acc = 0.f, l2 = INFINITY;
  if (i < p.Sq) {
    const long long b = bh / p.Hq;
    const long long h = bh - b * p.Hq;
    const Vec ov = *reinterpret_cast<const Vec*>(
        static_cast<const T*>(p.o) + b * p.vo.sb + h * p.vo.sh +
        i * p.vo.ss + lane * E);
    const Vec gv = *reinterpret_cast<const Vec*>(
        static_cast<const T*>(p.dout) + b * p.vdo.sb + h * p.vdo.sh +
        i * p.vdo.ss + lane * E);
    const T* oe = reinterpret_cast<const T*>(&ov);
    const T* ge = reinterpret_cast<const T*>(&gv);
#pragma unroll
    for (int e = 0; e < E; ++e)
      acc = fmaf(to_f32<T>(oe[e]), to_f32<T>(ge[e]), acc);
#pragma unroll
    for (int off = 16; off > 0; off >>= 1)
      acc += __shfl_xor_sync(0xffffffffu, acc, off);
    const float L = p.lse[bh * p.Sq + i];
    if (L != -INFINITY) l2 = L * kLog2e;
  }
  if (lane == 0) {
    p.l2[row] = l2;
    p.dl[row] = acc;
  }
}

// P^T and dS^T of one (64 keys x kKvBQ queries) tile in the wgmma
// accumulator layout: s[4 t + e] is key r0 + 8 (e >> 1), query
// q0 + 8 t + 2 tig + (e & 1).  In: the scores K Q^T in s and dO V^T in
// dp; out: P in s, dS (sm_scale and the softcap's derivative included)
// in dp.  L2 and Dl of the tile's queries come from shared memory.
template <bool kMasked>
__device__ __forceinline__ void grad_tile_kq(float (&s)[kKvBQ / 2],
                                             float (&dp)[kKvBQ / 2],
                                             uint32_t l_row, uint32_t d_row,
                                             const Params& p, float qk_scale,
                                             float cap_log2, int win, int r0,
                                             int q0, int tig) {
#pragma unroll
  for (int t = 0; t < kKvBQ / 8; ++t) {
    const float2 L = ld_shared_f2(l_row + (8 * t + 2 * tig) * 4);
    const float2 Dl = ld_shared_f2(d_row + (8 * t + 2 * tig) * 4);
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      const int i = 4 * t + e;
      float x = s[i] * qk_scale;
      float dscale = p.sm_scale;
      if (p.softcap > 0.f) {
        const float th = tanhf(x);
        x = cap_log2 * th;
        dscale = p.sm_scale * (1.f - th * th);
      }
      float pr = fast_exp2(x - ((e & 1) ? L.y : L.x));
      if (kMasked) {
        const int key = r0 + 8 * (e >> 1);
        const int q = q0 + 8 * t + 2 * tig + (e & 1);
        bool ok = key > q - win;
        if (p.causal) ok = ok && key <= q;
        pr = ok ? pr : 0.f;
      }
      s[i] = pr;
      dp[i] = pr * (dp[i] - ((e & 1) ? Dl.y : Dl.x)) * dscale;
    }
  }
}

// (b) dK and dV of one (b, q-head, 128-key block): f32 partials of the
// q-head under GQA, the output type otherwise
template <typename T, int D>
__global__ void __launch_bounds__(kTcThreads, 1)
flash_bwd_dkdv_tc(const __grid_constant__ CUtensorMap qmap,
                  const __grid_constant__ CUtensorMap dmap,
                  const __grid_constant__ CUtensorMap kmap,
                  const __grid_constant__ CUtensorMap vmap, const Params p) {
  using C = TcTile<D>;
  constexpr int BQ = kKvBQ;
  constexpr int S = kKvStages;
  extern __shared__ unsigned char smem_raw[];
  const uint32_t k_s = (smem_addr(smem_raw) + 1023u) & ~1023u;
  const uint32_t v_s = k_s + C::kKvBytes;
  const uint32_t q_s = k_s + C::kKvQ;     // stage s at + s * kQtBytes
  const uint32_t do_s = k_s + C::kKvDO;
  const uint32_t l_s = k_s + C::kKvL;     // stage s at + s * kRowBytes
  const uint32_t dl_s = k_s + C::kKvDl;
  const uint32_t kv_full = k_s + C::kKvBars;
  const uint32_t full = kv_full + 8;      // stage s at + 8 * s
  const uint32_t rows_full = full + 8 * S;
  const uint32_t empty = rows_full + 8 * S;

  const int bh = blockIdx.x;
  const int Hq = static_cast<int>(p.Hq);
  const int b = bh / Hq;
  const int h = bh - b * Hq;
  const int hk = h / (Hq / static_cast<int>(p.Hkv));
  // key block 0 first: under the causal mask it keeps the most rows
  const int k0 = blockIdx.y * kKvBN;
  const int Sq = static_cast<int>(p.Sq);
  const int Skv = static_cast<int>(p.Skv);
  const int win = static_cast<int>(p.window);  // in [-Skv, Sq]

  // the q tiles that hold a pair the block keeps: causal keeps rows
  // i >= j, the window rows i <= j + win - 1
  const int nq = (Sq + BQ - 1) / BQ;
  const int t_lo = p.causal ? k0 / BQ : 0;
  const int last = k0 + kKvBN - 2 + win;
  const int t_hi = last < 0 ? 0 : min(nq, last / BQ + 1);
  const int n = t_hi > t_lo ? t_hi - t_lo : 0;

  if (threadIdx.x == 0) {
    mbar_init(kv_full, 1);
#pragma unroll
    for (int s = 0; s < S; ++s) {
      mbar_init(full + 8 * s, 1);
      mbar_init(rows_full + 8 * s, 1);
      mbar_init(empty + 8 * s, 8);  // one arrival per consumer warp
    }
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();

  if (threadIdx.x < 128) {
    // ---- producer warpgroup: lane 0 of warp 0 keeps the Q / dO ring
    // full, lane 0 of warp 1 the L2 / Dl ring (apart, each loop fits the
    // 24 registers the warpgroup gives up to the consumers) ----
    asm volatile("setmaxnreg.dec.sync.aligned.u32 24;\n");
    if (threadIdx.x == 0 && n > 0) {
      mbar_expect_tx(kv_full, 2 * C::kKvBytes);
#pragma unroll
      for (int c = 0; c < C::kPanels; ++c) {
        tma_load(k_s + c * C::kKvPanel, &kmap, kv_full, 64 * c, k0, hk, b);
        tma_load(v_s + c * C::kKvPanel, &vmap, kv_full, 64 * c, k0, hk, b);
      }
      for (int i = 0; i < n; ++i) {
        const int s = i % S;
        const uint32_t ph = (i / S) & 1;
        const int q0 = (t_lo + i) * BQ;
        mbar_wait(empty + 8 * s, ph ^ 1);  // the first round passes
        mbar_expect_tx(full + 8 * s, 2 * C::kQtBytes);
#pragma unroll
        for (int c = 0; c < C::kPanels; ++c) {
          tma_load(q_s + s * C::kQtBytes + c * C::kQtPanel, &qmap,
                   full + 8 * s, 64 * c, q0, h, b);
          tma_load(do_s + s * C::kQtBytes + c * C::kQtPanel, &dmap,
                   full + 8 * s, 64 * c, q0, h, b);
        }
      }
    } else if (threadIdx.x == 32 && n > 0) {
      const float* l2 = p.l2 + static_cast<long long>(bh) * p.sq_pad +
                        t_lo * BQ;
      const long long dl = p.dl - p.l2;  // the Dl rows, from the L2 rows
      for (int i = 0; i < n; ++i) {
        const int s = i % S;
        mbar_wait(empty + 8 * s, ((i / S) & 1) ^ 1);
        mbar_expect_tx(rows_full + 8 * s, 2 * C::kRowBytes);
        bulk_load(l_s + s * C::kRowBytes, l2 + i * BQ, C::kRowBytes,
                  rows_full + 8 * s);
        bulk_load(dl_s + s * C::kRowBytes, l2 + dl + i * BQ, C::kRowBytes,
                  rows_full + 8 * s);
      }
    }
  } else {
    // ---- consumer warpgroups: 64 keys each ----
    asm volatile("setmaxnreg.inc.sync.aligned.u32 240;\n");
    const int wg = threadIdx.x / 128 - 1;
    const int t = threadIdx.x % 128;
    const int warp = t / 32;
    const int lane = t % 32;
    const int tig = lane & 3;
    const int kw = k0 + 64 * wg;                    // the warpgroup's first key
    const int r0 = kw + 16 * warp + (lane >> 2);    // and r0 + 8
    const uint32_t k_wg = k_s + 64 * 128 * wg;      // its rows of each panel
    const uint32_t v_wg = v_s + 64 * 128 * wg;

    const bool capped = p.softcap > 0.f;
    const float qk_scale = capped ? p.sm_scale / p.softcap
                                  : p.sm_scale * kLog2e;
    const float cap_log2 = p.softcap * kLog2e;

    float dk[C::kPanels][32], dv[C::kPanels][32];
#pragma unroll
    for (int c = 0; c < C::kPanels; ++c)
#pragma unroll
      for (int j = 0; j < 32; ++j) dk[c][j] = dv[c][j] = 0.f;

    if (n > 0) mbar_wait(kv_full, 0);
    for (int i = 0; i < n; ++i) {
      const int s = i % S;
      const uint32_t ph = (i / S) & 1;
      const int q0 = (t_lo + i) * BQ;
      // does the warpgroup's key block keep any pair of this tile?
      const bool any = kw < Skv && (!p.causal || kw <= q0 + BQ - 1) &&
                       kw + 63 > q0 - win;
      mbar_wait(full + 8 * s, ph);
      mbar_wait(rows_full + 8 * s, ph);
      if (any) {
        const uint32_t qt = q_s + s * C::kQtBytes;
        const uint32_t dt = do_s + s * C::kQtBytes;
        // bases made opaque here, so that no descriptor is hoisted out
        // of the loop and held in registers across it
        uint32_t kb = k_wg, vb = v_wg;
        asm volatile("" : "+r"(kb), "+r"(vb));
        const uint64_t kd = sw128_desc(kb, 16, 1024);
        const uint64_t vd = sw128_desc(vb, 16, 1024);
        const uint64_t qd = sw128_desc(qt, 16, 1024);
        const uint64_t dd = sw128_desc(dt, 16, 1024);
        // S^T = K Q^T and dP^T = V dO^T, both operands K-major
        float sc[BQ / 2], dp[BQ / 2];
        wgmma_fence();
#pragma unroll
        for (int kk = 0; kk < D / 16; ++kk) {
          const uint32_t col = (kk % 4) * 32;
          Wgmma<T>::ss(sc, kd + (((kk / 4) * C::kKvPanel + col) >> 4),
                       qd + (((kk / 4) * C::kQtPanel + col) >> 4), kk > 0);
        }
#pragma unroll
        for (int kk = 0; kk < D / 16; ++kk) {
          const uint32_t col = (kk % 4) * 32;
          Wgmma<T>::ss(dp, vd + (((kk / 4) * C::kKvPanel + col) >> 4),
                       dd + (((kk / 4) * C::kQtPanel + col) >> 4), kk > 0);
        }
        wgmma_commit();
        wgmma_wait_all();
        reg_fence(sc);
        reg_fence(dp);

        // only tiles that cross the diagonal or the window's edge
        // evaluate the mask (rows past Sq have L2 = +inf: P = 0)
        const uint32_t l_row = l_s + s * C::kRowBytes;
        const uint32_t d_row = dl_s + s * C::kRowBytes;
        if ((!p.causal || kw + 63 <= q0) && kw > q0 + BQ - 1 - win)
          grad_tile_kq<false>(sc, dp, l_row, d_row, p, qk_scale, cap_log2,
                              win, r0, q0, tig);
        else
          grad_tile_kq<true>(sc, dp, l_row, d_row, p, qk_scale, cap_log2,
                             win, r0, q0, tig);

        // P^T and dS^T as input-type hi + lo A fragments: the 16 queries
        // of step kt are columns 16 kt .. 16 kt + 15
        uint32_t p_hi[BQ / 16][4], p_lo[BQ / 16][4];
        uint32_t d_hi[BQ / 16][4], d_lo[BQ / 16][4];
#pragma unroll
        for (int kt = 0; kt < BQ / 16; ++kt)
#pragma unroll
          for (int r = 0; r < 4; ++r) {
            split2<T>(sc[8 * kt + 2 * r], sc[8 * kt + 2 * r + 1],
                      p_hi[kt][r], p_lo[kt][r]);
            split2<T>(dp[8 * kt + 2 * r], dp[8 * kt + 2 * r + 1],
                      d_hi[kt][r], d_lo[kt][r]);
          }

        // dV += P^T dO and dK += dS^T Q: dO and Q are (BQ x D) with D
        // contiguous, an MN-major B (leading offset: the next 64-column
        // panel; stride offset: the next 8 rows), 16 rows = 2048 bytes
        const uint64_t dmn = sw128_desc(dt, C::kQtPanel, 1024);
        const uint64_t qmn = sw128_desc(qt, C::kQtPanel, 1024);
        wgmma_fence();
#pragma unroll
        for (int kt = 0; kt < BQ / 16; ++kt)
#pragma unroll
          for (int c = 0; c < C::kPanels; ++c) {
            const uint32_t off = (c * C::kQtPanel + kt * 2048) >> 4;
            Wgmma<T>::rs(dv[c], p_hi[kt], dmn + off);
            Wgmma<T>::rs(dv[c], p_lo[kt], dmn + off);
            Wgmma<T>::rs(dk[c], d_hi[kt], qmn + off);
            Wgmma<T>::rs(dk[c], d_lo[kt], qmn + off);
          }
        wgmma_commit();
        wgmma_wait_all();
#pragma unroll
        for (int c = 0; c < C::kPanels; ++c) {
          reg_fence(dv[c]);
          reg_fence(dk[c]);
        }
        reg_fence(p_hi);
        reg_fence(p_lo);
        reg_fence(d_hi);
        reg_fence(d_lo);
      }
      if (lane == 0) mbar_arrive(empty + 8 * s);
    }

    // epilogue: rows of keys past Skv are dropped
    const bool gqa = p.Hq != p.Hkv;
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      const int key = r0 + 8 * r;
      if (key >= Skv) continue;
#pragma unroll
      for (int c = 0; c < C::kPanels; ++c)
#pragma unroll
        for (int j = 0; j < 8; ++j) {
          const int col = 64 * c + 8 * j + 2 * tig;
          const int e = 4 * j + 2 * r;
          if (gqa) {
            const long long off =
                (static_cast<long long>(bh) * Skv + key) * D + col;
            *reinterpret_cast<float2*>(p.pdk + off) =
                make_float2(dk[c][e], dk[c][e + 1]);
            *reinterpret_cast<float2*>(p.pdv + off) =
                make_float2(dv[c][e], dv[c][e + 1]);
          } else {
            *reinterpret_cast<uint32_t*>(
                static_cast<T*>(p.dk) + b * p.vdk.sb + hk * p.vdk.sh +
                key * p.vdk.ss + col) = pack2<T>(dk[c][e], dk[c][e + 1]);
            *reinterpret_cast<uint32_t*>(
                static_cast<T*>(p.dv) + b * p.vdv.sb + hk * p.vdv.sh +
                key * p.vdv.ss + col) = pack2<T>(dv[c][e], dv[c][e + 1]);
          }
        }
    }
  }
}

// (c) under GQA: dK (blockIdx.y 0) or dV (1) of kv head hk, the f32
// partials of its group's q-heads summed in head order and rounded once;
// 4 columns per thread
template <typename T, int D>
__global__ void __launch_bounds__(256)
flash_bwd_gsum(const Params p) {
  const long long e = static_cast<long long>(blockIdx.x) * 256 + threadIdx.x;
  if (e >= p.B * p.Hkv * p.Skv * (D / 4)) return;
  const bool is_v = blockIdx.y == 1;
  const int c4 = static_cast<int>(e % (D / 4));
  const long long rest = e / (D / 4);
  const long long key = rest % p.Skv;
  const long long bhk = rest / p.Skv;
  const long long b = bhk / p.Hkv;
  const long long hk = bhk - b * p.Hkv;
  const long long group = p.Hq / p.Hkv;
  const float* part = (is_v ? p.pdv : p.pdk) +
                      ((b * p.Hq + hk * group) * p.Skv + key) * D + 4 * c4;
  float4 acc = *reinterpret_cast<const float4*>(part);
  for (long long g = 1; g < group; ++g) {
    const float4 x =
        *reinterpret_cast<const float4*>(part + g * p.Skv * D);
    acc.x += x.x;
    acc.y += x.y;
    acc.z += x.z;
    acc.w += x.w;
  }
  T* out = is_v ? static_cast<T*>(p.dv) + b * p.vdv.sb + hk * p.vdv.sh +
                     key * p.vdv.ss
                 : static_cast<T*>(p.dk) + b * p.vdk.sb + hk * p.vdk.sh +
                     key * p.vdk.ss;
  out += 4 * c4;
  uint2 o;
  o.x = pack2<T>(acc.x, acc.y);
  o.y = pack2<T>(acc.z, acc.w);
  *reinterpret_cast<uint2*>(out) = o;
}

// P and dS of one (64 queries x kQBK keys) tile in the accumulator
// layout: s[4 t + e] is query r0 + 8 (e >> 1), key k0 + 8 t + 2 tig +
// (e & 1); out: dS in dp (P is not needed again)
template <bool kMasked>
__device__ __forceinline__ void grad_tile_qk(float (&s)[kQBK / 2],
                                             float (&dp)[kQBK / 2],
                                             const float (&L)[2],
                                             const float (&Dl)[2],
                                             const Params& p, float qk_scale,
                                             float cap_log2, int win, int r0,
                                             int k0, int tig) {
#pragma unroll
  for (int i = 0; i < kQBK / 2; ++i) {
    const int r = (i & 3) >> 1;
    float x = s[i] * qk_scale;
    float dscale = p.sm_scale;
    if (p.softcap > 0.f) {
      const float th = tanhf(x);
      x = cap_log2 * th;
      dscale = p.sm_scale * (1.f - th * th);
    }
    float pr = fast_exp2(x - L[r]);
    if (kMasked) {
      const int row = r0 + 8 * r;
      const int col = k0 + 8 * (i >> 2) + 2 * tig + (i & 1);
      bool ok = col < p.Skv && col > row - win;
      if (p.causal) ok = ok && col <= row;
      pr = ok ? pr : 0.f;
    }
    dp[i] = pr * (dp[i] - Dl[r]) * dscale;
  }
}

// (d) dQ of one (b, q-head, 128-row q-block)
template <typename T, int D>
__global__ void __launch_bounds__(kTcThreads, 1)
flash_bwd_dq_tc(const __grid_constant__ CUtensorMap qmap,
                const __grid_constant__ CUtensorMap dmap,
                const __grid_constant__ CUtensorMap kmap,
                const __grid_constant__ CUtensorMap vmap, const Params p) {
  using C = TcTile<D>;
  constexpr int BK = kQBK;
  constexpr int S = kStages;
  extern __shared__ unsigned char smem_raw[];
  const uint32_t q_s = (smem_addr(smem_raw) + 1023u) & ~1023u;
  const uint32_t do_s = q_s + C::kQqBytes;
  const uint32_t k_s = q_s + C::kQK;      // stage s at + s * kKtBytes
  const uint32_t v_s = q_s + C::kQV;
  const uint32_t qd_full = q_s + C::kQBars;
  const uint32_t full = qd_full + 8;      // stage s at + 8 * s
  const uint32_t empty = full + 8 * S;

  const int bh = blockIdx.x;
  const int Hq = static_cast<int>(p.Hq);
  const int b = bh / Hq;
  const int h = bh - b * Hq;
  const int hk = h / (Hq / static_cast<int>(p.Hkv));
  // last q-block first: under the causal mask it reads the most keys
  const int q0 = (gridDim.y - 1 - blockIdx.y) * kQBQ;
  const int Skv = static_cast<int>(p.Skv);
  const int win = static_cast<int>(p.window);

  // the key tiles the forward's visit predicate keeps for these rows
  const int nk = (Skv + BK - 1) / BK;
  int k_hi = nk;
  if (p.causal) k_hi = min(nk, (q0 + kQBQ - 1) / BK + 1);
  const int lo = q0 - win - BK + 1;  // first tile with k0 + BK > q0 - win
  const int k_lo = lo > 0 ? (lo + BK - 1) / BK : 0;
  const int n = k_hi > k_lo ? k_hi - k_lo : 0;

  if (threadIdx.x == 0) {
    mbar_init(qd_full, 1);
#pragma unroll
    for (int s = 0; s < S; ++s) {
      mbar_init(full + 8 * s, 1);
      mbar_init(empty + 8 * s, 8);
    }
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();

  if (threadIdx.x < 128) {
    asm volatile("setmaxnreg.dec.sync.aligned.u32 24;\n");
    if (threadIdx.x == 0 && n > 0) {
      mbar_expect_tx(qd_full, 2 * C::kQqBytes);
#pragma unroll
      for (int c = 0; c < C::kPanels; ++c) {
        tma_load(q_s + c * C::kQqPanel, &qmap, qd_full, 64 * c, q0, h, b);
        tma_load(do_s + c * C::kQqPanel, &dmap, qd_full, 64 * c, q0, h, b);
      }
      for (int i = 0; i < n; ++i) {
        const int s = i % S;
        const uint32_t ph = (i / S) & 1;
        const int k0 = (k_lo + i) * BK;
        mbar_wait(empty + 8 * s, ph ^ 1);
        mbar_expect_tx(full + 8 * s, 2 * C::kKtBytes);
#pragma unroll
        for (int c = 0; c < C::kPanels; ++c) {
          tma_load(k_s + s * C::kKtBytes + c * C::kKtPanel, &kmap,
                   full + 8 * s, 64 * c, k0, hk, b);
          tma_load(v_s + s * C::kKtBytes + c * C::kKtPanel, &vmap,
                   full + 8 * s, 64 * c, k0, hk, b);
        }
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
    const int w_lo = q0 + 64 * wg;                  // the warpgroup's first row
    const int r0 = w_lo + 16 * warp + (lane >> 2);  // and r0 + 8
    const uint32_t q_wg = q_s + 64 * 128 * wg;      // its rows of each panel
    const uint32_t do_wg = do_s + 64 * 128 * wg;

    const bool capped = p.softcap > 0.f;
    const float qk_scale = capped ? p.sm_scale / p.softcap
                                  : p.sm_scale * kLog2e;
    const float cap_log2 = p.softcap * kLog2e;
    float L[2], Dl[2];
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      const long long row = static_cast<long long>(bh) * p.sq_pad + r0 + 8 * r;
      L[r] = p.l2[row];
      Dl[r] = p.dl[row];
    }

    float dq[C::kPanels][32];
#pragma unroll
    for (int c = 0; c < C::kPanels; ++c)
#pragma unroll
      for (int j = 0; j < 32; ++j) dq[c][j] = 0.f;

    if (n > 0) mbar_wait(qd_full, 0);
    for (int i = 0; i < n; ++i) {
      const int s = i % S;
      const uint32_t ph = (i / S) & 1;
      const int k0 = (k_lo + i) * BK;
      const bool any = (!p.causal || k0 <= w_lo + 63) &&
                       k0 + BK - 1 > w_lo - win;
      mbar_wait(full + 8 * s, ph);
      if (any) {
        const uint32_t kt_s = k_s + s * C::kKtBytes;
        const uint32_t vt_s = v_s + s * C::kKtBytes;
        uint32_t qb = q_wg, db = do_wg;
        asm volatile("" : "+r"(qb), "+r"(db));
        const uint64_t qd = sw128_desc(qb, 16, 1024);
        const uint64_t dd = sw128_desc(db, 16, 1024);
        const uint64_t kd = sw128_desc(kt_s, 16, 1024);
        const uint64_t vd = sw128_desc(vt_s, 16, 1024);
        // S = Q K^T and dP = dO V^T, both operands K-major
        float sc[BK / 2], dp[BK / 2];
        wgmma_fence();
#pragma unroll
        for (int kk = 0; kk < D / 16; ++kk) {
          const uint32_t col = (kk % 4) * 32;
          Wgmma<T>::ss(sc, qd + (((kk / 4) * C::kQqPanel + col) >> 4),
                       kd + (((kk / 4) * C::kKtPanel + col) >> 4), kk > 0);
        }
#pragma unroll
        for (int kk = 0; kk < D / 16; ++kk) {
          const uint32_t col = (kk % 4) * 32;
          Wgmma<T>::ss(dp, dd + (((kk / 4) * C::kQqPanel + col) >> 4),
                       vd + (((kk / 4) * C::kKtPanel + col) >> 4), kk > 0);
        }
        wgmma_commit();
        wgmma_wait_all();
        reg_fence(sc);
        reg_fence(dp);

        if (k0 + BK <= Skv && (!p.causal || k0 + BK - 1 <= w_lo) &&
            k0 > w_lo + 63 - win)
          grad_tile_qk<false>(sc, dp, L, Dl, p, qk_scale, cap_log2, win, r0,
                              k0, tig);
        else
          grad_tile_qk<true>(sc, dp, L, Dl, p, qk_scale, cap_log2, win, r0,
                             k0, tig);

        uint32_t d_hi[BK / 16][4], d_lo[BK / 16][4];
#pragma unroll
        for (int kt = 0; kt < BK / 16; ++kt)
#pragma unroll
          for (int r = 0; r < 4; ++r)
            split2<T>(dp[8 * kt + 2 * r], dp[8 * kt + 2 * r + 1],
                      d_hi[kt][r], d_lo[kt][r]);

        // dQ += dS K: K is (BK keys x D) with D contiguous, MN-major B
        const uint64_t kmn = sw128_desc(kt_s, C::kKtPanel, 1024);
        wgmma_fence();
#pragma unroll
        for (int kt = 0; kt < BK / 16; ++kt)
#pragma unroll
          for (int c = 0; c < C::kPanels; ++c) {
            const uint32_t off = (c * C::kKtPanel + kt * 2048) >> 4;
            Wgmma<T>::rs(dq[c], d_hi[kt], kmn + off);
            Wgmma<T>::rs(dq[c], d_lo[kt], kmn + off);
          }
        wgmma_commit();
        wgmma_wait_all();
#pragma unroll
        for (int c = 0; c < C::kPanels; ++c) reg_fence(dq[c]);
        reg_fence(d_hi);
        reg_fence(d_lo);
      }
      if (lane == 0) mbar_arrive(empty + 8 * s);
    }

#pragma unroll
    for (int r = 0; r < 2; ++r) {
      const int row = r0 + 8 * r;
      if (row >= p.Sq) continue;
      T* out = static_cast<T*>(p.dq) + b * p.vdq.sb + h * p.vdq.sh +
               row * p.vdq.ss;
#pragma unroll
      for (int c = 0; c < C::kPanels; ++c)
#pragma unroll
        for (int j = 0; j < 8; ++j)
          *reinterpret_cast<uint32_t*>(out + 64 * c + 8 * j + 2 * tig) =
              pack2<T>(dq[c][4 * j + 2 * r], dq[c][4 * j + 2 * r + 1]);
    }
  }
}

template <typename T, int D>
int launch_tc(const Params& p, cudaStream_t st) {
  using C = TcTile<D>;
  if (p.Sq >= (1LL << 30) || p.Skv >= (1LL << 30))
    return static_cast<int>(cudaErrorInvalidValue);  // int tile coordinates
  // dK/dV: Q and dO in kKvBQ-row boxes, K and V in kKvBN; dQ: Q and dO in
  // kQBQ, K and V in kQBK
  CUtensorMap m[8];
  const struct {
    const void* ptr;
    const View* v;
    long long H, S;
    int rows;
  } maps[8] = {{p.q, &p.vq, p.Hq, p.Sq, kKvBQ},
               {p.dout, &p.vdo, p.Hq, p.Sq, kKvBQ},
               {p.k, &p.vk, p.Hkv, p.Skv, kKvBN},
               {p.v, &p.vv, p.Hkv, p.Skv, kKvBN},
               {p.q, &p.vq, p.Hq, p.Sq, kQBQ},
               {p.dout, &p.vdo, p.Hq, p.Sq, kQBQ},
               {p.k, &p.vk, p.Hkv, p.Skv, kQBK},
               {p.v, &p.vv, p.Hkv, p.Skv, kQBK}};
  for (int i = 0; i < 8; ++i) {
    const int rc = encode_map<T>(&m[i], maps[i].ptr, p.B, maps[i].H,
                                 maps[i].S, D, maps[i].v->sb, maps[i].v->sh,
                                 maps[i].v->ss, maps[i].rows);
    if (rc != 0) return rc;
  }
  cudaError_t e = cudaFuncSetAttribute(
      flash_bwd_dkdv_tc<T, D>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      static_cast<int>(C::kKvSmem));
  if (e != cudaSuccess) return static_cast<int>(e);
  e = cudaFuncSetAttribute(flash_bwd_dq_tc<T, D>,
                           cudaFuncAttributeMaxDynamicSharedMemorySize,
                           static_cast<int>(C::kQSmem));
  if (e != cudaSuccess) return static_cast<int>(e);

  const long long rows = p.B * p.Hq * p.sq_pad;
  flash_bwd_rows<T, D><<<static_cast<unsigned>((rows + 7) / 8), 256, 0,
                         st>>>(p);
  e = cudaGetLastError();
  if (e != cudaSuccess) return static_cast<int>(e);
  const dim3 g_kv(static_cast<unsigned>(p.B * p.Hq),
                  static_cast<unsigned>((p.Skv + kKvBN - 1) / kKvBN));
  flash_bwd_dkdv_tc<T, D><<<g_kv, kTcThreads, C::kKvSmem, st>>>(
      m[0], m[1], m[2], m[3], p);
  e = cudaGetLastError();
  if (e != cudaSuccess) return static_cast<int>(e);
  if (p.Hq != p.Hkv) {
    const long long n = p.B * p.Hkv * p.Skv * (D / 4);
    flash_bwd_gsum<T, D><<<dim3(static_cast<unsigned>((n + 255) / 256), 2),
                           256, 0, st>>>(p);
    e = cudaGetLastError();
    if (e != cudaSuccess) return static_cast<int>(e);
  }
  const dim3 g_q(static_cast<unsigned>(p.B * p.Hq),
                 static_cast<unsigned>((p.Sq + kQBQ - 1) / kQBQ));
  flash_bwd_dq_tc<T, D><<<g_q, kTcThreads, C::kQSmem, st>>>(
      m[4], m[5], m[6], m[7], p);
  return static_cast<int>(cudaGetLastError());
}

// bf16 / f16: the tensor-core route wherever the views allow it; the
// wrapper sized ``delta`` by flash_bwd_scratch_floats, the same rule
template <typename T>
int dispatch_tc(Params p, long long D, cudaStream_t st) {
  if (!tc_route(p, D)) return dispatch_d<T>(p, D, st);
  p.sq_pad = (p.Sq + kTcPad - 1) / kTcPad * kTcPad;
  p.l2 = p.delta;
  p.dl = p.l2 + p.B * p.Hq * p.sq_pad;
  p.pdk = p.dl + p.B * p.Hq * p.sq_pad;
  p.pdv = p.pdk + p.B * p.Hq * p.Skv * D;
  switch (D) {
    case 64: return launch_tc<T, 64>(p, st);
    case 128: return launch_tc<T, 128>(p, st);
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
}

}  // namespace

extern "C" {

// dtype: 0 float32, 1 bfloat16, 2 float16.  q, o, dout, dq: (B, Hq, Sq,
// D) views; k, v, dk, dv: (B, Hkv, Skv, D) views; ``strides`` holds the
// (b, h, s) element strides of q, k, v, o, dout, dq, dk, dv in that
// order (24 values; every last axis unit).  lse: (B, Hq, Sq) f32 from
// the forward; delta: f32 scratch of flash_bwd_scratch_floats(...) words
// ((B, Hq, Sq) on the FMA route).  Returns cudaGetLastError() after the
// last launch (cudaErrorInvalidValue for a shape, head dim or dtype the
// kernels do not take), or -CUresult when a TMA tensor map fails to
// encode.
int flash_attention_bwd(const void* q, const void* k, const void* v,
                        const void* o, const void* dout, const float* lse,
                        float* delta, void* dq, void* dk, void* dv,
                        int dtype, long long B, long long Hq, long long Hkv,
                        long long Sq, long long Skv, long long D,
                        const long long* strides, float sm_scale, int causal,
                        long long window, float softcap, void* stream) {
  if (B <= 0 || Hq <= 0 || Hkv <= 0 || Hq % Hkv || Sq <= 0 || Skv <= 0 ||
      B * Hq > 2147483647LL || (Sq + kT - 1) / kT > 65535 ||
      (Skv + kT - 1) / kT > 65535)
    return static_cast<int>(cudaErrorInvalidValue);
  // the forward's clamp: a window >= Sq keeps every key the mask allows,
  // a window <= -Skv keeps none
  if (window > Sq) window = Sq;
  if (window < -Skv) window = -Skv;
  Params p;
  p.q = q;
  p.k = k;
  p.v = v;
  p.o = o;
  p.dout = dout;
  p.lse = lse;
  p.delta = delta;
  p.dq = dq;
  p.dk = dk;
  p.dv = dv;
  View* views[8] = {&p.vq, &p.vk, &p.vv, &p.vo, &p.vdo, &p.vdq, &p.vdk,
                    &p.vdv};
  for (int i = 0; i < 8; ++i)
    *views[i] = View{strides[3 * i], strides[3 * i + 1], strides[3 * i + 2]};
  p.B = B;
  p.Hq = Hq;
  p.Hkv = Hkv;
  p.Sq = Sq;
  p.Skv = Skv;
  p.sm_scale = sm_scale;
  p.causal = causal;
  p.window = window;
  p.softcap = softcap;
  const auto st = static_cast<cudaStream_t>(stream);
  switch (dtype) {
    case 0: return dispatch_d<float>(p, D, st);
    case 1: return dispatch_tc<__nv_bfloat16>(p, D, st);
    case 2: return dispatch_tc<__half>(p, D, st);
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
}

// The f32 scratch words flash_attention_bwd needs for these views, with
// 1 in *tensor_core where it takes the tensor-core route and 0 where it
// takes the FMA route: ``ptrs`` holds q, k, v, o, dout, dq, dk, dv, and
// ``strides``, dtype and the shape are flash_attention_bwd's.
long long flash_bwd_scratch_floats(const void* const* ptrs,
                                   const long long* strides, int dtype,
                                   long long B, long long Hq, long long Hkv,
                                   long long Sq, long long Skv, long long D,
                                   int* tensor_core) {
  Params p;
  p.q = ptrs[0];
  p.k = ptrs[1];
  p.v = ptrs[2];
  p.o = ptrs[3];
  p.dout = ptrs[4];
  p.dq = const_cast<void*>(ptrs[5]);
  p.dk = const_cast<void*>(ptrs[6]);
  p.dv = const_cast<void*>(ptrs[7]);
  View* views[8] = {&p.vq, &p.vk, &p.vv, &p.vo, &p.vdo, &p.vdq, &p.vdk,
                    &p.vdv};
  for (int i = 0; i < 8; ++i)
    *views[i] = View{strides[3 * i], strides[3 * i + 1], strides[3 * i + 2]};
  *tensor_core = (dtype == 1 || dtype == 2) && tc_route(p, D);
  return *tensor_core ? tc_scratch_floats(B, Hq, Hkv, Sq, Skv, D)
                      : B * Hq * Sq;
}

}  // extern "C"
