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
// Three kernels, no atomics, so the result is the same bits on every run:
//  (a) flash_bwd_delta: D_i = rowsum(dO * O) in f32, one warp per row;
//  (b) flash_bwd_dkdv: one CTA per (b, kv head, 64-key block).  K and V
//      of the block stay in shared memory; the CTA walks the group's
//      q-heads and the 64-row q-blocks the forward's visit predicate
//      keeps for this key block, recomputes S and dP for the tile, and
//      accumulates dV += P^T dO and dK += dS^T Q in registers;
//  (c) flash_bwd_dq: one CTA per (b, q head, 64-row q-block).  Q and dO
//      stay in shared memory; it walks the kept key blocks, recomputes S
//      and dP, and accumulates dQ += dS K in registers.
// Each kernel recomputes the scores it needs (seven products per tile
// pair where the bound counts five) instead of carrying dQ partial sums
// between CTAs.
//
// Layout: 256 threads as a 16 x 16 grid.  For the scores, thread (ty,
// tx) owns rows 4 ty .. 4 ty + 3 and key columns tx + 16 c (c < 4) of
// the 64 x 64 tile; for an accumulator, its 4 rows (keys in (b), query
// rows in (c)) and head-dim columns tx + 16 c (c < D / 16).  Tiles are
// f32 in shared memory with rows padded by one word (no bank conflicts);
// P and dS pass between the phases through 64 x 65 f32 tiles.  Inputs
// are read in place through their strides (the models' transposed
// (B, S, H, D) views included; the last axis unit), outputs written
// through theirs.
//
// Bound on an H100 SXM: 2.5x the forward's 4 * B * Hq * D * (kept pairs)
// operations at 989 TFLOP/s (bf16/f16 tensor-core peak; 67 TFLOP/s f32).
// This kernel runs f32 FMAs from shared memory on every input type: it
// is far from that bound (PERF.md section 6 row 4c has its time).  Not
// done here: mma.sync / wgmma tiles, TMA loads, a persistent scheduler.

#include <cuda_bf16.h>
#include <cuda_fp16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace {

constexpr int kT = 64;         // query rows and keys per tile
constexpr int kThreads = 256;  // 16 x 16
constexpr int kRows = 4;       // tile rows per thread
constexpr int kCols = 4;       // score columns per thread
constexpr int kPP = kT + 1;    // pitch of the P and dS tiles

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

}  // namespace

extern "C" {

// dtype: 0 float32, 1 bfloat16, 2 float16.  q, o, dout, dq: (B, Hq, Sq,
// D) views; k, v, dk, dv: (B, Hkv, Skv, D) views; ``strides`` holds the
// (b, h, s) element strides of q, k, v, o, dout, dq, dk, dv in that
// order (24 values; every last axis unit).  lse: (B, Hq, Sq) f32 from
// the forward; delta: (B, Hq, Sq) f32 scratch.  Returns
// cudaGetLastError() after the last launch (cudaErrorInvalidValue for a
// shape, head dim or dtype the kernels do not take).
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
    case 1: return dispatch_d<__nv_bfloat16>(p, D, st);
    case 2: return dispatch_d<__half>(p, D, st);
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
}

}  // extern "C"
