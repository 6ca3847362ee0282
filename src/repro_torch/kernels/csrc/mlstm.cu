// Chunkwise mLSTM (xLSTM matrix memory) for Hopper (sm_90a).
//
// Replaces repro/kernels/mlstm.py:mlstm_chunkwise (the Pallas
// _mlstm_kernel).  Per batch*head row, with state C (d x d), n (d) and
// stabilizer m, over chunks of L = 64 steps it computes what that kernel
// computes:
//
//   q, k <- round(q * scale), round(k * scale), scale = round(1/sqrt(d)),
//           every round to the input type
//   b_t   = cumsum_{s<=t} log sigmoid(f_s)            (within the chunk)
//   m_t   = b_t + max(m_prev, max_{s<=t} (i_s - b_s))
//   D_ts  = exp(b_t - b_s + i_s - m_t) for s <= t, else 0
//   h_t   = (g_t (q_t C) + sum_s D_ts (q_t . k_s) v_s)
//           / max(|g_t (q_t . n) + sum_s D_ts (q_t . k_s)|, 1),
//   g_t   = exp(b_t + m_prev - m_t)                   (0 if not finite)
//   then, at the chunk's end (e = its last step),
//   C     = exp(b_e + m_prev - m_e) C + sum_s exp(b_e - b_s + i_s - m_e) k_s v_s^T
//   n     = (same decay) n + sum_s exp(b_e - b_s + i_s - m_e) k_s,  m = m_e.
//
// q, k, v: (BH, S, d) in one of float32 / bfloat16 / float16; the gates
// (BH, S) in that type or float32.  h (BH, S, d) is written in q's type,
// the final C, n, m in float32.  The scaling of q and k by 1/sqrt(d), and
// its rounding to the input type, happen here as the Pallas wrapper does
// them before its kernel (mlstm.py:130-132).
//
// m starts at -inf.  The Pallas kernel maps a non-finite g_t or carry
// decay to 0 with jnp.where(isfinite) (mlstm.py:77-78, :93-94): -inf minus
// -inf is NaN, not -inf, so the same is done here explicitly.  The TPU
// kernel padded S to the chunk with i = -inf, f = 60; here a ragged last
// chunk is a bounds mask (its rows take no update and write nothing).
//
// The TPU grid was (BH, chunks) with the chunk axis sequential and
// (C, n, m) in VMEM.  At xLSTM-350M, d = 512 (inner 2048 over 4 heads),
// so C is 512 x 512 f32 = 1 MiB per row: it cannot sit in one block's
// 227 KB of shared memory.  So C is split by columns of v: the grid is
// (BH, ceil(d / 32)), each block owns C[:, 32 columns] (64 KiB at d = 512)
// and loops over the chunks inside the block.  Every block of one row
// recomputes the shared L x L scores q k^T, the stabilizers and n: that
// repeats work on purpose (16x at d = 512) in exchange for needing no
// communication between blocks.  q and k are streamed through shared
// memory in slices of 64 along d (a whole 64 x 512 tile of each would not
// fit beside C), k twice per chunk (scores, then the state update).
//
// Bound on an H100 SXM: per row and chunk of L steps the products need
// 2 L^2 d (scores) + 2 L d^2 (q C) + 2 L^2 d (D-weighted v) + 2 L d^2 (the
// C update) operations, against the bytes of q, k, v, h and the final
// state; at the xLSTM prefill shape (16, 2048, 512) that is ~39 GFLOP
// and ~150 MB in bf16, so operations bound it.  All products here are
// f32 FMA loops on the CUDA cores (256 threads; thread (r, p) owns chunk
// row r and columns p, p+4, ...): tensor-core tiles are later work.
//
// Thread layout: r = tid / 4 is a chunk row (or a d row of the slice in
// the update), p = tid % 4 picks columns p + 4 j.  Shared tiles are
// padded to 65 words a row against bank conflicts.

#include <cuda_bf16.h>
#include <cuda_fp16.h>
#include <cuda_runtime.h>
#include <math.h>

namespace {

constexpr int kL = 64;        // chunk length
constexpr int kVB = 32;       // columns of v (and of C) per block
constexpr int kDS = 64;       // d slice streamed through shared memory
constexpr int kLP = 65;       // padded row of a 64-wide tile
constexpr int kThreads = 256;
constexpr int kMaxD = 1024;

__device__ __forceinline__ float to_f(float v) { return v; }
__device__ __forceinline__ float to_f(__nv_bfloat16 v) {
  return __bfloat162float(v);
}
__device__ __forceinline__ float to_f(__half v) { return __half2float(v); }

template <typename T>
__device__ __forceinline__ T from_f(float v);
template <>
__device__ __forceinline__ float from_f<float>(float v) { return v; }
template <>
__device__ __forceinline__ __nv_bfloat16 from_f<__nv_bfloat16>(float v) {
  return __float2bfloat16(v);
}
template <>
__device__ __forceinline__ __half from_f<__half>(float v) {
  return __float2half(v);
}

// x * scale rounded to T, as the Pallas wrapper's `q * scale` in q's
// type; `scale` has already been rounded to T (JAX casts the weakly typed
// Python scalar to the array's type before it multiplies)
template <typename T>
__device__ __forceinline__ float scaled(T x, float scale) {
  return to_f(from_f<T>(__fmul_rn(to_f(x), scale)));
}

// jax.nn.log_sigmoid(x) = -softplus(-x) = min(x, 0) - log1p(exp(-|x|))
__device__ __forceinline__ float log_sigmoid(float x) {
  return fminf(x, 0.0f) - log1pf(expf(-fabsf(x)));
}

__device__ __forceinline__ float finite_or_zero(float x) {
  return isfinite(x) ? x : 0.0f;
}

size_t smem_floats(long long d) {
  return static_cast<size_t>(d) * (kVB + 1)   // C[:, block cols], n
         + 3 * kL * kLP                        // q, k tiles; scores
         + kL * kVB                            // v tile
         + 6 * kL + 4;                         // per-row terms, scalars
}

template <typename T>
__device__ void load_tile(float* dst, const T* __restrict__ src,
                          long long row0, int rows, int d0, int cols,
                          long long d, float scale) {
  for (int idx = threadIdx.x; idx < kL * kDS; idx += kThreads) {
    const int rr = idx / kDS, kk = idx % kDS;
    float val = 0.0f;
    if (rr < rows && kk < cols)
      val = scaled<T>(src[(row0 + rr) * d + d0 + kk], scale);
    dst[rr * kLP + kk] = val;
  }
}

template <typename T, typename G>
__global__ void __launch_bounds__(kThreads)
mlstm_kernel(const T* __restrict__ q, const T* __restrict__ k,
             const T* __restrict__ v, const G* __restrict__ ig,
             const G* __restrict__ fg, T* __restrict__ h,
             float* __restrict__ c_out, float* __restrict__ n_out,
             float* __restrict__ m_out, long long S, long long d,
             float scale) {
  extern __shared__ float sm[];
  float* Cs = sm;                       // d x kVB
  float* ns = Cs + d * kVB;             // d
  float* qs = ns + d;                   // kL x kLP
  float* ks = qs + kL * kLP;            // kL x kLP
  float* Ss = ks + kL * kLP;            // kL x kLP: scores, then weights
  float* vs = Ss + kL * kLP;            // kL x kVB
  float* bs = vs + kL * kVB;            // b_t (log f during the scan)
  float* ms = bs + kL;                  // m_t
  float* is = ms + kL;                  // i_t
  float* gs = is + kL;                  // g_t, the inter-chunk scale
  float* us = gs + kL;                  // end-of-chunk update weights
  float* qn = us + kL;                  // q_t . n (old n)
  float* sc = qn + kL;                  // m_prev, carry decay

  const long long bh = blockIdx.x;
  const int v0 = blockIdx.y * kVB;
  const int tid = threadIdx.x;
  const int r = tid >> 2, p = tid & 3;
  const long long row_base = bh * S;   // row of (bh, t = 0) in q, k, v, h
  scale = to_f(from_f<T>(scale));

  for (long long i = tid; i < d * kVB; i += kThreads) Cs[i] = 0.0f;
  for (long long i = tid; i < d; i += kThreads) ns[i] = 0.0f;
  if (tid == 0) sc[0] = -INFINITY;
  __syncthreads();

  for (long long c0 = 0; c0 < S; c0 += kL) {
    const int Lc = static_cast<int>(S - c0 < kL ? S - c0 : kL);
    // gates: log f and i per row in parallel, the scans on one thread
    if (tid < Lc) {
      bs[tid] = log_sigmoid(to_f(fg[row_base + c0 + tid]));
      is[tid] = to_f(ig[row_base + c0 + tid]);
    }
    for (int idx = tid; idx < kL * kVB; idx += kThreads) {
      const int rr = idx / kVB, vc = idx % kVB;
      vs[idx] = (rr < Lc && v0 + vc < d)
                    ? to_f(v[(row_base + c0 + rr) * d + v0 + vc])
                    : 0.0f;
    }
    __syncthreads();
    if (tid == 0) {
      const float m_prev = sc[0];
      float b = 0.0f, g = -INFINITY;
      for (int s = 0; s < Lc; ++s) {
        b += bs[s];
        bs[s] = b;
        g = fmaxf(g, is[s] - b);
        ms[s] = b + fmaxf(m_prev, g);
      }
      sc[1] = finite_or_zero(expf(bs[Lc - 1] + m_prev - ms[Lc - 1]));
    }
    __syncthreads();
    const float m_prev = sc[0];
    const float b_e = bs[Lc - 1], m_e = ms[Lc - 1];
    if (tid < kL) {
      gs[tid] = tid < Lc ? finite_or_zero(expf(bs[tid] + m_prev - ms[tid]))
                         : 0.0f;
      us[tid] = tid < Lc ? expf(b_e - bs[tid] + is[tid] - m_e) : 0.0f;
    }

    // scores S = q k^T, inter h = q C[:, cols], q . n over slices of d
    float sacc[kL / 4], hacc[kVB / 4], qnacc = 0.0f;
#pragma unroll
    for (int j = 0; j < kL / 4; ++j) sacc[j] = 0.0f;
#pragma unroll
    for (int j = 0; j < kVB / 4; ++j) hacc[j] = 0.0f;
    for (int d0 = 0; d0 < d; d0 += kDS) {
      const int dsz = static_cast<int>(d - d0 < kDS ? d - d0 : kDS);
      load_tile<T>(qs, q, row_base + c0, Lc, d0, dsz, d, scale);
      load_tile<T>(ks, k, row_base + c0, Lc, d0, dsz, d, scale);
      __syncthreads();
      for (int kk = 0; kk < dsz; ++kk) {
        const float qv = qs[r * kLP + kk];
#pragma unroll
        for (int j = 0; j < kL / 4; ++j)
          sacc[j] += qv * ks[(p + 4 * j) * kLP + kk];
        const float* crow = Cs + (d0 + kk) * kVB;
#pragma unroll
        for (int j = 0; j < kVB / 4; ++j) hacc[j] += qv * crow[p + 4 * j];
        qnacc += qv * ns[d0 + kk];
      }
      __syncthreads();
    }

    // weights w = S o D, their row sums, then h
    float rsum = 0.0f;
#pragma unroll
    for (int j = 0; j < kL / 4; ++j) {
      const int c = p + 4 * j;
      float w = 0.0f;
      if (c <= r && r < Lc)
        w = sacc[j] * expf(bs[r] - bs[c] + is[c] - ms[r]);
      Ss[r * kLP + c] = w;
      rsum += w;
    }
    rsum += __shfl_xor_sync(0xffffffffu, rsum, 1);
    rsum += __shfl_xor_sync(0xffffffffu, rsum, 2);
    if (p == 0) qn[r] = qnacc;
    __syncthreads();
    if (r < Lc) {
      const float g = gs[r];
      const float denom = fmaxf(fabsf(qn[r] * g + rsum), 1.0f);
#pragma unroll
      for (int j = 0; j < kVB / 4; ++j) hacc[j] *= g;
      for (int c = 0; c <= r; ++c) {
        const float w = Ss[r * kLP + c];
#pragma unroll
        for (int j = 0; j < kVB / 4; ++j) hacc[j] += w * vs[c * kVB + p + 4 * j];
      }
      T* hrow = h + (row_base + c0 + r) * d;
#pragma unroll
      for (int j = 0; j < kVB / 4; ++j)
        if (v0 + p + 4 * j < d) hrow[v0 + p + 4 * j] = from_f<T>(hacc[j] / denom);
    }

    // end of chunk: C[:, cols] and n decay and take the chunk's k v^T
    const float carry = sc[1];
    for (int d0 = 0; d0 < d; d0 += kDS) {
      const int dsz = static_cast<int>(d - d0 < kDS ? d - d0 : kDS);
      load_tile<T>(ks, k, row_base + c0, Lc, d0, dsz, d, scale);
      __syncthreads();
      if (r < dsz) {
        float acc[kVB / 4], nacc = 0.0f;
#pragma unroll
        for (int j = 0; j < kVB / 4; ++j) acc[j] = 0.0f;
        for (int s = 0; s < Lc; ++s) {
          const float kw = ks[s * kLP + r] * us[s];  // (k * upd) as rounded
          nacc += kw;                                // by the Pallas kernel
#pragma unroll
          for (int j = 0; j < kVB / 4; ++j) acc[j] += kw * vs[s * kVB + p + 4 * j];
        }
        float* crow = Cs + (d0 + r) * kVB;
#pragma unroll
        for (int j = 0; j < kVB / 4; ++j)
          crow[p + 4 * j] = carry * crow[p + 4 * j] + acc[j];
        if (p == 0) ns[d0 + r] = carry * ns[d0 + r] + nacc;
      }
      __syncthreads();
    }
    if (tid == 0) sc[0] = m_e;
    __syncthreads();
  }

  for (long long i = tid; i < d * kVB; i += kThreads) {
    const long long kk = i / kVB;
    const int vc = static_cast<int>(i % kVB);
    if (v0 + vc < d) c_out[(bh * d + kk) * d + v0 + vc] = Cs[i];
  }
  if (blockIdx.y == 0) {
    for (long long i = tid; i < d; i += kThreads) n_out[bh * d + i] = ns[i];
    if (tid == 0) m_out[bh] = sc[0];
  }
}

template <typename T, typename G>
int launch(const void* q, const void* k, const void* v, const void* ig,
           const void* fg, void* h, float* c_out, float* n_out,
           float* m_out, long long BH, long long S, long long d,
           float scale, cudaStream_t st) {
  const size_t bytes = smem_floats(d) * sizeof(float);
  auto kern = mlstm_kernel<T, G>;
  cudaError_t err = cudaFuncSetAttribute(
      kern, cudaFuncAttributeMaxDynamicSharedMemorySize,
      static_cast<int>(bytes));
  if (err != cudaSuccess) return static_cast<int>(err);
  const dim3 grid(static_cast<unsigned>(BH),
                  static_cast<unsigned>((d + kVB - 1) / kVB));
  kern<<<grid, kThreads, bytes, st>>>(
      static_cast<const T*>(q), static_cast<const T*>(k),
      static_cast<const T*>(v), static_cast<const G*>(ig),
      static_cast<const G*>(fg), static_cast<T*>(h), c_out, n_out, m_out, S,
      d, scale);
  return static_cast<int>(cudaGetLastError());
}

template <typename T>
int dispatch_gate(int gate_dtype, const void* q, const void* k,
                  const void* v, const void* ig, const void* fg, void* h,
                  float* c, float* n, float* m, long long BH, long long S,
                  long long d, float scale, cudaStream_t st) {
  if (gate_dtype == 0)
    return launch<T, float>(q, k, v, ig, fg, h, c, n, m, BH, S, d, scale,
                            st);
  return launch<T, T>(q, k, v, ig, fg, h, c, n, m, BH, S, d, scale, st);
}

}  // namespace

extern "C" {

// dtype (of q, k, v and h): 0 float32, 1 bfloat16, 2 float16;
// gate_dtype: 0 float32 or the same code as dtype.  Returns
// cudaGetLastError() after the launch (cudaErrorInvalidValue for a shape
// or dtype the kernel does not take).
int mlstm_chunkwise_fwd(const void* q, const void* k, const void* v,
                        const void* ig, const void* fg, void* h, void* c_out,
                        void* n_out, void* m_out, int dtype, int gate_dtype,
                        long long BH, long long S, long long d, float scale,
                        void* stream) {
  if (BH <= 0 || BH > 2147483647LL || S <= 0 || d <= 0 || d > kMaxD ||
      (gate_dtype != 0 && gate_dtype != dtype))
    return static_cast<int>(cudaErrorInvalidValue);
  const auto st = static_cast<cudaStream_t>(stream);
  auto* c = static_cast<float*>(c_out);
  auto* n = static_cast<float*>(n_out);
  auto* m = static_cast<float*>(m_out);
  switch (dtype) {
    case 0:
      return launch<float, float>(q, k, v, ig, fg, h, c, n, m, BH, S, d,
                                  scale, st);
    case 1:
      return dispatch_gate<__nv_bfloat16>(gate_dtype, q, k, v, ig, fg, h, c,
                                          n, m, BH, S, d, scale, st);
    case 2:
      return dispatch_gate<__half>(gate_dtype, q, k, v, ig, fg, h, c, n, m,
                                   BH, S, d, scale, st);
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
}

}  // extern "C"
