// Chunkwise mLSTM (xLSTM matrix memory) for Hopper (sm_90a).
//
// Replaces repro/kernels/mlstm.py:mlstm_chunkwise (the Pallas
// _mlstm_kernel, src/repro/kernels/mlstm.py:36).  Per batch*head row,
// with state C (d x d), n (d) and stabilizer m, over chunks of L = 64
// steps it computes what that kernel computes:
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
// them before its kernel (mlstm.py:130-132).  m starts at -inf; a
// non-finite g_t or carry decay is mapped to 0 as the Pallas kernel's
// jnp.where(isfinite) does (mlstm.py:77-78, :93-94).  The TPU kernel
// padded S to the chunk with i = -inf, f = 60; here a ragged last chunk
// is a bounds mask (its rows take no update and write nothing).
//
// Bound on an H100 SXM at xLSTM-350M's prefill shape (16, 2048, 512)
// bf16: 38.7 GFLOP (mlstm_flops: scores, q C, the D-weighted v and the
// C update) is 0.039 ms at 989 TFLOP/s; q, k, v, h and the final state
// are ~151 MB, 0.045 ms at 3.35 TB/s, so bytes bound it.
//
// Two routes, picked by an explicit rule in the wrapper (kernels/mlstm.py):
//
// * The tensor-core route (bfloat16 / float16, d % 16 == 0), three
//   kernels on one stream:
//   (a) mlstm_gate_kernel, one block per row: b_t as a warp-shuffle scan
//       within each chunk, the running max of i - b likewise, the
//       chunk-to-chunk max-plus recurrence of m on one warp (32 chunk
//       ends per load), then g_t, u_t = exp(b_e - b_t + i_t - m_e) and the
//       carry decay, into (BH, S) f32 scratch.  No thread scans alone.
//   (b) mlstm_intra_kernel, grid (chunks, BH): the scores Q_c K_c^T ONCE
//       per chunk (the FMA kernel recomputes them in each of d / 32
//       column blocks: 16x at d = 512) on mma.sync m16n8k16, from the
//       kernel's own rounded, scaled q and k (each product exact, f32
//       sums); W_c = S_c o D_c and its row sums, W_c as an input-type
//       hi + lo pair; and everything else the state pass needs that does
//       not wait on the state: the rounded, scaled q, the hi + lo pair of
//       (k * u)^T (rounded in f32 first, as the Pallas kernel rounds
//       k * upd) and its column sums (n's increment).  So the sequential
//       pass converts nothing and loads each operand once.
//   (c) mlstm_state_kernel, grid (BH, d / NV), the only sequential part:
//       the block keeps C[:, NV columns] in f32 shared memory (NV = 64,
//       or 32 or 16 where d x NV f32 beside the ring would not fit: 128
//       blocks at the shape above, one wave on 132 SMs), and n.  Per
//       chunk, all on the tensor cores: W V with W's pair, Q C with C as
//       hi + lo, and the update (K o u)^T V with (k * u)'s pair; q and v
//       enter exactly.  The q and (k u)^T slices arrive through a
//       three-slot ring, one bulk copy (TMA) per slice issued by one
//       thread two slices ahead, across chunk boundaries too; the next
//       chunk's W, v tile, gates and n increment through registers
//       loaded a chunk ahead.  So every
//       product keeps ~16 bits of its f32 operand, and the result stays
//       within half an output ulp + 1e-4 max|h| of the f32 recurrence
//       (chip_smoke.py phase 7's contract gate).  C's pair is scaled by
//       a power of two chosen from max|C| (into [2^14, 2^15)), so that in
//       float16 it neither overflows nor falls into subnormals.
//   The splits double the products: the route does ~1.9x mlstm_flops
//   (~73 GFLOP at the shape above), a floor of ~0.074 ms at 989 TFLOP/s;
//   the intra pass also writes and the state pass reads ~100 MB of
//   prepared operands (~0.03 ms each way).  The sequential pass runs
//   mma.sync on one 8-warp block per SM: a wgmma state pass is later
//   work.
// * The FMA route (float32; 16-bit head dims that are no multiple of 16,
//   or q, k, v off a 16-byte boundary): f32 FMA loops on the CUDA cores.  Grid (BH, ceil(d / 32)), each
//   block owning C[:, 32 columns] (64 KiB at d = 512) and looping over
//   the chunks; every block of one row recomputes the L x L scores, the
//   stabilizers and n (16x at d = 512) in exchange for needing no
//   communication between blocks.  q and k are streamed through shared
//   memory in slices of 64 along d.  Thread layout: r = tid / 4 is a
//   chunk row (or a d row of the slice in the update), p = tid % 4 picks
//   columns p + 4 j; shared tiles are padded to 65 words a row.

#include <cuda_bf16.h>
#include <cuda_fp16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

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
__global__ void __launch_bounds__(kThreads, 1)
mlstm_fma_kernel(const T* __restrict__ q, const T* __restrict__ k,
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
int launch_fma(const void* q, const void* k, const void* v, const void* ig,
           const void* fg, void* h, float* c_out, float* n_out,
           float* m_out, long long BH, long long S, long long d,
           float scale, cudaStream_t st) {
  const size_t bytes = smem_floats(d) * sizeof(float);
  auto kern = mlstm_fma_kernel<T, G>;
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
int dispatch_fma(int gate_dtype, const void* q, const void* k,
                  const void* v, const void* ig, const void* fg, void* h,
                  float* c, float* n, float* m, long long BH, long long S,
                  long long d, float scale, cudaStream_t st) {
  if (gate_dtype == 0)
    return launch_fma<T, float>(q, k, v, ig, fg, h, c, n, m, BH, S, d, scale,
                            st);
  return launch_fma<T, T>(q, k, v, ig, fg, h, c, n, m, BH, S, d, scale, st);
}

// ---------------------------------------------------------------------------
// tensor-core path (bfloat16 / float16, d % 16 == 0): three kernels
// ---------------------------------------------------------------------------
constexpr int kTP = 72;            // pitch (elements) of a 16-bit 64-wide tile
constexpr int kGateThreads = 256;
constexpr int kIntraThreads = 128;
constexpr int kStateThreads = 256;
constexpr size_t kMaxSmem = 232448;  // a block's shared memory on sm_90

// 16-bit element traits: the mma.sync instruction, two floats rounded
// into one 32-bit register (the lower column in the low half)
template <typename T> struct Tc;
template <> struct Tc<__nv_bfloat16> {
  static __device__ __forceinline__ uint32_t pack(float lo, float hi) {
    __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);
    return *reinterpret_cast<uint32_t*>(&v);
  }
  static __device__ __forceinline__ void mma(float (&d)[4],
                                             const uint32_t (&a)[4],
                                             uint32_t b0, uint32_t b1) {
    asm("mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
        "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, "
        "{%0, %1, %2, %3};\n"
        : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
        : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
  }
};
template <> struct Tc<__half> {
  static __device__ __forceinline__ uint32_t pack(float lo, float hi) {
    __half2 v = __floats2half2_rn(lo, hi);
    return *reinterpret_cast<uint32_t*>(&v);
  }
  static __device__ __forceinline__ void mma(float (&d)[4],
                                             const uint32_t (&a)[4],
                                             uint32_t b0, uint32_t b1) {
    asm("mma.sync.aligned.m16n8k16.row.col.f32.f16.f16.f32 "
        "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, "
        "{%0, %1, %2, %3};\n"
        : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
        : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
  }
};

// the 16-bit value in the low (j = 0) or high (j = 1) half of a word
template <typename T>
__device__ __forceinline__ T half_of(uint32_t w, int j);
template <>
__device__ __forceinline__ __nv_bfloat16 half_of<__nv_bfloat16>(uint32_t w,
                                                                int j) {
  return __ushort_as_bfloat16(static_cast<unsigned short>(w >> (16 * j)));
}
template <>
__device__ __forceinline__ __half half_of<__half>(uint32_t w, int j) {
  return __ushort_as_half(static_cast<unsigned short>(w >> (16 * j)));
}

// x = hi + lo, each rounded to T: two products keep ~16 bits of x
template <typename T>
__device__ __forceinline__ void split2(float x0, float x1, uint32_t& hi,
                                       uint32_t& lo) {
  const T h0 = from_f<T>(x0), h1 = from_f<T>(x1);
  hi = Tc<T>::pack(to_f(h0), to_f(h1));
  lo = Tc<T>::pack(x0 - to_f(h0), x1 - to_f(h1));
}

__device__ __forceinline__ uint32_t lds32(const void* p) {
  return *reinterpret_cast<const uint32_t*>(p);
}

// rows [0, 64) x columns [d0, d0 + cols) of a (rows, d) slice of q or k,
// scaled and rounded to T, into a 64 x kTP tile (and, given ``copy``, into
// a global 64 x kTP copy of the tile); rows at or past Lc and columns
// past cols read as 0.  d and cols are multiples of 8 (16-byte
// vectors of 8 elements).
template <typename T>
__device__ __forceinline__ void load_scaled(T* dst, const T* __restrict__ src,
                                            int Lc, int d0, int cols,
                                            long long d, float scale,
                                            int nthreads,
                                            T* __restrict__ copy = nullptr) {
  for (int e = threadIdx.x; e < 64 * 8; e += nthreads) {
    const int r = e >> 3, c = (e & 7) * 8;
    uint4 raw = make_uint4(0u, 0u, 0u, 0u);
    if (r < Lc && c < cols)
      raw = *reinterpret_cast<const uint4*>(src + r * d + d0 + c);
    const auto sc2 = [&](uint32_t w) {
      return Tc<T>::pack(scaled<T>(half_of<T>(w, 0), scale),
                         scaled<T>(half_of<T>(w, 1), scale));
    };
    const uint4 o = make_uint4(sc2(raw.x), sc2(raw.y), sc2(raw.z),
                               sc2(raw.w));
    *reinterpret_cast<uint4*>(dst + r * kTP + c) = o;
    if (copy != nullptr) *reinterpret_cast<uint4*>(copy + r * kTP + c) = o;
  }
}

// (a) gate pass, one block per row: b_t, m_t, g_t, u_t, the carry decay
// of every chunk, and the final m.  Per-step arrays have a row pitch of
// Sp = 64 * chunks; steps past S hold b, i, m, g, u = 0.
template <typename G>
__global__ void __launch_bounds__(kGateThreads)
mlstm_gate_kernel(const G* __restrict__ ig, const G* __restrict__ fg,
                  float* __restrict__ Bt, float* __restrict__ It,
                  float* __restrict__ Mt, float* __restrict__ Gt,
                  float* __restrict__ Ut, float* __restrict__ carry,
                  float* __restrict__ m_out, long long S, int nc) {
  const long long bh = blockIdx.x;
  const long long Sp = 64LL * nc;
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const G* igr = ig + bh * S;
  const G* fgr = fg + bh * S;
  float* B = Bt + bh * Sp;
  float* Iv = It + bh * Sp;
  float* M = Mt + bh * Sp;
  float* Gg = Gt + bh * Sp;
  float* U = Ut + bh * Sp;
  float* cr = carry + bh * nc;
  constexpr int kWarps = kGateThreads / 32;

  // 1: within each chunk, b = cumsum log f and the running max of i - b
  //    (warp scans; lane l holds steps 2 l and 2 l + 1); M holds the
  //    running max for now
  for (int c = warp; c < nc; c += kWarps) {
    const long long t0 = 64LL * c;
    const int Lc = static_cast<int>(S - t0 < 64 ? S - t0 : 64);
    const int j0 = 2 * lane, j1 = j0 + 1;
    const float lf0 = j0 < Lc ? log_sigmoid(to_f(fgr[t0 + j0])) : 0.0f;
    const float lf1 = j1 < Lc ? log_sigmoid(to_f(fgr[t0 + j1])) : 0.0f;
    const float i0 = j0 < Lc ? to_f(igr[t0 + j0]) : 0.0f;
    const float i1 = j1 < Lc ? to_f(igr[t0 + j1]) : 0.0f;
    float incl = lf0 + lf1;
#pragma unroll
    for (int off = 1; off < 32; off <<= 1) {
      const float x = __shfl_up_sync(0xffffffffu, incl, off);
      if (lane >= off) incl += x;
    }
    float excl = __shfl_up_sync(0xffffffffu, incl, 1);
    if (lane == 0) excl = 0.0f;
    const float b0 = excl + lf0, b1 = b0 + lf1;
    const float x0 = j0 < Lc ? i0 - b0 : -INFINITY;
    const float x1 = j1 < Lc ? i1 - b1 : -INFINITY;
    float mx = fmaxf(x0, x1);
#pragma unroll
    for (int off = 1; off < 32; off <<= 1) {
      const float y = __shfl_up_sync(0xffffffffu, mx, off);
      if (lane >= off) mx = fmaxf(mx, y);
    }
    float mex = __shfl_up_sync(0xffffffffu, mx, 1);
    if (lane == 0) mex = -INFINITY;
    const float g0 = fmaxf(mex, x0), g1 = fmaxf(g0, x1);
    B[t0 + j0] = b0;
    B[t0 + j1] = b1;
    Iv[t0 + j0] = i0;
    Iv[t0 + j1] = i1;
    M[t0 + j0] = g0;
    M[t0 + j1] = g1;
  }
  __syncthreads();

  // 2: m_prev of every chunk: m <- b_e + max(m, G_e), a scan over chunks
  //    on warp 0 (32 chunks' ends loaded at once, walked by shuffles);
  //    cr holds m_prev for now
  if (warp == 0) {
    float m = -INFINITY;
    for (int cb = 0; cb < nc; cb += 32) {
      const int c = cb + lane;
      float be = 0.0f, ge = -INFINITY;
      if (c < nc) {
        const long long t0 = 64LL * c;
        const long long e = t0 + (S - t0 < 64 ? S - t0 : 64) - 1;
        be = B[e];
        ge = M[e];
      }
      const int n = nc - cb < 32 ? nc - cb : 32;
      for (int j = 0; j < n; ++j) {
        const float bj = __shfl_sync(0xffffffffu, be, j);
        const float gj = __shfl_sync(0xffffffffu, ge, j);
        if (lane == j) cr[c] = m;
        m = bj + fmaxf(m, gj);
      }
    }
    if (lane == 0) m_out[bh] = m;
  }
  __syncthreads();

  // 3: m_t, g_t, u_t and the carry decay of each chunk
  for (int c = warp; c < nc; c += kWarps) {
    const long long t0 = 64LL * c;
    const int Lc = static_cast<int>(S - t0 < 64 ? S - t0 : 64);
    const float m_prev = cr[c];
    float b[2], i[2], m[2];
#pragma unroll
    for (int j = 0; j < 2; ++j) {
      const long long t = t0 + 2 * lane + j;
      b[j] = B[t];
      i[j] = Iv[t];
      m[j] = b[j] + fmaxf(m_prev, M[t]);
    }
    const int le = (Lc - 1) >> 1, je = (Lc - 1) & 1;
    const float b_e = __shfl_sync(0xffffffffu, je ? b[1] : b[0], le);
    const float m_e = __shfl_sync(0xffffffffu, je ? m[1] : m[0], le);
#pragma unroll
    for (int j = 0; j < 2; ++j) {
      const int tj = 2 * lane + j;
      const long long t = t0 + tj;
      const bool live = tj < Lc;
      M[t] = live ? m[j] : 0.0f;
      Gg[t] = live ? finite_or_zero(expf(b[j] + m_prev - m[j])) : 0.0f;
      U[t] = live ? expf(b_e - b[j] + i[j] - m_e) : 0.0f;
      if (!live) B[t] = Iv[t] = 0.0f;
    }
    __syncwarp();
    if (lane == 0) cr[c] = finite_or_zero(expf(b_e + m_prev - m_e));
  }
}

// (b) intra-chunk pass, grid (chunks, BH), everything that does not wait
// on the previous chunk's state:
//   * S = Q K^T once per chunk on the tensor cores (the kernel's own
//     rounded, scaled q and k: each product exact, summed in f32), then
//     W = S o D for s <= t (f32), its row sums, and W as an input-type
//     hi + lo pair;
//   * the rounded, scaled q, written out for the state pass;
//   * k * u (rounded in f32, as the Pallas kernel rounds k * upd) as an
//     input-type hi + lo pair, transposed to (d, 64), and its column sums
//     (the chunk's n increment, f32).
// q and the pair go out as the state pass's shared-memory tiles (64 x kTP
// per d slice: 9 KiB of q, 18 KiB of the pair, padding included), so
// that it loads each with one bulk copy.
// Warp w owns score rows 16 w .. 16 w + 15, all 64 columns.
template <typename T>
__global__ void __launch_bounds__(kIntraThreads)
mlstm_intra_kernel(const T* __restrict__ q, const T* __restrict__ k,
                   const float* __restrict__ Bt, const float* __restrict__ It,
                   const float* __restrict__ Mt, const float* __restrict__ Ut,
                   float* __restrict__ Rt, uint32_t* __restrict__ Wp,
                   T* __restrict__ Qh, T* __restrict__ Kut,
                   float* __restrict__ Nk, long long S, long long d,
                   float scale) {
  constexpr int kSP = 66;  // (k u)^T staging pitch: 33 words, no conflicts
  __shared__ __align__(16) T qs[kL * kTP];
  __shared__ __align__(16) T ks[kL * kTP];
  __shared__ __align__(16) T kst[2 * kL * kSP];  // (k u)^T hi, then lo
  __shared__ float bs[kL], is[kL], ms[kL], us[kL], nkp[2 * kL];
  const long long bh = blockIdx.y;
  const int c = blockIdx.x, nc = gridDim.x;
  const long long t0 = 64LL * c;
  const int Lc = static_cast<int>(S - t0 < kL ? S - t0 : kL);
  const long long Sp = 64LL * nc;
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int g = lane >> 2, tig = lane & 3;
  scale = to_f(from_f<T>(scale));
  if (threadIdx.x < kL) {
    bs[threadIdx.x] = Bt[bh * Sp + t0 + threadIdx.x];
    is[threadIdx.x] = It[bh * Sp + t0 + threadIdx.x];
    ms[threadIdx.x] = Mt[bh * Sp + t0 + threadIdx.x];
    us[threadIdx.x] = Ut[bh * Sp + t0 + threadIdx.x];
  }
  const T* qc = q + (bh * S + t0) * d;
  const T* kc = k + (bh * S + t0) * d;
  // per d slice: q as a 64 x kTP tile, (k u)^T's hi and lo as two more
  const int P = static_cast<int>((d + kDS - 1) / kDS);
  T* qh = Qh + (bh * nc + c) * P * kL * kTP;
  T* kut = Kut + (bh * nc + c) * P * 2 * kL * kTP;
  float* nk = Nk + (bh * nc + c) * d;

  float acc[8][4];
#pragma unroll
  for (int n = 0; n < 8; ++n)
#pragma unroll
    for (int j = 0; j < 4; ++j) acc[n][j] = 0.0f;
  const int r0 = 16 * warp + g;
  for (int d0 = 0; d0 < d; d0 += kDS) {
    const int dsz = static_cast<int>(d - d0 < kDS ? d - d0 : kDS);
    __syncthreads();
    load_scaled<T>(qs, qc, Lc, d0, dsz, d, scale, kIntraThreads,
                   qh + (d0 / kDS) * kL * kTP);
    load_scaled<T>(ks, kc, Lc, d0, dsz, d, scale, kIntraThreads);
    __syncthreads();
    for (int kk = 0; kk < dsz; kk += 16) {
      uint32_t a[4];
      a[0] = lds32(qs + r0 * kTP + kk + 2 * tig);
      a[1] = lds32(qs + (r0 + 8) * kTP + kk + 2 * tig);
      a[2] = lds32(qs + r0 * kTP + kk + 8 + 2 * tig);
      a[3] = lds32(qs + (r0 + 8) * kTP + kk + 8 + 2 * tig);
#pragma unroll
      for (int n = 0; n < 8; ++n) {
        const T* kr = ks + (8 * n + g) * kTP + kk + 2 * tig;
        Tc<T>::mma(acc[n], a, lds32(kr), lds32(kr + 8));
      }
    }
    // k * u of this slice, transposed through shared memory: thread
    // (column dd, half hf) takes steps 32 hf .. 32 hf + 31; columns past
    // dsz read as 0
    {
      const int dd = threadIdx.x & (kL - 1), hf = threadIdx.x / kL;
      float part = 0.0f;
#pragma unroll 4
      for (int t = 32 * hf; t < 32 * hf + 32; t += 2) {
        const float x0 = to_f(ks[t * kTP + dd]) * us[t];
        const float x1 = to_f(ks[(t + 1) * kTP + dd]) * us[t + 1];
        part += x0;
        part += x1;
        uint32_t hi, lo;
        split2<T>(x0, x1, hi, lo);
        *reinterpret_cast<uint32_t*>(kst + dd * kSP + t) = hi;
        *reinterpret_cast<uint32_t*>(kst + (kL + dd) * kSP + t) = lo;
      }
      nkp[hf * kL + dd] = part;
    }
    __syncthreads();
    if (threadIdx.x < dsz)
      nk[d0 + threadIdx.x] = nkp[threadIdx.x] + nkp[kL + threadIdx.x];
    T* kout = kut + (d0 / kDS) * 2 * kL * kTP;
    for (int e = threadIdx.x; e < 2 * kL * 32; e += kIntraThreads) {
      const int r = e >> 5, w = e & 31;  // row of hi then lo, word
      reinterpret_cast<uint32_t*>(kout + r * kTP)[w] =
          reinterpret_cast<const uint32_t*>(kst + r * kSP)[w];
    }
  }

  // W = S o D for s <= t < Lc, row sums, the hi + lo pair of W
  float rsum[2] = {0.0f, 0.0f};
  uint32_t* wc = Wp + (bh * nc + c) * (kL * kL);  // hi, then lo
#pragma unroll
  for (int h = 0; h < 2; ++h) {
    const int t = r0 + 8 * h;
#pragma unroll
    for (int n = 0; n < 8; ++n) {
      float w[2];
#pragma unroll
      for (int j = 0; j < 2; ++j) {
        const int s = 8 * n + 2 * tig + j;
        w[j] = (s <= t && t < Lc)
                   ? acc[n][2 * h + j] * expf(bs[t] - bs[s] + is[s] - ms[t])
                   : 0.0f;
        rsum[h] += w[j];
      }
      uint32_t hi, lo;
      split2<T>(w[0], w[1], hi, lo);
      const int pos = (t * kL + 8 * n + 2 * tig) >> 1;
      wc[pos] = hi;
      wc[kL * kL / 2 + pos] = lo;
    }
    rsum[h] += __shfl_xor_sync(0xffffffffu, rsum[h], 1);
    rsum[h] += __shfl_xor_sync(0xffffffffu, rsum[h], 2);
    if (tig == 0) Rt[bh * Sp + t0 + t] = rsum[h];
  }
}

// (c) state pass, grid (BH, ceil(d / NV)), sequential over chunks: the
// block owns C[:, v0 : v0 + NV] in f32 shared memory and (redundantly) n.
// Per chunk:
//   h[:, tile] = (g o (Q C) + W V[:, tile]) / max(|g (q . n) + rowsum|, 1)
//   C <- carry C + (K o u)^T V[:, tile],  n <- carry n + (K o u)^T 1.
// Q C takes C as hi + lo (scaled by a power of two so that the pair
// neither overflows nor falls into subnormals in float16), W V takes W's
// pair, the update the pair of k * u; q and v enter exactly.  The
// chunk's q slices and (k u)^T slices stream through a kRing-slot ring
// of bulk copies (slices j + 1 and j + 2 in flight while slice j is
// used), and the next chunk's W pair, v tile, gates and n increment are
// loaded into registers at the start of a chunk and stored to shared
// memory at its end, so no load waits on the sequential path.
// Warps: for h, WN = NV / 8 along the tile's columns (one 8-column n-tile
// each) and 8 / WN along rows (MT m-tiles of 16 rows); for the update,
// one 16-row m-tile of the d slice and half of the tile's columns each.
template <int NV>
struct StateTile {
  static constexpr int kWN = NV / 8;
  static constexpr int kWM = (kStateThreads / 32) / kWN;
  static constexpr int kMT = 4 / kWM;
  static constexpr int kUN = NV / 16;  // update n-tiles per warp
  static constexpr int kCP = NV + 4;   // pitch of C's f32 rows
  static constexpr int kVP = NV + 8;   // pitch of the v tile
};
constexpr int kSlot = 2 * kL * kTP;    // a ring slot: (k u)^T pair, or q
constexpr int kRing = 3;               // slots: slice j + 2 lands during j

template <int NV>
size_t state_smem(long long d) {
  return static_cast<size_t>(d) * StateTile<NV>::kCP * 4  // C
         + static_cast<size_t>(d) * 8                     // n, n increment
         + 3 * kL * 4 + 16 + 32                 // g, r, qn; scalars; barriers
         + (kRing * kSlot + 2 * kL * kTP + kL * StateTile<NV>::kVP) * 2;
}

__device__ __forceinline__ uint32_t smem_addr(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}
__device__ __forceinline__ void mbar_init(uint32_t bar, uint32_t count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;\n" ::"r"(bar),
               "r"(count)
               : "memory");
}
// one bulk copy (TMA, no tensor map) of ``bytes`` into shared memory,
// completing on ``bar``, which expects them
__device__ __forceinline__ void bulk_load(void* dst, const void* src,
                                          uint32_t bytes, uint32_t bar) {
  asm volatile(
      "mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n" ::"r"(bar),
      "r"(bytes)
      : "memory");
  asm volatile(
      "cp.async.bulk.shared::cluster.global.mbarrier::complete_tx::bytes "
      "[%0], [%1], %2, [%3];\n" ::"r"(smem_addr(dst)),
      "l"(src), "r"(bytes), "r"(bar)
      : "memory");
}
// spin until the phase of parity ``parity`` has completed
__device__ __forceinline__ void mbar_wait(uint32_t bar, uint32_t parity) {
  uint32_t done = 0;
  do {
    asm volatile(
        "{\n.reg .pred p;\n"
        "mbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n"
        "selp.u32 %0, 1, 0, p;\n}\n"
        : "=r"(done)
        : "r"(bar), "r"(parity)
        : "memory");
  } while (!done);
}

__device__ __forceinline__ uint32_t pack_u16(const void* lo, const void* hi) {
  return static_cast<uint32_t>(*static_cast<const uint16_t*>(lo)) |
         (static_cast<uint32_t>(*static_cast<const uint16_t*>(hi)) << 16);
}

template <typename T, int NV>
__global__ void __launch_bounds__(kStateThreads, 1)
mlstm_state_kernel(const T* __restrict__ Qh, const T* __restrict__ Kut,
                   const T* __restrict__ v,
                   const float* __restrict__ Gt, const float* __restrict__ Rt,
                   const float* __restrict__ carry,
                   const float* __restrict__ Nk,
                   const uint32_t* __restrict__ Wp, T* __restrict__ h,
                   float* __restrict__ c_out, float* __restrict__ n_out,
                   long long S, long long d) {
  using Tile = StateTile<NV>;
  constexpr int CP = Tile::kCP, VP = Tile::kVP, MT = Tile::kMT;
  constexpr int UN = Tile::kUN;
  extern __shared__ __align__(16) unsigned char smem[];
  float* Cs = reinterpret_cast<float*>(smem);    // d x CP
  float* ns = Cs + d * CP;                       // d
  float* nks = ns + d;                           // the chunk's n increment
  float* gs = nks + d;                           // g_t
  float* rs = gs + kL;                           // row sums of W
  float* qn = rs + kL;                           // q_t . n
  float* sc = qn + kL;                           // carry; C's max x 2 (bits)
  const uint32_t bars = smem_addr(sc + 4);       // kRing mbarriers
  T* ring = reinterpret_cast<T*>(sc + 12);       // kRing slots of kSlot
  T* wh = ring + kRing * kSlot;                  // W hi: 64 x kTP
  T* wl = wh + kL * kTP;                         // W lo
  T* vs = wl + kL * kTP;                         // v tile: 64 x VP
  auto* cmax = reinterpret_cast<unsigned int*>(sc + 2);

  const long long bh = blockIdx.x;
  const int v0 = blockIdx.y * NV;
  const int nc = static_cast<int>((S + kL - 1) / kL);
  const long long Sp = 64LL * nc;
  const int P = static_cast<int>((d + kDS - 1) / kDS);  // d slices
  const int tid = threadIdx.x;
  const int warp = tid >> 5, lane = tid & 31;
  const int g = lane >> 2, tig = lane & 3;
  const int nt = warp % Tile::kWN;                 // h: this warp's n-tile
  const int mb = (warp / Tile::kWN) * MT;          // and first m-tile
  const int col = 8 * nt + 2 * tig;                // its accumulator columns
  const int um = warp & 3, un = warp >> 2;         // update: m-tile, half

  // the ring: slice s of chunk c is q slice s (s < P) or the (k u)^T
  // pair of slice s - P; issue() starts the next one in the sequence (one
  // bulk copy from thread 0), two ahead of use; a slot's barrier flips
  // parity at each use
  int ic = 0, is_ = 0, islot = 0, uslot = 0, uphase = 0;
  auto issue = [&]() {
    if (tid == 0 && ic < nc) {
      const long long tile = (bh * nc + ic) * P;
      if (is_ < P)
        bulk_load(ring + islot * kSlot, Qh + (tile + is_) * kL * kTP,
                  kL * kTP * 2, bars + 8 * islot);
      else
        bulk_load(ring + islot * kSlot,
                  Kut + (tile + is_ - P) * 2 * kL * kTP, kSlot * 2,
                  bars + 8 * islot);
    }
    if (++is_ == 2 * P) {
      is_ = 0;
      ++ic;
    }
    if (++islot == kRing) islot = 0;
  };
  auto next_slot = [&]() -> const T* {
    mbar_wait(bars + 8 * uslot, (uphase >> uslot) & 1);
    uphase ^= 1 << uslot;
    const T* t = ring + uslot * kSlot;
    if (++uslot == kRing) uslot = 0;
    return t;
  };

  // the next chunk's inputs, held in registers through a chunk
  constexpr int kWv = (kL * kL * 2 / 8) / kStateThreads;        // 4
  constexpr int kVv = (kL * NV / 8 + kStateThreads - 1) / kStateThreads;
  uint4 wreg[kWv], vreg[kVv], nreg;
  float greg = 0.0f, rreg = 0.0f, creg = 0.0f;
  auto fetch = [&](int cn) {
    const long long t0 = 64LL * cn;
    const int Lc = static_cast<int>(S - t0 < kL ? S - t0 : kL);
    const uint4* wsrc =
        reinterpret_cast<const uint4*>(Wp + (bh * nc + cn) * (kL * kL));
#pragma unroll
    for (int i = 0; i < kWv; ++i) wreg[i] = wsrc[tid + i * kStateThreads];
#pragma unroll
    for (int i = 0; i < kVv; ++i) {
      const int e = tid + i * kStateThreads;
      const int r = e / (NV / 8), cc = (e % (NV / 8)) * 8;
      vreg[i] = make_uint4(0u, 0u, 0u, 0u);
      if (e < kL * NV / 8 && r < Lc && v0 + cc < d)
        vreg[i] = *reinterpret_cast<const uint4*>(
            v + (bh * S + t0 + r) * d + v0 + cc);
    }
    nreg = make_uint4(0u, 0u, 0u, 0u);
    if (tid < d / 4)
      nreg = reinterpret_cast<const uint4*>(Nk + (bh * nc + cn) * d)[tid];
    if (tid < kL) {
      greg = Gt[bh * Sp + t0 + tid];
      rreg = Rt[bh * Sp + t0 + tid];
    }
    if (tid == 0) creg = carry[bh * nc + cn];
  };
  auto stash = [&]() {
#pragma unroll
    for (int i = 0; i < kWv; ++i) {
      const int e = tid + i * kStateThreads;      // 16-byte word of W
      const int lo = e >= kL * kL / 8, ee = e - lo * (kL * kL / 8);
      *reinterpret_cast<uint4*>((lo ? wl : wh) + (ee >> 3) * kTP +
                                (ee & 7) * 8) = wreg[i];
    }
#pragma unroll
    for (int i = 0; i < kVv; ++i) {
      const int e = tid + i * kStateThreads;
      if (e < kL * NV / 8)
        *reinterpret_cast<uint4*>(vs + (e / (NV / 8)) * VP +
                                  (e % (NV / 8)) * 8) = vreg[i];
    }
    if (tid < d / 4) reinterpret_cast<uint4*>(nks)[tid] = nreg;
    if (tid < kL) {
      gs[tid] = greg;
      rs[tid] = rreg;
    }
    if (tid == 0) sc[0] = creg;
  };

  for (long long i = tid; i < d * CP; i += kStateThreads) Cs[i] = 0.0f;
  for (long long i = tid; i < d; i += kStateThreads) ns[i] = 0.0f;
  if (tid < 2) cmax[tid] = 0u;
  if (tid == 0) {
    for (int i = 0; i < kRing; ++i) mbar_init(bars + 8 * i, 1);
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();
  fetch(0);
  stash();
  issue();
  issue();

  for (int c = 0; c < nc; ++c) {
    const long long t0 = 64LL * c;
    const int Lc = static_cast<int>(S - t0 < kL ? S - t0 : kL);
    const long long row0 = bh * S + t0;
    if (tid == 0) cmax[c & 1] = 0u;
    __syncthreads();  // this chunk's inputs are in shared memory

    // v's B fragments (k = the chunk's steps): this warp's n-tile for
    // W V, its half of the tile for the update
    uint32_t vb[4][2], vu[4][UN][2];
#pragma unroll
    for (int ks = 0; ks < 4; ++ks) {
      const T* vr = vs + (16 * ks + 2 * tig) * VP;
      vb[ks][0] = pack_u16(vr + 8 * nt + g, vr + VP + 8 * nt + g);
      vb[ks][1] = pack_u16(vr + 8 * VP + 8 * nt + g, vr + 9 * VP + 8 * nt + g);
#pragma unroll
      for (int j = 0; j < UN; ++j) {
        const int n = 8 * (un * UN + j) + g;
        vu[ks][j][0] = pack_u16(vr + n, vr + VP + n);
        vu[ks][j][1] = pack_u16(vr + 8 * VP + n, vr + 9 * VP + n);
      }
    }
    // W V
    float wv[MT][4];
#pragma unroll
    for (int m = 0; m < MT; ++m) {
#pragma unroll
      for (int j = 0; j < 4; ++j) wv[m][j] = 0.0f;
    }
#pragma unroll
    for (int ks = 0; ks < 4; ++ks) {
#pragma unroll
      for (int part = 0; part < 2; ++part) {  // W's hi, then its lo
        const T* w = (part ? wl : wh) + 16 * ks + 2 * tig;
#pragma unroll
        for (int m = 0; m < MT; ++m) {
          const int r = 16 * (mb + m) + g;
          uint32_t a[4];
          a[0] = lds32(w + r * kTP);
          a[1] = lds32(w + (r + 8) * kTP);
          a[2] = lds32(w + r * kTP + 8);
          a[3] = lds32(w + (r + 8) * kTP + 8);
          Tc<T>::mma(wv[m], a, vb[ks][0], vb[ks][1]);
        }
      }
    }
    if (c + 1 < nc) fetch(c + 1);
    // C's pair scale: max|C| * 2^e in [2^14, 2^15)
    const float cm = __uint_as_float(cmax[(c & 1) ^ 1]);
    int ex = 0;
    if (cm > 0.0f) {
      frexpf(cm, &ex);
      ex = 15 - ex;
      ex = ex > 100 ? 100 : (ex < -100 ? -100 : ex);
    }
    const float csc = ldexpf(1.0f, ex), cinv = ldexpf(1.0f, -ex);
    const float cy = sc[0];

    // ---- Q C and q . n over the q slices ----
    float acc[MT][4];
#pragma unroll
    for (int m = 0; m < MT; ++m)
#pragma unroll
      for (int j = 0; j < 4; ++j) acc[m][j] = 0.0f;
    float qnp = 0.0f;
    const int qr = tid >> 2, qp = tid & 3;  // q . n: row qr, 16 columns
    for (int s = 0; s < P; ++s) {
      const T* qs = next_slot();  // this slice has landed
      __syncthreads();            // and every thread is done with the last
      issue();                    // into the last one's slot
      const int d0 = s * kDS;
      const int dsz = static_cast<int>(d - d0 < kDS ? d - d0 : kDS);
      if (16 * qp < dsz) {
        const uint4* qv = reinterpret_cast<const uint4*>(qs + qr * kTP + 16 * qp);
        const float4* nv = reinterpret_cast<const float4*>(ns + d0 + 16 * qp);
#pragma unroll
        for (int h2 = 0; h2 < 2; ++h2) {
          const uint4 w = qv[h2];
          const float4 na = nv[2 * h2], nb = nv[2 * h2 + 1];
          const auto f = [](uint32_t x, int j) {
            return to_f(half_of<T>(x, j));
          };
          qnp += f(w.x, 0) * na.x + f(w.x, 1) * na.y + f(w.y, 0) * na.z +
                 f(w.y, 1) * na.w + f(w.z, 0) * nb.x + f(w.z, 1) * nb.y +
                 f(w.w, 0) * nb.z + f(w.w, 1) * nb.w;
        }
      }
#pragma unroll
      for (int kk = 0; kk < kDS; kk += 16) {
        if (kk >= dsz) break;
        const float* cr = Cs + (d0 + kk + 2 * tig) * CP + 8 * nt + g;
        uint32_t bh0, bl0, bh1, bl1;
        split2<T>(cr[0] * csc, cr[CP] * csc, bh0, bl0);
        split2<T>(cr[8 * CP] * csc, cr[9 * CP] * csc, bh1, bl1);
        uint32_t a[MT][4];
#pragma unroll
        for (int m = 0; m < MT; ++m) {
          const int r = 16 * (mb + m) + g;
          a[m][0] = lds32(qs + r * kTP + kk + 2 * tig);
          a[m][1] = lds32(qs + (r + 8) * kTP + kk + 2 * tig);
          a[m][2] = lds32(qs + r * kTP + kk + 8 + 2 * tig);
          a[m][3] = lds32(qs + (r + 8) * kTP + kk + 8 + 2 * tig);
          Tc<T>::mma(acc[m], a[m], bh0, bh1);
        }
#pragma unroll
        for (int m = 0; m < MT; ++m) Tc<T>::mma(acc[m], a[m], bl0, bl1);
      }
    }
    qnp += __shfl_xor_sync(0xffffffffu, qnp, 1);
    qnp += __shfl_xor_sync(0xffffffffu, qnp, 2);
    if (qp == 0) qn[qr] = qnp;
    __syncthreads();  // qn; every q . n has read the old n
    for (long long i = tid; i < d; i += kStateThreads)
      ns[i] = cy * ns[i] + nks[i];
#pragma unroll
    for (int m = 0; m < MT; ++m)
#pragma unroll
      for (int hh = 0; hh < 2; ++hh) {
        const int t = 16 * (mb + m) + g + 8 * hh;
        if (t < Lc && v0 + col < d) {
          const float gt = gs[t];
          const float inv = 1.0f / fmaxf(fabsf(qn[t] * gt + rs[t]), 1.0f);
          const float h0 =
              (acc[m][2 * hh] * cinv * gt + wv[m][2 * hh]) * inv;
          const float h1 =
              (acc[m][2 * hh + 1] * cinv * gt + wv[m][2 * hh + 1]) * inv;
          *reinterpret_cast<uint32_t*>(h + (row0 + t) * d + v0 + col) =
              Tc<T>::pack(h0, h1);
        }
      }

    // ---- C <- carry C + (K o u)^T V over the (k u)^T slices ----
    float cmx = 0.0f;
    for (int s = 0; s < P; ++s) {
      const T* kuh = next_slot();
      __syncthreads();
      issue();
      const T* kul = kuh + kL * kTP;
      const int d0 = s * kDS;
      const int dsz = static_cast<int>(d - d0 < kDS ? d - d0 : kDS);
      if (16 * um < dsz) {
        const int r = 16 * um + g;  // row of the slice (a d index)
        float u[UN][4];
#pragma unroll
        for (int jn = 0; jn < UN; ++jn)
#pragma unroll
          for (int e = 0; e < 4; ++e) u[jn][e] = 0.0f;
#pragma unroll
        for (int ks = 0; ks < 4; ++ks) {
          const int kk = 16 * ks + 2 * tig;
          uint32_t ah[4], al[4];
          ah[0] = lds32(kuh + r * kTP + kk);
          ah[1] = lds32(kuh + (r + 8) * kTP + kk);
          ah[2] = lds32(kuh + r * kTP + kk + 8);
          ah[3] = lds32(kuh + (r + 8) * kTP + kk + 8);
          al[0] = lds32(kul + r * kTP + kk);
          al[1] = lds32(kul + (r + 8) * kTP + kk);
          al[2] = lds32(kul + r * kTP + kk + 8);
          al[3] = lds32(kul + (r + 8) * kTP + kk + 8);
#pragma unroll
          for (int jn = 0; jn < UN; ++jn)
            Tc<T>::mma(u[jn], ah, vu[ks][jn][0], vu[ks][jn][1]);
#pragma unroll
          for (int jn = 0; jn < UN; ++jn)
            Tc<T>::mma(u[jn], al, vu[ks][jn][0], vu[ks][jn][1]);
        }
#pragma unroll
        for (int jn = 0; jn < UN; ++jn)
#pragma unroll
          for (int hh = 0; hh < 2; ++hh) {
            float* cp = Cs + (d0 + r + 8 * hh) * CP + 8 * (un * UN + jn) +
                        2 * tig;
            const float c0 = cy * cp[0] + u[jn][2 * hh];
            const float c1 = cy * cp[1] + u[jn][2 * hh + 1];
            cp[0] = c0;
            cp[1] = c1;
            cmx = fmaxf(cmx, fmaxf(fabsf(c0), fabsf(c1)));
          }
      }
    }
#pragma unroll
    for (int off = 16; off > 0; off >>= 1)
      cmx = fmaxf(cmx, __shfl_xor_sync(0xffffffffu, cmx, off));
    if (lane == 0) atomicMax(&cmax[c & 1], __float_as_uint(cmx));
    if (c + 1 < nc) stash();
  }
  __syncthreads();

  for (long long i = tid; i < d * NV; i += kStateThreads) {
    const long long kk = i / NV;
    const int j = static_cast<int>(i % NV);
    if (v0 + j < d) c_out[(bh * d + kk) * d + v0 + j] = Cs[kk * CP + j];
  }
  if (blockIdx.y == 0)
    for (long long i = tid; i < d; i += kStateThreads)
      n_out[bh * d + i] = ns[i];
}

// scratch (in f32 words) of the tensor-core route: six (BH, Sp) per-step
// arrays (b, i, m, g, u, W's row sums), the (BH, chunks, d) n increments
// and the (BH, chunks) carry decays, padded to 16 bytes; W's pair (4096
// words a chunk); per chunk and d slice, the rounded, scaled q (64 x kTP)
// and (k u)^T's pair (2 x 64 x kTP), in T.  kernels/mlstm.py:
// scratch_floats agrees.
long long tc_scratch_floats(long long BH, long long S, long long d) {
  const long long nc = (S + kL - 1) / kL, Sp = kL * nc;
  const long long P = (d + kDS - 1) / kDS;
  const long long small = 6 * BH * Sp + BH * nc + BH * nc * d;
  return (small + 3) / 4 * 4 + BH * nc * kL * kL +
         BH * nc * P * 3 * kL * kTP / 2;
}

template <typename T, int NV>
int launch_state(const T* Qh, const T* Kut, const void* v,
                 const float* Gt, const float* Rt, const float* carry,
                 const float* Nk, const uint32_t* Wp, void* h, float* c_out,
                 float* n_out, long long BH, long long S, long long d,
                 cudaStream_t st) {
  const size_t bytes = state_smem<NV>(d);
  auto kern = mlstm_state_kernel<T, NV>;
  const cudaError_t err = cudaFuncSetAttribute(
      kern, cudaFuncAttributeMaxDynamicSharedMemorySize,
      static_cast<int>(bytes));
  if (err != cudaSuccess) return static_cast<int>(err);
  kern<<<dim3(static_cast<unsigned>(BH),
              static_cast<unsigned>((d + NV - 1) / NV)),
         kStateThreads, bytes, st>>>(Qh, Kut, static_cast<const T*>(v),
                                     Gt, Rt, carry, Nk, Wp,
                                     static_cast<T*>(h), c_out, n_out, S, d);
  return static_cast<int>(cudaGetLastError());
}

template <typename T, typename G>
int launch_tc(const void* q, const void* k, const void* v, const void* ig,
              const void* fg, void* h, float* c_out, float* n_out,
              float* m_out, float* scratch, long long BH, long long S,
              long long d, float scale, cudaStream_t st) {
  const long long nc = (S + kL - 1) / kL;
  const long long Sp = kL * nc;
  if (BH > 65535 || nc > 2147483647LL)
    return static_cast<int>(cudaErrorInvalidValue);
  float* Bt = scratch;
  float* It = Bt + BH * Sp;
  float* Mt = It + BH * Sp;
  float* Gt = Mt + BH * Sp;
  float* Ut = Gt + BH * Sp;
  float* Rt = Ut + BH * Sp;
  float* Nk = Rt + BH * Sp;           // 16-byte aligned: Sp, d % 16 == 0
  float* carry = Nk + BH * nc * d;
  float* rest = scratch + (6 * BH * Sp + BH * nc + BH * nc * d + 3) / 4 * 4;
  auto* Wp = reinterpret_cast<uint32_t*>(rest);
  const long long P = (d + kDS - 1) / kDS;
  T* Qh = reinterpret_cast<T*>(rest + BH * nc * kL * kL);
  T* Kut = Qh + BH * nc * P * kL * kTP;

  mlstm_gate_kernel<G><<<static_cast<unsigned>(BH), kGateThreads, 0, st>>>(
      static_cast<const G*>(ig), static_cast<const G*>(fg), Bt, It, Mt, Gt,
      Ut, carry, m_out, S, static_cast<int>(nc));
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return static_cast<int>(err);
  mlstm_intra_kernel<T><<<dim3(static_cast<unsigned>(nc),
                               static_cast<unsigned>(BH)),
                          kIntraThreads, 0, st>>>(
      static_cast<const T*>(q), static_cast<const T*>(k), Bt, It, Mt, Ut, Rt,
      Wp, Qh, Kut, Nk, S, d, scale);
  err = cudaGetLastError();
  if (err != cudaSuccess) return static_cast<int>(err);
  // the widest tile of C whose f32 rows fit in shared memory
  if (state_smem<64>(d) <= kMaxSmem)
    return launch_state<T, 64>(Qh, Kut, v, Gt, Rt, carry, Nk, Wp, h,
                               c_out, n_out, BH, S, d, st);
  if (state_smem<32>(d) <= kMaxSmem)
    return launch_state<T, 32>(Qh, Kut, v, Gt, Rt, carry, Nk, Wp, h,
                               c_out, n_out, BH, S, d, st);
  if (state_smem<16>(d) <= kMaxSmem)
    return launch_state<T, 16>(Qh, Kut, v, Gt, Rt, carry, Nk, Wp, h,
                               c_out, n_out, BH, S, d, st);
  return static_cast<int>(cudaErrorInvalidValue);
}

template <typename T>
int dispatch_tc(int gate_dtype, const void* q, const void* k, const void* v,
                const void* ig, const void* fg, void* h, float* c, float* n,
                float* m, float* scratch, long long BH, long long S,
                long long d, float scale, cudaStream_t st) {
  if (gate_dtype == 0)
    return launch_tc<T, float>(q, k, v, ig, fg, h, c, n, m, scratch, BH, S,
                               d, scale, st);
  return launch_tc<T, T>(q, k, v, ig, fg, h, c, n, m, scratch, BH, S, d,
                         scale, st);
}

}  // namespace

extern "C" {

// The FMA route: float32, or any head dim.  dtype (of q, k, v and h):
// 0 float32, 1 bfloat16, 2 float16; gate_dtype: 0 float32 or the same
// code as dtype.  Returns cudaGetLastError() after the launch
// (cudaErrorInvalidValue for a shape or dtype the kernel does not take).
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
      return launch_fma<float, float>(q, k, v, ig, fg, h, c, n, m, BH, S, d,
                                      scale, st);
    case 1:
      return dispatch_fma<__nv_bfloat16>(gate_dtype, q, k, v, ig, fg, h, c,
                                         n, m, BH, S, d, scale, st);
    case 2:
      return dispatch_fma<__half>(gate_dtype, q, k, v, ig, fg, h, c, n, m,
                                  BH, S, d, scale, st);
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
}

// The tensor-core route: bfloat16 / float16 with d % 16 == 0 and q, k,
// v 16-byte aligned.  ``scratch`` holds mlstm_tc_scratch_floats(BH, S, d)
// f32 words, 16-byte aligned.
int mlstm_chunkwise_tc(const void* q, const void* k, const void* v,
                       const void* ig, const void* fg, void* h, void* c_out,
                       void* n_out, void* m_out, void* scratch, int dtype,
                       int gate_dtype, long long BH, long long S, long long d,
                       float scale, void* stream) {
  if (BH <= 0 || S <= 0 || d <= 0 || d > kMaxD || d % 16 ||
      (gate_dtype != 0 && gate_dtype != dtype))
    return static_cast<int>(cudaErrorInvalidValue);
  const auto st = static_cast<cudaStream_t>(stream);
  auto* c = static_cast<float*>(c_out);
  auto* n = static_cast<float*>(n_out);
  auto* m = static_cast<float*>(m_out);
  auto* w = static_cast<float*>(scratch);
  switch (dtype) {
    case 1:
      return dispatch_tc<__nv_bfloat16>(gate_dtype, q, k, v, ig, fg, h, c,
                                        n, m, w, BH, S, d, scale, st);
    case 2:
      return dispatch_tc<__half>(gate_dtype, q, k, v, ig, fg, h, c, n, m, w,
                                 BH, S, d, scale, st);
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
}

long long mlstm_tc_scratch_floats(long long BH, long long S, long long d) {
  return tc_scratch_floats(BH, S, d);
}

}  // extern "C"
