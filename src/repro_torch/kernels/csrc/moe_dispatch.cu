// MoE dispatch and combine for Hopper (sm_90a): two row-movement kernels.
//
// Replaces repro/kernels/moe_dispatch.py:
//
// * gather_rows (the Pallas _gather_kernel, line 30):
//     out[i, :] = x[idx[i], :]            x (N, D), idx (M,) int32 in [0, N)
//   the MoE dispatch: packing token rows into expert-capacity buffers.
// * moe_combine (the Pallas _combine_kernel, line 60):
//     out[t, :] = sum_k w[t, k] * y[slots[t, k], :]   (slot < 0: skipped)
//   accumulated in f32 over k = 0 .. K-1 in that order, written once in
//   y's type: the weighted 'accept' of expert outputs back into token
//   order.
//
// The TPU kernels walked a sequential grid, one row (gather) or one
// (token, k) pair (combine) a step, the indices prefetched to SMEM
// driving each step's DMA, the combine's sum carried across the k steps
// in VMEM scratch.  Here a warp owns an output row (gather) and a block
// owns a token (combine), each loading its own indices; the K pairs of
// a token are read once into registers and the sum over k runs inside
// the thread, so nothing carries between blocks and no atomics are used
// (a run is deterministic).
//
// Both move bytes and do almost no arithmetic: HBM bytes bound them on
// this card (gather: each output row read once and written once;
// combine: K rows read per token, one written).  Rows move as 16-byte
// vectors, neighbouring lanes on neighbouring chunks, where the row's
// source and destination both start 16-byte aligned; a row whose byte
// length is not a multiple of 16 finishes with element-sized copies of
// its tail, and a row that is not aligned copies element by element.
// Indices are the caller's to keep in range, as for the TPU kernel.

#include <cuda_bf16.h>
#include <cuda_fp16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kGatherThreads = 256;  // 8 warps, one row each at a time
constexpr int kCombineThreads = 128;
constexpr int kMaxK = 16;            // (slot, weight) pairs kept in registers
constexpr long long kMaxBlocks = 132LL * 32;

// -------------------------------------------------------------------------
// gather_rows: E is an unsigned type of the element's size
// -------------------------------------------------------------------------
template <typename E>
__global__ void __launch_bounds__(kGatherThreads)
gather_rows_kernel(const E* __restrict__ x, const int* __restrict__ idx,
                   E* __restrict__ out, long long M, long long D) {
  const int lane = threadIdx.x % 32;
  const long long warps = static_cast<long long>(gridDim.x) *
                          (kGatherThreads / 32);
  const long long row_bytes = D * static_cast<long long>(sizeof(E));
  for (long long i = static_cast<long long>(blockIdx.x) *
                         (kGatherThreads / 32) + threadIdx.x / 32;
       i < M; i += warps) {
    const E* src = x + static_cast<long long>(idx[i]) * D;
    E* dst = out + i * D;
    long long done = 0;  // elements copied as vectors
    if (((reinterpret_cast<uintptr_t>(src) |
          reinterpret_cast<uintptr_t>(dst)) & 15) == 0) {
      const long long n16 = row_bytes / 16;
      const uint4* s4 = reinterpret_cast<const uint4*>(src);
      uint4* d4 = reinterpret_cast<uint4*>(dst);
#pragma unroll 4
      for (long long c = lane; c < n16; c += 32) d4[c] = s4[c];
      done = n16 * 16 / static_cast<long long>(sizeof(E));
    }
    for (long long c = done + lane; c < D; c += 32) dst[c] = src[c];
  }
}

template <typename E>
int launch_gather(const void* x, const int* idx, void* out, long long M,
                  long long D, cudaStream_t st) {
  long long blocks = (M + kGatherThreads / 32 - 1) / (kGatherThreads / 32);
  if (blocks > kMaxBlocks) blocks = kMaxBlocks;
  gather_rows_kernel<E><<<static_cast<unsigned>(blocks), kGatherThreads, 0,
                          st>>>(static_cast<const E*>(x), idx,
                                static_cast<E*>(out), M, D);
  return static_cast<int>(cudaGetLastError());
}

// -------------------------------------------------------------------------
// moe_combine
// -------------------------------------------------------------------------
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

// V elements of T per thread and step: 16 bytes when the rows allow it
// (vector loads and stores), 1 otherwise
template <typename T, int V>
struct Chunk {
  T v[V];
};

template <typename T, int V>
__global__ void __launch_bounds__(kCombineThreads)
moe_combine_kernel(const T* __restrict__ y, const int* __restrict__ slots,
                   const float* __restrict__ w, T* __restrict__ out,
                   long long Tn, int K, long long D) {
  using C = Chunk<T, V>;
  for (long long t = blockIdx.x; t < Tn; t += gridDim.x) {
    // this token's pairs, once; an invalid slot is skipped
    int n = 0;
    long long rows[kMaxK];
    float ws[kMaxK];
    for (int k = 0; k < K; ++k) {
      const int s = slots[t * K + k];
      if (s >= 0) {
        rows[n] = static_cast<long long>(s) * D;
        ws[n] = w[t * K + k];
        ++n;
      }
    }
    T* dst = out + t * D;
    for (long long c = static_cast<long long>(threadIdx.x) * V; c < D;
         c += static_cast<long long>(kCombineThreads) * V) {
      float acc[V];
#pragma unroll
      for (int e = 0; e < V; ++e) acc[e] = 0.f;
      for (int j = 0; j < n; ++j) {
        const C src = *reinterpret_cast<const C*>(y + rows[j] + c);
#pragma unroll
        for (int e = 0; e < V; ++e)
          acc[e] = __fadd_rn(acc[e], __fmul_rn(ws[j], to_f32<T>(src.v[e])));
      }
      C o;
#pragma unroll
      for (int e = 0; e < V; ++e) o.v[e] = from_f32<T>(acc[e]);
      *reinterpret_cast<C*>(dst + c) = o;
    }
  }
}

template <typename T>
int launch_combine(const void* y, const int* slots, const float* w,
                   void* out, long long Tn, int K, long long D,
                   cudaStream_t st) {
  long long blocks = Tn < kMaxBlocks ? Tn : kMaxBlocks;
  const T* yt = static_cast<const T*>(y);
  T* ot = static_cast<T*>(out);
  constexpr int V = 16 / sizeof(T);
  const bool vec = D % V == 0 &&
                   ((reinterpret_cast<uintptr_t>(y) |
                     reinterpret_cast<uintptr_t>(out)) & 15) == 0;
  if (vec)
    moe_combine_kernel<T, V><<<static_cast<unsigned>(blocks),
                               kCombineThreads, 0, st>>>(yt, slots, w, ot,
                                                         Tn, K, D);
  else
    moe_combine_kernel<T, 1><<<static_cast<unsigned>(blocks),
                               kCombineThreads, 0, st>>>(yt, slots, w, ot,
                                                         Tn, K, D);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

extern "C" {

// itemsize: 2, 4 or 8 bytes (any type of that size: the rows are only
// moved).  Returns cudaGetLastError() after the launch
// (cudaErrorInvalidValue for what the kernel does not take).
int moe_gather_rows(const void* x, const int* idx, void* out, int itemsize,
                    long long M, long long D, void* stream) {
  if (M < 0 || D < 0) return static_cast<int>(cudaErrorInvalidValue);
  if (M == 0 || D == 0) return 0;
  const auto st = static_cast<cudaStream_t>(stream);
  switch (itemsize) {
    case 2: return launch_gather<uint16_t>(x, idx, out, M, D, st);
    case 4: return launch_gather<uint32_t>(x, idx, out, M, D, st);
    case 8: return launch_gather<unsigned long long>(x, idx, out, M, D, st);
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
}

// dtype: 0 float32, 1 bfloat16, 2 float16 (y and out); slots int32 and
// weights float32, both (T, K) contiguous, K <= 16.
int moe_combine(const void* y, const int* slots, const float* w, void* out,
                int dtype, long long Tn, int K, long long D, void* stream) {
  if (Tn < 0 || D < 0 || K < 1 || K > kMaxK)
    return static_cast<int>(cudaErrorInvalidValue);
  if (Tn == 0 || D == 0) return 0;
  const auto st = static_cast<cudaStream_t>(stream);
  switch (dtype) {
    case 0: return launch_combine<float>(y, slots, w, out, Tn, K, D, st);
    case 1:
      return launch_combine<__nv_bfloat16>(y, slots, w, out, Tn, K, D, st);
    case 2: return launch_combine<__half>(y, slots, w, out, Tn, K, D, st);
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
}

}  // extern "C"
