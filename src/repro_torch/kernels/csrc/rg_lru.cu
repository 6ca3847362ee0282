// RG-LRU scan for Hopper (sm_90a): the Griffin / RecurrentGemma linear
// recurrence over a whole sequence.
//
// Replaces repro/kernels/rg_lru.py:rg_lru (the Pallas _rg_lru_kernel).
// It computes what that kernel computes, for every batch row b and
// channel d:
//
//   h_t = a_t * h_{t-1} + sqrt(clip(1 - a_t^2, 0, 1)) * x_t,  h_{-1} = h0
//
// over x, a of shape (B, S, D) (float32, bfloat16 or float16, both the
// same type); it writes h_seq (B, S, D) in x's type and h_last (B, D) in
// float32.  h0 is optional (zeros when null).
//
// The TPU kernel walked a (batch, d-block, s-block) grid with the
// sequence axis sequential and h carried in VMEM scratch, padding S and D
// with decay 1.  Here one thread owns one (b, d) channel and runs the
// whole sequence with h in a register: the loads of a warp are 32
// neighbouring channels of one step (128 contiguous bytes in f32), and
// bounds checks replace the padding.
//
// Bound on an H100 SXM: the bytes, x and a read once and h_seq written
// once (12 B per element in f32), at 3.35 TB/s.  At RecurrentGemma-2B's
// prefill shape (4, 4096, 2560) that is 503 MB, ~0.15 ms.  But the scan
// has only B * D = 10 240 independent chains there, ~2.4 warps per SM,
// so it is bound by the latency of its loads, not by the HBM rate: each
// thread keeps the loads of the next kU steps in flight (a second
// register buffer) while it runs the current kU steps.  A chunked scan
// across S (more chains in flight) is later work.
//
// Rounding: a_t^2 and the input term sqrt(...) * x_t are rounded as the
// plain version rounds them (__fmul_rn: no contraction); the update
// a_t * h + b_t is one fused multiply-add, where the plain version rounds
// the product first.  The two differ by at most half an ulp of a_t * h
// per step.

#include <cuda_bf16.h>
#include <cuda_fp16.h>
#include <cuda_runtime.h>

namespace {

constexpr int kThreads = 64;
constexpr int kU = 16;  // steps per register buffer

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

__device__ __forceinline__ float step(float h, float a, float x) {
  const float s = sqrtf(fminf(fmaxf(1.0f - __fmul_rn(a, a), 0.0f), 1.0f));
  return fmaf(a, h, __fmul_rn(s, x));
}

template <typename T>
__global__ void __launch_bounds__(kThreads)
rg_lru_kernel(const T* __restrict__ x, const T* __restrict__ a,
              const float* __restrict__ h0, T* __restrict__ out,
              float* __restrict__ h_last, long long S, long long D) {
  const long long d = static_cast<long long>(blockIdx.x) * kThreads +
                      threadIdx.x;
  const long long b = blockIdx.y;
  if (d >= D) return;
  const long long base = b * S * D + d;
  float h = h0 ? h0[b * D + d] : 0.0f;

  const long long full = S / kU * kU;
  float xn[kU], an[kU];
  if (full) {
#pragma unroll
    for (int u = 0; u < kU; ++u) {
      xn[u] = to_f(x[base + u * D]);
      an[u] = to_f(a[base + u * D]);
    }
  }
  for (long long t = 0; t < full; t += kU) {
    float xc[kU], ac[kU];
#pragma unroll
    for (int u = 0; u < kU; ++u) {
      xc[u] = xn[u];
      ac[u] = an[u];
    }
    if (t + kU < full) {  // issue the next buffer's loads first
      const long long o = base + (t + kU) * D;
#pragma unroll
      for (int u = 0; u < kU; ++u) {
        xn[u] = to_f(x[o + u * D]);
        an[u] = to_f(a[o + u * D]);
      }
    }
    const long long o = base + t * D;
#pragma unroll
    for (int u = 0; u < kU; ++u) {
      h = step(h, ac[u], xc[u]);
      out[o + u * D] = from_f<T>(h);
    }
  }
  for (long long t = full; t < S; ++t) {
    const long long o = base + t * D;
    h = step(h, to_f(a[o]), to_f(x[o]));
    out[o] = from_f<T>(h);
  }
  h_last[b * D + d] = h;
}

template <typename T>
int launch(const void* x, const void* a, const float* h0, void* out,
           float* h_last, long long B, long long S, long long D,
           cudaStream_t st) {
  const dim3 grid(static_cast<unsigned>((D + kThreads - 1) / kThreads),
                  static_cast<unsigned>(B));
  rg_lru_kernel<T><<<grid, kThreads, 0, st>>>(
      static_cast<const T*>(x), static_cast<const T*>(a), h0,
      static_cast<T*>(out), h_last, S, D);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

extern "C" {

// dtype (of x, a and out): 0 float32, 1 bfloat16, 2 float16.  h0 may be
// null.  Returns cudaGetLastError() after the launch
// (cudaErrorInvalidValue for a shape or dtype the kernel does not take).
int rg_lru_fwd(const void* x, const void* a, const void* h0, void* out,
               void* h_last, int dtype, long long B, long long S,
               long long D, void* stream) {
  if (B <= 0 || S <= 0 || D <= 0 || B > 65535 ||
      (D + kThreads - 1) / kThreads > 2147483647LL)
    return static_cast<int>(cudaErrorInvalidValue);
  const auto st = static_cast<cudaStream_t>(stream);
  const auto* h0f = static_cast<const float*>(h0);
  auto* hl = static_cast<float*>(h_last);
  switch (dtype) {
    case 0: return launch<float>(x, a, h0f, out, hl, B, S, D, st);
    case 1: return launch<__nv_bfloat16>(x, a, h0f, out, hl, B, S, D, st);
    case 2: return launch<__half>(x, a, h0f, out, hl, B, S, D, st);
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
}

}  // extern "C"
