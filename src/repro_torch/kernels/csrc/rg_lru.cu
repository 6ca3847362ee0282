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
// whole sequence with h in a register, and bounds checks replace the
// padding.  The chains are independent, so nothing crosses threads.
//
// Bound on an H100 SXM: the bytes, x and a read once and h_seq written
// once (12 B per element in f32), at 3.35 TB/s.  At RecurrentGemma-2B's
// prefill shape (4, 4096, 2560) that is 503 MB, ~0.15 ms.  But the scan
// has only B * D = 10 240 independent chains there, ~2.4 warps per SM,
// so a chain's own latency is what bounds it: each step waits on the
// step before, and sqrtf (correctly rounded) branches to its slow path
// for special inputs, so the compiler cannot overlap one step's input
// term with the next.  With one warp per scheduler nothing hides that:
// the simple route takes ~0.25 ms here on an H100 (chip_smoke.py phase
// 7), ~60 ns a step.  Two routes, picked by the wrapper before the
// launch (kernels/rg_lru.py: rg_lru_route):
//
// * the TMA route (16-byte aligned x and a, D * itemsize a 16-byte
//   multiple): a block owns 32 channels of one batch row.  Thread 0
//   keeps a ring of kTmaStages stages of (32 channels x 32 steps) tiles
//   of x and a in flight through a 3-D tensor map over (D, S, B), 8 KB a
//   stage in f32 (up to ~32 KB of loads in flight a block, ~10 MB over
//   the 320 blocks of the prefill shape, at no cost in registers); a
//   ragged S or D reads zeros past the edge and the scan stops at S.
//   Four prep warps compute the input terms sqrt(clip(1 - a^2)) * x of a
//   landed tile, eight independent ones a thread, into shared memory;
//   the chain warp (a lane a channel) then runs only h = fma(a, h, term)
//   from shared memory, and stores h straight from its register: the 32
//   lanes of a step write 32 neighbouring channels, one coalesced
//   128-byte (f32) or 64-byte store.  The sequence is not cut into
//   chunks that carry a prefix: that would change the rounding.
// * the simple route (any layout): one thread a channel keeps the loads
//   of the next kU steps in flight in a second register buffer while it
//   runs the current kU steps, input terms included.

// Rounding, the same on both routes (so they agree bit for bit: each
// operation is rounded on its own, wherever it runs): a_t^2 and the input
// term sqrt(...) * x_t are rounded as the plain version rounds them
// (__fmul_rn: no contraction); the update a_t * h + b_t is one fused
// multiply-add, where the plain version rounds the product first.  The
// two differ by at most half an ulp of a_t * h per step.

#include "hopper.cuh"

namespace {

// the simple route
constexpr int kThreads = 64;
constexpr int kU = 16;  // steps per register buffer

// the TMA route
constexpr int kTmaCh = 32;      // channels of a block: a chain lane each
constexpr int kTmaSteps = 32;   // steps of a tile
constexpr int kTmaStages = 6;   // ring depth
constexpr int kTmaPrep = 4;     // warps that compute the tiles' input terms
constexpr int kTmaThreads = 32 * (1 + kTmaPrep);
constexpr int kTile = kTmaSteps * kTmaCh;  // elements of a tile
constexpr int kPrepElems = kTile / (32 * kTmaPrep);  // of a prep thread
static_assert(kTile % (32 * kTmaPrep) == 0, "prep threads split a tile");

// the input term sqrt(clip(1 - a^2, 0, 1)) * x, which does not depend on h
__device__ __forceinline__ float gain(float a, float x) {
  const float s = sqrtf(fminf(fmaxf(1.0f - __fmul_rn(a, a), 0.0f), 1.0f));
  return __fmul_rn(s, x);
}

__device__ __forceinline__ float step(float h, float a, float x) {
  return fmaf(a, h, gain(a, x));
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
      xn[u] = to_f32(x[base + u * D]);
      an[u] = to_f32(a[base + u * D]);
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
        xn[u] = to_f32(x[o + u * D]);
        an[u] = to_f32(a[o + u * D]);
      }
    }
    const long long o = base + t * D;
#pragma unroll
    for (int u = 0; u < kU; ++u) {
      h = step(h, ac[u], xc[u]);
      out[o + u * D] = from_f32<T>(h);
    }
  }
  for (long long t = full; t < S; ++t) {
    const long long o = base + t * D;
    h = step(h, to_f32(a[o]), to_f32(x[o]));
    out[o] = from_f32<T>(h);
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

// ---------------------------------------------------------------------------
// the TMA route
// ---------------------------------------------------------------------------
// stage s of the ring: the x and a tiles (T) as the tensor maps deliver
// them, (step, channel) in row-major order, then the f32 input terms
template <typename T>
constexpr int tma_smem() {
  return kTmaStages * kTile * (2 * static_cast<int>(sizeof(T)) + 4);
}

template <typename T>
__global__ void __launch_bounds__(kTmaThreads)
rg_lru_tma_kernel(const __grid_constant__ CUtensorMap xmap,
                  const __grid_constant__ CUtensorMap amap,
                  const float* __restrict__ h0, T* __restrict__ out,
                  float* __restrict__ h_last, int S, int D) {
  extern __shared__ __align__(128) unsigned char smem[];
  T* xs = reinterpret_cast<T*>(smem);
  T* as = xs + kTmaStages * kTile;
  float* gs = reinterpret_cast<float*>(as + kTmaStages * kTile);
  __shared__ __align__(8) uint64_t full[kTmaStages];   // the tiles landed
  __shared__ __align__(8) uint64_t ready[kTmaStages];  // the terms computed
  const int warp = threadIdx.x / 32;
  const int lane = threadIdx.x % 32;
  const int d0 = blockIdx.x * kTmaCh;
  const int b = blockIdx.y;
  const int n = (S + kTmaSteps - 1) / kTmaSteps;  // tiles of steps

  // tile i into stage i % kTmaStages (thread 0 only)
  auto issue = [&](int i) {
    const int s = i % kTmaStages;
    const uint32_t bar = smem_addr(&full[s]);
    mbar_expect_tx(bar, 2 * kTile * sizeof(T));
    tma_load_3d(smem_addr(xs + s * kTile), &xmap, bar, d0, i * kTmaSteps, b);
    tma_load_3d(smem_addr(as + s * kTile), &amap, bar, d0, i * kTmaSteps, b);
  };
  if (threadIdx.x == 0) {
#pragma unroll
    for (int s = 0; s < kTmaStages; ++s) {
      mbar_init(smem_addr(&full[s]), 1);
      mbar_init(smem_addr(&ready[s]), kTmaPrep);
    }
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
    for (int i = 0; i < kTmaStages && i < n; ++i) issue(i);
  }
  __syncthreads();

  if (warp > 0) {
    // ---- prep warps: the input term of every element of a tile, many
    //      independent ones a thread, so their latency overlaps ----
    const int pt = threadIdx.x - 32;
    for (int i = 0; i < n; ++i) {
      const int s = i % kTmaStages;
      mbar_wait(smem_addr(&full[s]), (i / kTmaStages) & 1);
      const T* xt = xs + s * kTile + pt;
      const T* at = as + s * kTile + pt;
      float* gt = gs + s * kTile + pt;
      float xv[kPrepElems], av[kPrepElems];
#pragma unroll
      for (int k = 0; k < kPrepElems; ++k) {
        xv[k] = to_f32(xt[k * 32 * kTmaPrep]);
        av[k] = to_f32(at[k * 32 * kTmaPrep]);
      }
#pragma unroll
      for (int k = 0; k < kPrepElems; ++k)
        gt[k * 32 * kTmaPrep] = gain(av[k], xv[k]);
      __syncwarp();
      if (lane == 0) mbar_arrive(smem_addr(&ready[s]));
    }
    return;
  }

  // ---- the chain warp: lane l runs channel d0 + l, one FMA a step ----
  const int d = d0 + lane;
  const bool live = d < D;
  float h = h0 != nullptr && live ? h0[static_cast<long long>(b) * D + d]
                                  : 0.0f;
  T* o = out + static_cast<long long>(b) * S * D + d;
  for (int i = 0; i < n; ++i) {
    const int s = i % kTmaStages;
    mbar_wait(smem_addr(&ready[s]), (i / kTmaStages) & 1);
    const T* at = as + s * kTile + lane;
    const float* gt = gs + s * kTile + lane;
    T* ot = o + static_cast<long long>(i) * kTmaSteps * D;
    const int steps = S - i * kTmaSteps;
    if (steps >= kTmaSteps) {
#pragma unroll 8
      for (int u = 0; u < kTmaSteps; ++u) {
        h = fmaf(to_f32(at[u * kTmaCh]), h, gt[u * kTmaCh]);
        if (live) ot[static_cast<long long>(u) * D] = from_f32<T>(h);
      }
    } else {  // the last, ragged tile
      for (int u = 0; u < steps; ++u) {
        h = fmaf(to_f32(at[u * kTmaCh]), h, gt[u * kTmaCh]);
        if (live) ot[static_cast<long long>(u) * D] = from_f32<T>(h);
      }
    }
    // the prep warps are done with stage s (they arrived on ready[s]) and
    // so is this warp: refill it
    __syncwarp();
    if (lane == 0 && i + kTmaStages < n) issue(i + kTmaStages);
  }
  if (live) h_last[static_cast<long long>(b) * D + d] = h;
}

// the TMA route's conditions (the wrapper's rg_lru_route checks the same)
template <typename T>
bool tma_ok(const void* x, const void* a, long long S, long long D) {
  return ((reinterpret_cast<uintptr_t>(x) |
           reinterpret_cast<uintptr_t>(a)) & 15) == 0 &&
         D * static_cast<long long>(sizeof(T)) % 16 == 0 &&
         S < (1LL << 30) && D < (1LL << 31) &&
         S * D * static_cast<long long>(sizeof(T)) < (1LL << 40);
}

template <typename T>
int launch_tma(const void* x, const void* a, const float* h0, void* out,
               float* h_last, long long B, long long S, long long D,
               cudaStream_t st) {
  if (!tma_ok<T>(x, a, S, D)) return static_cast<int>(cudaErrorInvalidValue);
  CUtensorMap xm, am;
  int rc = encode_map_3d<T>(&xm, x, D, S, B, kTmaCh, kTmaSteps);
  if (rc == 0) rc = encode_map_3d<T>(&am, a, D, S, B, kTmaCh, kTmaSteps);
  if (rc != 0) return rc;
  constexpr int smem = tma_smem<T>();
  const cudaError_t e = cudaFuncSetAttribute(
      rg_lru_tma_kernel<T>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      smem);
  if (e != cudaSuccess) return static_cast<int>(e);
  const dim3 grid(static_cast<unsigned>((D + kTmaCh - 1) / kTmaCh),
                  static_cast<unsigned>(B));
  rg_lru_tma_kernel<T><<<grid, kTmaThreads, smem, st>>>(
      xm, am, h0, static_cast<T*>(out), h_last, static_cast<int>(S),
      static_cast<int>(D));
  return static_cast<int>(cudaGetLastError());
}

template <typename T>
int dispatch(int route, const void* x, const void* a, const float* h0,
             void* out, float* h_last, long long B, long long S, long long D,
             cudaStream_t st) {
  return route == 1 ? launch_tma<T>(x, a, h0, out, h_last, B, S, D, st)
                    : launch<T>(x, a, h0, out, h_last, B, S, D, st);
}

}  // namespace

extern "C" {

// dtype (of x, a and out): 0 float32, 1 bfloat16, 2 float16.  h0 may be
// null.  route: 0 the simple route, 1 the TMA route.  Returns
// cudaGetLastError() after the launch (cudaErrorInvalidValue for a shape,
// dtype or route the kernels do not take; -CUresult if a tensor map is
// refused).
int rg_lru_fwd(const void* x, const void* a, const void* h0, void* out,
               void* h_last, int dtype, long long B, long long S,
               long long D, int route, void* stream) {
  if (B <= 0 || S <= 0 || D <= 0 || B > 65535 ||
      (D + kThreads - 1) / kThreads > 2147483647LL || route < 0 ||
      route > 1)
    return static_cast<int>(cudaErrorInvalidValue);
  const auto st = static_cast<cudaStream_t>(stream);
  const auto* h0f = static_cast<const float*>(h0);
  auto* hl = static_cast<float*>(h_last);
  switch (dtype) {
    case 0:
      return dispatch<float>(route, x, a, h0f, out, hl, B, S, D, st);
    case 1:
      return dispatch<__nv_bfloat16>(route, x, a, h0f, out, hl, B, S, D,
                                     st);
    case 2:
      return dispatch<__half>(route, x, a, h0f, out, hl, B, S, D, st);
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
}

}  // extern "C"
