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
// in VMEM scratch.  Here a warp owns an output row (gather), and the sum
// over k of a combined element runs inside one thread, so nothing
// carries between blocks and no atomics are used (a run is
// deterministic).
//
// Both move bytes and do almost no arithmetic: HBM bytes bound them on
// this card (gather: each output row read once and written once;
// combine: K rows read per token, one written).  Rows move as 16-byte
// vectors, neighbouring lanes on neighbouring chunks, where the row's
// source and destination both start 16-byte aligned; a row whose byte
// length is not a multiple of 16 finishes with element-sized copies of
// its tail, and a row that is not aligned copies element by element.
// Indices are the caller's to keep in range, as for the TPU kernel.
//
// What held the combine's first kernel (now its simple route) at half
// its bound: a block per token, and in each thread a loop over the
// token's live rows with a trip count known only at run time, so the
// 16-byte load of row j + 1 issued only after the sum of row j had
// waited on row j: one load in flight a thread, and every token began
// with a dependent read of its K (slot, weight) pairs by all 128
// threads.  At deepseek-v2-lite's decode shape (4 tokens, K 6, D 2048)
// that made the call a chain of ~12 DRAM latencies in 4 blocks.  Three
// routes now, picked by the wrapper before the launch
// (kernels/moe_dispatch.py: combine_route):
//
// * the bulk route (16-byte aligned y and out, D * itemsize a 16-byte
//   multiple; at least 264 tokens, a prefill): persistent blocks (2 an
//   SM) walk work items of (token, chunk of the row).  A producer warp
//   reads an item's K pairs once (lane k pair k; the next item's pairs
//   already in flight), puts the live weights in shared memory in k
//   order and issues one cp.async.bulk per live row chunk into the
//   item's stage of a ring (up to 96 KB a block: 4 stages of a token's
//   6 x 4 KB rows at the prefill shape), so a block keeps up to ~96 KB
//   of rows in flight at no cost in registers.  Four consumer warps sum
//   the stage's rows in k order from shared memory and store 16-byte
//   vectors.  Rows are cut into chunks (of at least 256 bytes) until
//   there are at least 2 items an SM.
// * the register route (the same conditions and items; fewer tokens, a
//   decode batch, where a bulk block would hold one item and its ring
//   nothing to overlap): warp 0 reads an item's pairs, then each thread
//   issues the 16-byte loads of all live rows of its columns (unrolled
//   to kMaxK, predicated on the live count) before the first sum, with
//   no mbarrier hand-off.  At the decode shape (4 tokens, K 6, D 2048)
//   the rows are cut into 256-byte chunks, 64 blocks, and the call is
//   one pair-table latency plus one row latency.
// * the simple route (any layout): the first kernel, as above.
//
// All three sum the same products in the same order with the same
// roundings (__fmul_rn, __fadd_rn: no contraction), so they agree bit
// for bit.

#include "hopper.cuh"

namespace {

constexpr int kGatherThreads = 256;  // 8 warps, one row each at a time
constexpr int kCombineThreads = 128;
constexpr int kMaxK = 16;            // (slot, weight) pairs of a token
constexpr long long kMaxBlocks = 132LL * 32;

// the combine's bulk and register routes: work items of (token, chunk of
// its row); a row is cut into chunks where a token's K chunks would not
// fit a stage, or where the tokens are too few to fill the card
constexpr int kStageMax = 32 * 1024;  // bytes of a token's K chunks, at most
constexpr int kMinChunk = 256;        // bytes of a chunk, at least
constexpr int kItemsPerSm = 2;        // cut rows until items >= this x SMs
// the bulk route: a producer warp and kBulkConsumers consumer warps
constexpr int kBulkConsumers = 4;
constexpr int kBulkThreads = 32 * (1 + kBulkConsumers);
constexpr int kBulkMaxStages = 8;
constexpr int kBulkRing = 96 * 1024;  // ring bytes of a block, 2 blocks an SM
constexpr int kBulkBlocksPerSm = 2;
// the register route: persistent blocks of kCombineThreads
constexpr int kRegsBlocksPerSm = 8;

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

// ---------------------------------------------------------------------------
// moe_combine, the bulk and register routes
// ---------------------------------------------------------------------------
// how a call is cut: items of (token, chunk of cw bytes), chunks a row
struct Plan {
  long long items;
  int chunks;
  int cw;
};

Plan plan(long long Tn, int K, long long rb, int sms) {
  const long long cw_max = kStageMax / K / 16 * 16;
  long long chunks = (rb + cw_max - 1) / cw_max;
  while (Tn * chunks < static_cast<long long>(kItemsPerSm) * sms &&
         rb / (2 * chunks) >= kMinChunk)
    chunks *= 2;
  const long long cw = ((rb + chunks - 1) / chunks + 15) / 16 * 16;
  chunks = (rb + cw - 1) / cw;
  return {Tn * chunks, static_cast<int>(chunks), static_cast<int>(cw)};
}

int sm_count(int* sms) {
  int dev = 0;
  cudaError_t e = cudaGetDevice(&dev);
  if (e == cudaSuccess)
    e = cudaDeviceGetAttribute(sms, cudaDevAttrMultiProcessorCount, dev);
  return static_cast<int>(e);
}

// A persistent block walks items blockIdx.x, + gridDim.x, ...  Warp 0,
// the producer, reads an item's K (slot, weight) pairs once (lane k pair
// k, the next item's already in flight), puts the live weights in
// shared memory in k order and, for each live slot, one cp.async.bulk of
// the row's chunk into the item's stage of the ring, all completing on
// the stage's ``full`` mbarrier.  The consumer warps sum the stage's
// rows in k order from shared memory, store 16-byte vectors and arrive
// on its ``empty`` mbarrier.
template <typename T>
__global__ void __launch_bounds__(kBulkThreads)
moe_combine_bulk_kernel(const T* __restrict__ y, const int* __restrict__ slots,
                        const float* __restrict__ w, T* __restrict__ out,
                        int K, long long D, long long items, int chunks,
                        int cw, int stages) {
  constexpr int V = 16 / sizeof(T);
  using C = Chunk<T, V>;
  extern __shared__ __align__(128) unsigned char ring[];
  __shared__ __align__(8) uint64_t full[kBulkMaxStages];
  __shared__ __align__(8) uint64_t empty[kBulkMaxStages];
  __shared__ float ws[kBulkMaxStages][kMaxK];
  __shared__ int live[kBulkMaxStages];
  const long long rb = D * static_cast<long long>(sizeof(T));
  const int sb = K * cw;  // bytes of a stage
  const int warp = threadIdx.x / 32;
  const int lane = threadIdx.x % 32;
  // the producer's lane k holds pair k of an item's token
  auto pair = [&](long long it, int& sl, float& wt) {
    if (it < items && lane < K) {
      const long long p = it / chunks * K + lane;
      sl = slots[p];
      wt = w[p];
    } else {
      sl = -1;
    }
  };
  int slot = -1;
  float wk = 0.f;
  if (warp == 0) pair(blockIdx.x, slot, wk);  // in flight over the set-up
  if (threadIdx.x == 0) {
    for (int s = 0; s < stages; ++s) {
      mbar_init(smem_addr(&full[s]), 1);
      mbar_init(smem_addr(&empty[s]), kBulkConsumers);
    }
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();

  if (warp == 0) {
    int next_slot = -1;
    float next_w = 0.f;
    int i = 0;
    for (long long it = blockIdx.x; it < items; it += gridDim.x, ++i) {
      pair(it + gridDim.x, next_slot, next_w);
      const int s = i % stages;
      const long long c0 = it % chunks * cw;
      const uint32_t bytes = static_cast<uint32_t>(
          rb - c0 < cw ? rb - c0 : static_cast<long long>(cw));
      const unsigned m = __ballot_sync(0xffffffffu, slot >= 0);
      const int rank = __popc(m & ((1u << lane) - 1u));
      const uint32_t bar = smem_addr(&full[s]);
      mbar_wait(smem_addr(&empty[s]), ((i / stages) & 1) ^ 1);
      if (slot >= 0) ws[s][rank] = wk;
      if (lane == 0) live[s] = __popc(m);
      __syncwarp();
      if (lane == 0) mbar_expect_tx(bar, __popc(m) * bytes);
      __syncwarp();
      if (slot >= 0)
        bulk_load(smem_addr(ring) + s * sb + rank * cw,
                  reinterpret_cast<const unsigned char*>(y) + slot * rb + c0,
                  bytes, bar);
      slot = next_slot;
      wk = next_w;
    }
  } else {
    const int ct = threadIdx.x - 32;
    int i = 0;
    for (long long it = blockIdx.x; it < items; it += gridDim.x, ++i) {
      const int s = i % stages;
      const long long t = it / chunks;
      const long long c0 = (it - t * chunks) * cw;
      const int nv = static_cast<int>(
          (rb - c0 < cw ? rb - c0 : static_cast<long long>(cw)) / 16);
      mbar_wait(smem_addr(&full[s]), (i / stages) & 1);
      const int n = live[s];
      const unsigned char* rows = ring + s * sb;
      T* dst = out + t * D + c0 / static_cast<long long>(sizeof(T));
      for (int v = ct; v < nv; v += 32 * kBulkConsumers) {
        float acc[V];
#pragma unroll
        for (int e = 0; e < V; ++e) acc[e] = 0.f;
        for (int j = 0; j < n; ++j) {
          const C src = *reinterpret_cast<const C*>(rows + j * cw + v * 16);
          const float wj = ws[s][j];
#pragma unroll
          for (int e = 0; e < V; ++e)
            acc[e] = __fadd_rn(acc[e], __fmul_rn(wj, to_f32<T>(src.v[e])));
        }
        C o;
#pragma unroll
        for (int e = 0; e < V; ++e) o.v[e] = from_f32<T>(acc[e]);
        *reinterpret_cast<C*>(dst + v * V) = o;
      }
      __syncwarp();  // the warp has read stage s
      if (lane == 0) mbar_arrive(smem_addr(&empty[s]));
    }
  }
}

// The same items, read with plain loads: warp 0 puts an item's live
// (row offset, weight) pairs in shared memory, then each thread issues
// the loads of all its live rows (unrolled to kMaxK, predicated on the
// live count) before the first sum, so K loads of a thread are in flight
// at once.
template <typename T>
__global__ void __launch_bounds__(kCombineThreads)
moe_combine_regs_kernel(const T* __restrict__ y, const int* __restrict__ slots,
                        const float* __restrict__ w, T* __restrict__ out,
                        int K, long long D, long long items, int chunks,
                        int cw) {
  constexpr int V = 16 / sizeof(T);
  using C = Chunk<T, V>;
  __shared__ long long rows[kMaxK];  // byte offsets into y
  __shared__ float ws[kMaxK];
  __shared__ int live;
  const long long rb = D * static_cast<long long>(sizeof(T));
  const unsigned char* yb = reinterpret_cast<const unsigned char*>(y);
  for (long long it = blockIdx.x; it < items; it += gridDim.x) {
    const long long t = it / chunks;
    const long long c0 = (it - t * chunks) * cw;
    if (threadIdx.x < 32) {
      const int lane = threadIdx.x;
      int slot = -1;
      float wk = 0.f;
      if (lane < K) {  // both loads in flight at once
        slot = slots[t * K + lane];
        wk = w[t * K + lane];
      }
      const unsigned m = __ballot_sync(0xffffffffu, slot >= 0);
      const int rank = __popc(m & ((1u << lane) - 1u));
      if (slot >= 0) {
        rows[rank] = slot * rb + c0;
        ws[rank] = wk;
      }
      if (lane == 0) live = __popc(m);
    }
    __syncthreads();
    const int n = live;
    const int nv = static_cast<int>(
        (rb - c0 < cw ? rb - c0 : static_cast<long long>(cw)) / 16);
    T* dst = out + t * D + c0 / static_cast<long long>(sizeof(T));
    for (int v = threadIdx.x; v < nv; v += kCombineThreads) {
      C src[kMaxK];
#pragma unroll
      for (int j = 0; j < kMaxK; ++j)
        if (j < n) src[j] = *reinterpret_cast<const C*>(yb + rows[j] + v * 16);
      float acc[V];
#pragma unroll
      for (int e = 0; e < V; ++e) acc[e] = 0.f;
#pragma unroll
      for (int j = 0; j < kMaxK; ++j)
        if (j < n) {
          const float wj = ws[j];
#pragma unroll
          for (int e = 0; e < V; ++e)
            acc[e] = __fadd_rn(acc[e], __fmul_rn(wj, to_f32<T>(src[j].v[e])));
        }
      C o;
#pragma unroll
      for (int e = 0; e < V; ++e) o.v[e] = from_f32<T>(acc[e]);
      *reinterpret_cast<C*>(dst + v * V) = o;
    }
    __syncthreads();  // before warp 0 rewrites the pairs
  }
}

template <typename T>
bool chunked_ok(const void* y, const void* out, long long D) {
  return ((reinterpret_cast<uintptr_t>(y) |
           reinterpret_cast<uintptr_t>(out)) & 15) == 0 &&
         D * static_cast<long long>(sizeof(T)) % 16 == 0;
}

template <typename T>
int launch_chunked(int route, const void* y, const int* slots,
                   const float* w, void* out, long long Tn, int K,
                   long long D, cudaStream_t st) {
  if (!chunked_ok<T>(y, out, D))
    return static_cast<int>(cudaErrorInvalidValue);
  int sms = 0;
  int rc = sm_count(&sms);
  if (rc != 0) return rc;
  const long long rb = D * static_cast<long long>(sizeof(T));
  const Plan pl = plan(Tn, K, rb, sms);
  const T* yt = static_cast<const T*>(y);
  T* ot = static_cast<T*>(out);
  if (route == 1) {
    const long long cap = static_cast<long long>(kBulkBlocksPerSm) * sms;
    const long long grid = pl.items < cap ? pl.items : cap;
    const long long per_block = (pl.items + grid - 1) / grid;
    long long stages = kBulkRing / (static_cast<long long>(K) * pl.cw);
    if (stages > kBulkMaxStages) stages = kBulkMaxStages;
    if (stages > per_block) stages = per_block;
    const int smem = static_cast<int>(stages) * K * pl.cw;
    const cudaError_t e = cudaFuncSetAttribute(
        moe_combine_bulk_kernel<T>,
        cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
    if (e != cudaSuccess) return static_cast<int>(e);
    moe_combine_bulk_kernel<T><<<static_cast<unsigned>(grid), kBulkThreads,
                                 smem, st>>>(yt, slots, w, ot, K, D,
                                             pl.items, pl.chunks, pl.cw,
                                             static_cast<int>(stages));
  } else {
    const long long cap = static_cast<long long>(kRegsBlocksPerSm) * sms;
    const long long grid = pl.items < cap ? pl.items : cap;
    moe_combine_regs_kernel<T><<<static_cast<unsigned>(grid),
                                 kCombineThreads, 0, st>>>(
        yt, slots, w, ot, K, D, pl.items, pl.chunks, pl.cw);
  }
  return static_cast<int>(cudaGetLastError());
}

template <typename T>
int dispatch_combine(int route, const void* y, const int* slots,
                     const float* w, void* out, long long Tn, int K,
                     long long D, cudaStream_t st) {
  return route == 0
             ? launch_combine<T>(y, slots, w, out, Tn, K, D, st)
             : launch_chunked<T>(route, y, slots, w, out, Tn, K, D, st);
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
// weights float32, both (T, K) contiguous, K <= 16.  route: 0 the simple
// route, 1 the bulk route, 2 the register route (1 and 2 need 16-byte
// aligned y and out and D * itemsize a multiple of 16).
int moe_combine(const void* y, const int* slots, const float* w, void* out,
                int dtype, long long Tn, int K, long long D, int route,
                void* stream) {
  if (Tn < 0 || D < 0 || K < 1 || K > kMaxK || route < 0 || route > 2)
    return static_cast<int>(cudaErrorInvalidValue);
  if (Tn == 0 || D == 0) return 0;
  const auto st = static_cast<cudaStream_t>(stream);
  switch (dtype) {
    case 0:
      return dispatch_combine<float>(route, y, slots, w, out, Tn, K, D, st);
    case 1:
      return dispatch_combine<__nv_bfloat16>(route, y, slots, w, out, Tn, K,
                                             D, st);
    case 2:
      return dispatch_combine<__half>(route, y, slots, w, out, Tn, K, D, st);
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
}

}  // extern "C"
