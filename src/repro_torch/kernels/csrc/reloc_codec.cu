// Relocation-codec kernels for Hopper (sm_90a): chunks -> send buffer -> chunks.
//
// Three byte-movement kernels behind a plain C interface (loaded with
// ctypes by repro_torch/kernels/reloc_codec.py).  Each launches on the
// caller's stream, allocates nothing, and returns cudaGetLastError().
//
// * reloc_encode_pack replaces repro/kernels/reloc_codec.py:encode_pack
//   (_encode_pack_kernel): slot s of the (pairs*slots, width) send buffer
//   <- row clamp(idx[s], 0, m-1) of the typed chunk matrix, as bytes;
//   bytes j >= min(widths[s], nb) are zero.
// * reloc_pack_rows replaces repro/kernels/reloc_codec.py:pack_rows
//   (_pack_rows_kernel): slot s <- arena[clamp(off[s] + j, 0, A-1)] for
//   j < widths[s], zero past it.  Offsets are int64: an arena of a few
//   GiB passes 2^31.
// * reloc_decode_rows replaces repro/kernels/reloc_codec.py:decode_rows
//   (_decode_kernel): the first nbytes of each received row, read with a
//   row stride (the receiver block is a slice of the transposed send
//   buffer), into a contiguous (m, nbytes) output whose typed view is the
//   bitcast.
//
// Bound on an H100 SXM (3.35 TB/s): all three only move bytes, so the
// least time is (bytes read + bytes written) / 3.35e12; there is no
// arithmetic to speak of.  The TPU kernels walked one (src, dest) pair
// per grid step with a sequential row loop; here every thread owns one
// 16-byte chunk of the output, so neighbouring threads write
// neighbouring 16-byte words (fully coalesced stores) and the slot
// tables are read once per chunk from L1/L2.  The 16-byte path is taken
// when the output width (and, for the aligned-read variant, the source
// row pitch and base) are multiples of 16; ragged tails and unaligned
// sources fall back to byte loads inside the same chunk, and widths
// below 16 use a byte-per-thread kernel.  Indices are 64-bit: the main
// path's send buffer holds ~67 M slots.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;

inline int grid_for(long long work) {
  long long blocks = (work + kThreads - 1) / kThreads;
  // grid-stride loops: cap at 16 resident blocks on each of 132 SMs
  const long long cap = 132LL * 16;
  if (blocks > cap) blocks = cap;
  if (blocks < 1) blocks = 1;
  return static_cast<int>(blocks);
}

template <int B> struct Word;
template <> struct Word<16> { using T = uint4; };
template <> struct Word<1> { using T = uint8_t; };

template <int B>
union Chunk {
  typename Word<B>::T v;
  uint8_t b[B];
};

__device__ __forceinline__ long long clampll(long long x, long long lo,
                                             long long hi) {
  return x < lo ? lo : (x > hi ? hi : x);
}

// ---------------------------------------------------------------------------
// encode_pack
// ---------------------------------------------------------------------------
template <int B, bool ALIGNED_READ>
__global__ void encode_pack_kernel(const uint8_t* __restrict__ src,
                                   const int32_t* __restrict__ idx,
                                   const int32_t* __restrict__ wid,
                                   uint8_t* __restrict__ out,
                                   long long n_slots, long long m,
                                   long long nb, long long width) {
  using T = typename Word<B>::T;
  const long long cpr = width / B;  // chunks per slot
  const long long total = n_slots * cpr;
  const long long stride = static_cast<long long>(gridDim.x) * blockDim.x;
  for (long long t = static_cast<long long>(blockIdx.x) * blockDim.x +
                     threadIdx.x;
       t < total; t += stride) {
    const long long s = t / cpr;
    const long long j0 = (t - s * cpr) * B;
    long long w = wid[s];
    if (w > nb) w = nb;
    Chunk<B> c;
    if (j0 >= w) {
      c.v = T{};
    } else {
      const uint8_t* row = src + clampll(idx[s], 0, m - 1) * nb;
      if (ALIGNED_READ && j0 + B <= w) {
        c.v = *reinterpret_cast<const T*>(row + j0);
      } else {
#pragma unroll
        for (int k = 0; k < B; ++k) c.b[k] = (j0 + k < w) ? row[j0 + k] : 0;
      }
    }
    *reinterpret_cast<T*>(out + s * width + j0) = c.v;
  }
}

// ---------------------------------------------------------------------------
// pack_rows
// ---------------------------------------------------------------------------
template <int B>
__global__ void pack_rows_kernel(const uint8_t* __restrict__ arena,
                                 const int64_t* __restrict__ off,
                                 const int32_t* __restrict__ wid,
                                 uint8_t* __restrict__ out,
                                 long long n_slots, long long arena_bytes,
                                 long long width) {
  using T = typename Word<B>::T;
  const long long cpr = width / B;
  const long long total = n_slots * cpr;
  const long long stride = static_cast<long long>(gridDim.x) * blockDim.x;
  const long long last = arena_bytes - 1;
  for (long long t = static_cast<long long>(blockIdx.x) * blockDim.x +
                     threadIdx.x;
       t < total; t += stride) {
    const long long s = t / cpr;
    const long long j0 = (t - s * cpr) * B;
    const long long w = wid[s];
    Chunk<B> c;
    if (j0 >= w) {
      c.v = T{};
    } else {
      const long long p = off[s] + j0;
      if (B > 1 && j0 + B <= w && p >= 0 && p + B <= arena_bytes &&
          (reinterpret_cast<uintptr_t>(arena + p) % B) == 0) {
        c.v = *reinterpret_cast<const T*>(arena + p);
      } else {
#pragma unroll
        for (int k = 0; k < B; ++k)
          c.b[k] = (j0 + k < w) ? arena[clampll(p + k, 0, last)] : 0;
      }
    }
    *reinterpret_cast<T*>(out + s * width + j0) = c.v;
  }
}

// ---------------------------------------------------------------------------
// decode_rows
// ---------------------------------------------------------------------------
template <int B>
__global__ void decode_rows_kernel(const uint8_t* __restrict__ rows,
                                   uint8_t* __restrict__ out, long long m,
                                   long long row_stride, long long nbytes) {
  using T = typename Word<B>::T;
  const long long cpr = nbytes / B;
  const long long total = m * cpr;
  const long long stride = static_cast<long long>(gridDim.x) * blockDim.x;
  for (long long t = static_cast<long long>(blockIdx.x) * blockDim.x +
                     threadIdx.x;
       t < total; t += stride) {
    const long long i = t / cpr;
    const long long j0 = (t - i * cpr) * B;
    *reinterpret_cast<T*>(out + i * nbytes + j0) =
        *reinterpret_cast<const T*>(rows + i * row_stride + j0);
  }
}

inline bool aligned16(const void* p) {
  return (reinterpret_cast<uintptr_t>(p) % 16) == 0;
}

}  // namespace

extern "C" {

int reloc_encode_pack(const void* src, const void* idx, const void* wid,
                      void* out, long long n_slots, long long m,
                      long long nb, long long width, void* stream) {
  const auto st = static_cast<cudaStream_t>(stream);
  const auto* s8 = static_cast<const uint8_t*>(src);
  const auto* ix = static_cast<const int32_t*>(idx);
  const auto* wd = static_cast<const int32_t*>(wid);
  auto* o8 = static_cast<uint8_t*>(out);
  if (width % 16 == 0 && aligned16(out)) {
    const int grid = grid_for(n_slots * (width / 16));
    if (nb % 16 == 0 && aligned16(src))
      encode_pack_kernel<16, true><<<grid, kThreads, 0, st>>>(
          s8, ix, wd, o8, n_slots, m, nb, width);
    else
      encode_pack_kernel<16, false><<<grid, kThreads, 0, st>>>(
          s8, ix, wd, o8, n_slots, m, nb, width);
  } else {
    encode_pack_kernel<1, false><<<grid_for(n_slots * width), kThreads, 0,
                                   st>>>(s8, ix, wd, o8, n_slots, m, nb,
                                         width);
  }
  return static_cast<int>(cudaGetLastError());
}

int reloc_pack_rows(const void* arena, const void* off, const void* wid,
                    void* out, long long n_slots, long long arena_bytes,
                    long long width, void* stream) {
  const auto st = static_cast<cudaStream_t>(stream);
  const auto* a8 = static_cast<const uint8_t*>(arena);
  const auto* of = static_cast<const int64_t*>(off);
  const auto* wd = static_cast<const int32_t*>(wid);
  auto* o8 = static_cast<uint8_t*>(out);
  if (width % 16 == 0 && aligned16(out))
    pack_rows_kernel<16><<<grid_for(n_slots * (width / 16)), kThreads, 0,
                           st>>>(a8, of, wd, o8, n_slots, arena_bytes,
                                 width);
  else
    pack_rows_kernel<1><<<grid_for(n_slots * width), kThreads, 0, st>>>(
        a8, of, wd, o8, n_slots, arena_bytes, width);
  return static_cast<int>(cudaGetLastError());
}

int reloc_decode_rows(const void* rows, void* out, long long m,
                      long long row_stride, long long nbytes, void* stream) {
  const auto st = static_cast<cudaStream_t>(stream);
  const auto* r8 = static_cast<const uint8_t*>(rows);
  auto* o8 = static_cast<uint8_t*>(out);
  if (nbytes % 16 == 0 && row_stride % 16 == 0 && aligned16(rows) &&
      aligned16(out))
    decode_rows_kernel<16><<<grid_for(m * (nbytes / 16)), kThreads, 0, st>>>(
        r8, o8, m, row_stride, nbytes);
  else
    decode_rows_kernel<1><<<grid_for(m * nbytes), kThreads, 0, st>>>(
        r8, o8, m, row_stride, nbytes);
  return static_cast<int>(cudaGetLastError());
}

}  // extern "C"
