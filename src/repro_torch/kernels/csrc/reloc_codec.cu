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
//
// decode_rows is a plain copy, so it is held to a copy's rate: a
// streaming kernel (eight 16-byte loads in flight per thread, no 64-bit
// division per word, L1-bypassing loads, a grid sized from the SMs'
// resident capacity) with a flat path where the block is contiguous.
// Phase 1 of chip_smoke.py times it beside rows[:, :nbytes].clone() and
// the byte bound.

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
// The 16-byte path is a streaming copy: each thread keeps kUnroll
// independent 16-byte loads in flight before it stores any, and loads
// bypass L1 (ld.global.nc.L1::no_allocate: every byte is read once).
// Stores are plain: st.global.cs was no faster on the card.
// * flat (a contiguous block, row stride == nbytes): block b copies one
//   contiguous range of words, two rounds of the SMs' resident blocks in
//   all;
// * strided: rows in tiles of tile_rows rows (tile_rows * wpr <=
//   kTileWords 16-byte words, or one row when a row is wider); a word's
//   row and column within the tile come from a 32-bit division by the
//   words per row, never a 64-bit one.
constexpr int kUnroll = 8;
constexpr int kTileWords = kThreads * kUnroll;

__device__ __forceinline__ uint4 ld_stream(const uint8_t* p) {
  uint4 v;
  asm volatile("ld.global.nc.L1::no_allocate.v4.u32 {%0, %1, %2, %3}, [%4];"
               : "=r"(v.x), "=r"(v.y), "=r"(v.z), "=r"(v.w)
               : "l"(p));
  return v;
}

__global__ void __launch_bounds__(kThreads)
decode_flat_kernel(const uint8_t* __restrict__ rows, uint8_t* __restrict__ out,
                   long long nw, long long per) {
  const long long lo = blockIdx.x * per;
  const long long hi = lo + per < nw ? lo + per : nw;
  for (long long b = lo; b < hi; b += kTileWords) {
    uint4 w[kUnroll];
#pragma unroll
    for (int j = 0; j < kUnroll; ++j) {
      const long long e = b + j * kThreads + threadIdx.x;
      if (e < hi) w[j] = ld_stream(rows + e * 16);
    }
#pragma unroll
    for (int j = 0; j < kUnroll; ++j) {
      const long long e = b + j * kThreads + threadIdx.x;
      if (e < hi) reinterpret_cast<uint4*>(out)[e] = w[j];
    }
  }
}

__global__ void __launch_bounds__(kThreads)
decode_strided_kernel(const uint8_t* __restrict__ rows,
                      uint8_t* __restrict__ out, long long m,
                      long long row_stride, int wpr, int tile_rows,
                      long long n_tiles) {
  for (long long tile = blockIdx.x; tile < n_tiles; tile += gridDim.x) {
    const long long r0 = tile * tile_rows;
    const int nrows = static_cast<int>(
        m - r0 < tile_rows ? m - r0 : static_cast<long long>(tile_rows));
    const int words = nrows * wpr;
    const uint8_t* src = rows + r0 * row_stride;
    uint4* dst = reinterpret_cast<uint4*>(out + r0 * wpr * 16);
    for (int base = 0; base < words; base += kTileWords) {
      uint4 w[kUnroll];
#pragma unroll
      for (int j = 0; j < kUnroll; ++j) {
        const int e = base + j * kThreads + threadIdx.x;
        if (e < words) {
          const int r = e / wpr;
          w[j] = ld_stream(src + r * row_stride + (e - r * wpr) * 16);
        }
      }
#pragma unroll
      for (int j = 0; j < kUnroll; ++j) {
        const int e = base + j * kThreads + threadIdx.x;
        if (e < words) dst[e] = w[j];
      }
    }
  }
}

// blocks of kThreads resident on the current device at once, asked once
// per device
int resident_blocks(int* out) {
  constexpr int kMaxDevices = 64;
  static int resident[kMaxDevices] = {};
  int dev = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err != cudaSuccess) return static_cast<int>(err);
  if (dev >= kMaxDevices) return static_cast<int>(cudaErrorInvalidDevice);
  if (resident[dev] == 0) {
    int sms = 0, per_sm = 0;
    err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
    if (err == cudaSuccess)
      err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(
          &per_sm, decode_strided_kernel, kThreads, 0);
    if (err != cudaSuccess) return static_cast<int>(err);
    resident[dev] = sms * (per_sm > 0 ? per_sm : 1);
  }
  *out = resident[dev];
  return 0;
}

int launch_decode_flat(const uint8_t* rows, uint8_t* out, long long nw,
                       cudaStream_t st) {
  int cap = 0;
  const int err = resident_blocks(&cap);
  if (err != 0) return err;
  const long long blocks = 2LL * cap;
  long long per = (nw + blocks - 1) / blocks;
  per = (per + kTileWords - 1) / kTileWords * kTileWords;
  decode_flat_kernel<<<static_cast<unsigned>((nw + per - 1) / per), kThreads,
                       0, st>>>(rows, out, nw, per);
  return static_cast<int>(cudaGetLastError());
}

// as many blocks as the SMs hold at once, no more than there are tiles,
// with the tiles spread evenly over them
int launch_decode_strided(const uint8_t* rows, uint8_t* out, long long m,
                          long long row_stride, long long wpr,
                          cudaStream_t st) {
  const int tile_rows =
      wpr >= kTileWords ? 1 : static_cast<int>(kTileWords / wpr);
  const long long n_tiles = (m + tile_rows - 1) / tile_rows;
  int cap = 0;
  const int err = resident_blocks(&cap);
  if (err != 0) return err;
  const long long waves = (n_tiles + cap - 1) / cap;
  const long long grid = (n_tiles + waves - 1) / waves;
  decode_strided_kernel<<<static_cast<unsigned>(grid), kThreads, 0, st>>>(
      rows, out, m, row_stride, static_cast<int>(wpr), tile_rows, n_tiles);
  return static_cast<int>(cudaGetLastError());
}

// narrow or unaligned rows: one byte per thread, grid-stride
__global__ void decode_rows_bytes_kernel(const uint8_t* __restrict__ rows,
                                         uint8_t* __restrict__ out,
                                         long long m, long long row_stride,
                                         long long nbytes) {
  const long long total = m * nbytes;
  const long long stride = static_cast<long long>(gridDim.x) * blockDim.x;
  for (long long t = static_cast<long long>(blockIdx.x) * blockDim.x +
                     threadIdx.x;
       t < total; t += stride) {
    const long long i = t / nbytes;
    out[t] = rows[i * row_stride + (t - i * nbytes)];
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
      aligned16(out) && nbytes / 16 <= 2147483647LL) {
    // a contiguous block is one run of m * nbytes / 16 words
    if (row_stride == nbytes || m == 1)
      return launch_decode_flat(r8, o8, m * (nbytes / 16), st);
    return launch_decode_strided(r8, o8, m, row_stride, nbytes / 16, st);
  }
  decode_rows_bytes_kernel<<<grid_for(m * nbytes), kThreads, 0, st>>>(
      r8, o8, m, row_stride, nbytes);
  return static_cast<int>(cudaGetLastError());
}

}  // extern "C"
