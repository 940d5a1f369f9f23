// Kernel F: the LCS length of whole titles, one pair a thread, for NVIDIA
// Hopper (sm_90a).
//
// Replaces no Pallas kernel.  The JAX package leaves this function to XLA:
// doppelspeller_tpu/ops/levenshtein.py lcs_kernel, a scan that XLA fuses.  Its
// plain PyTorch version (lcs_plain in ops/levenshtein.py) is a loop of
// elementwise launches on int64 lanes: La launches build the match masks,
// then Lb x ceil(La/32) carry and borrow steps of about eleven launches
// each, some 600 launches a call at 32 characters and 1,850 at 64, every one
// streaming (pairs, width) int64 temporaries through device memory.  The
// fuzzy stage runs it twice a candidate pair, the model's features twice
// more.
//
// What it computes, bit for bit what lcs_plain computes.  For pair p, with
// n = ceil(La/32) words, la' = min(la, 32 n) and the valid characters
// a[i] (i < min(la, La), a[i] != 0) and b[j] (j < min(lb, Lb), b[j] != 0):
// the Crochemore-Iliopoulos-Pinzon bit-parallel LCS over the DP column of a,
// held in n 32-bit words V.  Per valid b[j] with match mask M (bit i set
// where a[i] == b[j]):  U = V & M;  V = (V + U) | (V & ~M), the add carrying
// across words.  The result is la' - popc(V & mask(la')), cast to int32.
// Every byte value is a code: codes past the 38-letter alphabet match their
// equals, as in lcs_plain (a slow path builds their masks; the encoder never
// gives one).  Lengths past the width read as the width, a length of zero or
// less gives no characters.
//
// What bounds it on the H100.  A step is three 32-bit operations a word (the
// and, the add, the and-not-or), and a pair at 64 characters takes at most
// 64 steps over two words: ~400 operations, with its table, for 136 bytes
// read (two rows and two int32 lengths) and 4 written.  65,536 such pairs
// are 9 MB, 2.7 us at 3.35 TB/s, against 0.8 us of operations at 33.5e12 a
// second: the bytes bound it on paper.  What the card really spends is
// instruction issue and latency: each step is a chain of dependent
// operations on V (and, add, or) behind a shared-memory read a word, so a
// thread takes some thousand cycles for its pair, and only enough threads
// in flight hide that.
//
// What the design does about it.
// - One thread a pair.  The scan over b is sequential; the parallelism lies
//   across pairs (65,536 in a fuzzy chunk, 12,800 in a served block), so
//   each thread scans its own pair and no thread waits on another.  Steps
//   run only to the pair's own lengths, not the tile's width: real titles
//   fill half a 64-wide tile.
// - V in registers as NW words, a template parameter (1, 2, 4 or 8) chosen
//   from the width; the carry runs through a 64-bit sum a word, which the
//   compiler turns into an add with carry.  Carries only move upward, so the
//   bits at or above la' never reach the ones below: V starts as all ones,
//   no step masks, and the mask is applied once, before the popcount.
// - The match table Peq[code] is built once a pair from a's characters, in
//   shared memory laid out [code][word][lane], so a data-dependent lookup
//   always lands in the thread's own bank: no conflicts, and a step is one
//   read a word and three operations.  Its 38 rows cover the alphabet (pad,
//   space, a-z, 0-9); a code past it reads the pad's row, all zeros, and the
//   slow path adds its mask from a's row in registers.  The scan stores
//   nothing, so the reads of a group of four characters can all be issued
//   ahead of their chain of steps.
// - Coalesced loads.  A warp stages its 32 pairs' rows through shared memory:
//   consecutive lanes read consecutive 4-byte words of the rows (bytes where
//   the width or the rows' alignment is not a multiple of 4), only as many
//   words as the warp's longest string needs, and write them to a tile laid
//   out [word][lane] with a stride of 33 words, so each thread then reads its
//   own row four characters at a time, free of conflicts.  The words go by
//   asynchronous copies (cp.async), all of a lane's in flight at once: the
//   warps of a served block are too few to hide one load's latency behind
//   another's.  a's tile, once its table is built, makes room for b's.
// - Rows may be strided (a column slice of a wider tensor, as the fuzzy stage
//   passes them): the kernel takes each side's row stride.  Lengths are
//   int32 or int64, read as they are.
// - No allocation, no synchronisation with the host: the kernel can be
//   captured in a CUDA graph.

#include <cuda_pipeline.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kCodes = 38;            // pad, space, a-z, 0-9: the table's rows
constexpr int kTileStride = 33;       // u32 words between a tile's columns
constexpr int kMaxWidth = 256;        // characters a row, 8 words of V
constexpr int kMaxWarps = 4;
constexpr int kSmemLimit = 48 * 1024; // the default limit of dynamic shared memory
constexpr unsigned kFull = 0xFFFFFFFFu;

__host__ __device__ inline int words4(int width) { return (width + 3) / 4; }

template <int NW>
__host__ __device__ inline int warp_smem(int la_width, int lb_width) {
  const int tile = words4(la_width > lb_width ? la_width : lb_width);
  return 4 * (kCodes * NW * 32 + (tile > 0 ? tile : 1) * kTileStride);
}

__device__ inline long long load_len(const void* len, bool is64, int p) {
  return is64 ? static_cast<const long long*>(len)[p] : (long long)static_cast<const int*>(len)[p];
}

// Stage words [0, n_words) of the warp's rows into tile[word * 33 + row]:
// lane-consecutive units of one row are consecutive in memory.  A unit is a
// 4-byte word where ``by_word`` (width, stride and pointer all multiples of
// 4), copied asynchronously so that all of a lane's loads are in flight at
// once, else a byte, with zeros past the width.
__device__ inline void stage(uint32_t* __restrict__ tile, const uint8_t* __restrict__ rows,
                             long long stride, int width, bool by_word, int n_rows, int n_words,
                             int lane) {
  const int per_row = by_word ? n_words : 4 * n_words;
  if (per_row == 0) return;
  const uint64_t magic = 0xFFFFFFFFull / (uint64_t)per_row + 1;  // k / per_row for k < 2^16
  const int units = n_rows * per_row;
  if (by_word) {
    for (int k = lane; k < units; k += 32) {
      const int r = (int)(((uint64_t)k * magic) >> 32);
      const int c = k - r * per_row;
      __pipeline_memcpy_async(tile + c * kTileStride + r,
                              reinterpret_cast<const uint32_t*>(rows + r * stride) + c, 4);
    }
    __pipeline_commit();
    __pipeline_wait_prior(0);
    return;
  }
  // bytes: a loop of its own, without the copies' asm, so that the compiler
  // can keep several loads in flight
#pragma unroll 4
  for (int k = lane; k < units; k += 32) {
    const int r = (int)(((uint64_t)k * magic) >> 32);
    const int c = k - r * per_row;
    reinterpret_cast<uint8_t*>(tile + (c >> 2) * kTileStride + r)[c & 3] =
        c < width ? rows[r * stride + c] : (uint8_t)0;
  }
}

template <int NW>
__global__ void __launch_bounds__(kMaxWarps * 32)
lcs_pairs_kernel(const uint8_t* __restrict__ a, long long a_stride, const void* __restrict__ la_ptr,
                 const uint8_t* __restrict__ b, long long b_stride, const void* __restrict__ lb_ptr,
                 int* __restrict__ out, int n_pairs, int la_width, int lb_width, int n_words,
                 bool la64, bool lb64, bool a_by_word, bool b_by_word, int smem_per_warp) {
  extern __shared__ __align__(16) uint8_t smem[];
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int p0 = (blockIdx.x * (blockDim.x >> 5) + warp) * 32;
  if (p0 >= n_pairs) return;            // whole warps only: the lanes below sync
  const int p = p0 + lane;
  const bool live = p < n_pairs;
  const int n_rows = min(32, n_pairs - p0);
  uint8_t* base = smem + warp * smem_per_warp;
  uint32_t* peq = reinterpret_cast<uint32_t*>(base) + lane;   // row r, word w at [(r * NW + w) * 32]
  uint32_t* tile = reinterpret_cast<uint32_t*>(base) + kCodes * NW * 32;

  const long long la = live ? load_len(la_ptr, la64, p) : 0;
  const long long lb = live ? load_len(lb_ptr, lb64, p) : 0;
  const int na = (int)max(0LL, min(la, (long long)la_width));   // a's characters
  const int nb = (int)max(0LL, min(lb, (long long)lb_width));   // b's steps

  // a's rows, then its table
  stage(tile, a + p0 * a_stride, a_stride, la_width, a_by_word, n_rows,
        words4(__reduce_max_sync(kFull, (unsigned)na)), lane);
#pragma unroll 1
  for (int r = 0; r < kCodes; ++r) {
#pragma unroll
    for (int w = 0; w < NW; ++w) peq[(r * NW + w) * 32] = 0u;
  }
  __syncwarp();
  for (int i0 = 0; i0 < na; i0 += 4) {
    const uint32_t chars = tile[(i0 >> 2) * kTileStride + lane];
#pragma unroll
    for (int q = 0; q < 4; ++q) {
      const int i = i0 + q;
      const uint32_t c = (chars >> (8 * q)) & 0xFFu;
      // 0 never matches; past 37: the scan's slow path
      if (i < na && c - 1u < (uint32_t)(kCodes - 1))
        peq[(c * NW + (i >> 5)) * 32] |= 1u << (i & 31);
    }
  }
  __syncwarp();                         // every lane is done with a's tile

  // b's rows, then the scan
  stage(tile, b + p0 * b_stride, b_stride, lb_width, b_by_word, n_rows,
        words4(__reduce_max_sync(kFull, (unsigned)nb)), lane);
  __syncwarp();
  uint32_t v[NW];
#pragma unroll
  for (int w = 0; w < NW; ++w) v[w] = kFull;
  for (int j0 = 0; j0 < nb; j0 += 4) {
    const uint32_t chars = tile[(j0 >> 2) * kTileStride + lane];
#pragma unroll
    for (int q = 0; q < 4; ++q) {
      if (j0 + q >= nb) break;
      const uint32_t c = (chars >> (8 * q)) & 0xFFu;
      // the scan stores nothing, so the group's table reads can all be
      // issued ahead of its chain of steps
      const uint32_t* mrow = peq + (c < (uint32_t)kCodes ? c : 0u) * NW * 32;
      uint32_t m[NW];
#pragma unroll
      for (int w = 0; w < NW; ++w) m[w] = mrow[w * 32];
      if (c >= (uint32_t)kCodes) {      // a code past the alphabet: its mask from a's row
        const uint8_t* row = a + (long long)p * a_stride;
#pragma unroll
        for (int w = 0; w < NW; ++w)
          for (int i = 32 * w; i < min(na, 32 * w + 32); ++i)
            m[w] |= (uint32_t)(row[i] == c) << (i & 31);
      }
      uint32_t carry = 0u;
#pragma unroll
      for (int w = 0; w < NW; ++w) {
        const uint64_t s = (uint64_t)v[w] + (v[w] & m[w]) + carry;
        carry = (uint32_t)(s >> 32);
        v[w] = (uint32_t)s | (v[w] & ~m[w]);
      }
    }
  }
  if (!live) return;
  const long long lap = min(la, 32LL * n_words);   // la': the bits of the DP column
  int ones = 0;
#pragma unroll
  for (int w = 0; w < NW; ++w) {
    const long long bits = lap - 32 * w;
    const uint32_t mask = bits >= 32 ? kFull : bits <= 0 ? 0u : (1u << bits) - 1u;
    ones += __popc(v[w] & mask);
  }
  out[p] = (int)(lap - ones);
}

template <int NW>
cudaError_t launch(const uint8_t* a, long long a_stride, const void* la, const uint8_t* b,
                   long long b_stride, const void* lb, int* out, int n_pairs, int la_width,
                   int lb_width, bool la64, bool lb64, bool a_by_word, bool b_by_word,
                   cudaStream_t stream) {
  const int per_warp = warp_smem<NW>(la_width, lb_width);
  const int warps = min(kMaxWarps, kSmemLimit / per_warp);   // >= 1 at widths up to 256
  const int pairs_per_block = 32 * warps;
  const int blocks = (n_pairs + pairs_per_block - 1) / pairs_per_block;
  lcs_pairs_kernel<NW><<<blocks, 32 * warps, (size_t)warps * per_warp, stream>>>(
      a, a_stride, la, b, b_stride, lb, out, n_pairs, la_width, lb_width,
      (la_width + 31) / 32, la64, lb64, a_by_word, b_by_word, per_warp);
  return cudaGetLastError();
}

}  // namespace

// a, b: uint8 rows of la_width / lb_width characters, a row every a_stride /
// b_stride bytes; la, lb: (n_pairs,) int32, or int64 where la64 / lb64;
// out: (n_pairs,) int32.  Widths up to 256.
extern "C" int doppel_lcs_pairs(const void* a, long long a_stride, const void* la, int la64,
                                const void* b, long long b_stride, const void* lb, int lb64,
                                void* out, int n_pairs, int la_width, int lb_width, void* stream) {
  if (n_pairs < 0 || la_width < 0 || lb_width < 0 || la_width > kMaxWidth || lb_width > kMaxWidth ||
      a_stride < 0 || b_stride < 0)
    return (int)cudaErrorInvalidValue;
  if (n_pairs == 0) return 0;
  const uint8_t* pa = static_cast<const uint8_t*>(a);
  const uint8_t* pb = static_cast<const uint8_t*>(b);
  const bool a_by_word = la_width % 4 == 0 && a_stride % 4 == 0 && (uintptr_t)pa % 4 == 0;
  const bool b_by_word = lb_width % 4 == 0 && b_stride % 4 == 0 && (uintptr_t)pb % 4 == 0;
  int* po = static_cast<int*>(out);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const int n_words = (la_width + 31) / 32;
  if (n_words <= 1)
    return (int)launch<1>(pa, a_stride, la, pb, b_stride, lb, po, n_pairs, la_width, lb_width,
                          la64, lb64, a_by_word, b_by_word, st);
  if (n_words <= 2)
    return (int)launch<2>(pa, a_stride, la, pb, b_stride, lb, po, n_pairs, la_width, lb_width,
                          la64, lb64, a_by_word, b_by_word, st);
  if (n_words <= 4)
    return (int)launch<4>(pa, a_stride, la, pb, b_stride, lb, po, n_pairs, la_width, lb_width,
                          la64, lb64, a_by_word, b_by_word, st);
  return (int)launch<8>(pa, a_stride, la, pb, b_stride, lb, po, n_pairs, la_width, lb_width,
                        la64, lb64, a_by_word, b_by_word, st);
}
