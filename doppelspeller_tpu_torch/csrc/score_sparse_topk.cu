// Kernel E: IDF-weighted Jaccard scores from sparse weights with the exact
// top-k kept on chip, for NVIDIA Hopper (sm_90a).
//
// Replaces the TPU kernel doppelspeller_tpu/ops/jaccard_pallas.py
// _score_kernel, entered through jaccard_topk_pallas (the v1 retrieval step)
// together with that entry's densified weights and its blockwise exact
// top-k (XLA outside the Pallas kernel).
//
// What it computes.  packed: u8 (V, nbytes) the packed trigram index, bit
// t%8 of byte t/8 set when title t holds trigram v; ids: i32 (U,) the
// union's row ids; w_pos: i32 (QB, LQ) positions into the union, U (or any
// position outside [0, U)) the padding slot; w_val: f32 (QB, LQ) weights,
// rounded to bf16 first in bf16 mode.  num[q, t] = sum over q's slots l of
// w[q, l] * bit[ids[w_pos[q, l]], t], accumulated in f32 in slot order;
// jacc = num / max((sums[t] + maxint[q]) - num, 1e-9), and -1 for t >= nt.
// Out: the exact top-k of each query, scores f32 (QB, k) descending and
// titles i32 (QB, k), ties to the lower pi column (tile-local title 8*b + s
// is column s*nb + b, nb = tb/8): the order of the int64 keys of
// jaccard_kernels.score_keys, the score's order-preserving 32 bits above
// the complement of its column.  Keys are unique, so every selection below
// is exact.
//
// What bounds it on the H100.  At the oracle's shapes (QB = 128, LQ = 64,
// U = 3,072, 524,288 titles) a block weights ~4.7k of its 393k (query, row)
// slots, ~2.4k distinct rows: 0.16 GB of rows read once, 0.047 ms at
// 3.35 TB/s, against 2.5e9 weighted bits, one f32 add each: the bytes.  The
// dense route (kernel D, then a top-k over its output) multiplies every
// slot and writes and reads back a (QB, ntp) f32 matrix of 268 MB.
//
// What the design does about it.  Two kernels, one launch after the other.
// - score_sparse_topk_kernel: each block owns kRange consecutive titles
//   (whole tiles) and kQueries queries; the grid runs the query groups of
//   one range next to each other, so the row words that several groups
//   weight are read from HBM about once and from L2 after.
//   - Only weighted slots are visited.  Each warp compacts one query's
//     slots into shared memory (row id, weight; the padding slot and zero
//     weights dropped).  Every thread owns one 32-bit word of each row: per
//     slot it loads that word (1 KB of the row a block, coalesced), the
//     next kDepth slots in flight while it adds the weight into 32 f32
//     accumulators in registers, one predicated add a set bit, on the CUDA
//     cores.  The f32 mode needs no split into bf16 parts.
//   - The scores never leave the SM.  They become 48-bit keys (32 bits of
//     score, 16 of complemented range-local column).  Candidates are the
//     keys at or above two floors: each warp's ceil(k/8)-th best thread
//     maximum, least over the warps (at least k titles reach it), and the
//     query's floor in global memory, under the k-th key of a range another
//     block has finished (atomicMax), below which no key can make the top
//     k.  They are compacted into shared memory.  When no more than k are
//     left the block writes them all; else a radix select over 8-bit
//     digits (histograms in shared memory, lanes of equal digits adding
//     once through __match_any_sync, two barriers a digit) finds the k-th,
//     and the block writes the k from it up and raises the floor.  Ranges
//     wholly past nt skip the contraction.
//   - Each (query, range) writes k int64 keys, INT64_MIN past those taken:
//     6.6 MB at the oracle's shapes.
// - merge_topk_kernel: one block a query selects the k largest of its
//   ranges' keys at or above the final floor with the same radix select
//   (reading the keys from L2 in each pass), ranks the k by counting, and
//   writes scores and titles.

#include <climits>
#include <stdint.h>

#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include "div_rn.cuh"

namespace {

constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;
constexpr int kRange = kThreads * 32;   // titles a block owns: one 32-bit word a thread
constexpr int kQueries = kWarps;        // queries a block scores: one warp compacts each
constexpr int kMaxSlots = 256;          // LQ the kernel takes
constexpr int kMaxK = 1024;             // k the merge takes
constexpr int kDepth = 4;               // row words in flight a thread
constexpr unsigned kFull = 0xffffffffu;

// The warp's 32 values v, one a lane, sorted descending across the lanes
// (a bitonic network of shuffles).
__device__ __forceinline__ uint32_t warp_sorted_desc(uint32_t v, int lane) {
#pragma unroll
  for (int size = 2; size <= 32; size <<= 1) {
    const bool desc = (lane & size) == 0;
#pragma unroll
    for (int stride = size >> 1; stride > 0; stride >>= 1) {
      const uint32_t other = __shfl_xor_sync(kFull, v, stride);
      v = (((lane & stride) == 0) == desc) ? max(v, other) : min(v, other);
    }
  }
  return v;
}

// A key split for the radix select: hi the score's order-preserving bits,
// lo the column part (larger for a lower column), ok whether it takes part.
struct Item {
  bool ok;
  uint32_t hi, lo;
};

// The digits taken: the selected keys are those with (hi & mh, lo & ml) at
// or above (ph, pl).
struct Prefix {
  uint32_t ph, pl, mh, ml;
  __device__ __forceinline__ bool holds(const Item& it) const {
    const uint32_t h = it.hi & mh;
    return it.ok && (h > ph || (h == ph && (it.lo & ml) >= pl));
  }
};

// Radix select, block-wide, over items fetch(0..n-1) of which at least need
// (>= 1) take part: the prefix of the need-th largest key, 8-bit digits
// from the top (four of hi, then kLoDigits of lo), ending at the first
// digit whose bin is taken whole (keys are unique, so by the last).
// s_hist[0] must be zero, and a barrier past, on entry.  Two histograms
// alternate, so a digit takes two barriers: after the counts, and after
// warp 0 has found the digit and cleared the other histogram.
template <int kLoDigits, class Fetch>
__device__ Prefix radix_select(Fetch fetch, int n, unsigned need, unsigned (*s_hist)[256],
                               unsigned* s_pick, int tid) {
  const int lane = tid & 31, warp = tid >> 5;
  Prefix p = {0u, 0u, 0u, 0u};
  for (int digit = 0;; ++digit) {
    const bool high = digit < 4;
    const int sh = high ? 24 - 8 * digit : 8 * (kLoDigits - 1) - 8 * (digit - 4);
    unsigned* hist = s_hist[digit & 1];
    for (int i0 = 0; i0 < n; i0 += kThreads) {
      const int i = i0 + tid;
      const Item it = i < n ? fetch(i) : Item{false, 0u, 0u};
      const bool in = it.ok && ((it.hi ^ p.ph) & p.mh) == 0 && ((it.lo ^ p.pl) & p.ml) == 0;
      const unsigned ballot = __ballot_sync(kFull, in);
      if (ballot) {
        const unsigned d = in ? ((high ? it.hi : it.lo) >> sh) & 255u : 256u;
        if (__popc(ballot) > 4) {   // lanes with equal digits add once
          const unsigned peers = __match_any_sync(kFull, d);
          if (in && lane == __ffs(peers) - 1) atomicAdd(&hist[d], (unsigned)__popc(peers));
        } else if (in) {
          atomicAdd(&hist[d], 1u);
        }
      }
    }
    __syncthreads();
    if (warp == 0) {
      // lane l holds bins 255 - 8l down to 248 - 8l: a scan from the top bin
      unsigned c[8], sum = 0;
#pragma unroll
      for (int b = 0; b < 8; ++b) {
        c[b] = hist[255 - 8 * lane - b];
        sum += c[b];
      }
      unsigned incl = sum;
#pragma unroll
      for (int off = 1; off < 32; off <<= 1) {
        const unsigned v = __shfl_up_sync(kFull, incl, off);
        if (lane >= off) incl += v;
      }
      unsigned run = incl - sum;
      if (run < need && need <= incl) {
#pragma unroll
        for (int b = 0; b < 8; ++b) {
          if (run < need && need <= run + c[b]) {
            s_pick[0] = 255u - 8 * lane - b;
            s_pick[1] = need - run;
            s_pick[2] = c[b];
          }
          run += c[b];
        }
      }
      unsigned* other = s_hist[(digit & 1) ^ 1];
#pragma unroll
      for (int b = 0; b < 8; ++b) other[8 * lane + b] = 0;
    }
    __syncthreads();
    if (high) {
      p.ph |= s_pick[0] << sh;
      p.mh |= 255u << sh;
    } else {
      p.pl |= s_pick[0] << sh;
      p.ml |= 255u << sh;
    }
    need = s_pick[1];
    if (s_pick[2] == need) return p;
  }
}

// The slot of this thread's item among those the block's threads append
// with `take`, counted from *s_cnt (one shared atomic a warp).
__device__ __forceinline__ unsigned append_slot(bool take, unsigned* s_cnt, int lane) {
  const unsigned ballot = __ballot_sync(kFull, take);
  unsigned base = 0;
  if (ballot) {
    if (lane == 0) base = atomicAdd(s_cnt, (unsigned)__popc(ballot));
    base = __shfl_sync(kFull, base, 0);
  }
  return base + __popc(ballot & ((1u << lane) - 1u));
}

__global__ void __launch_bounds__(kThreads, 3)
score_sparse_topk_kernel(const uint32_t* __restrict__ packed,   // (V, nw) words
                         const int* __restrict__ ids,           // (U,)
                         const int* __restrict__ w_pos,         // (QB, LQ)
                         const float* __restrict__ w_val,       // (QB, LQ)
                         const float* __restrict__ sums,        // (ntp,)
                         const float* __restrict__ maxint,      // (QB,)
                         long long* __restrict__ out,           // (QB, ranges, k) keys
                         long long* floor_key,                  // (QB,), raised by atomicMax
                         int qb, int u, int lq, int nw, int nt, int tb, int k, int bf16) {
  __shared__ int s_row[kQueries][kMaxSlots];
  __shared__ float s_w[kQueries][kMaxSlots];
  __shared__ int s_n[kQueries];
  __shared__ unsigned s_hist[2][256];
  __shared__ uint32_t s_floor[kWarps];
  __shared__ unsigned s_pick[3];   // digit, keys still to take, keys in the digit's bin
  __shared__ unsigned s_cnt, s_out;   // candidates, keys written
  extern __shared__ __align__(16) uint8_t s_dyn[];
  uint32_t* c_hi = reinterpret_cast<uint32_t*>(s_dyn);               // [kRange] candidates' scores
  uint16_t* c_lo = reinterpret_cast<uint16_t*>(s_dyn + 4 * kRange);  // [kRange] their column parts

  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int q0 = blockIdx.x * kQueries;
  const int range = blockIdx.y;
  const int r0 = range * kRange;                    // the range's first title
  const int word = range * kThreads + tid;          // this thread's word of every row
  const bool have = word < nw;
  const int n_in = min(kRange, nw * 32 - r0);       // titles in the range
  const bool scored = r0 < nt;                      // else every score is -1

  // each warp compacts one query's weighted slots
  {
    const int q = q0 + warp;
    int n = 0;
    if (q < qb && scored) {
      for (int l0 = 0; l0 < lq; l0 += 32) {
        const int l = l0 + lane;
        int pos = -1;
        float w = 0.f;
        if (l < lq) {
          pos = w_pos[(long long)q * lq + l];
          w = w_val[(long long)q * lq + l];
          if (bf16) w = __bfloat162float(__float2bfloat16_rn(w));
        }
        const bool take = pos >= 0 && pos < u && w != 0.f;
        const unsigned ballot = __ballot_sync(kFull, take);
        if (take) {
          const int at = n + __popc(ballot & ((1u << lane) - 1u));
          s_row[warp][at] = ids[pos];
          s_w[warp][at] = w;
        }
        n += __popc(ballot);
      }
    }
    if (lane == 0) s_n[warp] = n;
  }
  __syncthreads();

  // range-local pi column of this thread's title j: col0 + (j % 8) * nb + j / 8
  // (tb is a power of two from 32 to kRange, so the thread's 32 titles lie
  // in one tile and the range holds whole tiles)
  const int nb = tb >> 3;
  const int o = (tid * 32) & (tb - 1);
  const int col0 = tid * 32 - o + (o >> 3);
  const uint32_t* rowword = packed + word;
  const long long n_ranges = gridDim.y;
  // a key's low word: the complement of its column, lo_base + its column part
  const uint32_t lo_base = 0xffffffffu - (uint32_t)r0 - 0xffffu;

  for (int qi = 0; qi < kQueries; ++qi) {
    const int q = q0 + qi;
    if (q >= qb) break;
    const int n = s_n[qi];
    float acc[32];
#pragma unroll
    for (int j = 0; j < 32; ++j) acc[j] = 0.f;
    if (have) {
      // the next kDepth slots' words load while this batch's are added
      uint32_t b[kDepth];
#pragma unroll
      for (int t = 0; t < kDepth; ++t)
        b[t] = t < n ? __ldg(rowword + (long long)s_row[qi][t] * nw) : 0u;
      for (int l = 0; l < n; l += kDepth) {
        uint32_t nxt[kDepth];
#pragma unroll
        for (int t = 0; t < kDepth; ++t)
          nxt[t] = l + kDepth + t < n ? __ldg(rowword + (long long)s_row[qi][l + kDepth + t] * nw) : 0u;
#pragma unroll
        for (int t = 0; t < kDepth; ++t) {
          if (l + t < n) {
            const float w = s_w[qi][l + t];
#pragma unroll
            for (int j = 0; j < 32; ++j)
              if ((b[t] >> j) & 1u) acc[j] += w;
          }
        }
#pragma unroll
        for (int t = 0; t < kDepth; ++t) b[t] = nxt[t];
      }
    }
    // scores as order-preserving 32-bit keys
    uint32_t hi[32];
    const float mi = maxint[q];
#pragma unroll
    for (int j4 = 0; j4 < 8; ++j4) {
      float4 sm = make_float4(0.f, 0.f, 0.f, 0.f);
      if (have && scored) sm = __ldg(reinterpret_cast<const float4*>(sums) + word * 8 + j4);
      const float sv[4] = {sm.x, sm.y, sm.z, sm.w};
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        const int j = j4 * 4 + i;
        const float a = acc[j];
        const float s = word * 32 + j < nt ? div_rn(a, fmaxf((sv[i] + mi) - a, 1e-9f)) : -1.f;
        const uint32_t bits = __float_as_uint(s);
        hi[j] = (bits & 0x80000000u) ? ~bits : (bits | 0x80000000u);
      }
    }

    // the floors: each warp's ceil(k/8)-th best thread maximum, least over
    // the warps (0 for k > kThreads: every title), and the query's key
    // floor from the ranges finished so far
    if (k <= kThreads) {
      uint32_t m = 0;
#pragma unroll
      for (int j = 0; j < 32; ++j) m = max(m, hi[j]);
      const uint32_t v = warp_sorted_desc(have ? m : 0u, lane);
      const uint32_t r = __shfl_sync(kFull, v, (k + kWarps - 1) / kWarps - 1);
      if (lane == 0) s_floor[warp] = r;
    }
    if (tid == 0) s_cnt = s_out = 0;
    s_hist[0][tid] = 0;
    __syncthreads();
    uint32_t floor_hi = 0;
    if (k <= kThreads) {
      floor_hi = s_floor[0];
#pragma unroll
      for (int w = 1; w < kWarps; ++w) floor_hi = min(floor_hi, s_floor[w]);
    }
    const long long floor_q = *reinterpret_cast<volatile long long*>(floor_key + q);
    // the candidates, compacted with their column parts 0xffff - local column
#pragma unroll
    for (int j = 0; j < 32; ++j) {
      const uint32_t lo = 0xffffu - (uint32_t)(col0 + (j & 7) * nb + (j >> 3));
      const long long key =
          (long long)(((unsigned long long)(hi[j] ^ 0x80000000u) << 32) | (lo_base + lo));
      const bool cand = have && hi[j] >= floor_hi && key >= floor_q;
      const unsigned at = append_slot(cand, &s_cnt, lane);
      if (cand) {
        c_hi[at] = hi[j];
        c_lo[at] = (uint16_t)lo;
      }
    }
    __syncthreads();
    const int n_cand = (int)s_cnt;
    const unsigned need = (unsigned)min(k, n_in);
    auto fetch = [&](int i) { return Item{true, c_hi[i], (uint32_t)c_lo[i]}; };
    Prefix p = {0u, 0u, 0u, 0u};   // every candidate, when no more than need are left
    if ((unsigned)n_cand > need) {
      p = radix_select<2>(fetch, n_cand, need, s_hist, s_pick, tid);
      // the prefix with its untaken bits zero lies under the range's k-th key
      if (tid == 0 && need == (unsigned)k)
        atomicMax(floor_key + q, (long long)(((unsigned long long)(p.ph ^ 0x80000000u) << 32) |
                                             (p.ml ? lo_base + p.pl : 0u)));
    }

    long long* dst = out + ((long long)q * n_ranges + range) * k;
    for (int i0 = 0; i0 < n_cand; i0 += kThreads) {
      const int i = i0 + tid;
      const Item it = i < n_cand ? fetch(i) : Item{false, 0u, 0u};
      const bool sel = p.holds(it);
      const unsigned at = append_slot(sel, &s_out, lane);
      if (sel)
        dst[at] = (long long)(((unsigned long long)(it.hi ^ 0x80000000u) << 32) | (lo_base + it.lo));
    }
    __syncthreads();
    for (int at = (int)s_out + tid; at < k; at += kThreads) dst[at] = LLONG_MIN;
    __syncthreads();   // the candidates, s_cnt and s_out are the next query's
  }
}

__global__ void __launch_bounds__(kThreads)
merge_topk_kernel(const long long* __restrict__ keys,        // (QB, n) the ranges' keys
                  const long long* __restrict__ floor_key,   // (QB,)
                  float* __restrict__ vals, int* __restrict__ titles,   // (QB, k)
                  int n, int k, int tb) {
  __shared__ unsigned s_hist[2][256];
  __shared__ unsigned s_pick[3];
  __shared__ unsigned s_cnt;
  __shared__ long long s_top[kMaxK];
  const int tid = threadIdx.x, lane = tid & 31;
  const long long* row = keys + (long long)blockIdx.x * n;
  const long long fq = floor_key[blockIdx.x];
  auto fetch = [&](int i) {
    const long long key = row[i];
    return Item{key != LLONG_MIN && key >= fq,
                (uint32_t)((unsigned long long)key >> 32) ^ 0x80000000u, (uint32_t)key};
  };
  s_hist[0][tid] = 0;
  if (tid == 0) s_cnt = 0;
  __syncthreads();
  const Prefix p = radix_select<4>(fetch, n, (unsigned)k, s_hist, s_pick, tid);
  for (int i0 = 0; i0 < n; i0 += kThreads) {
    const int i = i0 + tid;
    const Item it = i < n ? fetch(i) : Item{false, 0u, 0u};
    const bool sel = p.holds(it);
    const unsigned at = append_slot(sel, &s_cnt, lane);
    if (sel) s_top[at] = row[i];
  }
  __syncthreads();
  // each key's rank by counting, then its score and title
  const int nb = tb >> 3;
  for (int i = tid; i < k; i += kThreads) {
    const long long key = s_top[i];
    int rank = 0;
    for (int j = 0; j < k; ++j) rank += s_top[j] > key;
    const int mono = (int)(key >> 32);
    const uint32_t col = 0xffffffffu - (uint32_t)key;
    const uint32_t c = col % (uint32_t)tb;
    vals[(long long)blockIdx.x * k + rank] = __int_as_float(mono ^ ((mono >> 31) & 0x7fffffff));
    titles[(long long)blockIdx.x * k + rank] = (int)(col - c + 8 * (c % nb) + c / nb);
  }
}

}  // namespace

extern "C" int doppel_score_sparse_topk(const void* packed, const void* ids, const void* w_pos,
                                        const void* w_val, const void* sums, const void* maxint,
                                        void* keys, void* floor_key, void* vals, void* titles,
                                        int qb, int u, int lq, long long nbytes, int nt, int tb,
                                        int k, int bf16, void* stream) {
  if (qb < 1 || u < 0 || lq < 0 || lq > kMaxSlots || k < 1 || k > kMaxK || nbytes % 4 ||
      nbytes * 8 > INT_MAX || k > nbytes * 8 || tb < 32 || tb > kRange || (tb & (tb - 1)) ||
      (nbytes * 8) % tb)
    return (int)cudaErrorInvalidValue;
  const int nw = (int)(nbytes / 4);
  const int ranges = (nw + kThreads - 1) / kThreads;
  if (ranges > 65535) return (int)cudaErrorInvalidValue;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  constexpr int kDynSmem = 6 * kRange;   // the candidates: 32 + 16 bits each
  cudaError_t err = cudaFuncSetAttribute(score_sparse_topk_kernel,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize, kDynSmem);
  if (err != cudaSuccess) return (int)err;
  dim3 grid((qb + kQueries - 1) / kQueries, ranges);
  score_sparse_topk_kernel<<<grid, kThreads, kDynSmem, st>>>(
      static_cast<const uint32_t*>(packed), static_cast<const int*>(ids),
      static_cast<const int*>(w_pos), static_cast<const float*>(w_val),
      static_cast<const float*>(sums), static_cast<const float*>(maxint),
      static_cast<long long*>(keys), static_cast<long long*>(floor_key), qb, u, lq, nw, nt, tb, k,
      bf16);
  err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  merge_topk_kernel<<<qb, kThreads, 0, st>>>(static_cast<const long long*>(keys),
                                             static_cast<const long long*>(floor_key),
                                             static_cast<float*>(vals), static_cast<int*>(titles),
                                             ranges * k, k, tb);
  return (int)cudaGetLastError();
}
