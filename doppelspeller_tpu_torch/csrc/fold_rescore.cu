// Kernel G: the folded engine's coarse top-k' select, exact rescore and
// final top-k of one query block in one launch, for NVIDIA Hopper (sm_90a).
//
// Replaces no Pallas kernel.  The JAX package leaves this chain to XLA:
// doppelspeller_tpu/ops/fold.py, the select over the window maxima that
// follows the coarse kernel, then _rescore_exact.  Its plain PyTorch version
// (select_rescore_plain in ops/fold.py) is a full stable sort of every
// query's window maxima to keep k' of them, a gather of the candidates'
// trigram lists, about four launches a query slot (a compare, a bool
// reduction, a multiply and an add over (QB, k', Ltw)) and a second stable
// sort: some 260 launches a block.
//
// What it computes, bit for bit what select_rescore_plain computes.  Per
// query row q (one block a row):
// 1. Select.  The k' largest window maxima wmax[q, :], in the order of
//    torch.sort(descending=True, stable=True): equal values go to the lower
//    window.  Keys are the floats' order-preserving 32 bits, -0 read as +0
//    (the sort compares them equal) and a NaN above everything, joined
//    with the window's complement so that keys are unique; candidate r of
//    that order stands for title pos[r] = warg[q, window].
// 2. Rescore.  For each candidate with 0 <= pos < nt:
//    c = sum over l ascending of w_val[q, l] * [ids[q, l] in tl[pos, :]],
//    added in f32 one term at a time; jacc = c / max((sums[pos] + maxint[q])
//    - c, 1e-9) with IEEE rounding (__fadd_rn, __fsub_rn, __fdiv_rn).  A slot
//    whose weight is zero is skipped, and so is one whose id is not an
//    int32 (it matches no entry): c starts at +0.0 and only grows by such
//    sums, so adding w * 0 or 0 * hit leaves it as it is.  The engine's
//    sentinel slots (id V) carry weight 0.  Candidates outside [0, nt) read
//    no row and score -1.
// 3. Top-k.  The k' scores by (value descending, coarse rank ascending),
//    with the same keys; the first k values and their positions written.
//
// What bounds it on the H100.  At the 500k block (QB 128, 32,768 windows,
// k' 128, Ltw 64) a block reads 16.8 MB of window maxima, 4.2 MB of
// candidate rows and 0.2 MB of ids, weights and sums: 6.4 us at 3.35
// TB/s.  Kernel A has just written the maxima (with their titles 33.5 MB,
// under the 50 MB L2), so they may come from L2.  The plain chain took about
// 1.3 ms a block in the graphs, nearly all of it the latency of ~260 nodes.
//
// What the design does about it.  One block of 512 threads a query row,
// every step on chip, one launch:
// - A floor first.  Each thread takes the largest key of its windows
//   (float4 loads); each warp's ceil(k'/16)-th largest thread maximum,
//   least over the warps, has at least k' keys at or above it.  A second
//   sweep compacts those keys into shared memory (one shared atomic a warp
//   for each of a float4's keys), far fewer than the row's 32,768 where the
//   top scores stand apart.
// - A radix select over 8-bit digits of the unique 64-bit keys (histograms
//   in shared memory, lanes of equal digits adding once through
//   __match_any_sync) finds the k'-th, from the compacted keys, or, where
//   more than kCap keys tie at the floor (all-padding rows), from the
//   whole row read again.  The k' keys at or above it are ranked by
//   counting.
// - The candidates' trigram rows go to shared memory by cp.async, 64 KB of
//   them in flight at once (all k' at the 500k block); a warp rescores a
//   candidate: each lane tests one query slot against the row (broadcast
//   reads), a ballot gives the hits, and the hit weights are added in slot
//   order.
// - The final top-k ranks the k' scores by counting.
// - No allocation, no synchronisation with the host: the kernel can be
//   captured in a CUDA graph.

#include <cuda_pipeline.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 512;
constexpr int kWarps = kThreads / 32;
constexpr int kMaxKp = 1024;            // k' the kernel takes
constexpr int kMaxSlots = 256;          // LQ the kernel takes
constexpr int kDynSmem = 64 * 1024;     // compacted keys, then candidate rows
constexpr int kCap = kDynSmem / 8;      // keys the compaction holds
constexpr unsigned kFull = 0xffffffffu;

// A float's order-preserving 32 bits: -0 as +0, NaN above +inf.
__device__ __forceinline__ uint32_t order_key(float v) {
  uint32_t b = __float_as_uint(v);
  const uint32_t mag = b & 0x7fffffffu;
  if (mag > 0x7f800000u) return 0xffffffffu;
  if (mag == 0) b = 0;
  return (b & 0x80000000u) ? ~b : (b | 0x80000000u);
}

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

// A key for the radix select: hi the value's order bits, lo the
// complement of the window (larger for a lower window), ok whether it
// takes part.
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
// from the top (four of hi, then lo_digits of lo), ending at the first
// digit whose bin is taken whole (keys are unique, so by the last).
// s_hist[0] must be zero, and a barrier past, on entry.  Two histograms
// alternate, so a digit takes two barriers: after the counts, and after
// warp 0 has found the digit and cleared the other histogram.
template <class Fetch>
__device__ Prefix radix_select(Fetch fetch, int n, unsigned need, int lo_digits,
                               unsigned (*s_hist)[256], unsigned* s_pick, int tid) {
  const int lane = tid & 31, warp = tid >> 5;
  Prefix p = {0u, 0u, 0u, 0u};
  for (int digit = 0;; ++digit) {
    const bool high = digit < 4;
    const int sh = high ? 24 - 8 * digit : 8 * (lo_digits - 1) - 8 * (digit - 4);
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

__global__ void __launch_bounds__(kThreads, 1)
select_rescore_kernel(const float* __restrict__ wmax,     // (QB, nw)
                      const int* __restrict__ warg,       // (QB, nw)
                      const long long* __restrict__ ids,  // (QB, lq)
                      const float* __restrict__ w_val,    // (QB, lq)
                      const float* __restrict__ maxint,   // (QB,)
                      const int* __restrict__ tl,         // (ntp, ltw)
                      const float* __restrict__ sums,     // (ntp,)
                      float* __restrict__ out_vals,       // (QB, k)
                      int* __restrict__ out_pos,          // (QB, k)
                      int nw, int lq, int ltw, int nt, int kp, int k, int lo_digits) {
  __shared__ unsigned s_hist[2][256];
  __shared__ unsigned s_pick[3];   // digit, keys still to take, keys in the digit's bin
  __shared__ unsigned s_cnt, s_top_cnt;
  __shared__ uint32_t s_floor[kWarps];
  __shared__ uint32_t s_thi[kMaxKp], s_tlo[kMaxKp];   // the k' keys, then the scores' keys
  __shared__ int s_pos[kMaxKp];                       // candidates in coarse order
  __shared__ float s_jacc[kMaxKp];
  __shared__ int s_qid[kMaxSlots];
  __shared__ float s_qw[kMaxSlots];
  __shared__ int s_nslots;
  extern __shared__ __align__(16) uint8_t s_dyn[];
  uint32_t* c_hi = reinterpret_cast<uint32_t*>(s_dyn);                // [kCap] compacted keys
  uint32_t* c_lo = reinterpret_cast<uint32_t*>(s_dyn + 4 * kCap);
  int* rows = reinterpret_cast<int*>(s_dyn);                          // [rows_per_batch][ltw]

  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int q = blockIdx.x;
  const float* row = wmax + (long long)q * nw;
  const float4* row4 = reinterpret_cast<const float4*>(row);
  const int nw4 = nw >> 2;

  // warp 0 compacts the query's weighted slots, in slot order
  if (warp == 0) {
    int n = 0;
    for (int l0 = 0; l0 < lq; l0 += 32) {
      const int l = l0 + lane;
      long long id = 0;
      float w = 0.f;
      if (l < lq) {
        const long long at = (long long)q * lq + l;
        id = ids[at];
        w = w_val[at];
      }
      const bool take = l < lq && w != 0.f && id >= INT32_MIN && id <= INT32_MAX;
      const unsigned ballot = __ballot_sync(kFull, take);
      if (take) {
        const int at = n + __popc(ballot & ((1u << lane) - 1u));
        s_qid[at] = (int)id;
        s_qw[at] = w;
      }
      n += __popc(ballot);
    }
    if (lane == 0) s_nslots = n;
  }
  if (tid < 256) s_hist[0][tid] = 0;
  if (tid == 0) s_cnt = s_top_cnt = 0;

  // ---- 1. select: the floor, the keys at or above it, the k'-th key
  uint32_t m = 0;
  for (int i = tid; i < nw4; i += kThreads) {
    const float4 v = __ldg(row4 + i);
    m = max(max(m, max(order_key(v.x), order_key(v.y))), max(order_key(v.z), order_key(v.w)));
  }
  const int need_w = (kp + kWarps - 1) / kWarps;
  if (need_w <= 32) {
    const uint32_t v = warp_sorted_desc(m, lane);
    const uint32_t r = __shfl_sync(kFull, v, need_w - 1);
    if (lane == 0) s_floor[warp] = r;
  }
  __syncthreads();
  uint32_t floor_hi = 0;   // every key, when a warp's share passes its lanes
  if (need_w <= 32) {
    floor_hi = s_floor[0];
#pragma unroll
    for (int w = 1; w < kWarps; ++w) floor_hi = min(floor_hi, s_floor[w]);
  }
  for (int i0 = 0; i0 < nw4; i0 += kThreads) {
    const int i = i0 + tid;
    float4 v = make_float4(0.f, 0.f, 0.f, 0.f);
    if (i < nw4) v = __ldg(row4 + i);
    const float vs[4] = {v.x, v.y, v.z, v.w};
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      const uint32_t key = order_key(vs[j]);
      const bool cand = i < nw4 && key >= floor_hi;
      const unsigned at = append_slot(cand, &s_cnt, lane);
      if (cand && at < (unsigned)kCap) {
        c_hi[at] = key;
        c_lo[at] = (uint32_t)(nw - 1 - (4 * i + j));
      }
    }
  }
  __syncthreads();
  const int n_cand = (int)s_cnt;
  const bool held = n_cand <= kCap;
  auto fetch = [&](int i) -> Item {
    if (held) return Item{true, c_hi[i], c_lo[i]};
    const uint32_t key = order_key(row[i]);
    return Item{key >= floor_hi, key, (uint32_t)(nw - 1 - i)};
  };
  const int n = held ? n_cand : nw;
  Prefix p = {0u, 0u, 0u, 0u};   // every key, when no more than k' are left
  if (n_cand > kp) p = radix_select(fetch, n, (unsigned)kp, lo_digits, s_hist, s_pick, tid);
  for (int i0 = 0; i0 < n; i0 += kThreads) {
    const int i = i0 + tid;
    const Item it = i < n ? fetch(i) : Item{false, 0u, 0u};
    const bool sel = p.holds(it);
    const unsigned at = append_slot(sel, &s_top_cnt, lane);
    if (sel) {
      s_thi[at] = it.hi;
      s_tlo[at] = it.lo;
    }
  }
  __syncthreads();
  // coarse rank by counting (keys are unique), then the title of each
  for (int i = tid; i < kp; i += kThreads) {
    const unsigned long long key = ((unsigned long long)s_thi[i] << 32) | s_tlo[i];
    int rank = 0;
    for (int j = 0; j < kp; ++j)
      rank += (((unsigned long long)s_thi[j] << 32) | s_tlo[j]) > key;
    s_pos[rank] = __ldg(warg + (long long)q * nw + (nw - 1 - (int)s_tlo[i]));
  }
  __syncthreads();   // s_pos complete; the compacted keys are done with

  // ---- 2. rescore: rows by cp.async, a warp a candidate
  const int nslots = s_nslots;
  const float mi = maxint[q];
  const int chunks = ltw >> 2;   // 16-byte pieces of a row
  const int per_batch = kDynSmem / (ltw * 4);
  for (int b0 = 0; b0 < kp; b0 += per_batch) {
    const int nb = min(per_batch, kp - b0);
    for (int c = tid; c < nb * chunks; c += kThreads) {
      const int r = c / chunks, part = c - r * chunks;
      const int pos = s_pos[b0 + r];
      if (pos >= 0 && pos < nt)
        __pipeline_memcpy_async(rows + r * ltw + 4 * part, tl + (long long)pos * ltw + 4 * part, 16);
    }
    __pipeline_commit();
    __pipeline_wait_prior(0);
    __syncthreads();
    for (int r = warp; r < nb; r += kWarps) {
      const int pos = s_pos[b0 + r];
      float jacc = -1.f;
      if (pos >= 0 && pos < nt) {
        const float s = __ldg(sums + pos);
        const int4* rp = reinterpret_cast<const int4*>(rows + r * ltw);
        float c = 0.f;
        for (int g0 = 0; g0 < nslots; g0 += 32) {
          const int l = g0 + lane;
          bool hit = false;
          if (l < nslots) {
            const int x = s_qid[l];
            for (int j = 0; j < chunks; ++j) {
              const int4 e = rp[j];
              hit |= (e.x == x) | (e.y == x) | (e.z == x) | (e.w == x);
            }
          }
          unsigned hits = __ballot_sync(kFull, hit);
          while (hits) {   // in slot order
            c = __fadd_rn(c, s_qw[g0 + __ffs(hits) - 1]);
            hits &= hits - 1;
          }
        }
        float denom = __fsub_rn(__fadd_rn(s, mi), c);
        denom = denom < 1e-9f ? 1e-9f : denom;   // a NaN stays, as torch.clamp keeps it
        jacc = __fdiv_rn(c, denom);
      }
      if (lane == 0) s_jacc[b0 + r] = jacc;
    }
    __syncthreads();   // the rows' buffer is the next batch's
  }

  // ---- 3. top-k: the scores ranked by (value descending, coarse rank)
  for (int i = tid; i < kp; i += kThreads) s_thi[i] = order_key(s_jacc[i]);
  __syncthreads();
  for (int i = tid; i < kp; i += kThreads) {
    const unsigned long long key = ((unsigned long long)s_thi[i] << 32) | (unsigned)(kp - 1 - i);
    int rank = 0;
    for (int j = 0; j < kp; ++j)
      rank += (((unsigned long long)s_thi[j] << 32) | (unsigned)(kp - 1 - j)) > key;
    if (rank < k) {
      out_vals[(long long)q * k + rank] = s_jacc[i];
      out_pos[(long long)q * k + rank] = s_pos[i];
    }
  }
}

}  // namespace

// wmax f32, warg i32 (qb, nw), nw a multiple of 4; ids int64 and w_val f32
// (qb, lq); maxint f32 (qb,); tl i32 (ntp, ltw),
// ltw a multiple of 4; sums f32 (ntp,); out_vals f32, out_pos i32 (qb, k).
// 1 <= k <= kp <= min(nw, 1,024), lq <= 256, nt <= ntp.  Every pointer
// 16-byte aligned.
extern "C" int doppel_select_rescore(const void* wmax, const void* warg, const void* ids,
                                     const void* w_val, const void* maxint, const void* tl,
                                     const void* sums, void* out_vals, void* out_pos, int qb,
                                     int nw, int lq, int ltw, int nt, int kp, int k, void* stream) {
  if (qb < 1 || nw < 4 || nw % 4 || lq < 0 || lq > kMaxSlots || ltw < 4 || ltw % 4 ||
      ltw * 4 > kDynSmem || nt < 0 || k < 1 || k > kp || kp > nw || kp > kMaxKp)
    return (int)cudaErrorInvalidValue;
  const unsigned top = (unsigned)(nw - 1);
  const int lo_digits = top < (1u << 8) ? 1 : top < (1u << 16) ? 2 : top < (1u << 24) ? 3 : 4;
  cudaError_t err = cudaFuncSetAttribute(select_rescore_kernel,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize, kDynSmem);
  if (err != cudaSuccess) return (int)err;
  select_rescore_kernel<<<qb, kThreads, kDynSmem, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float*>(wmax), static_cast<const int*>(warg),
      static_cast<const long long*>(ids),
      static_cast<const float*>(w_val), static_cast<const float*>(maxint),
      static_cast<const int*>(tl), static_cast<const float*>(sums), static_cast<float*>(out_vals),
      static_cast<int*>(out_pos), nw, lq, ltw, nt, kp, k, lo_digits);
  return (int)cudaGetLastError();
}
