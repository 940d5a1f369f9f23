// Kernel D: the full (QB, ntp) IDF-weighted Jaccard matrix of a query block
// against every title, with the union's row gather fused into its loads, for
// NVIDIA Hopper (sm_90a), on the tensor cores.
//
// Replaces the TPU kernels doppelspeller_tpu/ops/jaccard_pallas.py
// _score_kernel_v2 (with _accumulate_numerator and _unpack_mm_chunk, folds
// = 1), entered through jaccard_topk_pallas_v2(window_select=False) together
// with that entry's row gather of the union (packed[union_ids]).
//
// What it computes.  packed: u8 (V, nbytes) the packed trigram index, bit
// t%8 of byte t/8 set when title t holds trigram v; ids: i32 (U,) the
// union's row ids, repeats allowed.  The weights w (QB, U) arrive as kernel
// A's weight image (jaccard_kernels.py kernel_a_weights with folds = 1): one
// bf16 part in bf16 mode, three parts hi + mid + lo that sum exactly to the
// f32 weight in f32 mode.  num[q, t] = sum_r w[q, r] * bit[ids[r], t],
// accumulated in f32; jacc = num / max((sums[t] + maxint[q]) - num, 1e-9),
// and -1 for t >= nt.  The output is f32 or bf16 (rounded to nearest even)
// in the reference's column order: within each tile of tb titles, column c
// holds tile-local title 8*(c mod nb) + c div nb (nb = tb/8), so tile-local
// title 8*b + s goes to column s*nb + b.  The exact top-k breaks ties toward
// the lower column, so this order decides which of equal-scored titles are
// kept.
//
// What bounds it on the H100.  QB * ntp * U multiply-adds of a weight by a
// 0/1 bit: 128 x 524,288 x 3,072 = 2.1e11 at 500k titles, 4.1e11 FLOP,
// 0.417 ms at the 989 TFLOP/s bf16 tensor-core peak, 1.251 ms for the f32
// mode's three passes.  The bytes are the union's rows read once (201 MB)
// and the scores written once (268 MB in f32, 134 MB in bf16), 0.14 ms at
// 3.35 TB/s: the tensor cores.
//
// What the design does about it.
// - Kernel A's mainloop (wgmma_bits.cuh): wgmma m64n128k16 with the bits
//   built in registers from the staged packed bytes, the weight image as
//   the B tile, a cp.async ring of four stages.  A bit is exactly 0.0 or
//   1.0 in bf16 and every weight part is exact, so only the summation order
//   differs from the plain version.  Block tile: 128 queries x 256 titles,
//   that is 32 consecutive bytes of every union row.
// - The gather is fused: the loading threads copy their 16 bytes of row
//   ids[r] straight from the packed index, zero-filled past U, so the
//   (U, nbytes) gathered matrix never exists.  Each loading thread reads the
//   id of its next chunk's row one chunk ahead into a register, where its
//   latency hides behind a chunk of wgmmas.  (Staging all ids in shared
//   memory would not fit beside the f32 mode's 204 KB ring at U = 8,192.)
// - A warp's 16 M rows are one bit plane of 16 consecutive bytes: row g is
//   bit s of byte g, row g+8 bit s of byte g+8, and the warp's two m64 tiles
//   are planes s and s+1.  A thread reads 8 bytes per k-step and builds both
//   tiles' bits from them, and each bit plane of the block's 32 bytes is one
//   run of 32 consecutive pi columns.
// - Epilogue: Jaccard (the division as kernel A's), -1 past nt; the 128 x
//   256 score tile goes in pi order through shared memory over the freed
//   ring, padded so that the stores from the accumulators hit 32 banks, and
//   leaves in 16-byte stores, 8 (f32) or 4 (bf16) neighbouring threads on
//   each 128-byte run of a query.  Blocks wholly past nt skip the
//   contraction and write -1.

#include <climits>

#include <cuda_bf16.h>

#include "wgmma_bits.cuh"

namespace {

using namespace wgmma_bits;

constexpr int kBytes = 32;                    // bytes of each row per block: 256 titles
constexpr int kRowStride = 48;                // staged bytes per row: 32, and 16 against bank conflicts
constexpr int kRowStage = kKC * kRowStride;   // staged row bytes per stage
constexpr int kQS = 8 * kBytes + 4;           // floats per query of the epilogue tile: 8 planes x 32, and 4 of padding

template <int P>
struct Cfg {
  static constexpr size_t RING = (size_t)kStages * (P * kWTile * 2 + kRowStage);
  static constexpr size_t TILE = (size_t)kN * kQS * 4;
  static constexpr size_t SMEM = (RING > TILE ? RING : TILE) + kN * 4;
};

// The block's scores leave in 16-byte stores: val(n, s, j) is the float4 of
// query n of the block, bit plane s, block bytes j..j+3.  Byte b of a row,
// plane s, goes to column (b / nb) * tb + s * nb + b % nb; nb is a multiple
// of 8, so 8 consecutive bytes of a plane are 8 consecutive columns.
template <class Val>
__device__ __forceinline__ void write_tile(float* out, Val val, int tid, int qblk, int qb, int byte0,
                                           int nbytes, int nb, long long ntp) {
#pragma unroll 4
  for (int it = 0; it < kN * 8 * (kBytes / 4) / kThreads; ++it) {
    const int i = tid + it * kThreads;
    const int n = i >> 6, s = (i >> 3) & 7, j = (i & 7) * 4;
    const int q = qblk * kN + n;
    const int b = byte0 + j;
    if (q < qb && b < nbytes) {
      const long long col = (long long)(b / nb) * (8 * nb) + s * nb + b % nb;
      *reinterpret_cast<float4*>(out + q * ntp + col) = val(n, s, j);
    }
  }
}

__device__ __forceinline__ uint32_t bf16_pair(float lo, float hi) {
  return (uint32_t)__bfloat16_as_ushort(__float2bfloat16_rn(lo)) |
         ((uint32_t)__bfloat16_as_ushort(__float2bfloat16_rn(hi)) << 16);
}

template <class Val>
__device__ __forceinline__ void write_tile(__nv_bfloat16* out, Val val, int tid, int qblk, int qb,
                                           int byte0, int nbytes, int nb, long long ntp) {
#pragma unroll 4
  for (int it = 0; it < kN * 8 * (kBytes / 8) / kThreads; ++it) {
    const int i = tid + it * kThreads;
    const int n = i >> 5, s = (i >> 2) & 7, j = (i & 3) * 8;
    const int q = qblk * kN + n;
    const int b = byte0 + j;
    if (q < qb && b < nbytes) {
      const long long col = (long long)(b / nb) * (8 * nb) + s * nb + b % nb;
      const float4 lo = val(n, s, j), hi = val(n, s, j + 4);
      *reinterpret_cast<uint4*>(out + q * ntp + col) =
          make_uint4(bf16_pair(lo.x, lo.y), bf16_pair(lo.z, lo.w), bf16_pair(hi.x, hi.y),
                     bf16_pair(hi.z, hi.w));
    }
  }
}

// P bf16 weight parts (1: bf16 mode, 3: f32 mode); Out: float or bf16.
template <int P, typename Out>
__global__ void __launch_bounds__(kThreads, 1)
score_full_kernel(const uint8_t* __restrict__ packed,   // (V, nbytes)
                  const int* __restrict__ ids,          // (U,)
                  const uint16_t* __restrict__ wimg,    // bf16 weight image, see kernel_a_weights
                  const float* __restrict__ sums,       // (ntp,)
                  const float* __restrict__ maxint,     // (QB,)
                  Out* __restrict__ out,                // (QB, ntp), pi columns
                  int qb, int u, int nbytes, int nb, int nt) {
  using K = Cfg<P>;
  extern __shared__ __align__(128) uint8_t smem[];
  uint16_t* s_w = reinterpret_cast<uint16_t*>(smem);                 // [kStages][P][kWTile]
  uint8_t* s_r = smem + (size_t)kStages * P * kWTile * 2;            // [kStages][kKC][kRowStride]
  float* s_tile = reinterpret_cast<float*>(smem);                    // [kN][kQS] after the loop
  float* s_mi = reinterpret_cast<float*>(smem + K::SMEM - kN * 4);   // [kN]

  const int tid = threadIdx.x;
  const int warp = tid >> 5, lane = tid & 31;
  const int g = lane >> 2, tig = lane & 3;
  const int byte0 = blockIdx.x * kBytes;
  const int qblk = blockIdx.y;
  const int n_qblk = gridDim.y;
  const long long ntp = 8LL * nbytes;

  if (8LL * byte0 >= nt) {
    // every title of the block lies past nt
    write_tile(out, [](int, int, int) { return make_float4(-1.f, -1.f, -1.f, -1.f); }, tid, qblk, qb,
               byte0, nbytes, nb, ntp);
    return;
  }

  if (tid < kN) {
    const int q = qblk * kN + tid;
    s_mi[tid] = q < qb ? maxint[q] : 0.f;
  }
  // the thread's titles: rows g and g+8 of its warp's tile mt are bit plane
  // s0 + mt of block bytes jb and jb + 8; their idf sums are read now so
  // that the latency hides behind the contraction
  const int s0 = 2 * (warp & 3);
  const int jb = 16 * (warp >> 2) + g;
  float tsum[2][2];
#pragma unroll
  for (int mt = 0; mt < 2; ++mt)
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const int b = byte0 + jb + 8 * h;
      tsum[mt][h] = b < nbytes ? __ldg(sums + 8LL * b + s0 + mt) : 0.f;
    }

  const int nch = (u + kKC - 1) / kKC;
  const long long w_part = (long long)n_qblk * nch * kWTile;
  // loading thread (lk, lh) copies the block's 16 bytes lh of row lk of
  // each chunk; `id` is that row's index into the packed index, read one
  // chunk ahead of its use
  const int lk = tid >> 1, lh = tid & 1;
  const bool lh_in = byte0 + 16 * lh < nbytes;
  int id = (tid < kKC * 2 && lk < u) ? __ldg(ids + lk) : 0;
  auto load = [&](int c) {
    if (c < nch) {
      const int st = c & (kStages - 1);
      load_weights<P>(s_w + (long long)st * P * kWTile, wimg + ((long long)qblk * nch + c) * kWTile,
                      w_part, tid);
      if (tid < kKC * 2) {
        const int r = c * kKC + lk;
        cp_async<16>(smem_addr(s_r + st * kRowStage + lk * kRowStride + 16 * lh),
                     packed + (long long)id * nbytes + byte0 + 16 * lh, r < u && lh_in);
        id = r + kKC < u ? __ldg(ids + r + kKC) : 0;
      }
    }
    cp_async_commit();  // an empty group past the end keeps the count aligned
  };

  float acc[2][64];

#pragma unroll
  for (int c = 0; c < kLook; ++c) load(c);

  auto chunk = [&](int c, uint32_t (&a)[kKC / 16][2][4]) {
    const int st = c & (kStages - 1);
    const uint8_t* rs = s_r + st * kRowStage + jb;
    auto build = [&](uint32_t (&bits)[kKC / 16][2][4]) {
#pragma unroll
      for (int ks = 0; ks < kKC / 16; ++ks) {
        const int k0 = ks * 16 + 2 * tig;
        // byte jb (h = 0, row g) or jb + 8 (h = 1, row g+8) of staged row k
#define RB(k, h) ((uint32_t)rs[(k) * kRowStride + 8 * (h)])
        const uint32_t r0 = RB(k0, 0), r1 = RB(k0 + 1, 0), r2 = RB(k0, 1), r3 = RB(k0 + 1, 1);
        const uint32_t r4 = RB(k0 + 8, 0), r5 = RB(k0 + 9, 0), r6 = RB(k0 + 8, 1), r7 = RB(k0 + 9, 1);
#undef RB
#pragma unroll
        for (int mt = 0; mt < 2; ++mt) {
          bits[ks][mt][0] = bit_pair(r0, r1, s0 + mt);   // row g, k0..k0+1
          bits[ks][mt][1] = bit_pair(r2, r3, s0 + mt);   // row g+8
          bits[ks][mt][2] = bit_pair(r4, r5, s0 + mt);   // row g, k0+8..k0+9
          bits[ks][mt][3] = bit_pair(r6, r7, s0 + mt);   // row g+8
        }
      }
    };
    mma_chunk<P, 2>(c, smem_addr(s_w + (long long)st * P * kWTile), c == 0, acc, 0, a, load, build);
  };

  uint32_t a_even[kKC / 16][2][4], a_odd[kKC / 16][2][4];
  int kc = 0;
  for (; kc + 1 < nch; kc += 2) {
    chunk(kc, a_even);
    chunk(kc + 1, a_odd);
  }
  if (kc < nch) chunk(kc, a_even);
  asm volatile("wgmma.wait_group.sync.aligned 0;\n" ::: "memory");
  fence_acc(acc[0]);
  fence_acc(acc[1]);
  cp_async_wait<0>();
  __syncthreads();                                 // the stages are free for the tile

  // thread (g, tig) holds rows g and g+8 of tile mt at the 32 queries
  // n = 8j + 2tig + e, accumulators 4j + e and 4j + 2 + e
#pragma unroll
  for (int mt = 0; mt < 2; ++mt) {
    const int s = s0 + mt;
    const long long t = 8LL * (byte0 + jb) + s;    // row g's title; row g+8's is t + 64
    const bool pad0 = t >= nt, pad1 = t + 64 >= nt;
    float* dst = s_tile + s * kBytes + jb;
#pragma unroll
    for (int c = 0; c < 32; ++c) {
      const int n = 8 * (c >> 1) + 2 * tig + (c & 1);
      const float mi = s_mi[n];
      const int i0 = 2 * c - (c & 1), i1 = i0 + 2;
      const float n0 = acc[mt][i0], n1 = acc[mt][i1];
      const float j0 = div_rn(n0, fmaxf((tsum[mt][0] + mi) - n0, 1e-9f));
      const float j1 = div_rn(n1, fmaxf((tsum[mt][1] + mi) - n1, 1e-9f));
      dst[n * kQS] = pad0 ? -1.f : j0;
      dst[n * kQS + 8] = pad1 ? -1.f : j1;
    }
  }
  __syncthreads();
  write_tile(out, [&](int n, int s, int j) {
    return *reinterpret_cast<const float4*>(s_tile + n * kQS + s * kBytes + j);
  }, tid, qblk, qb, byte0, nbytes, nb, ntp);
}

template <int P, typename Out>
cudaError_t launch(const uint8_t* packed, const int* ids, const uint16_t* wimg, const float* sums,
                   const float* maxint, Out* out, int qb, int u, int nbytes, int nb, int nt,
                   cudaStream_t stream) {
  using K = Cfg<P>;
  auto kernel = score_full_kernel<P, Out>;
  cudaError_t err = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                                         (int)K::SMEM);
  if (err != cudaSuccess) return err;
  dim3 grid((nbytes + kBytes - 1) / kBytes, (qb + kN - 1) / kN);
  kernel<<<grid, kThreads, K::SMEM, stream>>>(packed, ids, wimg, sums, maxint, out, qb, u, nbytes, nb,
                                              nt);
  return cudaGetLastError();
}

}  // namespace

extern "C" int doppel_score_full(const void* packed, const void* ids, const void* wimg,
                                 const void* sums, const void* maxint, void* out, int parts,
                                 int out_bf16, int qb, int u, long long nbytes, int tb, int nt,
                                 void* stream) {
  if (u < 1 || tb % 64 || nbytes % 16 || (nbytes * 8) % tb || nbytes * 8 > INT_MAX)
    return (int)cudaErrorInvalidValue;
  const uint8_t* pk = static_cast<const uint8_t*>(packed);
  const int* id = static_cast<const int*>(ids);
  const uint16_t* wi = static_cast<const uint16_t*>(wimg);
  const float* sm = static_cast<const float*>(sums);
  const float* mi = static_cast<const float*>(maxint);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const int nbi = (int)nbytes, nb = tb / 8;
  if (parts == 3 && !out_bf16)
    return (int)launch<3>(pk, id, wi, sm, mi, static_cast<float*>(out), qb, u, nbi, nb, nt, st);
  if (parts == 1 && !out_bf16)
    return (int)launch<1>(pk, id, wi, sm, mi, static_cast<float*>(out), qb, u, nbi, nb, nt, st);
  if (parts == 1 && out_bf16)
    return (int)launch<1>(pk, id, wi, sm, mi, static_cast<__nv_bfloat16*>(out), qb, u, nbi, nb, nt,
                          st);
  return (int)cudaErrorInvalidValue;
}
