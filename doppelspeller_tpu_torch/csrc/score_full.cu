// Kernel D: the full (QB, ntp) IDF-weighted Jaccard matrix of a query block
// against every title, for NVIDIA Hopper (sm_90a).  Kernel E (the v1 entry,
// sparse weights, f32 output) runs this kernel too.
//
// Replaces the TPU kernels doppelspeller_tpu/ops/jaccard_pallas.py
// _score_kernel_v2 (with _accumulate_numerator and _unpack_mm_chunk, folds
// = 1), entered through jaccard_topk_pallas_v2(window_select=False), and
// _score_kernel, entered through jaccard_topk_pallas.
//
// What it computes.  rows: u8 (U, nbytes) gathered union rows of the packed
// index, bit t%8 of byte t/8 set when title t holds the row's trigram.  w:
// f32 (QB, U) dense weights (rounded to bf16 by the wrapper in bf16 mode).
// num[q, t] = sum_r w[q, r] * bit[r, t] in f32 (true f32, no TF32);
// jacc = num / max((sums[t] + maxint[q]) - num, 1e-9), and -1 for t >= nt.
// The output is f32 or bf16 (rounded to nearest even) in the reference's
// column order: within each tile of tb titles, column c holds tile-local
// title 8*(c mod nb) + c div nb (nb = tb/8), so tile-local title 8*b + s
// goes to column s*nb + b.  The exact top-k breaks ties toward the lower
// column, so this order decides which of equal-scored titles are kept.
//
// What bounds it on the H100.  QB * ntp * U bit-gated f32 adds (128 x
// 524,288 x 3,072 = 2.1e11 at 500k titles): the FP32 pipes.  The output is
// 268 MB per block in f32, written once.
//
// What the design does about it.  One thread per byte (8 titles) and block
// of 128 bytes, a slice of 8 queries per block: 64 f32 accumulators in
// registers.  Chunks of 64 rows x 128 bytes and the slice's 64 x 8 weights
// are staged in shared memory with 16-byte loads.  Per row a thread turns
// its byte into eight 0.0/1.0 floats once and runs 64 FMAs (w * bit + acc
// is exactly the gated add), with the weights as warp-uniform broadcasts.
// Writes are coalesced: for fixed (query, bit) neighbouring threads write
// neighbouring columns.  Moving the contraction to tensor cores is later
// work (and in f32 mode would have to stay exact f32).

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kBytes = 128;       // bytes of a row per block (= threads)
constexpr int kQuerySlice = 8;    // queries per block
constexpr int kRowChunk = 64;     // rows staged in shared memory per step

__device__ __forceinline__ void store(float* out, long long i, float v) { out[i] = v; }
__device__ __forceinline__ void store(__nv_bfloat16* out, long long i, float v) {
  out[i] = __float2bfloat16_rn(v);
}

template <typename Out>
__global__ void __launch_bounds__(kBytes)
score_full_kernel(const uint8_t* __restrict__ rows,    // (U, nbytes)
                  const float* __restrict__ w,         // (QB, U)
                  const float* __restrict__ sums,      // (ntp,)
                  const float* __restrict__ maxint,    // (QB,)
                  Out* __restrict__ out,               // (QB, ntp), pi columns
                  int qb, long long nbytes, int u, int nb_tile, int nt) {
  __shared__ __align__(16) uint8_t s_bytes[kRowChunk][kBytes];
  __shared__ __align__(16) float s_w[kRowChunk][kQuerySlice];

  const long long byte0 = (long long)blockIdx.x * kBytes;
  const long long g = byte0 + threadIdx.x;
  const int q0 = blockIdx.y * kQuerySlice;

  float acc[kQuerySlice][8];
#pragma unroll
  for (int q = 0; q < kQuerySlice; ++q)
#pragma unroll
    for (int s = 0; s < 8; ++s) acc[q][s] = 0.f;

  for (int r0 = 0; r0 < u; r0 += kRowChunk) {
    const int nr = min(kRowChunk, u - r0);
    constexpr int V16 = kBytes / 16;
    for (int i = threadIdx.x; i < nr * V16; i += kBytes) {
      const int rr = i / V16;
      const int v = i % V16;
      const long long off = byte0 + v * 16;
      uint4 val = make_uint4(0u, 0u, 0u, 0u);
      if (off < nbytes) val = *reinterpret_cast<const uint4*>(rows + (long long)(r0 + rr) * nbytes + off);
      reinterpret_cast<uint4*>(&s_bytes[rr][0])[v] = val;
    }
    for (int i = threadIdx.x; i < kQuerySlice * kRowChunk; i += kBytes) {
      const int qq = i / kRowChunk;
      const int rr = i % kRowChunk;
      const int q = q0 + qq;
      s_w[rr][qq] = (rr < nr && q < qb) ? w[(long long)q * u + r0 + rr] : 0.f;
    }
    __syncthreads();
#pragma unroll 4
    for (int rr = 0; rr < nr; ++rr) {
      const unsigned by = s_bytes[rr][threadIdx.x];
      float bit[8];
#pragma unroll
      for (int s = 0; s < 8; ++s) bit[s] = __uint_as_float(((by >> s) & 1u) * 0x3F800000u);
      const float4 wa = *reinterpret_cast<const float4*>(&s_w[rr][0]);
      const float4 wb = *reinterpret_cast<const float4*>(&s_w[rr][4]);
      const float wq[kQuerySlice] = {wa.x, wa.y, wa.z, wa.w, wb.x, wb.y, wb.z, wb.w};
#pragma unroll
      for (int q = 0; q < kQuerySlice; ++q)
#pragma unroll
        for (int s = 0; s < 8; ++s) acc[q][s] = fmaf(wq[q], bit[s], acc[q][s]);
    }
    __syncthreads();
  }

  if (g >= nbytes) return;
  const long long ntp = nbytes * 8;
  const long long tb = (long long)nb_tile * 8;
  const long long col0 = (g / nb_tile) * tb + (g % nb_tile);   // column of bit 0
  const float4 sa = reinterpret_cast<const float4*>(sums)[2 * g];
  const float4 sb = reinterpret_cast<const float4*>(sums)[2 * g + 1];
  const float st[8] = {sa.x, sa.y, sa.z, sa.w, sb.x, sb.y, sb.z, sb.w};
#pragma unroll
  for (int q = 0; q < kQuerySlice; ++q) {
    if (q0 + q >= qb) break;
    const float mi = maxint[q0 + q];
    Out* row = out + (long long)(q0 + q) * ntp;
#pragma unroll
    for (int s = 0; s < 8; ++s) {
      const float num = acc[q][s];
      const float denom = (st[s] + mi) - num;
      float j = num / fmaxf(denom, 1e-9f);
      if (g * 8 + s >= nt) j = -1.f;
      store(row, col0 + (long long)s * nb_tile, j);
    }
  }
}

}  // namespace

extern "C" int doppel_score_full(const void* rows, const void* w, const void* sums,
                                 const void* maxint, void* out, int out_bf16, int qb,
                                 long long nbytes_row, int u, int tb, int nt, void* stream) {
  if (tb % 8 || nbytes_row % 16 || (nbytes_row * 8) % tb) return (int)cudaErrorInvalidValue;
  dim3 grid((unsigned)((nbytes_row + kBytes - 1) / kBytes), (qb + kQuerySlice - 1) / kQuerySlice);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const uint8_t* r = static_cast<const uint8_t*>(rows);
  const float* wf = static_cast<const float*>(w);
  const float* sm = static_cast<const float*>(sums);
  const float* mi = static_cast<const float*>(maxint);
  if (out_bf16) {
    score_full_kernel<__nv_bfloat16><<<grid, kBytes, 0, st>>>(
        r, wf, sm, mi, static_cast<__nv_bfloat16*>(out), qb, nbytes_row, u, tb / 8, nt);
  } else {
    score_full_kernel<float><<<grid, kBytes, 0, st>>>(
        r, wf, sm, mi, static_cast<float*>(out), qb, nbytes_row, u, tb / 8, nt);
  }
  return (int)cudaGetLastError();
}
