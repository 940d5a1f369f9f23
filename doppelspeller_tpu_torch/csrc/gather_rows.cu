// Kernel C: gather rows of the packed trigram index, for NVIDIA Hopper
// (sm_90a).
//
// Replaces the TPU kernel doppelspeller_tpu/ops/jaccard_pallas.py
// _gather_rows_kernel, entered through gather_rows_pallas.
//
// What it computes.  out[i] = src[ids[i]]: (U,) int32 row ids into the
// (V, nbytes) u8 bit-packed occupancy matrix give the (U, nbytes) u8 rows of
// a query block's trigram union.  The TPU kernel needs the (V, 32, NB/32)
// page layout only for Mosaic's tiling; here every row of the flat matrix is
// already contiguous.
//
// What bounds it on the H100.  Pure data movement: U * nbytes bytes read and
// written (3,072 x 65,536 = 201 MB each way at 500k titles), so HBM
// bandwidth.
//
// What the design does about it.  One block per output row; each thread
// copies 16-byte vectors, four in flight, neighbouring threads on
// neighbouring addresses.  The wrapper checks that nbytes is a multiple of
// 16 and that both matrices are 16-byte aligned.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;
constexpr int kUnroll = 4;

__global__ void __launch_bounds__(kThreads)
gather_rows_kernel(const uint4* __restrict__ src, const int* __restrict__ ids,
                   uint4* __restrict__ out, long long n16) {
  const uint4* s = src + (long long)ids[blockIdx.x] * n16;
  uint4* d = out + (long long)blockIdx.x * n16;
  for (long long i0 = threadIdx.x; i0 < n16; i0 += (long long)kThreads * kUnroll) {
    uint4 v[kUnroll];
#pragma unroll
    for (int j = 0; j < kUnroll; ++j) {
      const long long i = i0 + (long long)j * kThreads;
      if (i < n16) v[j] = s[i];
    }
#pragma unroll
    for (int j = 0; j < kUnroll; ++j) {
      const long long i = i0 + (long long)j * kThreads;
      if (i < n16) d[i] = v[j];
    }
  }
}

}  // namespace

extern "C" int doppel_gather_rows(const void* src, const void* ids, void* out, int n_ids,
                                  long long nbytes_row, void* stream) {
  if (nbytes_row % 16) return (int)cudaErrorInvalidValue;
  gather_rows_kernel<<<n_ids, kThreads, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const uint4*>(src), static_cast<const int*>(ids), static_cast<uint4*>(out),
      nbytes_row / 16);
  return (int)cudaGetLastError();
}
