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
// bandwidth: 0.120 ms at 3.35 TB/s.
//
// What the design does about it.  The grid is flat over (row, 32 KB chunk)
// items, row-major, so neighbouring blocks stream neighbouring chunks of one
// row and no block waits on a long row alone.  Each thread issues all eight
// of its 16-byte loads before its first store (32 KB in flight a block,
// neighbouring threads on neighbouring addresses), and both loads and
// stores carry the streaming hint (ld/st.global.cs, evict first): nothing
// read or written here is read again, so neither should displace what is.
// The wrapper checks that nbytes is a multiple of 16 and that both
// matrices are 16-byte aligned.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;
constexpr int kDepth = 8;                        // 16-byte vectors in flight a thread
constexpr long long kChunk = kThreads * kDepth;  // vectors a block copies: 32 KB

__global__ void __launch_bounds__(kThreads)
gather_rows_kernel(const uint4* __restrict__ src, const int* __restrict__ ids,
                   uint4* __restrict__ out, long long n16, long long chunks) {
  const long long row = blockIdx.x / chunks;
  const long long i0 = (blockIdx.x - row * chunks) * kChunk + threadIdx.x;
  const uint4* s = src + (long long)ids[row] * n16;
  uint4* d = out + row * n16;
  uint4 v[kDepth];
#pragma unroll
  for (int j = 0; j < kDepth; ++j) {
    const long long i = i0 + (long long)j * kThreads;
    if (i < n16) v[j] = __ldcs(s + i);
  }
#pragma unroll
  for (int j = 0; j < kDepth; ++j) {
    const long long i = i0 + (long long)j * kThreads;
    if (i < n16) __stcs(d + i, v[j]);
  }
}

}  // namespace

extern "C" int doppel_gather_rows(const void* src, const void* ids, void* out, int n_ids,
                                  long long nbytes_row, void* stream) {
  if (nbytes_row % 16 || n_ids < 1) return (int)cudaErrorInvalidValue;
  const long long n16 = nbytes_row / 16;
  if (n16 == 0) return (int)cudaSuccess;
  const long long chunks = (n16 + kChunk - 1) / kChunk;
  if (chunks * n_ids > 0x7fffffffLL) return (int)cudaErrorInvalidValue;
  gather_rows_kernel<<<(unsigned)(chunks * n_ids), kThreads, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const uint4*>(src), static_cast<const int*>(ids), static_cast<uint4*>(out), n16,
      chunks);
  return (int)cudaGetLastError();
}
