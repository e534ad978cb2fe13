// Gather K rows of a block pool: out[k] = pool[idx[k]], copied as bytes so
// one kernel serves every element type.
//
// Replaces the TPU kernel block_gather
// (src/repro/kernels/block_gather/kernel.py, pl.pallas_call at :35), which
// streamed one pool row per grid cell HBM -> VMEM -> HBM; its plain version
// here is repro_torch/kernels/block_gather/ref.py (pool[idx]).
//
// What bounds it on an H100: bytes. Each row is read once and written once,
// 2 * K * row_bytes in all (48 MB for 8 expert slabs of 3 MB: some 14 us at
// 3.35 TB/s), with no arithmetic. The design spreads the copy over the
// whole card: a block copies one 32 KB chunk of one row (a 3 MB slab is 96
// blocks), 256 threads with 16-byte vector loads and stores where both
// the source and the destination row are 16-byte aligned, and a byte loop
// for the tail and for unaligned rows. An index below 0 counts from the
// end and the result is clamped into the pool, as the JAX gather does.
//
// Built with nvcc into a shared library with a plain C interface and called
// through ctypes.

#include <cstdint>

#include <cuda_runtime.h>

namespace {

constexpr int kThreads = 256;
constexpr long long kChunkBytes = kThreads * 16LL * 8;  // 32 KB per block

__global__ void __launch_bounds__(kThreads)
    block_gather_kernel(const uint8_t* __restrict__ pool,
                        const int* __restrict__ idx, uint8_t* __restrict__ out,
                        long long num_rows, long long row_bytes) {
  long long r = idx[blockIdx.y];
  if (r < 0) r += num_rows;
  r = r < 0 ? 0 : (r >= num_rows ? num_rows - 1 : r);
  const uint8_t* src = pool + r * row_bytes;
  uint8_t* dst = out + static_cast<long long>(blockIdx.y) * row_bytes;
  const long long begin = static_cast<long long>(blockIdx.x) * kChunkBytes;
  const long long end = min(begin + kChunkBytes, row_bytes);
  long long tail = begin;
  if (((reinterpret_cast<uintptr_t>(src) | reinterpret_cast<uintptr_t>(dst)) & 15) == 0) {
    // begin is a multiple of 16, so the chunk's vectors stay aligned
    const long long n16 = (end - begin) >> 4;
    const uint4* s = reinterpret_cast<const uint4*>(src + begin);
    uint4* d = reinterpret_cast<uint4*>(dst + begin);
#pragma unroll 4
    for (long long i = threadIdx.x; i < n16; i += kThreads) d[i] = __ldg(s + i);
    tail = begin + (n16 << 4);
  }
  for (long long b = tail + threadIdx.x; b < end; b += kThreads) dst[b] = src[b];
}

}  // namespace

extern "C" int block_gather(const void* pool, const void* idx, void* out,
                            long long num_rows, long long row_bytes, int K,
                            void* stream) {
  if (K <= 0 || row_bytes <= 0) return 0;
  if (num_rows <= 0 || K > 65535) return static_cast<int>(cudaErrorInvalidValue);
  const dim3 grid(static_cast<unsigned>((row_bytes + kChunkBytes - 1) / kChunkBytes), K);
  block_gather_kernel<<<grid, kThreads, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const uint8_t*>(pool), static_cast<const int*>(idx),
      static_cast<uint8_t*>(out), num_rows, row_bytes);
  return static_cast<int>(cudaGetLastError());
}
