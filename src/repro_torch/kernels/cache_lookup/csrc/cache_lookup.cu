// Batched set-associative probe over the tiering runtime's cache metadata:
// for each of K block ids, hash to its set, compare the set's tag row, and
// return (hit, way, slot = set * ways + way, or -1 on a miss).
//
// Replaces the TPU kernel cache_lookup
// (src/repro/kernels/cache_lookup/kernel.py, pl.pallas_call at :58), which
// ran one grid cell per query with that query's tag row staged in VMEM; its
// plain version here is repro_torch/kernels/cache_lookup/ref.py.
//
// What bounds it on an H100: one probe reads a 4-byte query and one tag
// row (64 B at 16 ways) and writes 9 bytes, so K = 256 probes need about
// 20 KB: some 6 ns of the card's 3.35 TB/s. Launch latency and one
// dependent load (query, then its row) bound it, not bytes or operations.
// The design is one warp per query with the ways spread over the lanes (in
// chunks of 32), one coalesced load of the row, and __ballot_sync + __ffs
// so a tie returns the lowest matching way, as the reference's argmax does.
// The set hash is the reference's uint32 arithmetic:
// ((q * 0x9E3779B1) >> 7) % sets.
//
// Built with nvcc into a shared library with a plain C interface and called
// through ctypes.

#include <cstdint>

#include <cuda_runtime.h>

namespace {

constexpr unsigned kFull = 0xffffffffu;
constexpr int kWarpsPerBlock = 8;

__global__ void cache_lookup_kernel(const int* __restrict__ tags,
                                    const int* __restrict__ queries,
                                    uint8_t* __restrict__ hit_out,
                                    int* __restrict__ way_out,
                                    int* __restrict__ slot_out, int K,
                                    int sets, int ways) {
  const int lane = threadIdx.x & 31;
  const int i = blockIdx.x * kWarpsPerBlock + (threadIdx.x >> 5);
  if (i >= K) return;  // the whole warp leaves together
  const uint32_t q = static_cast<uint32_t>(queries[i]);
  const uint32_t si = ((q * 0x9E3779B1u) >> 7) % static_cast<uint32_t>(sets);
  const int tag = static_cast<int>(q + 1u);  // int32 wrap-around, as in JAX
  const int* row = tags + static_cast<size_t>(si) * ways;
  int way = -1;
  for (int base = 0; base < ways; base += 32) {
    const int w = base + lane;
    const unsigned m = __ballot_sync(kFull, w < ways && row[w] == tag);
    if (m != 0u) {  // the same on every lane
      way = base + __ffs(m) - 1;
      break;
    }
  }
  if (lane == 0) {
    hit_out[i] = way >= 0 ? 1 : 0;
    way_out[i] = way >= 0 ? way : 0;
    slot_out[i] = way >= 0 ? static_cast<int>(si) * ways + way : -1;
  }
}

}  // namespace

extern "C" int cache_lookup(const void* tags, const void* queries, void* hit,
                            void* way, void* slot, int K, int sets, int ways,
                            void* stream) {
  if (K <= 0) return 0;
  if (sets <= 0 || ways <= 0) return static_cast<int>(cudaErrorInvalidValue);
  const dim3 block(32 * kWarpsPerBlock);
  const dim3 grid((K + kWarpsPerBlock - 1) / kWarpsPerBlock);
  cache_lookup_kernel<<<grid, block, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const int*>(tags), static_cast<const int*>(queries),
      static_cast<uint8_t*>(hit), static_cast<int*>(way),
      static_cast<int*>(slot), K, sets, ways);
  return static_cast<int>(cudaGetLastError());
}
