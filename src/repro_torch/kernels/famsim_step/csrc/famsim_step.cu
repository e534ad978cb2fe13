// One simulator event's DRAM-cache work for every lane (system x node) in
// one launch: C sequential prefetch-fill inserts, the demand probe with its
// recency touch, then P tag-only probes, on padded (sets, ways) int32
// metadata masked down to each lane's effective geometry.
//
// Replaces the TPU kernel fused_cache_step
// (src/repro/kernels/famsim_step/kernel.py, pl.pallas_call at :152), which
// ran once per node per event; its plain version here is
// repro_torch/kernels/famsim_step/ref.py::cache_step_ref.
//
// What bounds it on an H100: at the fig08 grid (72 lanes, 16 ways, C = 8,
// P = 6) one launch needs a 64 B tag row per enabled fill, demand and
// probe and a 64 B lru row per evicting fill, about 1 KB per lane and
// under 100 KB in all (chip_smoke.py counts it from each run's data):
// some 0.02 us of the card's 3.35 TB/s. So the launch latency and the
// chain of 8 dependent fills (each reads the row the previous one may have
// written) bound it, not bytes or operations. The design takes one launch
// per event for ALL lanes (never one per node), one warp per lane so the chain stays
// inside a warp with no block-level barrier, a set row spread over the
// warp's threads (way w on thread w % 32, in chunks of 32 ways), and
// ballot/__ffs and shuffle reductions that break ties to the lowest way as
// the JAX reference's argmax/argmin do. Folding the event loop into a
// persistent kernel is the next step.
//
// Built with nvcc into a shared library with a plain C interface and
// called through ctypes; the caller guarantees num_sets <= sets_pad.

#include <climits>
#include <cstddef>
#include <cstdint>

#include <cuda_runtime.h>

namespace {

constexpr unsigned kFull = 0xffffffffu;
constexpr int kWarpsPerBlock = 4;
constexpr int kModeLru = 0;
constexpr int kModeSrrip = 1;

__device__ __forceinline__ int set_index(int blk, int num_sets) {
  const uint32_t h = (static_cast<uint32_t>(blk) * 0x9E3779B1u) >> 7;
  return static_cast<int>(h % static_cast<uint32_t>(num_sets));
}

// Lexicographic (value, index) reductions over the warp: every thread ends
// with the same pair, the lowest index among equal extreme values.
__device__ __forceinline__ void warp_argmin(int& v, int& i) {
  for (int off = 16; off > 0; off >>= 1) {
    const int ov = __shfl_xor_sync(kFull, v, off);
    const int oi = __shfl_xor_sync(kFull, i, off);
    if (ov < v || (ov == v && oi < i)) { v = ov; i = oi; }
  }
}

__device__ __forceinline__ void warp_argmax(int& v, int& i) {
  for (int off = 16; off > 0; off >>= 1) {
    const int ov = __shfl_xor_sync(kFull, v, off);
    const int oi = __shfl_xor_sync(kFull, i, off);
    if (ov > v || (ov == v && oi < i)) { v = ov; i = oi; }
  }
}

// First way < ways_pad whose tag equals `tag` among the effective ways, or -1.
__device__ __forceinline__ int first_match(const int* row, int tag, int eff_ways,
                                           int ways_pad, int t) {
  for (int base = 0; base < ways_pad; base += 32) {
    const int w = base + t;
    const bool ok = w < ways_pad && w < eff_ways && row[w] == tag;
    const unsigned bits = __ballot_sync(kFull, ok);
    if (bits) return base + __ffs(bits) - 1;
  }
  return -1;
}

template <int kMode>
__global__ void __launch_bounds__(32 * kWarpsPerBlock)
cache_step_kernel(int* __restrict__ tags, int* __restrict__ lru,
                  int* __restrict__ stamps,
                  const int* __restrict__ fills,
                  const uint8_t* __restrict__ fill_en,
                  const int* __restrict__ demand,
                  const uint8_t* __restrict__ demand_en,
                  const int* __restrict__ probes,
                  const int* __restrict__ num_sets,
                  const int* __restrict__ ways,
                  uint8_t* __restrict__ hit_out,
                  uint8_t* __restrict__ probe_hit_out,
                  int lanes, int sets_pad, int ways_pad, int C, int P,
                  int max_rrpv) {
  const int t = threadIdx.x & 31;
  const int lane = blockIdx.x * kWarpsPerBlock + (threadIdx.x >> 5);
  if (lane >= lanes) return;  // uniform per warp
  const int ns = num_sets[lane];
  const int ew = ways[lane];
  const size_t lane_off = static_cast<size_t>(lane) * sets_pad * ways_pad;
  int* const lane_tags = tags + lane_off;
  int* const lane_lru = lru + lane_off;
  int stamp = stamps[lane];

  // 1) retire prefetch fills, in order: same-set fills interact
  for (int c = 0; c < C; ++c) {
    const int blk = fills[static_cast<size_t>(lane) * C + c];
    const bool en = fill_en[static_cast<size_t>(lane) * C + c] != 0;
    const size_t row = static_cast<size_t>(set_index(blk, ns)) * ways_pad;
    int* const rt = lane_tags + row;
    int* const rl = lane_lru + row;
    const int tag = blk + 1;
    stamp += en ? 1 : 0;
    const int present = first_match(rt, tag, ew, ways_pad, t);
    const int vacant = present >= 0 ? -1 : first_match(rt, 0, ew, ways_pad, t);

    int victim;
    int bump = 0;
    if (kMode == kModeLru) {
      // min stamp over the effective ways (padded ways read as INT_MAX)
      int bv = INT_MAX, bi = INT_MAX;
      for (int w = t; w < ways_pad; w += 32) {
        const int v = w < ew ? rl[w] : INT_MAX;
        if (v < bv || (v == bv && w < bi)) { bv = v; bi = w; }
      }
      warp_argmin(bv, bi);
      victim = bi;
    } else {
      // SRRIP: age the effective ways until one reaches max_rrpv, then
      // evict the first way holding the aged maximum
      int mx = INT_MIN;
      for (int w = t; w < ways_pad; w += 32) {
        const int v = w < ew ? rl[w] : 0;
        mx = v > mx ? v : mx;
      }
      mx = __reduce_max_sync(kFull, mx);
      bump = max_rrpv - mx > 0 ? max_rrpv - mx : 0;
      int bv = INT_MIN, bi = INT_MAX;
      for (int w = t; w < ways_pad; w += 32) {
        const int v = w < ew ? rl[w] + bump : -1;
        if (v > bv || (v == bv && w < bi)) { bv = v; bi = w; }
      }
      warp_argmax(bv, bi);
      victim = bi;
    }
    const int way = present >= 0 ? present : (vacant >= 0 ? vacant : victim);

    if (en) {
      if (kMode == kModeLru) {
        if (t == (way & 31)) {
          rt[way] = tag;
          rl[way] = stamp;
        }
      } else {
        // aging applies only on the eviction path; a redundant fill of a
        // present block re-references it (RRPV 0)
        const bool evicting = present < 0 && vacant < 0;
        for (int w = t; w < ways_pad; w += 32) {
          int v = rl[w];
          if (evicting && w < ew) v += bump;
          if (w == way) {
            v = present >= 0 ? 0 : max_rrpv - 1;
            rt[w] = tag;
          }
          rl[w] = v;
        }
      }
    }
    __syncwarp();
  }

  // 2) demand probe + recency touch on the post-fill state
  {
    const int q = demand[lane];
    const size_t row = static_cast<size_t>(set_index(q, ns)) * ways_pad;
    const int way = first_match(lane_tags + row, q + 1, ew, ways_pad, t);
    const bool hit = way >= 0 && demand_en[lane] != 0;
    stamp += hit ? 1 : 0;
    if (hit && t == (way & 31)) lane_lru[row + way] = kMode == kModeLru ? stamp : 0;
    if (t == 0) {
      hit_out[lane] = hit ? 1 : 0;
      stamps[lane] = stamp;
    }
  }

  // 3) tag-only probes (a touch never writes tags, so these are order-free)
  for (int j = 0; j < P; ++j) {
    const int b = probes[static_cast<size_t>(lane) * P + j];
    const int* rt = lane_tags + static_cast<size_t>(set_index(b, ns)) * ways_pad;
    const int way = first_match(rt, b + 1, ew, ways_pad, t);
    if (t == 0) probe_hit_out[static_cast<size_t>(lane) * P + j] = way >= 0 ? 1 : 0;
  }
}

}  // namespace

extern "C" int famsim_cache_step(void* tags, void* lru, void* stamps,
                                 const void* fills, const void* fill_en,
                                 const void* demand, const void* demand_en,
                                 const void* probes, const void* num_sets,
                                 const void* ways, void* hit_out,
                                 void* probe_hit_out, int lanes, int sets_pad,
                                 int ways_pad, int C, int P, int mode,
                                 int max_rrpv, void* stream) {
  if (mode != kModeLru && mode != kModeSrrip) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  const auto kernel = mode == kModeLru ? cache_step_kernel<kModeLru>
                                       : cache_step_kernel<kModeSrrip>;
  const dim3 block(32 * kWarpsPerBlock);
  const dim3 grid((lanes + kWarpsPerBlock - 1) / kWarpsPerBlock);
  kernel<<<grid, block, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<int*>(tags), static_cast<int*>(lru), static_cast<int*>(stamps),
      static_cast<const int*>(fills), static_cast<const uint8_t*>(fill_en),
      static_cast<const int*>(demand), static_cast<const uint8_t*>(demand_en),
      static_cast<const int*>(probes), static_cast<const int*>(num_sets),
      static_cast<const int*>(ways), static_cast<uint8_t*>(hit_out),
      static_cast<uint8_t*>(probe_hit_out), lanes, sets_pad, ways_pad, C, P,
      max_rrpv);
  return static_cast<int>(cudaGetLastError());
}
