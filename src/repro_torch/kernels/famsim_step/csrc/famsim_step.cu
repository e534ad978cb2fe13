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
// 64,640 B in all (chip_smoke.py counts it from each run's data): some
// 0.02 us of the card's 3.35 TB/s. Bytes and operations are far below
// that; what bounds it is latency: the launch and the chain of dependent
// memory round trips between reading an event's inputs and writing its
// rows back.
//
// The design keeps that chain to two round trips to device memory. Each
// lane is one warp, in a block of its own (72 lanes spread over 72 SMs
// rather than packed four to an SM: the chain is latency-bound, so a lane
// gains nothing from company and each SM's load units serve one lane).
//   1. Stage. One thread per row of the event's R = C + 1 + P rows (fills,
//      demand, probes; R = 15 at fig08) loads its block id and enable and
//      hashes it to its set. __match_any_sync finds, for each row, the
//      first earlier row with the same set; rows that share a set share
//      that row's shared-memory slot, so a later fill, the demand and the
//      probes see the earlier fills' writes. Every distinct slot's tag row
//      (and its lru row, unless only probes read it) is then requested at
//      once with cp.async (16-byte copies when ways_pad % 4 == 0), before
//      any is used: one cp.async.wait_all and a __syncwarp.
//   2. Chain. The fills, the demand probe with its touch and the probes
//      run on the shared-memory rows with the reference's tie-breaking:
//      __ballot_sync + __ffs for the first matching or vacant way, and
//      (value, index) reductions of two redux.sync each for the LRU argmin
//      and the SRRIP argmax. A disabled fill is skipped, the victim search
//      runs only when a fill finds neither its block nor a vacant way, and
//      the probes, which only ask whether a row holds a tag, run one per
//      thread at once.
//   3. Write back. Only the slots a fill or the touch dirtied go back to
//      device memory, tags and lru, once, with the stamp and the hits.
// Shared memory is R x ways_pad x 8 B per lane plus 5 ints per row (2,220 B
// at fig08), dynamic; shapes above the card's opt-in limit are refused by
// the wrapper. Ways above 32 are handled in chunks of 32. The launch
// itself is the next cost: folding the event loop, with the scheduler and
// the accounting, into one persistent kernel is the next step.
//
// Built with nvcc into a shared library with a plain C interface and
// called through ctypes; the caller guarantees num_sets <= sets_pad and
// ways <= ways_pad.

#include <climits>
#include <cstddef>
#include <cstdint>

#include <cuda_runtime.h>

namespace {

constexpr unsigned kFull = 0xffffffffu;
constexpr int kModeLru = 0;
constexpr int kModeSrrip = 1;
constexpr int kRowInts = 5;  // per row besides its ways: blk, set, slot, en, dirty

__device__ __forceinline__ int set_index(int blk, int num_sets) {
  const uint32_t h = (static_cast<uint32_t>(blk) * 0x9E3779B1u) >> 7;
  return static_cast<int>(h % static_cast<uint32_t>(num_sets));
}

__device__ __forceinline__ void cp_async16(void* smem, const void* gmem) {
  const unsigned s = static_cast<unsigned>(__cvta_generic_to_shared(smem));
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(s), "l"(gmem));
}

__device__ __forceinline__ void cp_async4(void* smem, const void* gmem) {
  const unsigned s = static_cast<unsigned>(__cvta_generic_to_shared(smem));
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4;\n" ::"r"(s), "l"(gmem));
}

__device__ __forceinline__ void cp_async_wait_all() {
  asm volatile("cp.async.wait_all;\n" ::: "memory");
}

// Lexicographic (value, index) reductions over the warp from each thread's
// own best pair: the lowest index among equal extreme values, the same on
// every thread. Two redux.sync instructions, not a chain of shuffles.
__device__ __forceinline__ int warp_argmin(int v, int i) {
  const int m = __reduce_min_sync(kFull, v);
  return __reduce_min_sync(kFull, v == m ? i : INT_MAX);
}

__device__ __forceinline__ int warp_argmax(int v, int i) {
  const int m = __reduce_max_sync(kFull, v);
  return __reduce_min_sync(kFull, v == m ? i : INT_MAX);
}

// First effective way of `row` whose tag equals `tag`, and the first
// effective way that is vacant (tag 0); -1 where there is none.
__device__ __forceinline__ void scan_row(const int* row, int tag, int eff_ways,
                                         int ways_pad, int t, int& present,
                                         int& vacant) {
  present = -1;
  vacant = -1;
  for (int base = 0; base < ways_pad; base += 32) {
    const int w = base + t;
    const bool ok = w < ways_pad && w < eff_ways;
    const int v = ok ? row[w] : 0;
    const unsigned m_tag = __ballot_sync(kFull, ok && v == tag);
    const unsigned m_vac = __ballot_sync(kFull, ok && v == 0);
    if (present < 0 && m_tag) present = base + __ffs(m_tag) - 1;
    if (vacant < 0 && m_vac) vacant = base + __ffs(m_vac) - 1;
  }
}

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

__host__ __device__ constexpr size_t shared_bytes(int rows, int ways_pad) {
  return static_cast<size_t>(rows) * (2 * ways_pad + kRowInts) * sizeof(int);
}

template <int kMode>
__global__ void __launch_bounds__(32)
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
                  int sets_pad, int ways_pad, int C, int P, int max_rrpv,
                  int vec16) {
  extern __shared__ __align__(16) int smem[];
  const int t = threadIdx.x;
  const int lane = blockIdx.x;
  const int R = C + 1 + P;
  const int W = ways_pad;
  int* const sh_tags = smem;              // [R][W], a row per slot
  int* const sh_lru = smem + R * W;       // [R][W]
  int* const sh_blk = sh_lru + R * W;     // [R] block id of each row
  int* const sh_set = sh_blk + R;         // [R] its set
  int* const sh_slot = sh_set + R;        // [R] first row with that set
  int* const sh_en = sh_slot + R;         // [R] enable of each fill row
  int* const sh_dirty = sh_en + R;        // [R] a slot written by the chain

  const int ns = num_sets[lane];
  const int ew = ways[lane];
  const size_t lane_off = static_cast<size_t>(lane) * sets_pad * W;
  const bool demand_on = demand_en[lane] != 0;
  int stamp = stamps[lane];

  // 1) stage: each row's block, enable, set and slot ...
  for (int base = 0; base < R; base += 32) {
    const int r = base + t;
    const bool act = r < R;
    const unsigned act_mask = __ballot_sync(kFull, act);
    if (act) {
      int blk, en = 0;
      if (r < C) {
        blk = fills[static_cast<size_t>(lane) * C + r];
        en = fill_en[static_cast<size_t>(lane) * C + r];
      } else if (r == C) {
        blk = demand[lane];
      } else {
        blk = probes[static_cast<size_t>(lane) * P + (r - C - 1)];
      }
      const int si = set_index(blk, ns);
      int slot = base + __ffs(__match_any_sync(act_mask, si)) - 1;
      for (int e = 0; e < base; ++e) {  // rows of earlier chunks (R > 32)
        if (sh_set[e] == si) { slot = e; break; }
      }
      sh_blk[r] = blk;
      sh_set[r] = si;
      sh_slot[r] = slot;
      sh_en[r] = en;
      sh_dirty[r] = 0;
    }
    __syncwarp();
  }
  // ... then every distinct slot's rows requested at once; a slot that
  // only probes use (its first row is a probe) needs no lru row
  const int per_row = vec16 ? W / 4 : W;
  for (int i = t; i < R * 2 * per_row; i += 32) {
    const int r = i / (2 * per_row);
    const int rem = i - r * 2 * per_row;
    const int which = rem / per_row;  // 0 tags, 1 lru
    if (sh_slot[r] != r || (which == 1 && r > C)) continue;
    const int k = rem - which * per_row;
    const size_t g = lane_off + static_cast<size_t>(sh_set[r]) * W;
    const int* src = (which ? lru : tags) + g;
    int* dst = (which ? sh_lru : sh_tags) + r * W;
    if (vec16) {
      cp_async16(dst + 4 * k, src + 4 * k);
    } else {
      cp_async4(dst + k, src + k);
    }
  }
  cp_async_wait_all();
  __syncwarp();

  // 2) the chain on the staged rows. Fills first, in order: same-set fills
  // interact through their shared slot.
  for (int c = 0; c < C; ++c) {
    if (sh_en[c] == 0) continue;  // a disabled fill changes nothing
    const int s = sh_slot[c];
    int* const rt = sh_tags + s * W;
    int* const rl = sh_lru + s * W;
    const int tag = sh_blk[c] + 1;
    stamp += 1;
    int present, vacant;
    scan_row(rt, tag, ew, W, t, present, vacant);
    const bool evicting = present < 0 && vacant < 0;
    int way = present >= 0 ? present : vacant;
    int bump = 0;
    if (evicting) {
      if (kMode == kModeLru) {
        // min stamp over the effective ways (padded ways read as INT_MAX)
        int bv = INT_MAX, bi = INT_MAX;
        for (int w = t; w < W; w += 32) {
          const int v = w < ew ? rl[w] : INT_MAX;
          if (v < bv || (v == bv && w < bi)) { bv = v; bi = w; }
        }
        way = warp_argmin(bv, bi);
      } else {
        // SRRIP: age the effective ways until one reaches max_rrpv, then
        // evict the first way holding the aged maximum
        int mx = INT_MIN;
        for (int w = t; w < W; w += 32) {
          const int v = w < ew ? rl[w] : 0;
          mx = v > mx ? v : mx;
        }
        mx = __reduce_max_sync(kFull, mx);
        bump = max_rrpv - mx > 0 ? max_rrpv - mx : 0;
        int bv = INT_MIN, bi = INT_MAX;
        for (int w = t; w < W; w += 32) {
          const int v = w < ew ? rl[w] + bump : -1;
          if (v > bv || (v == bv && w < bi)) { bv = v; bi = w; }
        }
        way = warp_argmax(bv, bi);
      }
    }
    if (kMode == kModeLru) {
      if (t == (way & 31)) {
        rt[way] = tag;
        rl[way] = stamp;
      }
    } else {
      // aging applies only on the eviction path; a redundant fill of a
      // present block re-references it (RRPV 0)
      for (int w = t; w < W; w += 32) {
        int v = rl[w];
        if (evicting && w < ew) v += bump;
        if (w == way) {
          v = present >= 0 ? 0 : max_rrpv - 1;
          rt[w] = tag;
        }
        rl[w] = v;
      }
    }
    if (t == 0) sh_dirty[s] = 1;
    __syncwarp();
  }

  // demand probe + recency touch on the post-fill rows
  bool hit;
  {
    const int s = sh_slot[C];
    const int way = first_match(sh_tags + s * W, sh_blk[C] + 1, ew, W, t);
    hit = way >= 0 && demand_on;
    stamp += hit ? 1 : 0;
    if (hit) {
      if (t == (way & 31)) sh_lru[s * W + way] = kMode == kModeLru ? stamp : 0;
      if (t == 0) sh_dirty[s] = 1;
    }
  }
  // tag-only probes (a touch never writes tags, so these are order-free):
  // one thread per probe scans its row, all probes at once
  for (int j = t; j < P; j += 32) {
    const int r = C + 1 + j;
    const int* row = sh_tags + sh_slot[r] * W;
    const int tag = sh_blk[r] + 1;
    bool found = false;
    for (int w = 0; w < ew && w < W; ++w) found |= row[w] == tag;
    probe_hit_out[static_cast<size_t>(lane) * P + j] = found ? 1 : 0;
  }
  __syncwarp();

  // 3) write back the dirty slots (only rows <= C can be dirty) and the
  // lane's stamp and demand hit
  for (int i = t; i < (C + 1) * per_row; i += 32) {
    const int r = i / per_row;
    if (sh_slot[r] != r || sh_dirty[r] == 0) continue;
    const int k = i - r * per_row;
    const size_t g = lane_off + static_cast<size_t>(sh_set[r]) * W;
    if (vec16) {
      reinterpret_cast<int4*>(tags + g)[k] = reinterpret_cast<const int4*>(sh_tags + r * W)[k];
      reinterpret_cast<int4*>(lru + g)[k] = reinterpret_cast<const int4*>(sh_lru + r * W)[k];
    } else {
      tags[g + k] = sh_tags[r * W + k];
      lru[g + k] = sh_lru[r * W + k];
    }
  }
  if (t == 0) {
    hit_out[lane] = hit ? 1 : 0;
    stamps[lane] = stamp;
  }
}

}  // namespace

// Dynamic shared memory a launch with C fills, P probes and ways_pad ways
// needs, and the most the current device lets a block opt in to.
extern "C" int famsim_cache_step_shared(int C, int P, int ways_pad,
                                        long long* need, long long* limit) {
  int dev = 0, optin = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err == cudaSuccess) {
    err = cudaDeviceGetAttribute(&optin, cudaDevAttrMaxSharedMemoryPerBlockOptin, dev);
  }
  *need = static_cast<long long>(shared_bytes(C + 1 + P, ways_pad));
  *limit = optin;
  return static_cast<int>(err);
}

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
  const size_t smem = shared_bytes(C + 1 + P, ways_pad);
  if (smem > 48 * 1024) {
    const cudaError_t err = cudaFuncSetAttribute(
        kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, static_cast<int>(smem));
    if (err != cudaSuccess) return static_cast<int>(err);
  }
  const int vec16 = ways_pad % 4 == 0 &&
                    reinterpret_cast<uintptr_t>(tags) % 16 == 0 &&
                    reinterpret_cast<uintptr_t>(lru) % 16 == 0;
  kernel<<<lanes, 32, smem, static_cast<cudaStream_t>(stream)>>>(
      static_cast<int*>(tags), static_cast<int*>(lru), static_cast<int*>(stamps),
      static_cast<const int*>(fills), static_cast<const uint8_t*>(fill_en),
      static_cast<const int*>(demand), static_cast<const uint8_t*>(demand_en),
      static_cast<const int*>(probes), static_cast<const int*>(num_sets),
      static_cast<const int*>(ways), static_cast<uint8_t*>(hit_out),
      static_cast<uint8_t*>(probe_hit_out), sets_pad, ways_pad, C, P, max_rrpv,
      vec16);
  return static_cast<int>(cudaGetLastError());
}
