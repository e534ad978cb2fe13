// One access of the tiering runtime's tier (TieredBlockPool.access up to
// its final batched probe) as two launches on the stream and no host sync:
// a chain kernel that runs every metadata step of the access, and a copy
// kernel that moves the blocks the chain filled.
//
// Replaces, with cache_lookup.cu's batched probe after it, the TPU kernel
// cache_lookup (src/repro/kernels/cache_lookup/kernel.py, pl.pallas_call at
// :58) and the three jitted scans around it in
// src/repro/core/tiering.py:117-199 (TieredBlockPool.access). Its plain
// version is repro_torch/core/tiering.py::TieredBlockPool._access_torch,
// the eager loop that launches ~185 small kernels per block id.
//
// What the chain computes, as the reference does (policy = set-LRU):
//   1. Demand. Per id in order: probe the id's set row; on a hit, stamp +=
//      1 and touch the way; on a miss, fill: the first vacant way, else the
//      LRU victim (the first minimum over the ways), stamp += 1, and the
//      side tables slot_of_block[evicted] = -1, slot_of_block[id] = slot,
//      block_of_slot[slot] = id.
//   2. Counters: hits, demand_misses, prefetch_hits, one f32 add each.
//   3. With prefetch: SPP update over the K (page, block) pairs, predict
//      from the last one (f32 path confidence, IEEE division), the clamp
//      of the candidates, DWRR over degree + K int32 cycles, granted = the
//      PREFETCH choices among them; each valid candidate that is not
//      resident and ranks below granted is filled (prefetches += 1).
//
// What bounds it on an H100: not bytes (the tiered decode's metadata is
// ~4 KB of tags and lru and the SPP rows the ids touch, ~0.01 us of 3.35
// TB/s)
// but chains of dependent shared-memory round trips, K + degree steps
// long if walked in id order. The design shortens the chains by splitting
// them where the reference's order does not bind:
//   * Demand. Every demand id adds exactly one to the stamp (a touch or a
//     fill), so id i's stamp is stamp + i + 1, known up front; and an id
//     only reads and writes its own set's row and side-table entries (a
//     block lives in one set). So each set's ids form a chain of their own.
//     Warps 0-15 take the sets (set % 16), each walking its sets' ids in
//     id order: lane = way, __ballot_sync + __ffs for the first match and
//     the first vacancy, redux.sync min + ballot for the first LRU minimum;
//     lane 0 writes the side tables straight to device memory (the chain
//     never reads them).
//   * SPP update. A signature-table entry's chain (tag, last block,
//     signature) depends only on the ids that hash to it, and which
//     pattern row an id trains, with which delta, follows from that entry
//     alone. So warps 16-31 walk the entries' chains (entry % 16) at the
//     same time as the demand; then all 32 warps walk the pattern rows'
//     chains (row % 32), each in id order. The SPP tables stay in device
//     memory, read and written in place (160 KB at FamConfig(), of which
//     an access touches a few rows; staged in shared memory the chain was
//     5 % faster at the tiered decode, not worth a size limit).
//   * Lane 0 of warp 0 then predicts, runs DWRR (the cycles after both
//     queues are empty only replenish the deficits, so they are taken in
//     closed form) and warp 0 runs the prefetch fills in order.
//   * The tag and lru rows, the stamp, the WFQ state and the counters go
//     back to device memory.
// No block is copied inside the chain. The chain lists each slot an
// enabled fill wrote, once (a slot filled twice in one access is listed
// once), and the copy kernel then sets fast[slot] = slow[block_of_slot
// [slot]] for each, at HBM rate, in 16-byte units where the rows allow it,
// converting f32 -> bf16 (round to nearest even) where the tiers' types
// differ. That is what the plain loop leaves: each fill wrote the block
// that block_of_slot then names, and a later fill of the same slot
// overwrote the earlier one's data and entry alike.
//
// Built with nvcc into a shared library with a plain C interface and
// called through ctypes. The caller guarantees the ids lie in
// [0, num_blocks) and the state is one the runtime made; the kernel keeps
// its writes in bounds either way.

#include <climits>
#include <cstddef>
#include <cstdint>

#include <cuda_bf16.h>
#include <cuda_runtime.h>

namespace {

constexpr unsigned kFull = 0xffffffffu;
constexpr int kThreads = 1024;
constexpr int kWarps = kThreads / 32;
constexpr int kDemandWarps = 16;                    // warps 0-15: the sets' chains
constexpr int kSppWarps = kWarps - kDemandWarps;  // warps 16-31: SPP entries
constexpr int kMaxWays = 32;
constexpr int kMaxDegree = 32;
constexpr int kPtWays = 4;
constexpr int kMaxWeight = 15;
constexpr int kSigShift = 4;
constexpr int kIdInts = 7;  // per id: id, set, page, block, entry, pattern row, delta
constexpr uint32_t kHashMult = 0x9E3779B1u;
// dynamic shared memory: the 48 KB a launch gets without opting in, less
// 1 KB for the static arrays (the tiered decode needs 11.8 KB)
constexpr size_t kMaxSharedBytes = 47 * 1024;
constexpr int kIdle = 0, kDemand = 1, kPrefetch = 2;
constexpr int kCopyThreads = 256;
constexpr int kCopyBlocks = 528;  // 4 blocks of 256 threads per SM

// The SPP tables (int32): signature table (ST), pattern table (PT x 4)
// and its signature weights.
struct Spp {
  int* st_tag;
  int* st_last;
  int* st_sig;
  int* pt_delta;
  int* pt_weight;
  int* pt_sigw;
};

struct Args {
  int* tags;  // (sets, ways), in place
  int* lru;
  int* stamp;  // 0-d
  int* slot_of_block;  // (num_blocks,)
  int* block_of_slot;  // (sets * ways,)
  Spp spp;             // device memory, in place
  const int* wfq_in[3];  // current_round, demand_deficit, prefetch_deficit
  int* wfq_out;          // (3,)
  const float* counters_in[4];  // hits, demand_misses, prefetch_hits, prefetches
  float* counters_out;          // (4,)
  const int* ids;
  int K;
  int* fills;  // (1 + max fills,): count, then the filled slots
  int sets, ways, num_blocks, page_span, degree;
  int st_entries, pt_entries, sig_mask;
  float threshold;
  int weight, quantum, max_deficit;
  int prefetch;
};

__host__ __device__ constexpr size_t round4(size_t n) { return (n + 3) / 4 * 4; }

// Shared memory of one launch, in ints unless named: tags and lru rows
// and kIdInts ints per id (rounded to 16 bytes), then one byte per slot
// for the fill flags.
__host__ __device__ size_t head_ints(int entries, int K) {
  return round4(2 * size_t(entries) + kIdInts * size_t(K));
}

__host__ __device__ size_t shared_bytes(int entries, int K) {
  return 4 * head_ints(entries, K) + (size_t(entries) + 15) / 16 * 16;
}

__device__ __forceinline__ uint32_t hash_mod(int x, int shift, int mod) {
  return ((static_cast<uint32_t>(x) * kHashMult) >> shift) % static_cast<uint32_t>(mod);
}

// Python's floor division and modulo by a positive divisor.
__device__ __forceinline__ int floor_div(int a, int m) {
  const int q = a / m;
  return (a % m != 0 && a < 0) ? q - 1 : q;
}

__device__ __forceinline__ int floor_mod(int a, int m) {
  const int r = a % m;
  return r < 0 ? r + m : r;
}

// sig % PT (Python's modulo): a mask when PT is a power of two, which is
// the same value in two's complement.
__device__ __forceinline__ int pt_index(int sig, int pt) {
  return (pt & (pt - 1)) == 0 ? (sig & (pt - 1)) : floor_mod(sig, pt);
}

__device__ __forceinline__ int next_sig(int sig, int delta, int mask) {
  return static_cast<int>(((static_cast<uint32_t>(sig) << kSigShift) ^
                           static_cast<uint32_t>(delta & mask)) &
                          static_cast<uint32_t>(mask));
}

__device__ __forceinline__ int pick(const int (&v)[kPtWays], int j) {
  return j == 0 ? v[0] : (j == 1 ? v[1] : (j == 2 ? v[2] : v[3]));
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

// Request n ints src -> dst (dst 16-byte aligned) from threads t of nt:
// 16-byte copies when src allows them. The caller waits.
__device__ __forceinline__ void stage(int* dst, const int* src, int n, int t, int nt) {
  if ((reinterpret_cast<uintptr_t>(src) & 15) == 0 && (n & 3) == 0) {
    for (int i = 4 * t; i < n; i += 4 * nt) cp_async16(dst + i, src + i);
  } else {
    for (int i = t; i < n; i += nt) cp_async4(dst + i, src + i);
  }
}

// Calls visit(i) for each id i < K, in id order, that this warp owns
// (owned(i), the same on every lane): 32 ids a ballot.
template <typename Owned, typename Visit>
__device__ __forceinline__ void walk_owned(int K, int lane, Owned owned, Visit visit) {
  for (int c = 0; c < K; c += 32) {
    unsigned mask = __ballot_sync(kFull, c + lane < K && owned(c + lane));
    while (mask != 0u) {
      const int j = __ffs(mask) - 1;
      mask &= mask - 1u;
      visit(c + j);
    }
  }
}

// Shared-memory rows of the chain.
struct Rows {
  int* tags;
  int* lru;
  uint8_t* filled;
  int* n_fill;
};

// One fill by a whole warp into set row `base` (lane = way; `tv` is the
// lane's tag, read before) with recency `stamp`: the first vacant way,
// else the first LRU minimum. Lane 0 writes the side tables and lists the
// slot once.
__device__ __forceinline__ void fill(const Args& a, const Rows& r, int base, int id, int tv,
                                     bool w_ok, int lane, int stamp) {
  const unsigned vacant = __ballot_sync(kFull, w_ok && tv == 0);
  int way, evicted = -1;
  if (vacant != 0u) {
    way = __ffs(vacant) - 1;
  } else {
    const int l = w_ok ? r.lru[base + lane] : INT_MAX;
    const int m = __reduce_min_sync(kFull, l);
    way = __ffs(__ballot_sync(kFull, w_ok && l == m)) - 1;
    evicted = static_cast<int>(static_cast<uint32_t>(__shfl_sync(kFull, tv, way)) - 1u);
  }
  if (lane == way) {
    r.tags[base + lane] = static_cast<int>(static_cast<uint32_t>(id) + 1u);
    r.lru[base + lane] = stamp;
  }
  if (lane == 0) {
    const int slot = base + way;
    if (evicted >= 0 && evicted < a.num_blocks) a.slot_of_block[evicted] = -1;
    if (id >= 0 && id < a.num_blocks) a.slot_of_block[id] = slot;
    a.block_of_slot[slot] = id;
    if (!r.filled[slot]) {
      r.filled[slot] = 1;
      a.fills[1 + atomicAdd(r.n_fill, 1)] = slot;
    }
  }
}

// Probe id's set row with the whole warp (lane = way): the hit way or -1,
// and the lane's tag in `tv`.
__device__ __forceinline__ int probe(const Rows& r, int base, int id, bool w_ok, int lane,
                                     int& tv) {
  tv = w_ok ? r.tags[base + lane] : 0;
  const int tag = static_cast<int>(static_cast<uint32_t>(id) + 1u);
  const unsigned m = __ballot_sync(kFull, w_ok && tv == tag);
  return m != 0u ? __ffs(m) - 1 : -1;
}

// The signature-table step of SPP update for id i (core/spp.py update):
// the entry's new tag, last block and signature; the pattern row the id
// trains (-1: none) and its delta go to pt_s / delta_s. `cache` holds the
// entry this thread wrote last (index, tag, last block, signature).
__device__ __forceinline__ int spp_entry(const Args& a, const Spp& t, int i, const int* page_s,
                                         const int* blk_s, const int* sti_s, int* pt_s,
                                         int* delta_s, int (&cache)[4]) {
  const int idx = sti_s[i], blk = blk_s[i];
  const int tag = static_cast<int>(static_cast<uint32_t>(page_s[i]) + 1u);
  if (cache[0] != idx) {
    cache[0] = idx;
    cache[1] = t.st_tag[idx];
    cache[2] = t.st_last[idx];
    cache[3] = t.st_sig[idx];
  }
  const bool hit = cache[1] == tag;
  const int delta = static_cast<int>(static_cast<uint32_t>(blk) - static_cast<uint32_t>(cache[2]));
  const int old_sig = cache[3];
  pt_s[i] = hit && delta != 0 ? pt_index(old_sig, a.pt_entries) : -1;
  delta_s[i] = delta;
  const int new_sig = hit ? next_sig(old_sig, delta, a.sig_mask) : (blk & a.sig_mask);
  cache[1] = tag;
  cache[2] = blk;
  cache[3] = new_sig;
  t.st_tag[idx] = tag;
  t.st_last[idx] = blk;
  t.st_sig[idx] = new_sig;
  return new_sig;
}

// A pattern row held in registers: its deltas, weights and signature
// weight.
struct PatternRow {
  int pt = -1;
  int d[kPtWays], w[kPtWays], sigw;

  __device__ __forceinline__ void load(const Spp& t, int row) {
    pt = row;
#pragma unroll
    for (int j = 0; j < kPtWays; ++j) {
      d[j] = t.pt_delta[pt * kPtWays + j];
      w[j] = t.pt_weight[pt * kPtWays + j];
    }
    sigw = t.pt_sigw[pt];
  }

  __device__ __forceinline__ void store(const Spp& t) const {
#pragma unroll
    for (int j = 0; j < kPtWays; ++j) {
      t.pt_delta[pt * kPtWays + j] = d[j];
      t.pt_weight[pt * kPtWays + j] = w[j];
    }
    t.pt_sigw[pt] = sigw;
  }

  // The pattern-table step of SPP update for a training id: the row's
  // matching live way, else the first minimum weight, takes the delta.
  __device__ __forceinline__ void train(int delta) {
    int way = -1;
#pragma unroll
    for (int j = kPtWays - 1; j >= 0; --j)
      if (d[j] == delta && w[j] > 0) way = j;
    int new_w = 1;
    if (way >= 0) {
      new_w = min(pick(w, way) + 1, kMaxWeight);
    } else {
      way = 0;
#pragma unroll
      for (int j = 1; j < kPtWays; ++j)
        if (w[j] < pick(w, way)) way = j;
    }
#pragma unroll
    for (int j = 0; j < kPtWays; ++j) {
      if (j == way) {
        d[j] = delta;
        w[j] = new_w;
      }
    }
    if (sigw < 4 * kMaxWeight) ++sigw;
  }

  // train(delta) n more times right after train(delta): the way that took
  // the delta is its first live match every time.
  __device__ __forceinline__ void repeat(int delta, int n) {
    int way = -1;
#pragma unroll
    for (int j = kPtWays - 1; j >= 0; --j)
      if (d[j] == delta && w[j] > 0) way = j;
#pragma unroll
    for (int j = 0; j < kPtWays; ++j)
      if (j == way) w[j] = min(w[j] + n, kMaxWeight);
    if (sigw < 4 * kMaxWeight) sigw = min(sigw + n, 4 * kMaxWeight);
  }
};

// SPP predict from (page, block, sig), degree steps (core/spp.py predict),
// then the runtime's clamp of the candidates to [0, num_blocks).
__device__ int spp_predict(const Args& a, const Spp& t, int page, int block, int sig,
                           int* cand_s, int* valid_s) {
  int cur_sig = sig, cur_block = block, n_valid = 0;
  float conf = 1.0f;
  bool alive = true;
  for (int s = 0; s < a.degree; ++s) {
    const int pt = pt_index(cur_sig, a.pt_entries), row = pt * kPtWays;
    int way = 0, w = t.pt_weight[row];
#pragma unroll
    for (int j = 1; j < kPtWays; ++j) {  // the first maximum weight
      const int wj = t.pt_weight[row + j];
      if (wj > w) {
        w = wj;
        way = j;
      }
    }
    const int sigw = max(t.pt_sigw[pt], 1);
    float step = __fmul_rn(__fdiv_rn(static_cast<float>(w), static_cast<float>(sigw)), 4.0f);
    if (step > 1.0f) step = 1.0f;
    const float new_conf = __fmul_rn(conf, step);
    const int delta = t.pt_delta[row + way];
    const int nb = static_cast<int>(static_cast<uint32_t>(cur_block) + static_cast<uint32_t>(delta));
    const bool ok = alive && w > 0 && new_conf >= a.threshold && nb >= 0 && nb < a.page_span &&
                    delta != 0;
    const long long c = static_cast<long long>(page) * a.page_span + (ok ? nb : 0);
    cand_s[s] = static_cast<int>(c < 0 ? 0 : (c > a.num_blocks - 1 ? a.num_blocks - 1 : c));
    valid_s[s] = ok ? 1 : 0;
    n_valid += ok ? 1 : 0;
    if (ok) {
      cur_sig = next_sig(cur_sig, delta, a.sig_mask);
      cur_block = nb;
      conf = new_conf;
    }
    alive = ok;
  }
  return n_valid;
}

// x -> min(x + q, m), applied n >= 1 times, for q >= 0.
__device__ __forceinline__ int replenish(int x, int q, int m, int n) {
  const long long y = static_cast<long long>(x) + static_cast<long long>(q) * n;
  return y < m ? static_cast<int>(y) : m;
}

// DWRR schedule_batch over max_issues cycles with r = 1 (core/wfq.py
// _issue, on int32); writes the state and returns the PREFETCH choices.
// Once both queues are empty every cycle is idle: a demand turn only sets
// dd = min(dd + q, md), a prefetch turn pd = min(pd + q, md), so the rest
// is taken in closed form (for q >= 0 and a round in [0, W]).
__device__ int dwrr(const Args& a, int nd, int npf) {
  int cr = *a.wfq_in[0], dd = *a.wfq_in[1], pd = *a.wfq_in[2];
  const int W = a.weight, q = a.quantum, md = a.max_deficit, r = 1;
  const int issues = a.degree + a.K;
  int granted = 0, c = 0;
  for (; c < issues; ++c) {
    const bool in_range = W >= 0 && cr >= 0 && cr <= W;
    if (npf <= 0 && nd > 0 && in_range) {
      // only demands wait: every cycle issues one; a demand turn sets
      // dd = min(dd + q, md) - 1, a prefetch turn dd -= 1 and pd = min(pd + q, md)
      const int m = min(nd, issues - c);
      for (int k = 0; k < m; ++k) {
        cr = cr == W ? 0 : cr + 1;
        if (cr != 0) {
          dd = min(dd + q, md) - 1;
        } else {
          dd -= 1;
          pd = min(pd + q * r, md * r);
        }
      }
      nd -= m;
      c += m - 1;
      continue;
    }
    if (nd <= 0 && npf <= 0 && q >= 0 && in_range) break;
    cr = (cr >= 0 && cr < W) ? cr + 1 : floor_mod(cr + 1, W + 1);
    const bool demand_turn = cr != 0, dr = nd > 0, pr = npf > 0;
    const int dd_d = min(dd + q, md);
    const int choice_d = (dr && dd_d > 0) ? kDemand : ((pr && pd > r) ? kPrefetch : kIdle);
    const int pd_p = min(pd + q * r, md * r);
    const int choice_p = (pr && pd_p > r) ? kPrefetch : ((dr && dd > 0) ? kDemand : kIdle);
    int choice = demand_turn ? choice_d : choice_p;
    const int fallback = dr ? kDemand : (pr ? kPrefetch : kIdle);
    const bool floored = choice == kIdle && fallback != kIdle;
    if (demand_turn) {
      dd = choice_d == kDemand ? dd_d - 1 : dd_d;
      pd = choice_d == kPrefetch ? pd - r : pd;
    } else {
      dd = choice_p == kDemand ? dd - 1 : dd;
      pd = choice_p == kPrefetch ? pd_p - r : pd_p;
    }
    if (choice == kIdle) choice = fallback;
    if (floored && choice == kDemand) dd -= 1;
    if (floored && choice == kPrefetch) pd -= r;
    nd -= choice == kDemand ? 1 : 0;
    npf -= choice == kPrefetch ? 1 : 0;
    granted += choice == kPrefetch ? 1 : 0;
  }
  const int n = issues - c;  // idle cycles left
  if (n > 0) {
    const int p_turns = (cr + n) / (W + 1);  // cycles whose round comes back to 0
    if (n - p_turns > 0) dd = replenish(dd, q, md, n - p_turns);
    if (p_turns > 0) pd = replenish(pd, q * r, md * r, p_turns);
    cr = (cr + n) % (W + 1);
  }
  a.wfq_out[0] = cr;
  a.wfq_out[1] = dd;
  a.wfq_out[2] = pd;
  return granted;
}

__global__ void __launch_bounds__(kThreads, 1) tier_access_kernel(const Args a) {
  extern __shared__ int4 smem_raw[];
  __shared__ int cand_s[kMaxDegree], valid_s[kMaxDegree];
  __shared__ int n_fill_s, n_miss_s, sig_last_s;
  const int entries = a.sets * a.ways, K = a.K;
  int* tags_s = reinterpret_cast<int*>(smem_raw);
  int* lru_s = tags_s + entries;
  int* id_s = lru_s + entries;
  int* si_s = id_s + K;
  int* page_s = si_s + K;
  int* blk_s = page_s + K;
  int* sti_s = blk_s + K;
  int* pt_s = sti_s + K;
  int* delta_s = pt_s + K;
  uint8_t* filled_s = reinterpret_cast<uint8_t*>(tags_s + head_ints(entries, K));
  const Rows rows{tags_s, lru_s, filled_s, &n_fill_s};
  const int t = threadIdx.x, warp = t >> 5, lane = t & 31;
  const Spp& tab = a.spp;

  // 1. stage the tag and lru rows, hash every id, clear the fill flags
  stage(tags_s, a.tags, entries, t, kThreads);
  stage(lru_s, a.lru, entries, t, kThreads);
  for (int i = t; i < K; i += kThreads) {
    const int id = a.ids[i];
    id_s[i] = id;
    si_s[i] = static_cast<int>(hash_mod(id, 7, a.sets));
    if (a.prefetch) {
      const int page = floor_div(id, a.page_span);
      page_s[i] = page;
      blk_s[i] = id - page * a.page_span;
      sti_s[i] = static_cast<int>(hash_mod(page, 8, a.st_entries));
    }
  }
  for (int i = t; i < entries; i += kThreads) filled_s[i] = 0;
  if (t == 0) {
    n_fill_s = 0;
    n_miss_s = 0;
  }
  cp_async_wait_all();
  __syncthreads();

  const bool w_ok = lane < a.ways;
  const int stamp0 = *a.stamp;
  if (warp < kDemandWarps) {
    // 2. the demand chains, one set at a time; id i's stamp is stamp0 + i + 1
    int n_miss = 0;
    walk_owned(K, lane, [&](int i) { return si_s[i] % kDemandWarps == warp; }, [&](int i) {
      const int base = si_s[i] * a.ways, id = id_s[i];
      int tv;
      const int way = probe(rows, base, id, w_ok, lane, tv);
      if (way >= 0) {
        if (lane == way) lru_s[base + lane] = stamp0 + i + 1;
      } else {
        ++n_miss;
        fill(a, rows, base, id, tv, w_ok, lane, stamp0 + i + 1);
      }
    });
    if (lane == 0 && n_miss) atomicAdd(&n_miss_s, n_miss);
  } else if (a.prefetch) {
    // 2'. the signature-table chains, entry % 16
    const int sw = warp - kDemandWarps;
    int cache[4] = {-1, 0, 0, 0};
    walk_owned(K, lane, [&](int i) { return sti_s[i] % kSppWarps == sw; }, [&](int i) {
      if (lane == 0) {
        const int sig = spp_entry(a, tab, i, page_s, blk_s, sti_s, pt_s, delta_s, cache);
        if (i == K - 1) sig_last_s = sig;
      }
    });
  }
  __syncthreads();

  if (a.prefetch) {
    // 2''. the pattern rows' chains, row % 32, each in id order. Every
    // lane holds the warp's current row in registers; a run of ids that
    // train one row with one delta is applied at once.
    PatternRow row;
    for (int c = 0; c < K; c += 32) {
      const int i = c + lane;
      const int pt = i < K ? pt_s[i] : -1, dl = i < K ? delta_s[i] : 0;
      const bool owned = pt >= 0 && pt % kWarps == warp;
      unsigned mask = __ballot_sync(kFull, owned);
      while (mask != 0u) {
        const int j = __ffs(mask) - 1;
        const int pj = __shfl_sync(kFull, pt, j), dj = __shfl_sync(kFull, dl, j);
        const unsigned same = __ballot_sync(kFull, owned && pt == pj && dl == dj) & mask;
        const unsigned other = mask & ~same;  // owned ids of other keys, all after j
        const unsigned run = other != 0u ? same & ((1u << (__ffs(other) - 1)) - 1u) : same;
        if (pj != row.pt) {
          if (row.pt >= 0 && lane == 0) row.store(tab);
          __syncwarp();
          row.load(tab, pj);
        }
        row.train(dj);
        if (__popc(run) > 1) row.repeat(dj, __popc(run) - 1);
        mask &= ~run;
      }
    }
    if (lane == 0 && row.pt >= 0) row.store(tab);
    __syncthreads();
  }

  if (warp == 0) {
    // 3. predict, DWRR and the prefetch fills, in order
    int n_prefetched = 0;
    const int n_miss = n_miss_s;
    if (a.prefetch) {
      int granted = 0;
      if (lane == 0) {
        const int n_valid = spp_predict(a, tab, page_s[K - 1], blk_s[K - 1], sig_last_s,
                                        cand_s, valid_s);
        granted = dwrr(a, n_miss, n_valid);
      }
      granted = __shfl_sync(kFull, granted, 0);
      __syncwarp();
      int rank = -1;
      for (int s = 0; s < a.degree; ++s) {
        const int bid = cand_s[s];
        const bool valid = valid_s[s] != 0;
        rank += valid ? 1 : 0;
        const int base = static_cast<int>(hash_mod(bid, 7, a.sets)) * a.ways;
        int tv;
        const bool fresh = probe(rows, base, bid, w_ok, lane, tv) < 0;
        if (valid && fresh && rank < granted) {
          ++n_prefetched;
          fill(a, rows, base, bid, tv, w_ok, lane, stamp0 + K + n_prefetched);
        }
      }
    }
    if (lane == 0) {
      const float n_hit = static_cast<float>(K - n_miss);
      a.counters_out[0] = *a.counters_in[0] + n_hit;
      a.counters_out[1] = *a.counters_in[1] + static_cast<float>(n_miss);
      a.counters_out[2] = *a.counters_in[2] + n_hit;
      a.counters_out[3] = *a.counters_in[3] + static_cast<float>(n_prefetched);
      *a.stamp = stamp0 + K + n_prefetched;
      if (!a.prefetch) {  // the WFQ state passes through unchanged
        for (int j = 0; j < 3; ++j) a.wfq_out[j] = *a.wfq_in[j];
      }
    }
  }
  __syncthreads();

  // 4. back to device memory: the tag and lru rows and the fill count
  for (int i = t; i < entries; i += kThreads) {
    a.tags[i] = tags_s[i];
    a.lru[i] = lru_s[i];
  }
  if (t == 0) a.fills[0] = n_fill_s;
}

// fast[slot] = slow[block_of_slot[slot]] for every listed slot. kKind: 0
// same type in 16-byte units, 1 same type by bytes, 2 f32 -> bf16 four
// elements at a time, 3 f32 -> bf16 one at a time.
template <int kKind>
__device__ __forceinline__ void copy_unit(const void* __restrict__ slow, void* __restrict__ fast,
                                          size_t src, size_t dst) {
  if constexpr (kKind == 0) {
    static_cast<uint4*>(fast)[dst] = static_cast<const uint4*>(slow)[src];
  } else if constexpr (kKind == 1) {
    static_cast<uint8_t*>(fast)[dst] = static_cast<const uint8_t*>(slow)[src];
  } else if constexpr (kKind == 2) {
    const float4 x = static_cast<const float4*>(slow)[src];
    const __nv_bfloat162 lo = __floats2bfloat162_rn(x.x, x.y);
    const __nv_bfloat162 hi = __floats2bfloat162_rn(x.z, x.w);
    uint2 o;
    o.x = *reinterpret_cast<const unsigned*>(&lo);
    o.y = *reinterpret_cast<const unsigned*>(&hi);
    static_cast<uint2*>(fast)[dst] = o;
  } else {
    static_cast<__nv_bfloat16*>(fast)[dst] = __float2bfloat16_rn(static_cast<const float*>(slow)[src]);
  }
}

template <int kKind>
__global__ void __launch_bounds__(kCopyThreads) tier_copy_kernel(
    const int* __restrict__ fills, const int* __restrict__ block_of_slot,
    const void* __restrict__ slow, void* __restrict__ fast, long long units, int num_blocks) {
  const int n = fills[0];
  const long long stride = static_cast<long long>(gridDim.x) * kCopyThreads;
  for (int f = blockIdx.y; f < n; f += gridDim.y) {
    const int slot = fills[1 + f];
    const int bid = block_of_slot[slot];
    if (bid < 0 || bid >= num_blocks) continue;
    const size_t src = static_cast<size_t>(bid) * units, dst = static_cast<size_t>(slot) * units;
#pragma unroll 4
    for (long long u = static_cast<long long>(blockIdx.x) * kCopyThreads + threadIdx.x; u < units;
         u += stride)
      copy_unit<kKind>(slow, fast, src + u, dst + u);
  }
}

template <int kKind>
cudaError_t launch_copy(dim3 grid, cudaStream_t stream, const int* fills, const int* bos,
                        const void* slow, void* fast, long long units, int num_blocks) {
  tier_copy_kernel<kKind><<<grid, kCopyThreads, 0, stream>>>(fills, bos, slow, fast, units,
                                                              num_blocks);
  return cudaGetLastError();
}

}  // namespace

extern "C" int tier_access(void* tags, void* lru, void* stamp, void* slot_of_block,
                           void* block_of_slot, void* st_tag, void* st_last, void* st_sig,
                           void* pt_delta, void* pt_weight, void* pt_sigw, const void* wfq_cr,
                           const void* wfq_dd, const void* wfq_pd, void* wfq_out,
                           const void* hits, const void* demand_misses, const void* prefetch_hits,
                           const void* prefetches, void* counters_out, const void* ids, int K,
                           void* fills, int max_fills, const void* slow, void* fast,
                           long long units, int copy_kind, int sets, int ways, int num_blocks,
                           int page_span, int degree, int st_entries, int pt_entries,
                           int sig_bits, float threshold, int weight, int quantum,
                           int max_deficit, int prefetch, void* stream) {
  if (K < 0 || sets <= 0 || ways <= 0 || ways > kMaxWays || num_blocks <= 0 || page_span <= 0 ||
      degree < 0 || degree > kMaxDegree || st_entries <= 0 || pt_entries <= 0 ||
      sig_bits <= 0 || sig_bits > 30 || copy_kind < 0 || copy_kind > 3 || max_fills < 0 ||
      (prefetch && K == 0))
    return static_cast<int>(cudaErrorInvalidValue);
  const size_t smem = shared_bytes(sets * ways, K);
  if (smem > kMaxSharedBytes) return static_cast<int>(cudaErrorInvalidValue);
  Args a;
  a.tags = static_cast<int*>(tags);
  a.lru = static_cast<int*>(lru);
  a.stamp = static_cast<int*>(stamp);
  a.slot_of_block = static_cast<int*>(slot_of_block);
  a.block_of_slot = static_cast<int*>(block_of_slot);
  a.spp = Spp{static_cast<int*>(st_tag), static_cast<int*>(st_last), static_cast<int*>(st_sig),
              static_cast<int*>(pt_delta), static_cast<int*>(pt_weight),
              static_cast<int*>(pt_sigw)};
  a.wfq_in[0] = static_cast<const int*>(wfq_cr);
  a.wfq_in[1] = static_cast<const int*>(wfq_dd);
  a.wfq_in[2] = static_cast<const int*>(wfq_pd);
  a.wfq_out = static_cast<int*>(wfq_out);
  a.counters_in[0] = static_cast<const float*>(hits);
  a.counters_in[1] = static_cast<const float*>(demand_misses);
  a.counters_in[2] = static_cast<const float*>(prefetch_hits);
  a.counters_in[3] = static_cast<const float*>(prefetches);
  a.counters_out = static_cast<float*>(counters_out);
  a.ids = static_cast<const int*>(ids);
  a.K = K;
  a.fills = static_cast<int*>(fills);
  a.sets = sets;
  a.ways = ways;
  a.num_blocks = num_blocks;
  a.page_span = page_span;
  a.degree = degree;
  a.st_entries = st_entries;
  a.pt_entries = pt_entries;
  a.sig_mask = (1 << sig_bits) - 1;
  a.threshold = threshold;
  a.weight = weight;
  a.quantum = quantum;
  a.max_deficit = max_deficit;
  a.prefetch = prefetch ? 1 : 0;
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  tier_access_kernel<<<1, kThreads, smem, s>>>(a);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess || max_fills == 0 || units <= 0) return static_cast<int>(err);
  const long long per_block = static_cast<long long>(kCopyThreads) * 4;
  long long gx = (units + per_block - 1) / per_block;
  gx = gx < 1 ? 1 : (gx > 32 ? 32 : gx);
  long long gy = kCopyBlocks / gx;
  gy = gy < 1 ? 1 : (gy > max_fills ? max_fills : gy);
  const dim3 grid(static_cast<unsigned>(gx), static_cast<unsigned>(gy));
  const int* f = static_cast<const int*>(fills);
  const int* b = static_cast<const int*>(block_of_slot);
  switch (copy_kind) {
    case 0: err = launch_copy<0>(grid, s, f, b, slow, fast, units, num_blocks); break;
    case 1: err = launch_copy<1>(grid, s, f, b, slow, fast, units, num_blocks); break;
    case 2: err = launch_copy<2>(grid, s, f, b, slow, fast, units, num_blocks); break;
    default: err = launch_copy<3>(grid, s, f, b, slow, fast, units, num_blocks); break;
  }
  return static_cast<int>(err);
}
