// Decode attention over a block-pooled (paged) KV cache: one query token
// per sequence, GQA (G = Hq / Hkv query heads share a kv head), K/V blocks
// of T tokens reached through a (B, NB) block table, positions >= lengths[b]
// weigh 0, online softmax with float32 (m, l, acc); out = acc / max(l,
// 1e-20), so a sequence of length 0 gives exact zeros.
//
// Replaces the TPU kernel paged_attention
// (src/repro/kernels/paged_attention/kernel.py:74, pl.pallas_call at :103),
// whose grid (B, Hkv, NB) walked the blocks in order with the running state
// in VMEM scratch; its plain version here is
// repro_torch/kernels/paged_attention/ref.py.
//
// What bounds it on an H100: bytes. A (sequence, kv head) reads each live
// token's K and V rows once (2 * D * itemsize bytes) for about 4 * G * D
// float operations, one or two operations a byte, far below the card's
// balance point. At the tiered-KV decode (Hkv 8, D 64, 4,003 tokens, f32)
// that is 16.4 MB: 4.90 us at 3.35 TB/s.
//
// Design. One thread block cluster per (sequence, kv head); its `cluster`
// CTAs split the pair's live KV blocks into contiguous chunks. Every CTA
// asks for more than half an SM's shared memory, so no two share an SM,
// and the cluster is the largest size from 16 down to 9 of which the card
// holds all B * Hkv clusters at once (cudaOccupancyMaxActiveClusters),
// else 8: on an H100 that is 9 at the tiered decode's 8 pairs (72 SMs;
// only 7 clusters of 10 or more fit at once), 16 for a single pair. A
// CTA is one producer warp and W = RG * BW consumer warps:
//   - Loads: a ring of `stages` (up to 16, 128 KB) in shared memory, a
//     stage holding one KV block's K and V rows of the CTA's head. The
//     producer fetches the chunk's table entries 32 at a time (one per lane)
//     and fills each stage as soon as it is free; each stage completes to
//     its own mbarrier ("full"), and consumers release it through another
//     ("empty"). Copies: TMA (one elected lane; 4-D maps (D, Hkv, T, P)
//     over the views' own byte strides, boxes of one block's T x D) when the
//     bases, strides and D * itemsize are multiples of 16 bytes and D and T
//     at most 256; else cp.async of 16, 8 or 4 bytes by all 32 lanes
//     (cp.async.mbarrier.arrive.noinc); else element by element. The
//     wrapper picks the path from the views' layout; the consumer code is
//     the same for all three.
//   - Compute, float32 on the CUDA cores (f32 must hold 2e-5, so no TF32):
//     warp (rg, bw) takes R rows (4, or 2 past D 512; rows past G are zero
//     queries whose outputs are dropped) and the chunk's blocks bw,
//     bw + BW, ..., with its own (m, l, acc). Per block, lane (t, part)
//     scores token t against its R rows over every `parts`-th 16-byte chunk
//     of the row (chunks rotated by t, so 8 lanes reading 8 rows hit 8
//     distinct banks), the parts are summed by shuffles, the online softmax
//     (in log2 units, exp2) takes one (m, l) update per row and block, and
//     p.v keeps acc in registers, the lane owning pairs of adjacent columns
//     (one 8- or 4-byte load of V a token) and reading the R probabilities
//     of a token in one shared-memory load. Tokens past the length are
//     never scored or read.
//   - Merge: each warp leaves its state in shared memory (over the drained
//     ring); the CTA folds its walkers into one partial (M, L, ACC), one
//     warp per row for the scales; it then stores (M, L) of every row into
//     every rank of the cluster, and the ACC of rank q's slice of the
//     G x D outputs into rank q, through distributed shared memory
//     (map_shared_rank, stores only); one cluster.sync(); each rank merges
//     its slice from its own shared memory and writes the output. No
//     workspace, no counters, no atomics: a call is one kernel launch.
// G above 8 * R rows runs as several row blocks (gridDim.y), each its own
// cluster over the pair's blocks. Slots are clamped into the pool. Built
// with nvcc into a shared library with a plain C interface and called
// through ctypes; the TMA maps are encoded per call with
// cuTensorMapEncodeTiled, taken from the runtime with
// cudaGetDriverEntryPoint(ByVersion), so nothing links libcuda.

#include <cstdint>
#include <cstring>

#include <cooperative_groups.h>
#include <cuda.h>          // CUtensorMap and its enums (types only: nothing links libcuda)
#include <cuda_bf16.h>
#include <cuda_runtime.h>

namespace cg = cooperative_groups;

namespace {

constexpr unsigned kFull = 0xffffffffu;
constexpr float kNegInf = -1e30f;
constexpr float kLog2e = 1.4426950408889634f;
constexpr size_t kMaxSharedBytes = 227 * 1024;
constexpr int kMaxWarps = 8;           // consumer warps of a CTA
constexpr int kThreads = 32 * (kMaxWarps + 1);
constexpr int kMaxD = 1024;            // columns of a lane: D / 32 <= 32
constexpr int kMaxTmaBox = 256;        // a TMA box's limit in each dimension
constexpr int kMinStages = 3;
constexpr int kMaxStages = 16;
constexpr int kMaxCluster = 16;
constexpr int kMinCluster = 8;
constexpr size_t kRingBytes = 128 * 1024;
// A CTA asks for more than half an SM's 228 KB of shared memory, so no two
// CTAs share an SM and a cluster's CTAs spread over its GPC's SMs.
constexpr size_t kMinSharedBytes = 116 * 1024;
constexpr int kPlanInts = 4 + kMaxCluster - kMinCluster + 1;
enum Path { kTma = 0, kCpAsync = 1, kElement = 2 };

__device__ __forceinline__ float to_f32(float x) { return x; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 x) { return __bfloat162float(x); }
__device__ __forceinline__ void store(float* p, float x) { *p = x; }
__device__ __forceinline__ void store(__nv_bfloat16* p, float x) { *p = __float2bfloat16(x); }

__device__ __forceinline__ float warp_max(float v) {
  for (int off = 16; off > 0; off >>= 1) v = fmaxf(v, __shfl_xor_sync(kFull, v, off));
  return v;
}

__device__ __forceinline__ float warp_sum(float v) {
  for (int off = 16; off > 0; off >>= 1) v += __shfl_xor_sync(kFull, v, off);
  return v;
}

__device__ __forceinline__ float bf16_lo(uint32_t w) { return __uint_as_float(w << 16); }
__device__ __forceinline__ float bf16_hi(uint32_t w) { return __uint_as_float(w & 0xffff0000u); }

// 16 bytes of E in shared memory as floats (4 of float, 8 of bfloat16).
template <typename E>
struct Vec;

template <>
struct Vec<float> {
  static constexpr int n = 4;
  __device__ __forceinline__ static void load16(const unsigned char* p, float* out) {
    const float4 v = *reinterpret_cast<const float4*>(p);
    out[0] = v.x; out[1] = v.y; out[2] = v.z; out[3] = v.w;
  }
};

template <>
struct Vec<__nv_bfloat16> {
  static constexpr int n = 8;
  __device__ __forceinline__ static void load16(const unsigned char* p, float* out) {
    const uint4 u = *reinterpret_cast<const uint4*>(p);
    out[0] = bf16_lo(u.x); out[1] = bf16_hi(u.x);
    out[2] = bf16_lo(u.y); out[3] = bf16_hi(u.y);
    out[4] = bf16_lo(u.z); out[5] = bf16_hi(u.z);
    out[6] = bf16_lo(u.w); out[7] = bf16_hi(u.w);
  }
};

__host__ __device__ __forceinline__ size_t round_up(size_t x, size_t m) { return (x + m - 1) / m * m; }
__host__ __device__ __forceinline__ int cdiv(int a, int b) { return (a + b - 1) / b; }

// Query rows a warp holds at DW columns a lane (every warp holds exactly
// this many, rows past G being zero queries whose outputs are dropped):
// its acc takes at most 64 registers.
__host__ __device__ constexpr int max_rows(int dw) { return dw <= 16 ? 4 : 64 / dw; }


// How the rows share the work: DW columns of a lane (a power of two,
// D <= 32 * DW); the G rows of a kv head in row blocks of at most
// kMaxWarps * R (one cluster each, gridDim.y); a CTA's `gc` rows in RG row
// groups of R = max_rows(DW) rows.
struct Warps {
  int dw, rows, block_rows, row_blocks, gc, rg;
  __host__ __device__ Warps(int G, int D) {
    dw = 1;
    while (32 * dw < D) dw *= 2;
    rows = max_rows(dw);
    block_rows = kMaxWarps * rows;
    row_blocks = cdiv(G, block_rows);
    gc = G < block_rows ? G : block_rows;
    rg = cdiv(gc, rows);
  }
};

// Shared memory, in bytes from a 128-aligned base: the ring (stages of a
// K tile and a V tile, rows of rs bytes), whose space the warps' states
// reuse once it is drained; the CTA's queries in f32 (RG * R rows of dq
// floats, zero past D and past the CTA's rows); the CTA's (M, L) per row;
// the walkers' and then the ranks' scales of each row; each warp's
// probabilities of a pass (32 tokens x R rows); what the cluster's ranks
// send this CTA (M and L of every row, ACC of this CTA's slice); the full
// and empty mbarriers.
// The stages and the block walkers (BW per row group, W = RG * BW consumer
// warps) are chosen together: a walker takes blocks j = bw mod BW, and
// block j stage j mod S, so with S a multiple of BW a walker meets each of
// its stages again exactly one phase later and never waits on a parity
// two phases ahead.
struct Layout {
  int rs, nch, dq, stages, walkers, warps;
  size_t tile, stage, ring, warp_state, q, ml, scale, probs, recv, bars, total;
  __host__ __device__ Layout(int G, int D, int T, int isz) {
    const Warps w(G, D);
    rs = static_cast<int>(round_up(static_cast<size_t>(D) * isz, 16));
    nch = rs / 16;
    dq = nch * (16 / isz);
    tile = round_up(static_cast<size_t>(T) * rs, 128);
    stage = 2 * tile;
    size_t s = kRingBytes / stage;
    s = s < kMinStages ? kMinStages : (s > kMaxStages ? kMaxStages : s);
    const int s0 = static_cast<int>(s), bw0 = kMaxWarps / w.rg;
    if (s0 - s0 % bw0 >= kMinStages) {
      stages = s0 - s0 % bw0;
      walkers = bw0;
    } else {
      stages = s0;
      walkers = bw0 < s0 ? bw0 : s0;
      while (stages % walkers) --walkers;
    }
    warps = w.rg * walkers;
    ring = stages * stage;
    warp_state = static_cast<size_t>(warps) * w.rows * (D + 2) * sizeof(float);
    q = round_up(ring > warp_state ? ring : warp_state, 16);
    ml = q + round_up(static_cast<size_t>(w.rg) * w.rows * dq * sizeof(float), 16);
    scale = ml + static_cast<size_t>(w.gc) * 2 * sizeof(float);
    probs = round_up(scale + static_cast<size_t>(w.gc) * (kMaxCluster + 1) * sizeof(float), 16);
    recv = probs + static_cast<size_t>(warps) * 32 * w.rows * sizeof(float);
    bars = round_up(recv + (static_cast<size_t>(w.gc) * (2 * kMaxCluster + D) + kMaxCluster) *
                               sizeof(float), 8);
    total = bars + 2 * stages * 8 + 128;   // + alignment slack
    if (total < kMinSharedBytes) total = kMinSharedBytes;
  }
};

struct Params {
  const void* q;
  const int* table;
  const int* lengths;
  void* out;
  const unsigned char* k;   // the views' bases (non-TMA paths)
  const unsigned char* v;
  long long ks0, ks1, ks2, vs0, vs1, vs2;   // strides in bytes
  int Hkv, G, D, T, NB, P, cluster, path, width;
  float sqrt_d;
};

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

__device__ __forceinline__ void mbar_init(uint32_t bar, uint32_t count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;" ::"r"(bar), "r"(count) : "memory");
}

__device__ __forceinline__ void mbar_expect_tx(uint32_t bar, uint32_t bytes) {
  asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;" ::"r"(bar), "r"(bytes)
               : "memory");
}

__device__ __forceinline__ void mbar_arrive(uint32_t bar) {
  asm volatile("mbarrier.arrive.shared::cta.b64 _, [%0];" ::"r"(bar) : "memory");
}

// Wait until the phase of parity `parity` of the barrier has completed.
__device__ __forceinline__ void mbar_wait(uint32_t bar, uint32_t parity) {
  uint32_t done = 0;
  do {
    asm volatile(
        "{\n.reg .pred p;\n"
        "mbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n"
        "selp.u32 %0, 1, 0, p;\n}\n"
        : "=r"(done)
        : "r"(bar), "r"(parity)
        : "memory");
  } while (!done);
}

// One box of a 4-D map into shared memory, completing on `bar`.
__device__ __forceinline__ void tma_load_4d(uint32_t dst, const CUtensorMap* map, uint32_t bar,
                                            int c0, int c1, int c2, int c3) {
  asm volatile(
      "cp.async.bulk.tensor.4d.shared::cluster.global.mbarrier::complete_tx::bytes "
      "[%0], [%1, {%3, %4, %5, %6}], [%2];"
      ::"r"(dst), "l"(reinterpret_cast<uint64_t>(map)), "r"(bar), "r"(c0), "r"(c1), "r"(c2),
      "r"(c3)
      : "memory");
}

template <int N>
__device__ __forceinline__ void cp_async(uint32_t dst, const void* src) {
  if constexpr (N == 16) {
    asm volatile("cp.async.cg.shared.global [%0], [%1], 16;" ::"r"(dst), "l"(src) : "memory");
  } else {
    asm volatile("cp.async.ca.shared.global [%0], [%1], %2;" ::"r"(dst), "l"(src), "n"(N)
                 : "memory");
  }
}

// The barrier's phase completes once this thread's earlier cp.async are done.
__device__ __forceinline__ void cp_async_arrive(uint32_t bar) {
  asm volatile("cp.async.mbarrier.arrive.noinc.shared::cta.b64 [%0];" ::"r"(bar) : "memory");
}

// Column k of a lane's DW: lane + 32 k at DW 1, else pairs of adjacent
// columns (one 8- or 4-byte load a pair), 64 apart.
template <int DW>
__device__ __forceinline__ int column_of(int k, int lane) {
  return DW == 1 ? lane : 64 * (k >> 1) + 2 * lane + (k & 1);
}

// A V row's DW columns of this lane (column_of) as floats, 0 past D. A
// pair's second column may lie past D only in the row's zeroed padding.
template <typename E, int DW>
struct Cols {
  __device__ __forceinline__ static void load(const unsigned char* row, int lane, int D,
                                              float* out) {
    const E* v = reinterpret_cast<const E*>(row);
    if constexpr (DW == 1) {
      out[0] = lane < D ? to_f32(v[lane]) : 0.f;
    } else {
#pragma unroll
      for (int k = 0; k < DW; k += 2) {
        const int d = column_of<DW>(k, lane);
        float2 x = make_float2(0.f, 0.f);
        if (d < D) {
          if constexpr (sizeof(E) == 4) {
            x = *reinterpret_cast<const float2*>(v + d);
          } else {
            x = __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(v + d));
          }
        }
        out[k] = x.x;
        out[k + 1] = x.y;
      }
    }
  }
};

// R floats of a pass's probabilities in shared memory, one access.
template <int R>
struct Rows {
  __device__ __forceinline__ static void store(float* p, const float* x) {
    if constexpr (R == 4) {
      *reinterpret_cast<float4*>(p) = make_float4(x[0], x[1], x[2], x[3]);
    } else if constexpr (R == 2) {
      *reinterpret_cast<float2*>(p) = make_float2(x[0], x[1]);
    } else {
#pragma unroll
      for (int r = 0; r < R; ++r) p[r] = x[r];
    }
  }
  __device__ __forceinline__ static void load(const float* p, float* x) {
    if constexpr (R == 4) {
      const float4 v = *reinterpret_cast<const float4*>(p);
      x[0] = v.x; x[1] = v.y; x[2] = v.z; x[3] = v.w;
    } else if constexpr (R == 2) {
      const float2 v = *reinterpret_cast<const float2*>(p);
      x[0] = v.x; x[1] = v.y;
    } else {
#pragma unroll
      for (int r = 0; r < R; ++r) x[r] = p[r];
    }
  }
};

// A KV block's T rows (row_bytes each, row_stride apart in global memory)
// into shared memory rows rs apart, in cp.async copies of N bytes by the
// warp's 32 lanes.
template <int N>
__device__ __forceinline__ void copy_rows(uint32_t dst, const unsigned char* src,
                                          long long row_stride, int T, int row_bytes, int rs,
                                          int lane) {
  const int per_row = row_bytes / N;
  for (int c = lane; c < T * per_row; c += 32) {
    const int t = c / per_row, o = N * (c % per_row);
    cp_async<N>(dst + t * rs + o, src + t * row_stride + o);
  }
}

template <typename E, int DW>
__global__ void __launch_bounds__(kThreads, 1)
    paged_attention_kernel(const __grid_constant__ CUtensorMap tm_k,
                           const __grid_constant__ CUtensorMap tm_v, const Params p) {
  constexpr int kVec = Vec<E>::n;
  constexpr int kIsz = static_cast<int>(sizeof(E));
  constexpr int R = max_rows(DW);
  extern __shared__ unsigned char smem_raw[];
  unsigned char* smem = reinterpret_cast<unsigned char*>(
      round_up(reinterpret_cast<uintptr_t>(smem_raw), 128));
  const Warps wp(p.G, p.D);
  const Layout lay(p.G, p.D, p.T, kIsz);
  const int S = lay.stages, W = lay.warps, BW = lay.walkers, C = p.cluster;
  float* qs = reinterpret_cast<float*>(smem + lay.q);
  float* cta_ml = reinterpret_cast<float*>(smem + lay.ml);   // [M (gc), L (gc)]
  float* scales = reinterpret_cast<float*>(smem + lay.scale);
  float* probs = reinterpret_cast<float*>(smem + lay.probs);
  float* recv_m = reinterpret_cast<float*>(smem + lay.recv);   // [rank][row]
  float* recv_l = recv_m + kMaxCluster * wp.gc;                // [rank][row]
  float* recv_acc = recv_l + kMaxCluster * wp.gc;              // [rank][slice]
  const uint32_t ring = smem_u32(smem);
  const uint32_t full = smem_u32(smem + lay.bars), empty = full + 8 * S;

  cg::cluster_group cluster = cg::this_cluster();
  const int rank = static_cast<int>(cluster.block_rank());
  const int pair = blockIdx.x / p.cluster;
  const int b = pair / p.Hkv, h = pair % p.Hkv;
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  // this CTA's rows: gb rows of the pair's G from row gr0
  const int gr0 = blockIdx.y * wp.block_rows, gb = min(wp.block_rows, p.G - gr0);
  const int len = p.lengths[b];
  // this CTA has started: the cluster's wait before the first remote store
  // below finds every CTA running
  asm volatile("barrier.cluster.arrive.relaxed.aligned;" ::: "memory");

  if (threadIdx.x == 0) {
    for (int s = 0; s < S; ++s) {
      mbar_init(full + 8 * s, p.path == kTma ? 1 : 32);
      mbar_init(empty + 8 * s, wp.rg);   // one arrival per row group
    }
    asm volatile("fence.mbarrier_init.release.cluster;" ::: "memory");
    if (p.path == kTma) {
      asm volatile("prefetch.tensormap [%0];" ::"l"(reinterpret_cast<uint64_t>(&tm_k)) : "memory");
      asm volatile("prefetch.tensormap [%0];" ::"l"(reinterpret_cast<uint64_t>(&tm_v)) : "memory");
    }
  }
  if (lay.rs != p.D * kIsz) {   // rows padded to 16 bytes: the padding stays 0
    for (size_t i = 16 * threadIdx.x; i < lay.ring; i += 16 * blockDim.x)
      *reinterpret_cast<uint4*>(smem + i) = make_uint4(0u, 0u, 0u, 0u);
  }
  {   // the CTA's queries in f32, zero past D and past its rows
    const E* qb = static_cast<const E*>(p.q) + (static_cast<size_t>(pair) * p.G + gr0) * p.D;
    for (int i = threadIdx.x; i < wp.rg * R * lay.dq; i += blockDim.x) {
      const int g = i / lay.dq, d = i - g * lay.dq;
      qs[i] = g < gb && d < p.D ? to_f32(qb[g * p.D + d]) : 0.f;
    }
  }
  __syncthreads();

  // this CTA's chunk of the pair's live blocks: [j0, j0 + n)
  const int live = len <= 0 ? 0 : min(p.NB, cdiv(len, p.T));
  const int chunk = cdiv(live, C);
  const int j0 = rank * chunk;
  const int n = max(0, min(chunk, live - j0));

  float m[R], l[R], acc[R][DW];
#pragma unroll
  for (int r = 0; r < R; ++r) {
    m[r] = kNegInf;
    l[r] = 0.f;
#pragma unroll
    for (int k = 0; k < DW; ++k) acc[r][k] = 0.f;
  }
  const int rg = warp % wp.rg, bw = warp / wp.rg;
  const int g0 = rg * R;   // the warp's first row in the CTA

  if (warp == W) {
    // producer: the chunk's slots 32 at a time, one stage per KV block
    const int* row = p.table + static_cast<size_t>(b) * p.NB + j0;
    for (int base = 0; base < n; base += 32) {
      const int mine = base + lane < n ? min(max(row[base + lane], 0), p.P - 1) : 0;
      const int cnt = min(32, n - base);
      for (int i = 0; i < cnt; ++i) {
        const int j = base + i, s = j % S;
        const int slot = __shfl_sync(kFull, mine, i);
        if (j >= S) mbar_wait(empty + 8 * s, ((j / S) - 1) & 1);
        const uint32_t kd = ring + s * static_cast<uint32_t>(lay.stage);
        const uint32_t vd = kd + static_cast<uint32_t>(lay.tile);
        if (p.path == kTma) {
          if (lane == 0) {
            mbar_expect_tx(full + 8 * s, 2u * p.T * p.D * kIsz);
            tma_load_4d(kd, &tm_k, full + 8 * s, 0, h, 0, slot);
            tma_load_4d(vd, &tm_v, full + 8 * s, 0, h, 0, slot);
          }
          continue;
        }
        const unsigned char* kb = p.k + slot * p.ks0 + h * p.ks2;
        const unsigned char* vb = p.v + slot * p.vs0 + h * p.vs2;
        if (p.path == kCpAsync) {
          const int bytes = p.D * kIsz;
          if (p.width == 16) {
            copy_rows<16>(kd, kb, p.ks1, p.T, bytes, lay.rs, lane);
            copy_rows<16>(vd, vb, p.vs1, p.T, bytes, lay.rs, lane);
          } else if (p.width == 8) {
            copy_rows<8>(kd, kb, p.ks1, p.T, bytes, lay.rs, lane);
            copy_rows<8>(vd, vb, p.vs1, p.T, bytes, lay.rs, lane);
          } else {
            copy_rows<4>(kd, kb, p.ks1, p.T, bytes, lay.rs, lane);
            copy_rows<4>(vd, vb, p.vs1, p.T, bytes, lay.rs, lane);
          }
          cp_async_arrive(full + 8 * s);
        } else {
          unsigned char* ks = smem + s * lay.stage;
          unsigned char* vs = ks + lay.tile;
          for (int e = lane; e < p.T * p.D; e += 32) {
            const int t = e / p.D, d = e % p.D;
            reinterpret_cast<E*>(ks + t * lay.rs)[d] =
                *reinterpret_cast<const E*>(kb + t * p.ks1 + d * kIsz);
            reinterpret_cast<E*>(vs + t * lay.rs)[d] =
                *reinterpret_cast<const E*>(vb + t * p.vs1 + d * kIsz);
          }
          mbar_arrive(full + 8 * s);
        }
      }
    }
  } else {
    // consumers: the walker's blocks
    int tp = 1;   // tokens of a pass: lane = part * tp + token
    while (tp < p.T && tp < 32) tp *= 2;
    const int parts = 32 / tp, tl = lane % tp, part = lane / tp;
    const float scale = kLog2e / p.sqrt_d;   // scores in log2 units: exp2 below
    const float* qw = qs + g0 * lay.dq;
    float* pw = probs + warp * 32 * R;         // [token][row] of a pass
    for (int j = bw; j < n; j += BW) {
      const int s = j % S;
      mbar_wait(full + 8 * s, (j / S) & 1);
      const unsigned char* kt = smem + s * lay.stage;
      const unsigned char* vt = kt + lay.tile;
      const int tv = min(p.T, len - (j0 + j) * p.T);   // valid tokens, >= 1
      for (int tb = 0; tb < tv; tb += tp) {
        const int t = tb + tl;
        const bool valid = t < tv;
        float sc[R];
#pragma unroll
        for (int r = 0; r < R; ++r) sc[r] = 0.f;
        if (valid) {
          // every parts-th 16-byte chunk of row t, rotated by t
          const unsigned char* krow = kt + t * lay.rs;
          const int rot = t % lay.nch;
#pragma unroll 2
          for (int c = part; c < lay.nch; c += parts) {
            int cc = c + rot;
            if (cc >= lay.nch) cc -= lay.nch;
            float kv[kVec];
            Vec<E>::load16(krow + 16 * cc, kv);
#pragma unroll
            for (int r = 0; r < R; ++r) {
#pragma unroll
              for (int x = 0; x < kVec; x += 4) {
                const float4 qv =
                    *reinterpret_cast<const float4*>(qw + r * lay.dq + cc * kVec + x);
                sc[r] = fmaf(qv.x, kv[x], sc[r]);
                sc[r] = fmaf(qv.y, kv[x + 1], sc[r]);
                sc[r] = fmaf(qv.z, kv[x + 2], sc[r]);
                sc[r] = fmaf(qv.w, kv[x + 3], sc[r]);
              }
            }
          }
        }
        // the parts' sums, then one online-softmax step per row
        for (int off = tp; off < 32; off <<= 1) {
#pragma unroll
          for (int r = 0; r < R; ++r) sc[r] += __shfl_xor_sync(kFull, sc[r], off);
        }
        float mx[R];
#pragma unroll
        for (int r = 0; r < R; ++r) {
          sc[r] = valid ? sc[r] * scale : kNegInf;
          mx[r] = sc[r];
        }
        for (int off = 1; off < tp; off <<= 1) {
#pragma unroll
          for (int r = 0; r < R; ++r) mx[r] = fmaxf(mx[r], __shfl_xor_sync(kFull, mx[r], off));
        }
        float pr[R];
#pragma unroll
        for (int r = 0; r < R; ++r) {
          const float m_new = fmaxf(m[r], mx[r]);
          const float alpha = exp2f(m[r] - m_new);
          pr[r] = valid ? exp2f(sc[r] - m_new) : 0.f;
          l[r] = l[r] * alpha + pr[r];
          m[r] = m_new;
#pragma unroll
          for (int k = 0; k < DW; ++k) acc[r][k] *= alpha;
        }
        __syncwarp();   // the previous pass's probabilities are read
        if (part == 0) Rows<R>::store(pw + tl * R, pr);
        __syncwarp();
        // p.v: the lane's columns (column_of) of its rows
        const int nt = min(tp, tv - tb);
#pragma unroll 4
        for (int tt = 0; tt < nt; ++tt) {
          float vv[DW], pt[R];
          Cols<E, DW>::load(vt + (tb + tt) * lay.rs, lane, p.D, vv);
          Rows<R>::load(pw + tt * R, pt);
#pragma unroll
          for (int r = 0; r < R; ++r) {
#pragma unroll
            for (int k = 0; k < DW; ++k) acc[r][k] = fmaf(pt[r], vv[k], acc[r][k]);
          }
        }
      }
      __syncwarp();
      if (lane == 0) mbar_arrive(empty + 8 * s);
    }
    for (int off = 1; off < tp; off <<= 1) {
#pragma unroll
      for (int r = 0; r < R; ++r) l[r] += __shfl_xor_sync(kFull, l[r], off);
    }
  }
  __syncthreads();   // the ring is drained: its space holds the warps' states

  // warp state [m (R), l (R), acc (R x D)]
  const int sw = R * (p.D + 2);
  float* states = reinterpret_cast<float*>(smem);
  if (warp < W) {
    float* st = states + warp * sw;
#pragma unroll
    for (int r = 0; r < R; ++r) {
      if (lane == 0) {
        st[r] = m[r];
        st[R + r] = l[r];
      }
#pragma unroll
      for (int k = 0; k < DW; ++k) {
        const int d = column_of<DW>(k, lane);
        if (d < p.D) st[2 * R + r * p.D + d] = acc[r][k];
      }
    }
  }
  __syncthreads();

  // the CTA's partial: its walkers (warp = walker * RG + row group) folded;
  // a row's walker scales and (M, L) by one warp, lane w for walker w
  const int nwarps = static_cast<int>(blockDim.x) / 32;
  for (int g = warp; g < gb; g += nwarps) {
    const float* st0 = states + (g / R) * sw + g % R + lane * wp.rg * sw;
    const float mw = lane < BW ? st0[0] : kNegInf;
    const float mx = warp_max(mw);
    const float c = lane < BW ? exp2f(mw - mx) : 0.f;
    const float lsum = warp_sum(lane < BW ? st0[R] * c : 0.f);
    if (lane < BW) scales[g * kMaxWarps + lane] = c;
    if (lane == 0) {
      cta_ml[g] = mx;
      cta_ml[wp.gc + g] = lsum;
    }
  }
  __syncthreads();

  // send it to the ranks: every rank gets (M, L) of every row; rank q the
  // ACC of its slice [q * per, (q + 1) * per) of the gb x D outputs
  // (distributed shared memory, stores only)
  const int total = gb * p.D, per = cdiv(total, C);
  asm volatile("barrier.cluster.wait.aligned;" ::: "memory");
  for (int i = threadIdx.x; i < gb * C; i += blockDim.x) {
    const int g = i / C, q = i - g * C;
    cluster.map_shared_rank(recv_m, q)[rank * wp.gc + g] = cta_ml[g];
    cluster.map_shared_rank(recv_l, q)[rank * wp.gc + g] = cta_ml[wp.gc + g];
  }
  for (int i = threadIdx.x; i < total; i += blockDim.x) {
    const int g = i / p.D, d = i - g * p.D;
    const float* st0 = states + (g / R) * sw + 2 * R + (g % R) * p.D + d;
    const float* sc0 = scales + g * kMaxWarps;
    float sum = 0.f;
#pragma unroll
    for (int w = 0; w < kMaxWarps; ++w)
      if (w < BW) sum = fmaf(st0[w * wp.rg * sw], sc0[w], sum);
    const int q = i / per;
    cluster.map_shared_rank(recv_acc, q)[rank * per + (i - q * per)] = sum;
  }
  cluster.sync();   // every rank's sends have landed; nothing remote follows

  // this CTA's slice [o0, o1): each row's rank scales and 1 / L by one warp
  // (lane q for rank q), then the outputs, all from local shared memory
  const int o0 = min(total, rank * per), o1 = min(total, o0 + per);
  const int ga = o0 / p.D, gz = o1 > o0 ? (o1 - 1) / p.D + 1 : ga;
  constexpr int kRank = kMaxCluster + 1;
  for (int g = ga + warp; g < gz; g += nwarps) {
    const float mq = lane < C ? recv_m[lane * wp.gc + g] : kNegInf;
    const float mx = warp_max(mq);
    const float c = lane < C ? exp2f(mq - mx) : 0.f;
    const float lsum = warp_sum(lane < C ? recv_l[lane * wp.gc + g] * c : 0.f);
    if (lane < kMaxCluster) scales[g * kRank + lane] = c;
    if (lane == 0) scales[g * kRank + kMaxCluster] = 1.f / fmaxf(lsum, 1e-20f);
  }
  __syncthreads();
  E* ob = static_cast<E*>(p.out) + (static_cast<size_t>(pair) * p.G + gr0) * p.D;
  for (int o = o0 + static_cast<int>(threadIdx.x); o < o1; o += static_cast<int>(blockDim.x)) {
    const float* sg = scales + (o / p.D) * kRank;
    const float* ra = recv_acc + (o - o0);
    float a = 0.f;
#pragma unroll
    for (int q = 0; q < kMaxCluster; ++q)
      if (q < C) a = fmaf(ra[q * per], sg[q], a);
    store(ob + o, a * sg[kMaxCluster]);
  }
}

// cuTensorMapEncodeTiled from libcuda, looked up through the runtime (no -lcuda)
using EncodeTiled = CUresult (*)(CUtensorMap*, CUtensorMapDataType, cuuint32_t, void*,
                                 const cuuint64_t*, const cuuint64_t*, const cuuint32_t*,
                                 const cuuint32_t*, CUtensorMapInterleave, CUtensorMapSwizzle,
                                 CUtensorMapL2promotion, CUtensorMapFloatOOBfill);

EncodeTiled encoder() {
  static EncodeTiled fn = nullptr;
  if (fn == nullptr) {
    void* ptr = nullptr;
    cudaDriverEntryPointQueryResult found;
#if CUDART_VERSION >= 12050
    const cudaError_t err = cudaGetDriverEntryPointByVersion("cuTensorMapEncodeTiled", &ptr, 12000,
                                                            cudaEnableDefault, &found);
#else
    const cudaError_t err =
        cudaGetDriverEntryPoint("cuTensorMapEncodeTiled", &ptr, cudaEnableDefault, &found);
#endif
    if (err == cudaSuccess && found == cudaDriverEntryPointSuccess) fn = reinterpret_cast<EncodeTiled>(ptr);
  }
  return fn;
}

// (D, Hkv, T, P) map of a K or V view, strides in bytes; boxes of one
// block's T x D rows of one head, no swizzle.
int encode_kv(EncodeTiled enc, CUtensorMap* map, CUtensorMapDataType type, int isz,
              const void* ptr, int D, int Hkv, int T, int P, long long s0, long long s1,
              long long s2) {
  const cuuint64_t dims[4] = {static_cast<cuuint64_t>(D), static_cast<cuuint64_t>(Hkv),
                              static_cast<cuuint64_t>(T), static_cast<cuuint64_t>(P)};
  cuuint64_t strides[3] = {static_cast<cuuint64_t>(s2), static_cast<cuuint64_t>(s1),
                           static_cast<cuuint64_t>(s0)};
  for (int i = 0; i < 3; ++i)   // a dimension of size 1 is never stepped: any valid stride
    if (dims[i + 1] == 1) strides[i] = static_cast<cuuint64_t>(D) * isz;
  const cuuint32_t box[4] = {static_cast<cuuint32_t>(D), 1, static_cast<cuuint32_t>(T), 1};
  const cuuint32_t elem[4] = {1, 1, 1, 1};
  const CUresult r = enc(map, type, 4, const_cast<void*>(ptr), dims, strides, box, elem,
                         CU_TENSOR_MAP_INTERLEAVE_NONE, CU_TENSOR_MAP_SWIZZLE_NONE,
                         CU_TENSOR_MAP_L2_PROMOTION_L2_256B, CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE);
  return r == CUDA_SUCCESS ? 0 : static_cast<int>(cudaErrorInvalidValue);
}

// Clusters of `size` CTAs of this shape the card holds at once (0 when it
// holds none or cannot say).
template <typename E, int DW>
int max_clusters(int threads, size_t smem, int size) {
  const auto kernel = paged_attention_kernel<E, DW>;
  static bool configured = false;
  if (!configured) {
    if (cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                             static_cast<int>(kMaxSharedBytes)) != cudaSuccess ||
        cudaFuncSetAttribute(kernel, cudaFuncAttributeNonPortableClusterSizeAllowed, 1) !=
            cudaSuccess) {
      cudaGetLastError();
      return 0;
    }
    configured = true;
  }
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3(static_cast<unsigned>(size));
  cfg.blockDim = dim3(static_cast<unsigned>(threads));
  cfg.dynamicSmemBytes = smem;
  cudaLaunchAttribute attr;
  attr.id = cudaLaunchAttributeClusterDimension;
  attr.val.clusterDim.x = static_cast<unsigned>(size);
  attr.val.clusterDim.y = 1;
  attr.val.clusterDim.z = 1;
  cfg.attrs = &attr;
  cfg.numAttrs = 1;
  int n = 0;
  if (cudaOccupancyMaxActiveClusters(&n, kernel, &cfg) != cudaSuccess) {
    cudaGetLastError();
    n = 0;
  }
  return n;
}

// The launch plan of a shape: {cluster, stages, threads, shared bytes,
// then the clusters of 8, 9, ..., 16 CTAs the card holds at once}. The
// cluster is the largest size of which the card holds all B * Hkv pairs'
// clusters at once (one wave), else 8.
template <typename E, int DW>
void plan(int G, int D, int T, int pairs, int* out) {
  const Layout lay(G, D, T, static_cast<int>(sizeof(E)));
  const int threads = 32 * (lay.warps + 1);
  // one entry per shape: the occupancy queries cost more than a launch
  static int key[3] = {-1, -1, -1};
  static int held[kMaxCluster + 1];
  if (key[0] != G || key[1] != D || key[2] != T) {
    for (int c = kMinCluster; c <= kMaxCluster; ++c) held[c] = max_clusters<E, DW>(threads, lay.total, c);
    key[0] = G;
    key[1] = D;
    key[2] = T;
  }
  int cluster = kMinCluster;
  for (int c = kMaxCluster; c > kMinCluster; --c) {
    if (held[c] >= pairs) {
      cluster = c;
      break;
    }
  }
  out[0] = cluster;
  out[1] = lay.stages;
  out[2] = threads;
  out[3] = static_cast<int>(lay.total);
  for (int c = kMinCluster; c <= kMaxCluster; ++c) out[4 + c - kMinCluster] = held[c];
}

template <typename E, int DW>
int launch(Params p, int B, cudaStream_t stream) {
  const Layout lay(p.G, p.D, p.T, static_cast<int>(sizeof(E)));
  if (lay.total > kMaxSharedBytes) return static_cast<int>(cudaErrorInvalidValue);
  const int pairs = B * p.Hkv;
  int pl[kPlanInts];
  plan<E, DW>(p.G, p.D, p.T, pairs, pl);
  p.cluster = pl[0];
  CUtensorMap tm_k, tm_v;
  memset(&tm_k, 0, sizeof(tm_k));
  memset(&tm_v, 0, sizeof(tm_v));
  if (p.path == kTma) {
    const EncodeTiled enc = encoder();
    if (enc == nullptr) return static_cast<int>(cudaErrorNotSupported);
    const CUtensorMapDataType type =
        sizeof(E) == 4 ? CU_TENSOR_MAP_DATA_TYPE_FLOAT32 : CU_TENSOR_MAP_DATA_TYPE_BFLOAT16;
    const int isz = static_cast<int>(sizeof(E));
    int err = encode_kv(enc, &tm_k, type, isz, p.k, p.D, p.Hkv, p.T, p.P, p.ks0, p.ks1, p.ks2);
    if (err == 0) err = encode_kv(enc, &tm_v, type, isz, p.v, p.D, p.Hkv, p.T, p.P, p.vs0, p.vs1, p.vs2);
    if (err != 0) return err;
  }
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3(static_cast<unsigned>(pairs * p.cluster),
                     static_cast<unsigned>(Warps(p.G, p.D).row_blocks));
  cfg.blockDim = dim3(static_cast<unsigned>(pl[2]));
  cfg.dynamicSmemBytes = lay.total;
  cfg.stream = stream;
  cudaLaunchAttribute attr;
  attr.id = cudaLaunchAttributeClusterDimension;
  attr.val.clusterDim.x = static_cast<unsigned>(p.cluster);
  attr.val.clusterDim.y = 1;
  attr.val.clusterDim.z = 1;
  cfg.attrs = &attr;
  cfg.numAttrs = 1;
  const cudaError_t err = cudaLaunchKernelEx(&cfg, paged_attention_kernel<E, DW>, tm_k, tm_v, p);
  if (err != cudaSuccess) return static_cast<int>(err);
  return static_cast<int>(cudaGetLastError());
}

// Whether the views' layout allows the copy path the wrapper chose: TMA
// needs 16-byte bases, strides (of dimensions larger than 1) and rows and
// boxes of at most 256; cp.async of `width` bytes needs them width-aligned.
bool path_ok(const void* k, const void* v, const long long* st, const int* sizes, int D, int T,
             int isz, int path, int width) {
  if (path == kElement) return true;
  const long long a = path == kTma ? 16 : width;
  if (path == kCpAsync && a != 16 && a != 8 && a != 4) return false;
  if (path == kTma && (D > kMaxTmaBox || T > kMaxTmaBox)) return false;
  if (reinterpret_cast<uintptr_t>(k) % a || reinterpret_cast<uintptr_t>(v) % a) return false;
  if ((static_cast<long long>(D) * isz) % a) return false;
  for (int i = 0; i < 6; ++i)
    if (sizes[i % 3] > 1 && (st[i] * isz) % a) return false;
  return path == kTma || path == kCpAsync;
}

}  // namespace

// q (B, Hq, D), k and v (P, T, Hkv, D) strided views (strides in elements,
// D contiguous), out (B, Hq, D), all float32 (dtype 0) or bfloat16 (dtype
// 1); table (B, NB) and lengths (B,) int32. path: 0 TMA, 1 cp.async of
// `width` bytes, 2 element by element.
extern "C" int paged_attention(const void* q, const void* k, const void* v, const void* table,
                               const void* lengths, void* out, int B, int Hkv, int G, int D,
                               int T, int NB, int P, long long ks0, long long ks1, long long ks2,
                               long long vs0, long long vs1, long long vs2, int dtype, int path,
                               int width, void* stream) {
  if (B <= 0 || Hkv <= 0 || G <= 0) return 0;
  const Warps wp(G, D);
  if (D <= 0 || D > kMaxD || T <= 0 || NB < 0 || P <= 0 || wp.row_blocks > 65535 ||
      static_cast<long long>(B) * Hkv * kMaxCluster > 0x7fffffffLL || (dtype != 0 && dtype != 1)) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  const int isz = dtype == 0 ? 4 : 2;
  const long long st[6] = {ks0, ks1, ks2, vs0, vs1, vs2};
  const int sizes[3] = {P, T, Hkv};   // the dimensions ks0 / ks1 / ks2 step
  if (!path_ok(k, v, st, sizes, D, T, isz, path, width))
    return static_cast<int>(cudaErrorInvalidValue);
  Params p;
  p.q = q;
  p.table = static_cast<const int*>(table);
  p.lengths = static_cast<const int*>(lengths);
  p.out = out;
  p.k = static_cast<const unsigned char*>(k);
  p.v = static_cast<const unsigned char*>(v);
  p.ks0 = ks0 * isz; p.ks1 = ks1 * isz; p.ks2 = ks2 * isz;
  p.vs0 = vs0 * isz; p.vs1 = vs1 * isz; p.vs2 = vs2 * isz;
  p.Hkv = Hkv; p.G = G; p.D = D; p.T = T; p.NB = NB; p.P = P;
  p.cluster = 8;
  p.path = path;
  p.width = width;
  p.sqrt_d = sqrtf(static_cast<float>(D));
  const auto s = static_cast<cudaStream_t>(stream);
#define PA_LAUNCH(E)                                    \
  switch (wp.dw) {                                      \
    case 1: return launch<E, 1>(p, B, s);               \
    case 2: return launch<E, 2>(p, B, s);               \
    case 4: return launch<E, 4>(p, B, s);               \
    case 8: return launch<E, 8>(p, B, s);               \
    case 16: return launch<E, 16>(p, B, s);             \
    default: return launch<E, 32>(p, B, s);             \
  }
  if (dtype == 0) PA_LAUNCH(float)
  PA_LAUNCH(__nv_bfloat16)
#undef PA_LAUNCH
}

// The plan a launch of this shape takes on this card, into out[13]:
// {cluster, stages, threads, shared bytes, then the clusters of 8, 9, ...,
// 16 CTAs the card holds at once}. Returns a CUDA error for shapes it
// refuses.
extern "C" int paged_attention_plan(int G, int D, int T, int pairs, int dtype, int* out) {
  const Warps wp(G, D);
  if (G <= 0 || D <= 0 || D > kMaxD || T <= 0 || pairs <= 0 || wp.row_blocks > 65535 ||
      (dtype != 0 && dtype != 1)) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
#define PA_PLAN(E)                                                  \
  switch (wp.dw) {                                                  \
    case 1: plan<E, 1>(G, D, T, pairs, out); break;                 \
    case 2: plan<E, 2>(G, D, T, pairs, out); break;                 \
    case 4: plan<E, 4>(G, D, T, pairs, out); break;                 \
    case 8: plan<E, 8>(G, D, T, pairs, out); break;                 \
    case 16: plan<E, 16>(G, D, T, pairs, out); break;               \
    default: plan<E, 32>(G, D, T, pairs, out); break;               \
  }
  if (dtype == 0) {
    PA_PLAN(float)
  } else {
    PA_PLAN(__nv_bfloat16)
  }
#undef PA_PLAN
  return static_cast<int>(cudaGetLastError());
}
