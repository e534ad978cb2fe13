// Tiled attention with an online softmax: q (B, Sq, Hq, D) against k/v
// (B, Sk, Hkv, D), causal (top-left aligned: query row i sees keys 0..i,
// also when Sq != Sk) or not, GQA (query head hq reads kv head hq / G,
// G = Hq / Hkv). Scores q.k / sqrt(D) in float32; masked keys get weight
// exactly 0; float32 (m, l, acc) per row; out = acc / max(l, 1e-20) in
// q's type. Two kernels, picked by type and head dim alone (the wrapper,
// repro_torch/kernels/flash_attention/kernel.py, names the variant):
//   - bfloat16 with D 64 or 128: flash_attention_wgmma_kernel, on the
//     tensor cores (wgmma), fed by TMA from a producer warpgroup;
//   - float32, and bfloat16 with any other D (8..256): flash_attention_kernel,
//     on the CUDA cores in float32 (the float32 tolerance of 2e-5 needs
//     true float32 products).
//
// Replaces the TPU kernel flash_attention
// (src/repro/kernels/flash_attention/kernel.py:66, pl.pallas_call at :89,
// body _kernel at :24-61), whose grid (B * Hq, nQ, nK) walked the key
// tiles of one (batch, query head, query tile) in order with the running
// state in VMEM scratch and skipped whole tiles above the diagonal; its
// plain version here is repro_torch/kernels/flash_attention/ref.py.
//
// What bounds it on an H100: operations. A causal prefill does about
// 2 * B * Hq * Sq * Sk * D floating-point operations for
// (B * Sq * (Hq + 2 * Hkv) + B * Sq * Hq) * D elements moved: at the
// granite-3-2b prefill (B 4, S 4,000, Hq 32, Hkv 8, D 64, bf16) some
// 2.6e11 operations for 164 MB, over 1,600 operations a byte, far above
// the card's balance point, so the tensor cores' rate (989 TFLOP/s bf16)
// sets the bound (0.27 ms). The CUDA cores reach 67 TFLOP/s at best.
//
// Rows. Both kernels share one layout of the work: the rows of a (batch,
// kv head) are its Sq * G (query position, query head of the group)
// pairs, in the memory order of q, where the G heads of a kv head are
// adjacent, so one K/V tile read serves all G query heads of the group
// and any G fills the rows. Under `causal` the key walk stops at the
// block's last query position: tiles above the diagonal are never read.
// Query rows past Sq * G are computed on zeros and never written.
//
// Tensor-core design (bf16, D 64 / 128). A CTA of 384 threads takes 128
// rows: warpgroup 0 is the producer, warpgroups 1 and 2 the consumers of
// 64 rows each (wgmma's M). setmaxnreg moves registers from the producer
// (24) to the consumers (240).
//   - Q: each consumer loads its 64 rows once with 16-byte loads into
//     shared memory in the 128-byte-swizzled K-major layout wgmma reads
//     (D 128: two 64-column blocks). TMA could load Q only when G divides
//     64; these loads take any G.
//   - K, V: one producer thread brings 128-key tiles by TMA into a
//     ring (3 stages at D 64, 2 at D 128; 16 / 32 KB per tile) with full
//     (K and V apart) and empty mbarriers. The maps are 4-D (D, Hkv, Sk,
//     B) with the views' own byte strides, 64-column boxes, 128-byte
//     swizzle: keys past Sk of the sequence are zero-filled by TMA, never
//     read from the next sequence.
//   - S = Q K^T: wgmma m64n128k16, bf16 x bf16 -> f32, both operands from
//     shared memory (K-major), D / 16 steps.
//   - Online softmax in registers: each row's values sit in the 4 lanes
//     of a quad (max over 2 shuffles); ex2 with log2(e) / sqrt(D) folded
//     into one FMA; l kept per thread and reduced once at the end.
//     Masking runs only on tiles that cross the diagonal or Sk; masked
//     scores get -inf, which, as the reference's -1e30, weighs exactly 0
//     (every row sees key 0, so no row is wholly masked).
//   - O += P V: P goes to the tensor cores as two bf16 terms from
//     registers, hi = bf16(p) and lo = bf16(p - hi), each the A operand
//     of one wgmma (the f32 accumulator fragment of S maps onto wgmma's A
//     fragment pair by pair, no shuffles); V is the B operand from shared
//     memory, MN-major (the transpose bit). Each consumer warp releases
//     the stage through the empty barrier after its P.V is complete.
//   - Scheduling: a 1-D grid with (kv head, batch) fastest; under causal
//     the row tiles run in reverse, so the CTAs with the most key tiles
//     start first.
//   - Epilogue: O / max(l, 1e-20) -> bf16 stored from registers.
// Rounding: hi + lo keeps P to about 16 bits, near the float32 P of the
// CUDA-core and Pallas kernels (l sums the float32 P). P in bf16 alone
// (the rounding of the reference's jnp path and the port's torch
// backend) misses the plain version's tolerance at the serving prefill
// (atol 1e-3, rtol 2e-2) in rows with few keys, where the weighted mean
// of a few values nearly cancels and a 2^-9 error in one weight shows;
// the lo term doubles P.V's work.
// The TMA maps are encoded on the host on every call through
// cuTensorMapEncodeTiled, taken from the runtime with
// cudaGetDriverEntryPoint(ByVersion), so nothing links libcuda.
//
// CUDA-core design (float32, bf16 at other D). One block of 256 threads
// takes 64 rows and walks key tiles of 64. Per tile:
//   1. the K and V tiles are copied into shared memory in their own type
//      with 16-byte asynchronous copies (rows past Sk are zero-filled);
//   2. thread (ty, tx) of the 16 x 16 grid computes the scores of rows
//      ty + 16 i and keys tx + 16 j (i, j < 4) from the block's queries
//      (converted to float32 in shared memory once) and K, 16 bytes of K
//      a load; K rows are padded so those loads are free of bank
//      conflicts;
//   3. row maxima and sums reduce over the 16 lanes of a half warp with
//      shuffles; the thread updates (m, l) of its 4 rows, rescales its
//      accumulators and writes the probabilities to shared memory;
//   4. the thread accumulates its 4 rows x (up to 4 groups of 4) columns
//      of P.V, reading 4 probabilities and 4 values a load.
// Keys past Sk score -inf (weight exactly 0), causally masked ones -1e30.
// Grid (ceil(Sq * G / 64), Hkv, B).
//
// The wrapper checks types, shapes and alignment (16-byte rows and
// strides); q, k and v may be strided views along B, S and H with D
// contiguous; out is contiguous. Built with nvcc into a shared library with
// a plain C interface and called through ctypes.

#include <cstdint>
#include <cstring>

#include <cuda.h>          // CUtensorMap and its enums (types only: nothing links libcuda)
#include <cuda_bf16.h>
#include <cuda_pipeline.h>
#include <cuda_runtime.h>

namespace {

constexpr int kRows = 64;       // (query position, head) rows of a block
constexpr int kKeys = 64;       // keys of a tile
constexpr int kThreads = 256;   // 16 x 16
constexpr int kMaxD = 256;
constexpr float kNegInf = -1e30f;
constexpr size_t kMaxSharedBytes = 227 * 1024;

__device__ __forceinline__ float to_f32(float x) { return x; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 x) { return __bfloat162float(x); }
__device__ __forceinline__ void store(float* p, float x) { *p = x; }
__device__ __forceinline__ void store(__nv_bfloat16* p, float x) { *p = __float2bfloat16(x); }

__device__ __forceinline__ float bf16_lo(uint32_t w) { return __uint_as_float(w << 16); }
__device__ __forceinline__ float bf16_hi(uint32_t w) { return __uint_as_float(w & 0xffff0000u); }

// 16 bytes of E in shared memory as floats (4 of float, 8 of bfloat16),
// and 4 elements as floats.
template <typename E>
struct Vec;

template <>
struct Vec<float> {
  static constexpr int n = 4;
  __device__ __forceinline__ static void load16(const unsigned char* p, float* out) {
    const float4 v = *reinterpret_cast<const float4*>(p);
    out[0] = v.x; out[1] = v.y; out[2] = v.z; out[3] = v.w;
  }
  __device__ __forceinline__ static void load4(const unsigned char* p, float* out) {
    load16(p, out);
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
  __device__ __forceinline__ static void load4(const unsigned char* p, float* out) {
    const uint2 u = *reinterpret_cast<const uint2*>(p);
    out[0] = bf16_lo(u.x); out[1] = bf16_hi(u.x);
    out[2] = bf16_lo(u.y); out[3] = bf16_hi(u.y);
  }
};

__host__ __device__ __forceinline__ size_t round_up(size_t x, size_t m) { return (x + m - 1) / m * m; }

// Shared memory, in bytes: the block's queries in float32 (rows of D + 4
// floats), the K tile (rows padded to 16 bytes past a multiple of 32, so
// that 8 lanes reading 16 bytes each from 8 rows hit 8 distinct bank
// groups), the V tile and the probabilities (rows of kKeys + 4 floats).
struct Smem {
  size_t qstride, krow, vrow, pstride, q, k, v, p, total;
  __host__ __device__ Smem(int D, size_t isz) {
    qstride = D + 4;
    krow = round_up(D * isz, 32) + 16;
    vrow = D * isz;
    pstride = kKeys + 4;
    q = sizeof(float) * kRows * qstride;
    k = kKeys * krow;
    v = kKeys * vrow;
    p = sizeof(float) * kRows * pstride;
    total = q + k + v + p;
  }
};

template <typename E, int NG>
__global__ void __launch_bounds__(kThreads)
    flash_attention_kernel(const E* __restrict__ q, const E* __restrict__ k,
                           const E* __restrict__ v, E* __restrict__ out, int Sq,
                           int Sk, int Hkv, int G, int D, long long qs0,
                           long long qs1, long long qs2, long long ks0,
                           long long ks1, long long ks2, long long vs0,
                           long long vs1, long long vs2, int causal, float scale) {
  extern __shared__ __align__(16) unsigned char smem[];
  constexpr size_t isz = sizeof(E);
  const Smem lay(D, isz);
  float* qs = reinterpret_cast<float*>(smem);
  unsigned char* ks = smem + lay.q;
  unsigned char* vs = ks + lay.k;
  float* ps = reinterpret_cast<float*>(vs + lay.v);

  const int tx = threadIdx.x & 15, ty = threadIdx.x >> 4;
  const int h = blockIdx.y, b = blockIdx.z;
  const int rows = Sq * G;
  const int r0 = blockIdx.x * kRows;
  const int hq0 = h * G;
  const int groups = D / 4;     // column groups of 4

  // the block's queries, as float32
  for (int c = threadIdx.x; c < kRows * groups; c += kThreads) {
    const int r = c / groups, d = (c % groups) * 4;
    const int row = r0 + r;
    float4 val = make_float4(0.f, 0.f, 0.f, 0.f);
    if (row < rows) {
      const int qp = row / G, g = row % G;
      const E* src = q + b * qs0 + qp * qs1 + (hq0 + g) * qs2 + d;
      val = make_float4(to_f32(src[0]), to_f32(src[1]), to_f32(src[2]), to_f32(src[3]));
    }
    *reinterpret_cast<float4*>(qs + r * lay.qstride + d) = val;
  }

  float m[4], l[4], acc[4][NG][4];
  int qpos[4];
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    m[i] = kNegInf;
    l[i] = 0.f;
    qpos[i] = (r0 + ty + 16 * i) / G;
#pragma unroll
    for (int g = 0; g < NG; ++g)
#pragma unroll
      for (int e = 0; e < 4; ++e) acc[i][g][e] = 0.f;
  }

  const int last_row = min(r0 + kRows, rows) - 1;
  const int kend = causal ? min(Sk, last_row / G + 1) : Sk;
  const unsigned char* kb = reinterpret_cast<const unsigned char*>(k + b * ks0 + h * ks2);
  const unsigned char* vb = reinterpret_cast<const unsigned char*>(v + b * vs0 + h * vs2);
  const int chunks = static_cast<int>(D * isz / 16);   // 16-byte chunks of a row

  for (int k0 = 0; k0 < kend; k0 += kKeys) {
    // 1. K and V tiles into shared memory
    for (int c = threadIdx.x; c < kKeys * chunks; c += kThreads) {
      const int t = c / chunks, o = (c % chunks) * 16;
      unsigned char* kd = ks + t * lay.krow + o;
      unsigned char* vd = vs + t * lay.vrow + o;
      const long long kp = k0 + t;
      if (kp < Sk) {
        __pipeline_memcpy_async(kd, kb + kp * ks1 * static_cast<long long>(isz) + o, 16);
        __pipeline_memcpy_async(vd, vb + kp * vs1 * static_cast<long long>(isz) + o, 16);
      } else {
        *reinterpret_cast<uint4*>(kd) = make_uint4(0u, 0u, 0u, 0u);
        *reinterpret_cast<uint4*>(vd) = make_uint4(0u, 0u, 0u, 0u);
      }
    }
    __pipeline_commit();
    __pipeline_wait_prior(0);
    __syncthreads();

    // 2. scores of rows ty + 16 i, keys tx + 16 j
    float s[4][4];
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int j = 0; j < 4; ++j) s[i][j] = 0.f;
    constexpr int n = Vec<E>::n;
    for (int d0 = 0; d0 < D; d0 += n) {
      float kf[4][n];
#pragma unroll
      for (int j = 0; j < 4; ++j) Vec<E>::load16(ks + (tx + 16 * j) * lay.krow + d0 * isz, kf[j]);
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        const float* qr = qs + (ty + 16 * i) * lay.qstride + d0;
        float qf[n];
#pragma unroll
        for (int e = 0; e < n; e += 4) {
          const float4 x = *reinterpret_cast<const float4*>(qr + e);
          qf[e] = x.x; qf[e + 1] = x.y; qf[e + 2] = x.z; qf[e + 3] = x.w;
        }
#pragma unroll
        for (int j = 0; j < 4; ++j)
#pragma unroll
          for (int e = 0; e < n; ++e) s[i][j] += qf[e] * kf[j][e];
      }
    }

    // 3. online softmax of the tile
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      float mx = -INFINITY;
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const int kp = k0 + tx + 16 * j;
        float x = s[i][j] * scale;
        if (kp >= Sk) {
          x = -INFINITY;
        } else if (causal && kp > qpos[i]) {
          x = kNegInf;
        }
        s[i][j] = x;
        mx = fmaxf(mx, x);
      }
#pragma unroll
      for (int off = 8; off > 0; off >>= 1) mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, off));
      const float m_new = fmaxf(m[i], mx);
      const float alpha = expf(m[i] - m_new);
      float sum = 0.f;
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const float p = expf(s[i][j] - m_new);
        ps[(ty + 16 * i) * lay.pstride + tx + 16 * j] = p;
        sum += p;
      }
#pragma unroll
      for (int off = 8; off > 0; off >>= 1) sum += __shfl_xor_sync(0xffffffffu, sum, off);
      l[i] = l[i] * alpha + sum;
      m[i] = m_new;
#pragma unroll
      for (int g = 0; g < NG; ++g)
#pragma unroll
        for (int e = 0; e < 4; ++e) acc[i][g][e] *= alpha;
    }
    __syncthreads();

    // 4. acc += P . V for rows ty + 16 i, column groups tx + 16 g
    for (int t0 = 0; t0 < kKeys; t0 += 4) {
      float pr[4][4];
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        const float4 x = *reinterpret_cast<const float4*>(ps + (ty + 16 * i) * lay.pstride + t0);
        pr[i][0] = x.x; pr[i][1] = x.y; pr[i][2] = x.z; pr[i][3] = x.w;
      }
#pragma unroll
      for (int tt = 0; tt < 4; ++tt) {
#pragma unroll
        for (int g = 0; g < NG; ++g) {
          const int grp = tx + 16 * g;
          if (grp < groups) {
            float vf[4];
            Vec<E>::load4(vs + (t0 + tt) * lay.vrow + grp * 4 * isz, vf);
#pragma unroll
            for (int i = 0; i < 4; ++i)
#pragma unroll
              for (int e = 0; e < 4; ++e) acc[i][g][e] += pr[i][tt] * vf[e];
          }
        }
      }
    }
    __syncthreads();
  }

  // out = acc / max(l, 1e-20), rows past Sq * G not written
  const long long os2 = D, os1 = static_cast<long long>(Hkv) * G * D, os0 = os1 * Sq;
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int row = r0 + ty + 16 * i;
    if (row >= rows) continue;
    const int g0 = row % G;
    E* dst = out + b * os0 + qpos[i] * os1 + (hq0 + g0) * os2;
    const float lsafe = fmaxf(l[i], 1e-20f);
#pragma unroll
    for (int g = 0; g < NG; ++g) {
      const int grp = tx + 16 * g;
      if (grp < groups) {
#pragma unroll
        for (int e = 0; e < 4; ++e) store(dst + grp * 4 + e, acc[i][g][e] / lsafe);
      }
    }
  }
}

template <typename E, int NG>
int launch(const void* q, const void* k, const void* v, void* out, int B, int Sq,
           int Sk, int Hkv, int G, int D, const long long* st, int causal,
           cudaStream_t stream) {
  const Smem lay(D, sizeof(E));
  if (lay.total > kMaxSharedBytes) return static_cast<int>(cudaErrorInvalidValue);
  const auto kernel = flash_attention_kernel<E, NG>;
  if (lay.total > 48 * 1024) {
    const cudaError_t err = cudaFuncSetAttribute(
        kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, static_cast<int>(lay.total));
    if (err != cudaSuccess) return static_cast<int>(err);
  }
  const long long row_tiles = (static_cast<long long>(Sq) * G + kRows - 1) / kRows;
  const dim3 grid(static_cast<unsigned>(row_tiles), Hkv, B), block(kThreads);
  kernel<<<grid, block, lay.total, stream>>>(
      static_cast<const E*>(q), static_cast<const E*>(k), static_cast<const E*>(v),
      static_cast<E*>(out), Sq, Sk, Hkv, G, D, st[0], st[1], st[2], st[3], st[4],
      st[5], st[6], st[7], st[8], causal, 1.0f / sqrtf(static_cast<float>(D)));
  return static_cast<int>(cudaGetLastError());
}

template <typename E>
int launch_d(const void* q, const void* k, const void* v, void* out, int B, int Sq,
             int Sk, int Hkv, int G, int D, const long long* st, int causal,
             cudaStream_t stream) {
  if (D <= 64) return launch<E, 1>(q, k, v, out, B, Sq, Sk, Hkv, G, D, st, causal, stream);
  if (D <= 128) return launch<E, 2>(q, k, v, out, B, Sq, Sk, Hkv, G, D, st, causal, stream);
  return launch<E, 4>(q, k, v, out, B, Sq, Sk, Hkv, G, D, st, causal, stream);
}


// --------------------------------------------------------------------------
// Tensor-core kernel (bf16, D 64 / 128)
// --------------------------------------------------------------------------

constexpr int kTcRows = 128;          // rows of a CTA: two consumer warpgroups of 64
constexpr int kTcKeys = 128;          // keys of a tile
constexpr int kTcStages64 = 3;        // K/V ring stages at D 64
constexpr int kTcStages128 = 2;       // K/V ring stages at D 128
constexpr int kTcThreads = 384;       // producer warpgroup + two consumer warpgroups
constexpr int kTcProducerRegs = 24;
constexpr int kTcConsumerRegs = 240;
constexpr uint32_t kSw128Rows = 128;  // bytes of a swizzled row: 64 bf16 columns

// Shared memory, in bytes from a 1024-aligned base: Q (128 rows), the K
// ring and the V ring (128 keys a tile), each in 64-column blocks of 128
// rows x 128 bytes, 128-byte swizzled; then the barriers.
template <int D>
struct TcLayout {
  static constexpr int kStages = D == 64 ? kTcStages64 : kTcStages128;
  static constexpr int kBlocks = D / 64;
  static constexpr uint32_t kBlock = kTcKeys * kSw128Rows;   // one 64-column block
  static constexpr uint32_t kTile = kBlocks * kBlock;        // a Q, K or V tile
  static constexpr uint32_t kQ = 0;
  static constexpr uint32_t kK = kQ + kTile;
  static constexpr uint32_t kV = kK + kStages * kTile;
  static constexpr uint32_t kBar = kV + kStages * kTile;     // full_k, full_v, empty
  static constexpr uint32_t kBytes = kBar + 3 * kStages * 8 + 1024;   // + alignment slack
  static_assert(kTcRows == kTcKeys, "Q and K/V tiles share the block size");
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

// wgmma shared-memory descriptor of a 128-byte-swizzled operand: start
// address, leading and stride byte offsets (all in 16-byte units), layout
// type 1 (128-byte swizzle) in bits 62-63; base offset 0 (1024-aligned atoms).
__device__ __forceinline__ uint64_t sw128_desc(uint32_t addr, uint32_t lbo, uint32_t sbo) {
  return static_cast<uint64_t>((addr & 0x3FFFF) >> 4) |
         (static_cast<uint64_t>((lbo >> 4) & 0x3FFF) << 16) |
         (static_cast<uint64_t>((sbo >> 4) & 0x3FFF) << 32) | (1ull << 62);
}

__device__ __forceinline__ void wgmma_fence() { asm volatile("wgmma.fence.sync.aligned;" ::: "memory"); }
__device__ __forceinline__ void wgmma_commit() {
  asm volatile("wgmma.commit_group.sync.aligned;" ::: "memory");
}
__device__ __forceinline__ void wgmma_wait_all() {
  asm volatile("wgmma.wait_group.sync.aligned 0;" ::: "memory");
}
// Keeps the compiler from moving accesses of wgmma's registers across
// the asynchronous instructions.
template <int N>
__device__ __forceinline__ void fence_regs(float (&r)[N]) {
#pragma unroll
  for (int i = 0; i < N; ++i) asm volatile("" : "+f"(r[i])::"memory");
}

__device__ __forceinline__ float ex2(float x) {
  float y;
  asm("ex2.approx.ftz.f32 %0, %1;" : "=f"(y) : "f"(x));
  return y;
}

// (a, b) as two bf16x2 terms, hi = bf16(x) and lo = bf16(x - hi), so that
// hi + lo holds x to about 16 bits (bf16 alone: 8); a in the low halves.
__device__ __forceinline__ void split_bf16(float a, float b, uint32_t& hi, uint32_t& lo) {
  const __nv_bfloat162 h = __floats2bfloat162_rn(a, b);
  const float2 hf = __bfloat1622float2(h);
  const __nv_bfloat162 l = __floats2bfloat162_rn(a - hf.x, b - hf.y);
  hi = *reinterpret_cast<const uint32_t*>(&h);
  lo = *reinterpret_cast<const uint32_t*>(&l);
}

// d (64 x 128, f32) = (scale_d ? d : 0) + A . B, A and B bf16 from shared memory (K-major)
__device__ __forceinline__ void wgmma_m64n128k16_ss(float (&d)[64], uint64_t da, uint64_t db, int scale_d) {
  asm volatile(
      "{\n.reg .pred p;\n"
      "setp.ne.b32 p, %66, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k16.f32.bf16.bf16 "
      "{"
      "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31, "
      "%32, %33, %34, %35, %36, %37, %38, %39, %40, %41, %42, %43, %44, %45, %46, %47, "
      "%48, %49, %50, %51, %52, %53, %54, %55, %56, %57, %58, %59, %60, %61, %62, %63"
      "}, %64, %65, p, 1, 1, 0, 0;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
        "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31]),
        "+f"(d[32]), "+f"(d[33]), "+f"(d[34]), "+f"(d[35]), "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]),
        "+f"(d[40]), "+f"(d[41]), "+f"(d[42]), "+f"(d[43]), "+f"(d[44]), "+f"(d[45]), "+f"(d[46]), "+f"(d[47]),
        "+f"(d[48]), "+f"(d[49]), "+f"(d[50]), "+f"(d[51]), "+f"(d[52]), "+f"(d[53]), "+f"(d[54]), "+f"(d[55]),
        "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]), "+f"(d[60]), "+f"(d[61]), "+f"(d[62]), "+f"(d[63])
      : "l"(da), "l"(db), "r"(scale_d));
}

// d (64 x 64, f32) += A . B, A bf16 from registers (4 x bf16x2 a thread),
// B bf16 from shared memory, MN-major (the transpose bit set)
__device__ __forceinline__ void wgmma_m64n64k16_rs(float (&d)[32], const uint32_t (&a)[4], uint64_t db) {
  asm volatile(
      "{\n.reg .pred p;\n"
      "setp.ne.b32 p, %37, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 "
      "{"
      "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31"
      "}, {%32, %33, %34, %35}, %36, p, 1, 1, 1;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
        "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db), "r"(1));
}

// d (64 x 128, f32) += A . B, A bf16 from registers (4 x bf16x2 a thread),
// B bf16 from shared memory, MN-major (the transpose bit set)
__device__ __forceinline__ void wgmma_m64n128k16_rs(float (&d)[64], const uint32_t (&a)[4], uint64_t db) {
  asm volatile(
      "{\n.reg .pred p;\n"
      "setp.ne.b32 p, %69, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k16.f32.bf16.bf16 "
      "{"
      "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31, "
      "%32, %33, %34, %35, %36, %37, %38, %39, %40, %41, %42, %43, %44, %45, %46, %47, "
      "%48, %49, %50, %51, %52, %53, %54, %55, %56, %57, %58, %59, %60, %61, %62, %63"
      "}, {%64, %65, %66, %67}, %68, p, 1, 1, 1;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
        "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31]),
        "+f"(d[32]), "+f"(d[33]), "+f"(d[34]), "+f"(d[35]), "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]),
        "+f"(d[40]), "+f"(d[41]), "+f"(d[42]), "+f"(d[43]), "+f"(d[44]), "+f"(d[45]), "+f"(d[46]), "+f"(d[47]),
        "+f"(d[48]), "+f"(d[49]), "+f"(d[50]), "+f"(d[51]), "+f"(d[52]), "+f"(d[53]), "+f"(d[54]), "+f"(d[55]),
        "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]), "+f"(d[60]), "+f"(d[61]), "+f"(d[62]), "+f"(d[63])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db), "r"(1));
}


template <int D>
__device__ __forceinline__ void wgmma_pv(float (&o)[D / 2], const uint32_t (&a)[4], uint64_t db) {
  if constexpr (D == 64) {
    wgmma_m64n64k16_rs(o, a, db);
  } else {
    wgmma_m64n128k16_rs(o, a, db);
  }
}

template <int D>
__global__ void __launch_bounds__(kTcThreads, 1)
    flash_attention_wgmma_kernel(const __grid_constant__ CUtensorMap tm_k,
                                 const __grid_constant__ CUtensorMap tm_v,
                                 const __nv_bfloat16* __restrict__ q,
                                 __nv_bfloat16* __restrict__ out, int B, int Sq, int Sk,
                                 int Hkv, int G, long long qs0, long long qs1, long long qs2,
                                 int row_tiles, int causal, float scale_log2) {
  using L = TcLayout<D>;
  constexpr int S = L::kStages;
  extern __shared__ __align__(1024) unsigned char smem_raw[];
  const uint32_t raw = smem_u32(smem_raw);
  const uint32_t base = (raw + 1023u) & ~1023u;
  const uint32_t full_k = base + L::kBar, full_v = full_k + 8 * S, empty = full_v + 8 * S;

  // (row tile, kv head, batch) of this CTA; row tiles reversed under causal
  const int cta = blockIdx.x;
  const int h = cta % Hkv;
  const int b = (cta / Hkv) % B;
  int tile = cta / (Hkv * B);
  if (causal) tile = row_tiles - 1 - tile;
  const int rows = Sq * G;
  const int r0 = tile * kTcRows;
  const int last_row = min(r0 + kTcRows, rows) - 1;
  const int all_tiles = (Sk + kTcKeys - 1) / kTcKeys;
  const int n_tiles = causal ? min(all_tiles, last_row / G / kTcKeys + 1) : all_tiles;

  if (threadIdx.x == 0) {
#pragma unroll
    for (int s = 0; s < S; ++s) {
      mbar_init(full_k + 8 * s, 1);
      mbar_init(full_v + 8 * s, 1);
      mbar_init(empty + 8 * s, 8);   // one arrival per consumer warp
    }
    asm volatile("fence.mbarrier_init.release.cluster;" ::: "memory");
  }
  __syncthreads();

  const int wg = threadIdx.x / 128;
  if (wg == 0) {
    // producer: one thread keeps the K/V ring full
    asm volatile("setmaxnreg.dec.sync.aligned.u32 %0;" ::"n"(kTcProducerRegs));
    if (threadIdx.x == 0) {
      for (int n = 0; n < n_tiles; ++n) {
        const int s = n % S;
        if (n >= S) mbar_wait(empty + 8 * s, ((n / S) - 1) & 1);
        mbar_expect_tx(full_k + 8 * s, L::kTile);
#pragma unroll
        for (int blk = 0; blk < L::kBlocks; ++blk)
          tma_load_4d(base + L::kK + s * L::kTile + blk * L::kBlock, &tm_k, full_k + 8 * s,
                      64 * blk, h, n * kTcKeys, b);
        mbar_expect_tx(full_v + 8 * s, L::kTile);
#pragma unroll
        for (int blk = 0; blk < L::kBlocks; ++blk)
          tma_load_4d(base + L::kV + s * L::kTile + blk * L::kBlock, &tm_v, full_v + 8 * s,
                      64 * blk, h, n * kTcKeys, b);
      }
    }
  } else {
    // consumers: warpgroup c takes rows 64 c .. 64 c + 63 of the CTA
    asm volatile("setmaxnreg.inc.sync.aligned.u32 %0;" ::"n"(kTcConsumerRegs));
    const int c = wg - 1;
    const int tid = threadIdx.x % 128, warp = tid / 32, lane = tid % 32;

    // Q rows into shared memory, 128-byte swizzled: 16-byte chunk ch of
    // row r of a 64-column block goes to chunk ch ^ (r % 8) of that row
    constexpr int kChunks = D / 8;
    for (int i = tid; i < 64 * kChunks; i += 128) {
      const int rl = 64 * c + i / kChunks, ch = i % kChunks;
      const int row = r0 + rl;
      uint4 val = make_uint4(0u, 0u, 0u, 0u);
      if (row < rows) {
        const int qp = row / G, g = row % G;
        val = *reinterpret_cast<const uint4*>(q + b * qs0 + qp * qs1 + (h * G + g) * qs2 + ch * 8);
      }
      const uint32_t dst = base + L::kQ + (ch / 8) * L::kBlock + rl * kSw128Rows +
                           (((ch % 8) ^ (rl % 8)) * 16);
      asm volatile("st.shared.v4.u32 [%0], {%1, %2, %3, %4};" ::"r"(dst), "r"(val.x), "r"(val.y),
                   "r"(val.z), "r"(val.w)
                   : "memory");
    }
    // make the generic-proxy stores visible to wgmma, then sync the warpgroup
    asm volatile("fence.proxy.async.shared::cta;" ::: "memory");
    asm volatile("bar.sync %0, 128;" ::"r"(1 + c) : "memory");

    // this thread's two rows of the warpgroup's 64: rl0 and rl0 + 8
    const int rl0 = 64 * c + 16 * warp + lane / 4;
    const int qpos0 = (r0 + rl0) / G, qpos1 = (r0 + rl0 + 8) / G;
    const int qpos_first = (r0 + 64 * c) / G;
    const int col0 = 2 * (lane % 4);
    const uint32_t q_addr = base + L::kQ + 64 * c * kSw128Rows;

    float o[D / 2];
#pragma unroll
    for (int i = 0; i < D / 2; ++i) o[i] = 0.f;
    float m0 = -INFINITY, m1 = -INFINITY, l0 = 0.f, l1 = 0.f;

    for (int n = 0; n < n_tiles; ++n) {
      const int s = n % S;
      const uint32_t phase = (n / S) & 1;
      const uint32_t k_addr = base + L::kK + s * L::kTile, v_addr = base + L::kV + s * L::kTile;

      // S = Q K^T over D / 16 steps of 16 columns
      float sc[64];
      mbar_wait(full_k + 8 * s, phase);
      wgmma_fence();
#pragma unroll
      for (int kk = 0; kk < D / 16; ++kk) {
        const uint32_t off = (kk / 4) * L::kBlock + (kk % 4) * 32;
        wgmma_m64n128k16_ss(sc, sw128_desc(q_addr + off, 16, 1024),
                            sw128_desc(k_addr + off, 16, 1024), kk > 0);
      }
      wgmma_commit();
      wgmma_wait_all();
      fence_regs(sc);

      // element 4 j + e of sc: row rl0 (e < 2) or rl0 + 8 (e >= 2),
      // key k0 + 8 j + col0 + (e & 1)
      const int k0 = n * kTcKeys;
      if (k0 + kTcKeys > Sk || (causal && k0 + kTcKeys - 1 > qpos_first)) {
#pragma unroll
        for (int j = 0; j < 16; ++j) {
#pragma unroll
          for (int e = 0; e < 2; ++e) {
            const int key = k0 + 8 * j + col0 + e;
            if (key >= Sk || (causal && key > qpos0)) sc[4 * j + e] = -INFINITY;
            if (key >= Sk || (causal && key > qpos1)) sc[4 * j + 2 + e] = -INFINITY;
          }
        }
      }

      // online softmax in the log2 domain
      float mx0 = -INFINITY, mx1 = -INFINITY;
#pragma unroll
      for (int j = 0; j < 16; ++j) {
        mx0 = fmaxf(mx0, fmaxf(sc[4 * j], sc[4 * j + 1]));
        mx1 = fmaxf(mx1, fmaxf(sc[4 * j + 2], sc[4 * j + 3]));
      }
#pragma unroll
      for (int off = 1; off < 4; off <<= 1) {
        mx0 = fmaxf(mx0, __shfl_xor_sync(0xffffffffu, mx0, off));
        mx1 = fmaxf(mx1, __shfl_xor_sync(0xffffffffu, mx1, off));
      }
      const float n0 = fmaxf(m0, mx0 * scale_log2), n1 = fmaxf(m1, mx1 * scale_log2);
      const float u0 = n0 == -INFINITY ? 0.f : n0, u1 = n1 == -INFINITY ? 0.f : n1;
      const float a0 = ex2(m0 - u0), a1 = ex2(m1 - u1);
      m0 = n0;
      m1 = n1;
      float sum0 = 0.f, sum1 = 0.f;
#pragma unroll
      for (int j = 0; j < 16; ++j) {
        sc[4 * j] = ex2(fmaf(sc[4 * j], scale_log2, -u0));
        sc[4 * j + 1] = ex2(fmaf(sc[4 * j + 1], scale_log2, -u0));
        sc[4 * j + 2] = ex2(fmaf(sc[4 * j + 2], scale_log2, -u1));
        sc[4 * j + 3] = ex2(fmaf(sc[4 * j + 3], scale_log2, -u1));
        sum0 += sc[4 * j] + sc[4 * j + 1];
        sum1 += sc[4 * j + 2] + sc[4 * j + 3];
      }
      l0 = l0 * a0 + sum0;
      l1 = l1 * a1 + sum1;
#pragma unroll
      for (int j = 0; j < D / 8; ++j) {
        o[4 * j] *= a0;
        o[4 * j + 1] *= a0;
        o[4 * j + 2] *= a1;
        o[4 * j + 3] *= a1;
      }
      // P as two bf16 terms, hi + lo: keys 16 kk .. 16 kk + 15 are
      // sc[8 kk .. 8 kk + 7], which is wgmma's A fragment pair by pair
      uint32_t p_hi[8][4], p_lo[8][4];
#pragma unroll
      for (int kk = 0; kk < 8; ++kk)
#pragma unroll
        for (int i = 0; i < 4; ++i)
          split_bf16(sc[8 * kk + 2 * i], sc[8 * kk + 2 * i + 1], p_hi[kk][i], p_lo[kk][i]);

      // O += P_hi V + P_lo V over 8 steps of 16 keys; V is MN-major: 8-key
      // groups 1024 bytes apart, 64-column blocks L::kBlock apart
      mbar_wait(full_v + 8 * s, phase);
      fence_regs(o);
      wgmma_fence();
#pragma unroll
      for (int kk = 0; kk < 8; ++kk) {
        const uint64_t dv = sw128_desc(v_addr + kk * 16 * kSw128Rows, L::kBlock, 1024);
        wgmma_pv<D>(o, p_hi[kk], dv);
        wgmma_pv<D>(o, p_lo[kk], dv);
      }
      wgmma_commit();
      wgmma_wait_all();
      fence_regs(o);
      __syncwarp();
      if (lane == 0) mbar_arrive(empty + 8 * s);
    }

    // out = O / max(l, 1e-20) in bf16; rows past Sq * G not written
#pragma unroll
    for (int off = 1; off < 4; off <<= 1) {
      l0 += __shfl_xor_sync(0xffffffffu, l0, off);
      l1 += __shfl_xor_sync(0xffffffffu, l1, off);
    }
    const float inv0 = 1.f / fmaxf(l0, 1e-20f), inv1 = 1.f / fmaxf(l1, 1e-20f);
    const long long hq = static_cast<long long>(Hkv) * G;
#pragma unroll
    for (int half = 0; half < 2; ++half) {
      const int row = r0 + rl0 + 8 * half;
      if (row >= rows) continue;
      const float inv = half ? inv1 : inv0;
      __nv_bfloat16* dst =
          out + ((static_cast<long long>(b) * Sq + row / G) * hq + h * G + row % G) * D + col0;
#pragma unroll
      for (int j = 0; j < D / 8; ++j)
        *reinterpret_cast<__nv_bfloat162*>(dst + 8 * j) =
            __floats2bfloat162_rn(o[4 * j + 2 * half] * inv, o[4 * j + 2 * half + 1] * inv);
    }
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
    void* p = nullptr;
    cudaDriverEntryPointQueryResult found;
#if CUDART_VERSION >= 12050
    const cudaError_t err = cudaGetDriverEntryPointByVersion("cuTensorMapEncodeTiled", &p, 12000,
                                                            cudaEnableDefault, &found);
#else
    const cudaError_t err =
        cudaGetDriverEntryPoint("cuTensorMapEncodeTiled", &p, cudaEnableDefault, &found);
#endif
    if (err == cudaSuccess && found == cudaDriverEntryPointSuccess) fn = reinterpret_cast<EncodeTiled>(p);
  }
  return fn;
}

// (D, Hkv, Sk, B) map of a K or V view, strides in elements; boxes of 64
// columns x 128 keys, 128-byte swizzle, out-of-range keys zero-filled.
int encode_kv(EncodeTiled enc, CUtensorMap* map, const void* ptr, int B, int Sk, int Hkv, int D,
              long long s0, long long s1, long long s2) {
  const cuuint64_t dims[4] = {static_cast<cuuint64_t>(D), static_cast<cuuint64_t>(Hkv),
                              static_cast<cuuint64_t>(Sk), static_cast<cuuint64_t>(B)};
  cuuint64_t strides[3] = {static_cast<cuuint64_t>(s2) * 2, static_cast<cuuint64_t>(s1) * 2,
                           static_cast<cuuint64_t>(s0) * 2};
  for (int i = 0; i < 3; ++i)   // a dimension of size 1 is never stepped: any valid stride
    if (dims[i + 1] == 1) strides[i] = static_cast<cuuint64_t>(D) * 2;
  const cuuint32_t box[4] = {64, 1, static_cast<cuuint32_t>(kTcKeys), 1};
  const cuuint32_t elem[4] = {1, 1, 1, 1};
  const CUresult r = enc(map, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, 4, const_cast<void*>(ptr), dims,
                         strides, box, elem, CU_TENSOR_MAP_INTERLEAVE_NONE,
                         CU_TENSOR_MAP_SWIZZLE_128B, CU_TENSOR_MAP_L2_PROMOTION_L2_256B,
                         CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE);
  return r == CUDA_SUCCESS ? 0 : static_cast<int>(cudaErrorInvalidValue);
}

template <int D>
int launch_wgmma(const void* q, const void* k, const void* v, void* out, int B, int Sq, int Sk,
                 int Hkv, int G, const long long* st, int causal, cudaStream_t stream) {
  using L = TcLayout<D>;
  CUtensorMap tm_k, tm_v;
  memset(&tm_k, 0, sizeof(tm_k));
  memset(&tm_v, 0, sizeof(tm_v));
  if (Sk > 0) {   // with no keys the kernel reads no tile
    const EncodeTiled enc = encoder();
    if (enc == nullptr) return static_cast<int>(cudaErrorNotSupported);
    int err = encode_kv(enc, &tm_k, k, B, Sk, Hkv, D, st[3], st[4], st[5]);
    if (err == 0) err = encode_kv(enc, &tm_v, v, B, Sk, Hkv, D, st[6], st[7], st[8]);
    if (err != 0) return err;
  }
  const auto kernel = flash_attention_wgmma_kernel<D>;
  const cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, static_cast<int>(L::kBytes));
  if (err != cudaSuccess) return static_cast<int>(err);
  const long long row_tiles = (static_cast<long long>(Sq) * G + kTcRows - 1) / kTcRows;
  const long long ctas = row_tiles * Hkv * B;
  if (ctas > 0x7fffffffLL) return static_cast<int>(cudaErrorInvalidValue);
  kernel<<<static_cast<unsigned>(ctas), kTcThreads, L::kBytes, stream>>>(
      tm_k, tm_v, static_cast<const __nv_bfloat16*>(q), static_cast<__nv_bfloat16*>(out), B, Sq,
      Sk, Hkv, G, st[0], st[1], st[2], static_cast<int>(row_tiles), causal,
      1.4426950408889634f / sqrtf(static_cast<float>(D)));
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// q, k, v and out are float32 (dtype 0) or bfloat16 (dtype 1); q/k/v
// strides are (batch, position, head) in elements, D contiguous; out is
// contiguous (B, Sq, Hkv * G, D). D is a multiple of 8 up to 256; every
// row start is 16-byte aligned.
extern "C" int flash_attention(const void* q, const void* k, const void* v,
                               void* out, int B, int Sq, int Sk, int Hkv, int G,
                               int D, long long qs0, long long qs1, long long qs2,
                               long long ks0, long long ks1, long long ks2,
                               long long vs0, long long vs1, long long vs2,
                               int causal, int dtype, void* stream) {
  if (B <= 0 || Sq <= 0 || Hkv <= 0 || G <= 0) return 0;
  if (Sk < 0 || D <= 0 || D % 8 != 0 || D > kMaxD || B > 65535 || Hkv > 65535 ||
      static_cast<long long>(Sq) * G > 0x7fffffffLL - kRows) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  const long long st[9] = {qs0, qs1, qs2, ks0, ks1, ks2, vs0, vs1, vs2};
  const auto s = static_cast<cudaStream_t>(stream);
  if (dtype == 0) return launch_d<float>(q, k, v, out, B, Sq, Sk, Hkv, G, D, st, causal, s);
  if (dtype == 1) return launch_d<__nv_bfloat16>(q, k, v, out, B, Sq, Sk, Hkv, G, D, st, causal, s);
  return static_cast<int>(cudaErrorInvalidValue);
}

// The tensor-core kernel: q, k, v and out bfloat16, D 64 or 128; the
// rest as flash_attention above.
extern "C" int flash_attention_wgmma(const void* q, const void* k, const void* v, void* out,
                                     int B, int Sq, int Sk, int Hkv, int G, int D,
                                     long long qs0, long long qs1, long long qs2, long long ks0,
                                     long long ks1, long long ks2, long long vs0, long long vs1,
                                     long long vs2, int causal, void* stream) {
  if (B <= 0 || Sq <= 0 || Hkv <= 0 || G <= 0) return 0;
  if (Sk < 0 || static_cast<long long>(Sq) * G > 0x7fffffffLL - kTcRows) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  const long long st[9] = {qs0, qs1, qs2, ks0, ks1, ks2, vs0, vs1, vs2};
  const auto s = static_cast<cudaStream_t>(stream);
  if (D == 64) return launch_wgmma<64>(q, k, v, out, B, Sq, Sk, Hkv, G, st, causal, s);
  if (D == 128) return launch_wgmma<128>(q, k, v, out, B, Sq, Sk, Hkv, G, st, causal, s);
  return static_cast<int>(cudaErrorInvalidValue);
}
