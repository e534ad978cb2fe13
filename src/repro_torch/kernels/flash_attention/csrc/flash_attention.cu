// Tiled attention with an online softmax: q (B, Sq, Hq, D) against k/v
// (B, Sk, Hkv, D), causal (top-left aligned: query row i sees keys 0..i,
// also when Sq != Sk) or not, GQA (query head hq reads kv head hq / G,
// G = Hq / Hkv). Scores q.k / sqrt(D) in float32 from q, k and v read in
// their own type (float32 or bfloat16); masked keys get -1e30; float32
// (m, l, acc) per row; out = acc / max(l, 1e-20) in q's type.
//
// Replaces the TPU kernel flash_attention
// (src/repro/kernels/flash_attention/kernel.py, pl.pallas_call at :89),
// whose grid (B * Hq, nQ, nK) walked the key tiles of one (batch, query
// head, query tile) in order with the running state in VMEM scratch and
// skipped whole tiles above the diagonal; its plain version here is
// repro_torch/kernels/flash_attention/ref.py.
//
// What bounds it on an H100: operations. A causal prefill does about
// 2 * B * Hq * Sq * Sk * D floating-point operations for
// (B * Sq * (Hq + 2 * Hkv) + B * Sq * Hq) * D elements moved: at the
// granite-3-2b prefill (B 4, S 4,000, Hq 32, Hkv 8, D 64, bf16) some
// 2.6e11 operations for 50 MB, hundreds of operations a byte, far above
// the card's balance point, so the tensor cores' rate (989 TFLOP/s bf16)
// sets the bound (0.27 ms). This first design runs on the CUDA cores in
// float32 (67 TFLOP/s at best), which keeps one code path for both types
// and the float32 tolerance of the reference; wgmma is the next step.
//
// Design. The rows of a (batch, kv head) are its Sq * G (query position,
// query head of the group) pairs, in the memory order of q, where the G
// heads of a kv head are adjacent. One block of 256 threads takes 64
// such rows and walks the key tiles of 64 keys, so one K/V tile read
// serves all G query heads of the group. Grid (ceil(Sq * G / 64), Hkv, B).
// Under `causal` the walk stops at the block's last query position: whole
// tiles above the diagonal are never read. Per tile:
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
// Keys past Sk score -inf (weight exactly 0); query rows past Sq * G are
// computed on zeros and never written.
//
// The wrapper checks types, shapes and alignment (16-byte rows and
// strides); q, k and v may be strided views along B, S and H with D
// contiguous; out is contiguous. Built with nvcc into a shared library with
// a plain C interface and called through ctypes.

#include <cstdint>

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
