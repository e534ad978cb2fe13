// Decode attention over a block-pooled (paged) KV cache: one query token
// per sequence, GQA (G = Hq / Hkv query heads share a kv head), K/V blocks
// of T tokens reached through a (B, NB) block table, positions >= lengths[b]
// masked, online softmax with float32 (m, l, acc).
//
// Replaces the TPU kernel paged_attention
// (src/repro/kernels/paged_attention/kernel.py, pl.pallas_call at :103),
// whose grid (B, Hkv, NB) walked the blocks in order with the running state
// in VMEM scratch; its plain version here is
// repro_torch/kernels/paged_attention/ref.py.
//
// What bounds it on an H100: bytes. A (sequence, kv head) reads each of its
// live tokens' K and V rows once (2 * D * itemsize bytes a token) for about
// 4 * G * D float operations, one or two operations a byte, far below the
// card's balance point. At the tiered-KV decode (Hkv 8, D 64, 4,000 tokens,
// f32) that is 16 MB: some 5 us at 3.35 TB/s. One block per (sequence, kv
// head) would put 8 blocks on 132 SMs, so the design splits each sequence's
// blocks into `splits` chunks of `chunk` KV blocks: grid (B * Hkv, splits),
// 4 warps a block. Each warp takes the chunk's KV blocks round robin,
// copies a block's K and V rows of its head into shared memory with 16-byte
// asynchronous copies (all in flight at once; an element loop where rows
// are not 16-byte aligned), computes the G x T scores with its lanes over
// (query row, token) pairs, and updates its own (m, l, acc) per query row
// with its lanes over D. The warps' states are merged into one partial per
// chunk in a float32 workspace; the last block of a (sequence, kv head) to
// finish (an atomic count) merges the chunks and writes the output. Blocks
// and tokens past the length are never read, which is exact: the reference
// gives them weight 0 and they never set the maximum. Scores are
// q.k / sqrt(D); the output is acc / max(l, 1e-20), as in the TPU kernel.
// Slots are clamped into the pool.
//
// K and V come as strided views (block, token and head strides in
// elements; D contiguous), so the tiered-KV decode hands the fast tier's
// interleaved K/V halves over without a copy. The wrapper allocates the
// workspace and the zeroed counts.
//
// Built with nvcc into a shared library with a plain C interface and called
// through ctypes.

#include <cstdint>

#include <cuda_bf16.h>
#include <cuda_pipeline.h>
#include <cuda_runtime.h>

namespace {

constexpr unsigned kFull = 0xffffffffu;
constexpr int kWarps = 4;
constexpr float kNegInf = -1e30f;
constexpr size_t kMaxSharedBytes = 227 * 1024;

__device__ __forceinline__ float to_f32(float x) { return x; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 x) { return __bfloat162float(x); }
__device__ __forceinline__ void store(float* p, float x) { *p = x; }
__device__ __forceinline__ void store(__nv_bfloat16* p, float x) { *p = __float2bfloat16(x); }

__device__ __forceinline__ float warp_sum(float v) {
  for (int off = 16; off > 0; off >>= 1) v += __shfl_xor_sync(kFull, v, off);
  return v;
}

__device__ __forceinline__ float warp_max(float v) {
  for (int off = 16; off > 0; off >>= 1) v = fmaxf(v, __shfl_xor_sync(kFull, v, off));
  return v;
}

__host__ __device__ __forceinline__ size_t round16(size_t x) { return (x + 15) & ~size_t{15}; }

// Shared memory, in bytes: the queries in f32, then per warp a K tile
// (rows padded by 16 bytes against bank conflicts), a V tile, the scores
// of one tile and the warp's (acc, m, l).
struct Smem {
  size_t krow, vrow, q, k, v, sc, acc, ml, warp, total;
  __host__ __device__ Smem(int G, int D, int T, size_t isz) {
    vrow = round16(D * isz);
    krow = vrow + 16;
    q = round16(sizeof(float) * G * D);
    k = round16(T * krow);
    v = round16(T * vrow);
    sc = round16(sizeof(float) * G * T);
    acc = round16(sizeof(float) * G * D);
    ml = round16(sizeof(float) * 2 * G);
    warp = k + v + sc + acc + ml;
    total = q + kWarps * warp;
  }
};

template <typename E>
__global__ void __launch_bounds__(kWarps * 32)
    paged_attention_kernel(const E* __restrict__ q, const E* __restrict__ k,
                           const E* __restrict__ v,
                           const int* __restrict__ table,
                           const int* __restrict__ lengths, E* __restrict__ out,
                           float* __restrict__ ws, int* __restrict__ done,
                           int Hkv, int G, int D, int T, int NB, int P,
                           int chunk, int splits, long long ks0, long long ks1,
                           long long ks2, long long vs0, long long vs1,
                           long long vs2, float sqrt_d, int vec16) {
  extern __shared__ __align__(16) unsigned char smem[];
  __shared__ int is_last;
  const Smem lay(G, D, T, sizeof(E));
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int bh = blockIdx.x, split = blockIdx.y;
  const int b = bh / Hkv, h = bh % Hkv;

  float* qs = reinterpret_cast<float*>(smem);
  auto warp_base = [&](int w) { return smem + lay.q + w * lay.warp; };
  unsigned char* base = warp_base(warp);
  unsigned char* ks = base;
  unsigned char* vs = base + lay.k;
  float* sc = reinterpret_cast<float*>(base + lay.k + lay.v);
  auto acc_of = [&](int w) { return reinterpret_cast<float*>(warp_base(w) + lay.k + lay.v + lay.sc); };
  auto m_of = [&](int w) { return reinterpret_cast<float*>(warp_base(w) + lay.k + lay.v + lay.sc + lay.acc); };
  float* acc = acc_of(warp);
  float* m = m_of(warp);
  float* l = m + G;

  const E* qb = q + static_cast<size_t>(bh) * G * D;
  for (int i = threadIdx.x; i < G * D; i += blockDim.x) qs[i] = to_f32(qb[i]);
  for (int i = lane; i < G * D; i += 32) acc[i] = 0.f;
  for (int i = lane; i < G; i += 32) {
    m[i] = kNegInf;
    l[i] = 0.f;
  }
  __syncthreads();

  const int len = lengths[b];
  const int live = len <= 0 ? 0 : min(NB, (len + T - 1) / T);
  const int j1 = min(live, (split + 1) * chunk);
  for (int j = split * chunk + warp; j < j1; j += kWarps) {
    const long long slot = min(max(table[static_cast<size_t>(b) * NB + j], 0), P - 1);
    const E* kb = k + slot * ks0 + h * ks2;
    const E* vb = v + slot * vs0 + h * vs2;
    const int tv = min(T, len - j * T);  // valid tokens of this block, >= 1
    if (vec16) {
      const int per_row = static_cast<int>(D * sizeof(E) / 16);
      for (int c = lane; c < tv * per_row; c += 32) {
        const int t = c / per_row, o = 16 * (c % per_row);
        __pipeline_memcpy_async(ks + t * lay.krow + o,
                                reinterpret_cast<const unsigned char*>(kb + t * ks1) + o, 16);
        __pipeline_memcpy_async(vs + t * lay.vrow + o,
                                reinterpret_cast<const unsigned char*>(vb + t * vs1) + o, 16);
      }
      __pipeline_commit();
      __pipeline_wait_prior(0);
    } else {
#pragma unroll 4
      for (int i = lane; i < tv * D; i += 32) {
        const int t = i / D, d = i % D;
        reinterpret_cast<E*>(ks + t * lay.krow)[d] = kb[t * ks1 + d];
        reinterpret_cast<E*>(vs + t * lay.vrow)[d] = vb[t * vs1 + d];
      }
    }
    __syncwarp();
    for (int pr = lane; pr < G * tv; pr += 32) {
      const int g = pr / tv, t = pr % tv;
      const E* kt = reinterpret_cast<const E*>(ks + t * lay.krow);
      const float* qg = qs + g * D;
      float s = 0.f;
      for (int d = 0; d < D; ++d) s += qg[d] * to_f32(kt[d]);
      sc[g * T + t] = s / sqrt_d;
    }
    __syncwarp();
    for (int g = 0; g < G; ++g) {
      float* sg = sc + g * T;
      float tmax = kNegInf;
      for (int t = lane; t < tv; t += 32) tmax = fmaxf(tmax, sg[t]);
      const float m_prev = m[g];
      const float m_new = fmaxf(m_prev, warp_max(tmax));
      const float alpha = expf(m_prev - m_new);
      float psum = 0.f;
      for (int t = lane; t < tv; t += 32) {
        const float p = expf(sg[t] - m_new);
        sg[t] = p;
        psum += p;
      }
      psum = warp_sum(psum);
      __syncwarp();
      float* ag = acc + g * D;
      for (int d = lane; d < D; d += 32) {
        float a = ag[d] * alpha;
        for (int t = 0; t < tv; ++t) a += sg[t] * to_f32(reinterpret_cast<const E*>(vs + t * lay.vrow)[d]);
        ag[d] = a;
      }
      if (lane == 0) {
        l[g] = l[g] * alpha + psum;
        m[g] = m_new;
      }
      __syncwarp();
    }
  }
  __syncthreads();

  // this chunk's partial: the warps' states merged, [m (G), l (G), acc (G*D)]
  const size_t stride = static_cast<size_t>(G) * (D + 2);
  float* part = ws + (static_cast<size_t>(bh) * splits + split) * stride;
  for (int i = threadIdx.x; i < G * (D + 1); i += blockDim.x) {
    const int g = i < G * D ? i / D : i - G * D;
    float mx = kNegInf;
    for (int w = 0; w < kWarps; ++w) mx = fmaxf(mx, m_of(w)[g]);
    float sum = 0.f;
    for (int w = 0; w < kWarps; ++w) {
      const float c = expf(m_of(w)[g] - mx);
      sum += (i < G * D ? acc_of(w)[i] : m_of(w)[G + g]) * c;
    }
    if (i < G * D) {
      part[2 * G + i] = sum;
    } else {
      part[g] = mx;
      part[G + g] = sum;
    }
  }
  __threadfence();
  __syncthreads();
  if (threadIdx.x == 0) is_last = atomicAdd(done + bh, 1) == splits - 1;
  __syncthreads();
  if (!is_last) return;
  __threadfence();

  // the last block of this (sequence, kv head): merge the chunks
  const float* parts = ws + static_cast<size_t>(bh) * splits * stride;
  E* ob = out + static_cast<size_t>(bh) * G * D;
  for (int i = threadIdx.x; i < G * D; i += blockDim.x) {
    const int g = i / D;
    float mx = kNegInf;
    for (int s = 0; s < splits; ++s) mx = fmaxf(mx, __ldcg(parts + s * stride + g));
    float lsum = 0.f, a = 0.f;
    for (int s = 0; s < splits; ++s) {
      const float* ps = parts + s * stride;
      const float c = expf(__ldcg(ps + g) - mx);
      lsum += __ldcg(ps + G + g) * c;
      a += __ldcg(ps + 2 * G + i) * c;
    }
    store(ob + i, a / fmaxf(lsum, 1e-20f));
  }
}

template <typename E>
int launch(const void* q, const void* k, const void* v, const void* table,
           const void* lengths, void* out, void* ws, void* done, int B, int Hkv,
           int G, int D, int T, int NB, int P, int chunk, int splits,
           const long long* st, cudaStream_t stream) {
  const size_t isz = sizeof(E);
  const Smem lay(G, D, T, isz);
  if (lay.total > kMaxSharedBytes) return static_cast<int>(cudaErrorInvalidValue);
  const auto kernel = paged_attention_kernel<E>;
  if (lay.total > 48 * 1024) {
    const cudaError_t err = cudaFuncSetAttribute(
        kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, static_cast<int>(lay.total));
    if (err != cudaSuccess) return static_cast<int>(err);
  }
  bool vec16 = (D * isz) % 16 == 0 && reinterpret_cast<uintptr_t>(k) % 16 == 0 &&
               reinterpret_cast<uintptr_t>(v) % 16 == 0;
  for (int i = 0; i < 6; ++i) vec16 = vec16 && (st[i] * static_cast<long long>(isz)) % 16 == 0;
  const dim3 grid(B * Hkv, splits), block(kWarps * 32);
  kernel<<<grid, block, lay.total, stream>>>(
      static_cast<const E*>(q), static_cast<const E*>(k), static_cast<const E*>(v),
      static_cast<const int*>(table), static_cast<const int*>(lengths),
      static_cast<E*>(out), static_cast<float*>(ws), static_cast<int*>(done), Hkv,
      G, D, T, NB, P, chunk, splits, st[0], st[1], st[2], st[3], st[4], st[5],
      sqrtf(static_cast<float>(D)), vec16 ? 1 : 0);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// q, k, v and out are float32 (dtype 0) or bfloat16 (dtype 1); ws holds
// B * Hkv * splits * G * (D + 2) floats and done B * Hkv zeroed ints.
extern "C" int paged_attention(const void* q, const void* k, const void* v,
                               const void* table, const void* lengths,
                               void* out, void* ws, void* done, int B, int Hkv,
                               int G, int D, int T, int NB, int P, int chunk,
                               int splits, long long ks0, long long ks1,
                               long long ks2, long long vs0, long long vs1,
                               long long vs2, int dtype, void* stream) {
  if (B <= 0 || Hkv <= 0 || G <= 0 || D <= 0) return 0;
  if (T <= 0 || NB < 0 || P <= 0 || chunk <= 0 || splits <= 0 ||
      static_cast<long long>(chunk) * splits < NB || splits > 65535) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  const long long st[6] = {ks0, ks1, ks2, vs0, vs1, vs2};
  const auto s = static_cast<cudaStream_t>(stream);
  if (dtype == 0) {
    return launch<float>(q, k, v, table, lengths, out, ws, done, B, Hkv, G, D, T,
                         NB, P, chunk, splits, st, s);
  }
  if (dtype == 1) {
    return launch<__nv_bfloat16>(q, k, v, table, lengths, out, ws, done, B, Hkv,
                                 G, D, T, NB, P, chunk, splits, st, s);
  }
  return static_cast<int>(cudaErrorInvalidValue);
}
