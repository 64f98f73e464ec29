// Flash decode on Hopper (sm_90a): one query token of GQA attention over
// the first cache_len positions of a KV cache, softmax in float32, scale
// 1/sqrt(d).
//
// Replaces the TPU kernel repro/kernels/flash_decode.py::_flash_decode_kernel,
// which is also the single-chip form of repro/models/layers.py::
// decode_attention.  The TPU kernel walks the cache in a sequential grid of
// KV blocks per kv head and carries the running (max, sum, acc) of its G
// query heads in VMEM scratch from one grid step to the next.  Blocks here
// run in no order on 132 SMs, and (batch, kv head) alone gives too few of
// them at batch 1 (8 for the long_500k cache), so the walk becomes split-KV:
//
//   fd_split    one thread block per (chunk of kChunk positions, kv head,
//               batch row).  It stages the G query heads of its kv head in
//               shared memory, pre-scaled; each warp takes positions of the
//               chunk and reduces q.k for every head with shuffles; one warp
//               per head takes the chunk's max m and the sum l of
//               exp(s - m); the threads then stream the chunk's V once, each
//               owning columns, and write the chunk's partial (m, l,
//               acc = sum_t exp(s_t - m) v_t) in float32.  A chunk that
//               starts at or past cache_len reads and writes nothing.
//   fd_combine  one thread block per (query head, batch row): the global max
//               M over the chunks below cache_len, L = sum_c l_c exp(m_c - M),
//               out = sum_c acc_c exp(m_c - M) / L, rounded once to q's dtype.
//
// cache_len is read on the device (an int32 scalar, or one per batch row),
// so a decode step never waits on the host for it; positions at or past it
// are never read, and any T works (the ragged last chunk is bounded by
// cache_len and T).  q is (B, H, d) and the caches (B, T, Hkv, d), each by
// its strides with a unit stride on d, so the TPU layout (Hkv, S, d) runs as
// B = 1 with no copy.  cache_len <= 0 gives 0 (the reference averages all of
// V there; decoding never asks for it).
//
// Bound on this card: the K and V bytes below cache_len, plus q and out
// (bf16 at Qwen3-0.6B's decode_32k layer cache, 8 x 32768 x 8 x 128: 1.07 GB,
// 0.32 ms at 3.35 TB/s).  The partials add 4(d + 2) bytes per (chunk, head)
// written and read once, G(d + 2) / (kChunk d) of the K/V bytes.  Tensor
// cores, TMA and cp.async pipelines are left for later: this kernel loads
// with plain coalesced loads and multiplies on the CUDA cores.
//
// Plain C interface, loaded with ctypes.  Every function launches on the
// given stream, allocates nothing and returns cudaGetLastError().
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 128;
constexpr int kWarps = kThreads / 32;
constexpr int kChunk = 256;  // positions per split block (CHUNK in flash_decode.py)
constexpr int kGroup = 8;    // query heads accumulated in registers at once
constexpr int kTile = 1024;  // chunk weights staged per round of the combine
constexpr unsigned kFull = 0xffffffffu;

enum DType { DT_FLOAT32 = 0, DT_BFLOAT16 = 1 };

__device__ __forceinline__ float to_f32(float x) { return x; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 x) { return __bfloat162float(x); }

template <typename T>
__device__ __forceinline__ T from_f32(float x);
template <>
__device__ __forceinline__ float from_f32<float>(float x) { return x; }
template <>
__device__ __forceinline__ __nv_bfloat16 from_f32<__nv_bfloat16>(float x) {
  return __float2bfloat16(x);
}

__device__ __forceinline__ float warp_sum(float x) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) x += __shfl_xor_sync(kFull, x, o);
  return x;
}

__device__ __forceinline__ float warp_max(float x) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) x = fmaxf(x, __shfl_xor_sync(kFull, x, o));
  return x;
}

__device__ __forceinline__ int valid_len(const int* lens, int len_stride, int b, int T) {
  return min(lens[(long long)b * len_stride], T);
}

struct Strides {
  long long b, t, h;  // batch, position, head (elements); d has stride 1
};

// dynamic shared memory: q_s[G][d], p_s[G][kChunk], m_s[G], l_s[G]
template <typename T>
__global__ void __launch_bounds__(kThreads) split_kernel(
    const T* __restrict__ q, Strides qs, const T* __restrict__ k, Strides ks,
    const T* __restrict__ v, Strides vs, const int* __restrict__ lens, int len_stride,
    int T_, int Hkv, int G, int d, float scale, float* __restrict__ part_ml,
    float* __restrict__ part_acc) {
  extern __shared__ float smem[];
  float* q_s = smem;
  float* p_s = q_s + G * d;
  float* m_s = p_s + G * kChunk;
  float* l_s = m_s + G;

  const int c = blockIdx.x, h = blockIdx.y, b = blockIdx.z;
  const int NC = gridDim.x;
  const int t0 = c * kChunk;
  const int len = valid_len(lens, len_stride, b, T_);
  if (t0 >= len) return;  // the whole block: nothing read, nothing written
  const int n = min(kChunk, len - t0);
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;

  for (int i = threadIdx.x; i < G * d; i += kThreads) {
    const int g = i / d, j = i - g * d;
    q_s[i] = to_f32(q[b * qs.b + (long long)(h * G + g) * qs.h + j]) * scale;
  }
  __syncthreads();

  // scores: one position per warp at a time, lanes across d
  const T* kb = k + b * ks.b + (long long)h * ks.h;
  for (int t = warp; t < n; t += kWarps) {
    const T* kr = kb + (long long)(t0 + t) * ks.t;
    for (int g0 = 0; g0 < G; g0 += kGroup) {
      float part[kGroup];
#pragma unroll
      for (int gg = 0; gg < kGroup; ++gg) part[gg] = 0.f;
      for (int j = lane; j < d; j += 32) {
        const float kv = to_f32(kr[j]);
#pragma unroll
        for (int gg = 0; gg < kGroup; ++gg)
          if (g0 + gg < G) part[gg] = fmaf(q_s[(g0 + gg) * d + j], kv, part[gg]);
      }
#pragma unroll
      for (int gg = 0; gg < kGroup; ++gg) {
        if (g0 + gg < G) {  // warp-uniform
          const float s = warp_sum(part[gg]);
          if (lane == 0) p_s[(g0 + gg) * kChunk + t] = s;
        }
      }
    }
  }
  __syncthreads();

  // the chunk's softmax statistics: one warp per head
  for (int g = warp; g < G; g += kWarps) {
    float* ps = p_s + g * kChunk;
    float m = -INFINITY;
    for (int t = lane; t < n; t += 32) m = fmaxf(m, ps[t]);
    m = warp_max(m);
    float l = 0.f;
    for (int t = lane; t < n; t += 32) {
      const float p = expf(ps[t] - m);
      ps[t] = p;
      l += p;
    }
    l = warp_sum(l);
    if (lane == 0) {
      m_s[g] = m;
      l_s[g] = l;
    }
  }
  __syncthreads();

  // P.V: each thread owns columns, streams the chunk's V rows once per group
  const T* vb = v + b * vs.b + (long long)h * vs.h + (long long)t0 * vs.t;
  const long long slot = ((long long)(b * Hkv + h) * NC + c) * G;
  for (int g0 = 0; g0 < G; g0 += kGroup) {
    for (int j = threadIdx.x; j < d; j += kThreads) {
      float acc[kGroup];
#pragma unroll
      for (int gg = 0; gg < kGroup; ++gg) acc[gg] = 0.f;
#pragma unroll 4
      for (int t = 0; t < n; ++t) {
        const float vv = to_f32(vb[(long long)t * vs.t + j]);
#pragma unroll
        for (int gg = 0; gg < kGroup; ++gg)
          if (g0 + gg < G) acc[gg] = fmaf(p_s[(g0 + gg) * kChunk + t], vv, acc[gg]);
      }
#pragma unroll
      for (int gg = 0; gg < kGroup; ++gg)
        if (g0 + gg < G) part_acc[(slot + g0 + gg) * d + j] = acc[gg];
    }
  }
  for (int g = threadIdx.x; g < G; g += kThreads) {
    part_ml[(slot + g) * 2] = m_s[g];
    part_ml[(slot + g) * 2 + 1] = l_s[g];
  }
}

__device__ float block_reduce(float x, bool is_max, float* red) {
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  x = is_max ? warp_max(x) : warp_sum(x);
  __syncthreads();  // red is reused across calls
  if (lane == 0) red[warp] = x;
  __syncthreads();
  float r = red[0];
  for (int w = 1; w < kWarps; ++w) r = is_max ? fmaxf(r, red[w]) : r + red[w];
  return r;
}

template <typename T>
__global__ void __launch_bounds__(kThreads) combine_kernel(
    const float* __restrict__ part_ml, const float* __restrict__ part_acc,
    const int* __restrict__ lens, int len_stride, int T_, int Hkv, int G, int d, int NC,
    T* __restrict__ out) {
  __shared__ float red[kWarps];
  __shared__ float wt[kTile];
  const int hq = blockIdx.x, b = blockIdx.y;
  const int h = hq / G, g = hq - h * G;
  const int len = valid_len(lens, len_stride, b, T_);
  const int nc = len > 0 ? (len + kChunk - 1) / kChunk : 0;
  const long long base = (long long)(b * Hkv + h) * NC * G + g;  // chunk c at base + c*G

  float m = -INFINITY;
  for (int c = threadIdx.x; c < nc; c += kThreads) m = fmaxf(m, part_ml[(base + (long long)c * G) * 2]);
  const float M = block_reduce(m, true, red);
  float l = 0.f;
  for (int c = threadIdx.x; c < nc; c += kThreads) {
    const long long s = (base + (long long)c * G) * 2;
    l += part_ml[s + 1] * expf(part_ml[s] - M);
  }
  const float L = block_reduce(l, false, red);
  const float inv = L > 0.f ? 1.f / L : 0.f;

  T* o = out + ((long long)b * Hkv * G + hq) * d;
  for (int j0 = 0; j0 < d; j0 += kThreads) {
    const int j = j0 + threadIdx.x;
    float acc = 0.f;
    for (int c0 = 0; c0 < nc; c0 += kTile) {
      const int nt = min(kTile, nc - c0);
      __syncthreads();
      for (int i = threadIdx.x; i < nt; i += kThreads)
        wt[i] = expf(part_ml[(base + (long long)(c0 + i) * G) * 2] - M) * inv;
      __syncthreads();
      if (j < d) {
#pragma unroll 4
        for (int i = 0; i < nt; ++i)
          acc = fmaf(wt[i], part_acc[(base + (long long)(c0 + i) * G) * d + j], acc);
      }
    }
    if (j < d) o[j] = from_f32<T>(acc);
  }
}

size_t split_smem(int G, int d) { return sizeof(float) * ((size_t)G * d + (size_t)G * kChunk + 2 * G); }

template <typename T>
int launch_split(const void* q, Strides qs, const void* k, Strides ks, const void* v,
                 Strides vs, const int* lens, int len_stride, int B, int T_, int Hkv, int G,
                 int d, float scale, int NC, float* ml, float* acc, cudaStream_t s) {
  const size_t smem = split_smem(G, d);
  if (smem > 48 * 1024) {
    const cudaError_t e = cudaFuncSetAttribute(
        split_kernel<T>, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (e != cudaSuccess) return (int)e;
  }
  const dim3 grid(NC, Hkv, B);
  split_kernel<T><<<grid, kThreads, smem, s>>>((const T*)q, qs, (const T*)k, ks, (const T*)v,
                                               vs, lens, len_stride, T_, Hkv, G, d, scale, ml,
                                               acc);
  return 0;
}

}  // namespace

// Number of positions one split block covers (the wrapper sizes the partials
// (B, Hkv, NC, G, 2) and (B, Hkv, NC, G, d) float32 with NC = ceil(T / it)).
extern "C" int fd_chunk() { return kChunk; }

// q (B, H, d) with strides q_sb, q_sh; k, v (B, T, Hkv, d) with strides
// (*_sb, *_st, *_sh); lens int32 with len_stride 0 (one scalar) or 1 (per
// row).  H = Hkv * G.
extern "C" int fd_split(const void* q, long long q_sb, long long q_sh, const void* k,
                        long long k_sb, long long k_st, long long k_sh, const void* v,
                        long long v_sb, long long v_st, long long v_sh, const void* lens,
                        int len_stride, int B, int T, int Hkv, int G, int d, int dtype,
                        void* part_ml, void* part_acc, void* stream) {
  if (B <= 0 || T <= 0 || Hkv <= 0 || G <= 0 || d <= 0) return (int)cudaGetLastError();
  const Strides qs{q_sb, 0, q_sh}, ks{k_sb, k_st, k_sh}, vs{v_sb, v_st, v_sh};
  const int NC = (T + kChunk - 1) / kChunk;
  const float scale = 1.0f / sqrtf((float)d);
  cudaStream_t s = (cudaStream_t)stream;
  const int* ln = (const int*)lens;
  float* ml = (float*)part_ml;
  float* acc = (float*)part_acc;
  int e = 0;
  if (dtype == DT_FLOAT32) {
    e = launch_split<float>(q, qs, k, ks, v, vs, ln, len_stride, B, T, Hkv, G, d, scale, NC, ml, acc, s);
  } else if (dtype == DT_BFLOAT16) {
    e = launch_split<__nv_bfloat16>(q, qs, k, ks, v, vs, ln, len_stride, B, T, Hkv, G, d, scale, NC, ml, acc, s);
  } else {
    return (int)cudaErrorInvalidValue;
  }
  if (e) return e;
  return (int)cudaGetLastError();
}

// out (B, H, d) contiguous in `dtype`.
extern "C" int fd_combine(const void* part_ml, const void* part_acc, const void* lens,
                          int len_stride, int B, int T, int Hkv, int G, int d, int dtype,
                          void* out, void* stream) {
  if (B <= 0 || T <= 0 || Hkv <= 0 || G <= 0 || d <= 0) return (int)cudaGetLastError();
  const int NC = (T + kChunk - 1) / kChunk;
  const dim3 grid(Hkv * G, B);
  cudaStream_t s = (cudaStream_t)stream;
  const float* ml = (const float*)part_ml;
  const float* acc = (const float*)part_acc;
  const int* ln = (const int*)lens;
  if (dtype == DT_FLOAT32) {
    combine_kernel<float><<<grid, kThreads, 0, s>>>(ml, acc, ln, len_stride, T, Hkv, G, d, NC, (float*)out);
  } else if (dtype == DT_BFLOAT16) {
    combine_kernel<__nv_bfloat16><<<grid, kThreads, 0, s>>>(ml, acc, ln, len_stride, T, Hkv, G, d, NC, (__nv_bfloat16*)out);
  } else {
    return (int)cudaErrorInvalidValue;
  }
  return (int)cudaGetLastError();
}
