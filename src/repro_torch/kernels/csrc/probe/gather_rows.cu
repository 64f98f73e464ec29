// The gather time of the embedding bag's rows, in two layouts.
//
// A probe kernel (kernels/probe_embedding_bag.py), not a path of the port.
// Both kernels read the rows the bag kernel reads -- for each of B bags the
// L rows table[idx[b, l]] of a float32 (N, D) table, D a multiple of 4, in
// 16-byte loads marked evict_last in L2, indices evict_first -- and write
// one float a bag (the sum of the row values read), so there is no output
// stream: their time is that of these row reads alone.
//
//   - gather_kernel walks them as the bag kernel does, under the same
//     constants: a group of tpb lanes a bag, 4 columns a lane, each slot's
//     index broadcast by a shuffle, kChunk row loads in flight a lane;
//   - row_gather_kernel lays the work out the other way: one thread a
//     (bag, slot), all D / 4 of its row's 16-byte words in flight, the
//     bag's L slots summed by shuffles (L a power of two dividing 32).
//
// Plain C interface, loaded with ctypes; returns cudaGetLastError().
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 128;
constexpr int kChunk = 2;  // slot loop unroll: row loads a lane has in flight
constexpr int kRowWords = 16;  // row_gather_kernel: the 16-byte words of a row (D = 64)
constexpr unsigned kFull = 0xffffffffu;
// a power of two, as in the bag kernel (its static_assert says why)
static_assert(kChunk > 0 && (kChunk & (kChunk - 1)) == 0 && kThreads % 32 == 0,
              "slot loop unroll a power of two; whole warps");

__device__ __forceinline__ uint64_t evict_last_policy() {
  uint64_t p;
  asm("createpolicy.fractional.L2::evict_last.b64 %0, 1.0;" : "=l"(p));
  return p;
}

__device__ __forceinline__ float4 load_row(const float4* p, uint64_t keep) {
  float4 v;
  asm("ld.global.nc.L2::cache_hint.v4.f32 {%0, %1, %2, %3}, [%4], %5;"
      : "=f"(v.x), "=f"(v.y), "=f"(v.z), "=f"(v.w)
      : "l"(p), "l"(keep));
  return v;
}

__device__ __forceinline__ float word_sum(float4 v) { return (v.x + v.y) + (v.z + v.w); }

__global__ void __launch_bounds__(kThreads, 1) gather_kernel(
    const float* __restrict__ table, const int* __restrict__ idx, long long B, int L, int D,
    int tpb_log2, float* __restrict__ out) {
  const int tpb = 1 << tpb_log2;
  const int lane = threadIdx.x & (tpb - 1);
  const long long bag =
      (long long)blockIdx.x * (kThreads >> tpb_log2) + (threadIdx.x >> tpb_log2);
  const bool live = bag < B;
  const int col = lane * 4;
  const bool mine = live && col < D;
  const int* bidx = idx + bag * L;
  const uint64_t keep = evict_last_policy();
  float acc = 0.f;
  for (int t0 = 0; t0 < L; t0 += tpb) {
    int my_i = -1;
    if (live && t0 + lane < L) my_i = __ldcs(bidx + t0 + lane);
    const int n = min(tpb, L - t0);
#pragma unroll (kChunk)
    for (int s = 0; s < n; ++s) {
      const int r = __shfl_sync(kFull, my_i, s, tpb);
      if (r >= 0 && mine)
        acc += word_sum(load_row(reinterpret_cast<const float4*>(table + (long long)r * D + col),
                                 keep));
    }
  }
  for (int o = tpb / 2; o > 0; o /= 2) acc += __shfl_xor_sync(kFull, acc, o, tpb);
  if (live && lane == 0) out[bag] = acc;
}

__global__ void __launch_bounds__(kThreads, 1) row_gather_kernel(
    const float* __restrict__ table, const int* __restrict__ idx, long long slots, int L,
    float* __restrict__ out) {
  const long long t = (long long)blockIdx.x * kThreads + threadIdx.x;  // (bag, slot)
  const int r = t < slots ? __ldcs(idx + t) : -1;
  const uint64_t keep = evict_last_policy();
  float acc = 0.f;
  if (r >= 0) {
    const float4* p = reinterpret_cast<const float4*>(table + (long long)r * (4 * kRowWords));
    float4 v[kRowWords];
#pragma unroll
    for (int j = 0; j < kRowWords; ++j) v[j] = load_row(p + j, keep);
#pragma unroll
    for (int j = 0; j < kRowWords; ++j) acc += word_sum(v[j]);
  }
  for (int o = L / 2; o > 0; o /= 2) acc += __shfl_xor_sync(kFull, acc, o, L);
  if (t < slots && t % L == 0) out[t / L] = acc;
}

}  // namespace

// table (N, D) float32, 16-byte aligned, D a multiple of 4 and at most 4
// tpb; idx (B, L) int32 in [0, N); out (B) float32.  tpb (a power of two
// dividing 32) lanes cover a row.
extern "C" int gr_gather(const void* table, const void* idx, long long B, int L, int D, int tpb,
                         void* out, void* stream) {
  if (tpb <= 0 || tpb > 32 || 32 % tpb != 0 || D % 4 != 0 || tpb * 4 < D)
    return (int)cudaErrorInvalidValue;
  if (B <= 0) return 0;
  int tpb_log2 = 0;
  while ((1 << tpb_log2) < tpb) ++tpb_log2;
  const long long per_block = kThreads / tpb;
  const long long blocks = (B + per_block - 1) / per_block;
  if (blocks >= (1ll << 31)) return (int)cudaErrorInvalidValue;
  gather_kernel<<<(unsigned)blocks, kThreads, 0, (cudaStream_t)stream>>>(
      (const float*)table, (const int*)idx, B, L, D, tpb_log2, (float*)out);
  return (int)cudaGetLastError();
}

// The same rows, a thread a (bag, slot): D = 4 kRowWords, L a power of two
// dividing 32.
extern "C" int gr_row_gather(const void* table, const void* idx, long long B, int L, int D,
                             void* out, void* stream) {
  if (D != 4 * kRowWords || L <= 0 || L > 32 || 32 % L != 0) return (int)cudaErrorInvalidValue;
  if (B <= 0) return 0;
  const long long blocks = (B * L + kThreads - 1) / kThreads;
  if (blocks >= (1ll << 31)) return (int)cudaErrorInvalidValue;
  row_gather_kernel<<<(unsigned)blocks, kThreads, 0, (cudaStream_t)stream>>>(
      (const float*)table, (const int*)idx, B * L, L, (float*)out);
  return (int)cudaGetLastError();
}
