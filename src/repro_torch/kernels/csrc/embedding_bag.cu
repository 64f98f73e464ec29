// EmbeddingBag on Hopper (sm_90a): out[b] = sum_l w[b,l] * table[idx[b,l]],
// a slot with idx < 0 masked; mode "mean" divides by max(sum_l w, 1e-9).
//
// Replaces the TPU kernel repro/kernels/embedding_bag.py::_bag_kernel (with
// the mask and mean epilogue of repro/kernels/ops.py::embedding_bag).  That
// kernel runs a sequential (B, L) grid: the bag indices are scalar-prefetched
// so each grid step DMAs one table row into VMEM, and the bag's output block
// stays resident in VMEM across the L axis and accumulates.  Blocks here run
// in no order, so nothing carries between them; instead one group of `tpb`
// threads (a power of two dividing 32) owns a whole bag:
//
//   - the group loads the bag's indices and weights once, one slot per lane,
//     and broadcasts each slot to the group with a shuffle;
//   - each lane owns VEC consecutive columns (16-byte loads when the row
//     width allows: 4 float32 or 8 bfloat16) and walks the L slots
//     in slot order, accumulating in float32 registers;
//   - the bag's row is written once, divided by the masked weight sum in
//     mode "mean", rounded once to the table's dtype.
//
// At D = 64 float32 (MIND) a bag is 16 lanes of float4, two bags a warp.
//
// Masking: a slot with idx < 0 reads no row and adds nothing, and its weight
// does not count in the mean.  The TPU kernel instead reads row 0 and
// multiplies it by weight 0; the two differ only where row 0 holds a
// non-finite value (0 * inf is NaN there, nothing here).  weights == nullptr
// means weight 1 for every slot, and no weight array is read.  A slot with
// idx >= N is treated as masked and sets the device word *bad to 1, which
// the wrapper reads only when asked (no host sync inside a serving step).
//
// Bound on this card: the bytes of the indices, the weights (if given), the
// output, and the table once.  At MIND's serve_bulk shape (2,097,152 bags of
// 16 slots, D = 64, N = 100,000 float32) that is about 0.70 GB, 0.21 ms at
// 3.35 TB/s.  The 25.6 MB table fits in the 50 MB L2, so the 8.6 GB of
// gathered rows (16 per bag) should come from L2, not from device memory;
// the gathers through L2 are what this simple kernel pays above the bound.
//
// Plain C interface, loaded with ctypes.  The function launches on the given
// stream, allocates nothing and returns cudaGetLastError().
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;
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

// VEC consecutive elements at p (16-byte aligned when VEC * sizeof(T) == 16)
template <typename T, int VEC>
__device__ __forceinline__ void load_vec(const T* p, float (&v)[VEC]) {
  if constexpr (VEC * sizeof(T) == 16) {
    const uint4 u = __ldg(reinterpret_cast<const uint4*>(p));
    const T* e = reinterpret_cast<const T*>(&u);
#pragma unroll
    for (int j = 0; j < VEC; ++j) v[j] = to_f32(e[j]);
  } else {
#pragma unroll
    for (int j = 0; j < VEC; ++j) v[j] = to_f32(p[j]);
  }
}

template <typename T, int VEC>
__device__ __forceinline__ void store_vec(T* p, const float (&v)[VEC]) {
  if constexpr (VEC * sizeof(T) == 16) {
    uint4 u;
    T* e = reinterpret_cast<T*>(&u);
#pragma unroll
    for (int j = 0; j < VEC; ++j) e[j] = from_f32<T>(v[j]);
    *reinterpret_cast<uint4*>(p) = u;
  } else {
#pragma unroll
    for (int j = 0; j < VEC; ++j) p[j] = from_f32<T>(v[j]);
  }
}

// One group of tpb lanes per bag.  Every lane of a warp runs the same loop
// trip counts (a lane past the last bag or column only skips its loads and
// stores), so the group shuffles always see all 32 lanes.
template <typename T, int VEC>
__global__ void __launch_bounds__(kThreads) bag_kernel(
    const T* __restrict__ table, const int* __restrict__ idx, const T* __restrict__ w,
    long long B, int L, int D, long long N, int tpb, int mean, int* __restrict__ bad,
    T* __restrict__ out) {
  const long long gt = (long long)blockIdx.x * kThreads + threadIdx.x;
  const long long bag = gt / tpb;
  const int lane = (int)(gt % tpb);
  const bool live = bag < B;
  const int chunks = (D + tpb * VEC - 1) / (tpb * VEC);
  for (int c = 0; c < chunks; ++c) {
    const int col = (c * tpb + lane) * VEC;
    const bool mine = live && col < D;
    float acc[VEC];
#pragma unroll
    for (int j = 0; j < VEC; ++j) acc[j] = 0.f;
    float wsum = 0.f;
    for (int t0 = 0; t0 < L; t0 += tpb) {
      int my_i = -1;
      float my_w = 0.f;
      if (live && t0 + lane < L) {
        my_i = idx[bag * L + t0 + lane];
        if (my_i >= N) {
          *bad = 1;
          my_i = -1;
        }
        if (my_i >= 0) my_w = w ? to_f32(w[bag * L + t0 + lane]) : 1.f;
      }
      const int n = min(tpb, L - t0);
#pragma unroll 4
      for (int s = 0; s < n; ++s) {
        const int r = __shfl_sync(kFull, my_i, s, tpb);
        const float ws = __shfl_sync(kFull, my_w, s, tpb);
        wsum += ws;
        if (r >= 0 && mine) {
          float v[VEC];
          load_vec<T, VEC>(table + (long long)r * D + col, v);
#pragma unroll
          for (int j = 0; j < VEC; ++j) acc[j] = fmaf(ws, v[j], acc[j]);
        }
      }
    }
    if (mine) {
      if (mean) {
        const float denom = fmaxf(wsum, 1e-9f);
#pragma unroll
        for (int j = 0; j < VEC; ++j) acc[j] = acc[j] / denom;
      }
      store_vec<T, VEC>(out + bag * D + col, acc);
    }
  }
}

template <typename T, int VEC>
int launch(const void* table, const void* idx, const void* w, long long B, int L, int D,
           long long N, int tpb, int mean, int* bad, void* out, cudaStream_t s) {
  const long long threads = B * tpb;
  const unsigned int grid = (unsigned int)((threads + kThreads - 1) / kThreads);
  bag_kernel<T, VEC><<<grid, kThreads, 0, s>>>((const T*)table, (const int*)idx,
                                               (const T*)w, B, L, D, N, tpb, mean, bad,
                                               (T*)out);
  return 0;
}

}  // namespace

// table (N, D) and out (B, D) in `dtype`, contiguous; idx (B, L) int32 (an
// idx >= N reads nothing and sets *bad); w (B, L) in `dtype` or null; bad
// one device int32.  vec is 1 or 16 / sizeof(dtype) (the wrapper takes the
// wider one only when D is a multiple of it and the table is 16-byte
// aligned); tpb is a power of two dividing 32.
extern "C" int eb_embedding_bag(const void* table, const void* idx, const void* w,
                                long long B, int L, int D, long long N, int dtype,
                                int vec, int tpb, int mean, void* bad, void* out,
                                void* stream) {
  if (tpb <= 0 || tpb > 32 || (32 % tpb) != 0) return (int)cudaErrorInvalidValue;
  if (B > 0 && D > 0) {
    cudaStream_t s = (cudaStream_t)stream;
    bool known = true;
    if (dtype == DT_FLOAT32 && vec == 4) {
      launch<float, 4>(table, idx, w, B, L, D, N, tpb, mean, (int*)bad, out, s);
    } else if (dtype == DT_FLOAT32 && vec == 1) {
      launch<float, 1>(table, idx, w, B, L, D, N, tpb, mean, (int*)bad, out, s);
    } else if (dtype == DT_BFLOAT16 && vec == 8) {
      launch<__nv_bfloat16, 8>(table, idx, w, B, L, D, N, tpb, mean, (int*)bad, out, s);
    } else if (dtype == DT_BFLOAT16 && vec == 1) {
      launch<__nv_bfloat16, 1>(table, idx, w, B, L, D, N, tpb, mean, (int*)bad, out, s);
    } else {
      known = false;
    }
    if (!known) return (int)cudaErrorInvalidValue;
  }
  return (int)cudaGetLastError();
}
