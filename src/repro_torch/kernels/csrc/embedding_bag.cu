// EmbeddingBag on Hopper (sm_90a): out[b] = sum_l w[b,l] * table[idx[b,l]],
// a slot with idx < 0 masked; mode "mean" divides by max(sum_l w, 1e-9).
//
// Replaces the TPU kernel repro/kernels/embedding_bag.py::_bag_kernel (with
// the mask and mean epilogue of repro/kernels/ops.py::embedding_bag).  That
// kernel runs a sequential (B, L) grid: the bag indices are scalar-prefetched
// so each grid step DMAs one table row into VMEM, and the bag's output block
// stays resident in VMEM across the L axis and accumulates.  Blocks here run
// in no order, so nothing carries between them; one group of `tpb` lanes (a
// power of two dividing 32) owns a bag.
//
// What bounds it on this card.  The least bytes are the indices, the
// weights (if given), the output and the table once: at MIND's serve_bulk
// shape (2,097,152 bags of 16 slots, D = 64, N = 100,000 float32) about
// 0.70 GB, 0.21 ms at 3.35 TB/s.  But every slot gathers a table row, 8.6 GB
// of rows there, and with uniform indices a block of bags shares almost no
// row, so L1 is no help: the rows come from L2.  The probe
// (kernels/probe_embedding_bag.py) times a kernel that only gathers those
// rows with this kernel's walk (its gather time): ~1.08 ms on an H100 SXM,
// ~8 TB/s, for a table up to about half the L2 (25.6 MB), and ~16% more
// once the table is the whole L2.  The design, each choice timed by that
// probe:
//
//   - one group of tpb lanes per bag, each lane VEC consecutive columns
//     (16-byte loads when the row width and the table's alignment allow: 4
//     float32 or 8 bfloat16).  The group loads tpb slots at a time, one a
//     lane, and broadcasts each slot's index and weight by shuffles; the
//     slot loop is unrolled kChunk times, so a lane has kChunk row loads in
//     flight, in 32 registers: 16 blocks of 128 threads on an SM
//     (kMinBlocks).  A launch of less than one wave of the card (the
//     wrapper's `small`: serving requests of a few thousand bags) waits on
//     its chain of dependent loads, not on L2's rate, and takes the
//     kChunkSmall instance, with that many row loads in flight;
//   - block v covers kThreads / tpb consecutive bags, with no division
//     before the first load;
//   - table rows are loaded evict_last in L2 (a createpolicy policy), the
//     indices and weights evict_first (ld.global.cs) and the output stored
//     streaming (st.global.cs), so the streamed output and indices do not
//     push table lines out.  No device-wide state (access-policy window,
//     persisting L2 size) is touched;
//   - each column sums its slots in slot order with fmaf in float32, and
//     the masked weight sum in the same order: the float32 result is bit
//     for bit the one a slot-by-slot loop gives (ref.embedding_bag_slot_order
//     for unweighted bags).  The bag's columns are written once, divided by
//     the weight sum in mode "mean", rounded once to the table's dtype.
//
// kernels/probe_embedding_bag.py times builds with other values of the
// constants below beside the shipped one.
//
// Masking: a slot with idx < 0 reads no row and adds nothing, and its weight
// does not count in the mean.  The TPU kernel instead reads row 0 and
// multiplies it by weight 0; the two differ only where row 0 holds a
// non-finite value (0 * inf is NaN there, nothing here).  weights == nullptr
// means weight 1 for every slot, and no weight array is read.  A slot with
// idx >= N is treated as masked and sets the device word *bad to 1, which
// the wrapper reads only when asked (no host sync inside a serving step).
//
// Plain C interface, loaded with ctypes.  The function launches on the given
// stream, allocates nothing and returns cudaGetLastError().
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 128;
constexpr int kChunk = 2;       // slot loop unroll: row loads a lane has in flight
constexpr int kChunkSmall = 8;  // the same for a launch of less than one wave of the card
// blocks an SM must hold for the kChunk instance: caps its registers at
// 65536 / (16 x 128) = 32, 64 warps an SM (ptxas left alone takes 42 and
// loses 1-6%); the kChunkSmall instance runs below one wave, uncapped
constexpr int kMinBlocks = 16;
constexpr unsigned kFull = 0xffffffffu;
// Unrolled a number of times that is no power of two, the slot loop is
// miscompiled: the SASS of a kChunk = 3 build runs three slots a trip,
// tests the bound only after the third and has no remainder, so 16 slots
// run as 18 and the shuffles wrap slots 16 and 17 to lanes 0 and 1
// (kernels/probe_embedding_bag.py's census).  Powers of two get a
// remainder step.
static_assert((kChunk & (kChunk - 1)) == 0 && (kChunkSmall & (kChunkSmall - 1)) == 0 &&
                  kChunk > 0 && kChunkSmall > 0 && kThreads % 32 == 0,
              "slot loop unrolls are powers of two; whole warps");

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

// What a lane loads of one row: VEC elements, one 16-byte word when they
// fill one, else one element.
template <typename T, int VEC>
struct Word {
  using type = uint4;
};
template <typename T>
struct Word<T, 1> {
  using type = T;
};

__device__ __forceinline__ uint64_t evict_last_policy() {
  uint64_t p;
  asm("createpolicy.fractional.L2::evict_last.b64 %0, 1.0;" : "=l"(p));
  return p;
}

// Table loads: the line marked evict_last in L2 (a policy from createpolicy).
__device__ __forceinline__ uint4 load_row(const uint4* p, uint64_t keep) {
  uint4 v;
  asm("ld.global.nc.L2::cache_hint.v4.u32 {%0, %1, %2, %3}, [%4], %5;"
      : "=r"(v.x), "=r"(v.y), "=r"(v.z), "=r"(v.w)
      : "l"(p), "l"(keep));
  return v;
}
__device__ __forceinline__ float load_row(const float* p, uint64_t keep) {
  unsigned u;
  asm("ld.global.nc.L2::cache_hint.u32 %0, [%1], %2;" : "=r"(u) : "l"(p), "l"(keep));
  return __uint_as_float(u);
}
__device__ __forceinline__ __nv_bfloat16 load_row(const __nv_bfloat16* p, uint64_t keep) {
  unsigned short u;
  asm("ld.global.nc.L2::cache_hint.u16 %0, [%1], %2;" : "=h"(u) : "l"(p), "l"(keep));
  return __ushort_as_bfloat16(u);
}

// Read-once streams (indices, weights): evict_first (ld.global.cs).
__device__ __forceinline__ float weight_at(const float* p) { return __ldcs(p); }
__device__ __forceinline__ float weight_at(const __nv_bfloat16* p) {
  return __bfloat162float(__ushort_as_bfloat16(__ldcs(reinterpret_cast<const unsigned short*>(p))));
}

template <typename T, int VEC>
__device__ __forceinline__ void unpack(const uint4& u, float (&v)[VEC]) {
  const T* e = reinterpret_cast<const T*>(&u);
#pragma unroll
  for (int j = 0; j < VEC; ++j) v[j] = to_f32(e[j]);
}
template <typename T, int VEC>
__device__ __forceinline__ void unpack(const T& x, float (&v)[VEC]) {
  v[0] = to_f32(x);
}

__device__ __forceinline__ void store_one(float* p, float x) { __stcs(p, x); }
__device__ __forceinline__ void store_one(__nv_bfloat16* p, __nv_bfloat16 x) {
  __stcs(reinterpret_cast<unsigned short*>(p), __bfloat16_as_ushort(x));
}

// VEC consecutive elements at p (16-byte aligned when VEC * sizeof(T) == 16),
// streaming (st.global.cs)
template <typename T, int VEC>
__device__ __forceinline__ void store_vec(T* p, const float (&v)[VEC]) {
  if constexpr (VEC * sizeof(T) == 16) {
    uint4 u;
    T* e = reinterpret_cast<T*>(&u);
#pragma unroll
    for (int j = 0; j < VEC; ++j) e[j] = from_f32<T>(v[j]);
    __stcs(reinterpret_cast<uint4*>(p), u);
  } else {
#pragma unroll
    for (int j = 0; j < VEC; ++j) store_one(p + j, from_f32<T>(v[j]));
  }
}

// One group of tpb lanes per bag; block v covers kThreads / tpb
// consecutive bags.  Every lane of a warp runs the same trip counts (a lane
// past the last bag or column only skips its loads and stores), so the
// group shuffles always see all 32 lanes.
template <typename T, int VEC, int CHUNK>
__global__ void __launch_bounds__(kThreads, CHUNK == kChunk ? kMinBlocks : 1) bag_kernel(
    const T* __restrict__ table, const int* __restrict__ idx, const T* __restrict__ w,
    long long B, int L, int D, long long N, int tpb_log2, int mean, int* __restrict__ bad,
    T* __restrict__ out) {
  using W = typename Word<T, VEC>::type;
  // no division on the way to the first load: tpb and VEC are powers of two
  const int tpb = 1 << tpb_log2;
  const int lane = threadIdx.x & (tpb - 1);
  const long long bag =
      (long long)blockIdx.x * (kThreads >> tpb_log2) + (threadIdx.x >> tpb_log2);
  const bool live = bag < B;
  const int span_log2 = tpb_log2 + (VEC == 8 ? 3 : VEC == 4 ? 2 : 0);  // columns a pass
  const int chunks = (D + (1 << span_log2) - 1) >> span_log2;
  const int* bidx = idx + bag * L;
  const T* bw = w ? w + bag * L : nullptr;
  const uint64_t keep = evict_last_policy();
  for (int c = 0; c < chunks; ++c) {
    const int col = (c * tpb + lane) * VEC;
    const bool mine = live && col < D;
    float acc[VEC];
#pragma unroll
    for (int j = 0; j < VEC; ++j) acc[j] = 0.f;
    float wsum = 0.f;
    // the group loads tpb slots at a time, one a lane, and broadcasts each
    // slot's index and weight to the group; CHUNK slots' row loads are in
    // flight together
    for (int t0 = 0; t0 < L; t0 += tpb) {
      int my_i = -1;
      float my_w = 0.f;
      if (live && t0 + lane < L) {
        my_i = __ldcs(bidx + t0 + lane);
        if (my_i >= N) {
          *bad = 1;
          my_i = -1;
        }
        if (my_i >= 0) my_w = bw ? weight_at(bw + t0 + lane) : 1.f;
      }
      const int n = min(tpb, L - t0);
#pragma unroll (CHUNK)
      for (int s = 0; s < n; ++s) {
        const int r = __shfl_sync(kFull, my_i, s, tpb);
        const float ws = __shfl_sync(kFull, my_w, s, tpb);
        wsum += ws;
        if (r >= 0 && mine) {
          float f[VEC];
          unpack<T, VEC>(
              load_row(reinterpret_cast<const W*>(table + (long long)r * D + col), keep), f);
#pragma unroll
          for (int k = 0; k < VEC; ++k) acc[k] = fmaf(ws, f[k], acc[k]);
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

// One block a bag tile; `small` takes the kChunkSmall instance.
template <typename T, int VEC>
int launch(int small, const void* table, const void* idx, const void* w, long long B, int L,
           int D, long long N, int tpb, int mean, int* bad, void* out, cudaStream_t s) {
  int tpb_log2 = 0;
  while ((1 << tpb_log2) < tpb) ++tpb_log2;
  const long long per_block = kThreads / tpb;
  const long long blocks = (B + per_block - 1) / per_block;
  if (blocks >= (1ll << 31)) return (int)cudaErrorInvalidValue;
  const unsigned grid = (unsigned)blocks;
  if (small) {
    bag_kernel<T, VEC, kChunkSmall><<<grid, kThreads, 0, s>>>(
        (const T*)table, (const int*)idx, (const T*)w, B, L, D, N, tpb_log2, mean, bad, (T*)out);
  } else {
    bag_kernel<T, VEC, kChunk><<<grid, kThreads, 0, s>>>(
        (const T*)table, (const int*)idx, (const T*)w, B, L, D, N, tpb_log2, mean, bad, (T*)out);
  }
  return 0;
}

}  // namespace

// table (N, D) and out (B, D) in `dtype`, contiguous; idx (B, L) int32 (an
// idx >= N reads nothing and sets *bad); w (B, L) in `dtype` or null; bad
// one device int32.  vec is 1 or 16 / sizeof(dtype) (the wider one only
// when D is a multiple of it and the table is 16-byte aligned); small (a
// launch of less than one wave of the card) takes the kChunkSmall
// instance; tpb is a power of two dividing 32.
extern "C" int eb_embedding_bag(const void* table, const void* idx, const void* w,
                                long long B, int L, int D, long long N, int dtype,
                                int vec, int small, int tpb, int mean, void* bad, void* out,
                                void* stream) {
  if (tpb <= 0 || tpb > 32 || (32 % tpb) != 0) return (int)cudaErrorInvalidValue;
  if (B <= 0 || D <= 0) return (int)cudaGetLastError();
  cudaStream_t s = (cudaStream_t)stream;
  int* b = (int*)bad;
  int err;
  if (dtype == DT_FLOAT32 && vec == 4) {
    err = launch<float, 4>(small, table, idx, w, B, L, D, N, tpb, mean, b, out, s);
  } else if (dtype == DT_FLOAT32 && vec == 1) {
    err = launch<float, 1>(small, table, idx, w, B, L, D, N, tpb, mean, b, out, s);
  } else if (dtype == DT_BFLOAT16 && vec == 8) {
    err = launch<__nv_bfloat16, 8>(small, table, idx, w, B, L, D, N, tpb, mean, b, out, s);
  } else if (dtype == DT_BFLOAT16 && vec == 1) {
    err = launch<__nv_bfloat16, 1>(small, table, idx, w, B, L, D, N, tpb, mean, b, out, s);
  } else {
    return (int)cudaErrorInvalidValue;
  }
  return err ? err : (int)cudaGetLastError();
}
