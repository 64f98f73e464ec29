// Segment sum over sorted rows on Hopper (sm_90a), with and without block
// skipping.
//
// Replaces two TPU kernels that compute the same reduction:
//   repro/kernels/segsum_active.py::_kernel            (block-skipping)
//   repro/kernels/segsum.py::_segsum_block_kernel      (every block)
// Both march fixed blocks of `block_edges` edges and reduce each block by a
// one-hot x values matmul into a window of compact segment ranks, combined
// by a scatter epilogue in the wrapper; the skipping one re-points inactive
// blocks at block 0 so no DMA is issued for them.  This file computes the
// same sums directly:
//
//   block_flags   a thread block per 32 edge blocks, a warp per edge block:
//                 flag[b] = 1 iff some edge e of the block has
//                 node_active[rows[e]], read 128 rows at a time (16-byte
//                 words where the layout allows) up to the first active
//                 row.  The same launch appends the ids of the active
//                 blocks to a list in device memory (one ballot and one
//                 atomic per 32 edge blocks; the list's order is free) and
//                 leaves their number in `count`, zeroed by the caller.
//                 Launched once per pass; every probe of the pass reads
//                 the list.  No count goes to the host.
//   segsum_warp   D = 1.  A card-sized grid whose warps walk the list up
//                 to `count` (or every block, or every block whose flag is
//                 set): one warp folds one edge block, kChunk edges a
//                 step.  Each lane loads kLaneEdges consecutive edges (rows
//                 and values as 16-byte words, 8 B for bfloat16, where the
//                 layout allows) and folds its runs in registers; a run
//                 inside the lane is complete and written at once.  A
//                 warp-segmented shuffle scan joins the lanes' last runs,
//                 with no __syncthreads; the warp's open run carries into
//                 its next step.  A run is written where it ends: stored,
//                 or, for the block's first and last rows, which may
//                 continue into a neighbour block, added with an atomic to
//                 the zeroed output.  The block-read counter grows once a
//                 launch by the number of blocks walked (per warp when
//                 only flags are given).
//   segsum        D > 1, one thread block per edge block (the port's first
//                 design, kept for the widths no user path launches yet).
//                 A block whose flag is 0 returns before reading any of
//                 its values.  An active block walks its edges in tiles of
//                 kThreads: each edge gets its run's rank in the tile
//                 (ballot + popc over the run heads), a warp-segmented
//                 shuffle scan folds each run inside a warp, one shared
//                 atomic per (warp, run) folds the warps, and one thread
//                 per run writes it out, stored or, for a run that
//                 continues past the tile, added with a global atomic.
//                 Columns repeat the tile reduction one at a time.
//
// Layout (the wrapper's `vector_width`): 16-byte loads when `rows` and
// `vals` start on 16-byte boundaries (8 bytes for bfloat16 values) and
// block_edges is a multiple of 4, so every block starts aligned; scalar
// loads otherwise.  A ragged block end is read with scalar loads.
//
// Arithmetic: int32 values accumulate exactly in int32 (integer atomics);
// float32 and bfloat16 accumulate in float32 (the wrapper rounds a bfloat16
// result once at the end).  Float atomics make the order of a float sum vary
// from run to run; integer sums are exact.
//
// Rows must be sorted non-decreasing (a precondition, not checked: an
// unsorted row's runs would store over each other).  An edge whose row lies
// outside [0, n) is dropped (never read as a node, never written), as the
// reference's scatter drops it.
//
// Bound on this card: the bytes of rows and values of the walked blocks
// (8 B per edge at D = 1 in int32), the list, and the write of the
// output; block_flags reads the rows up to each block's first active row.
// Each edge is read once, in coalesced 16-byte words; the fold stays in
// registers and shuffles.
//
// Plain C interface, loaded with ctypes.  Every function launches on the
// given stream, allocates nothing and returns cudaGetLastError().
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kWarp = 32;
constexpr int kThreads = 256;
constexpr int kWarps = kThreads / kWarp;
constexpr unsigned kFull = 0xffffffffu;
constexpr int kVec = 4;                        // edges a 16-byte word of rows holds
constexpr int kUnits = 1;                      // words a lane loads per step
constexpr int kLaneEdges = kVec * kUnits;      // consecutive edges of a lane
constexpr int kChunk = kWarp * kLaneEdges;     // edges a warp folds per step
constexpr int kFlagTile = kWarp;               // edge blocks per block_flags block

enum DType { DT_FLOAT32 = 0, DT_BFLOAT16 = 1, DT_INT32 = 2 };

__device__ __forceinline__ float to_acc(float x) { return x; }
__device__ __forceinline__ float to_acc(__nv_bfloat16 x) { return __bfloat162float(x); }
__device__ __forceinline__ int to_acc(int x) { return x; }

// Four values at e (16-byte aligned rows; vals aligned to 4 elements).
__device__ __forceinline__ void load4(const int* p, int* v) {
  const int4 q = __ldg(reinterpret_cast<const int4*>(p));
  v[0] = q.x; v[1] = q.y; v[2] = q.z; v[3] = q.w;
}
__device__ __forceinline__ void load4(const float* p, float* v) {
  const float4 q = __ldg(reinterpret_cast<const float4*>(p));
  v[0] = q.x; v[1] = q.y; v[2] = q.z; v[3] = q.w;
}
__device__ __forceinline__ void load4(const __nv_bfloat16* p, float* v) {
  const uint2 q = __ldg(reinterpret_cast<const uint2*>(p));
  const __nv_bfloat162 a = *reinterpret_cast<const __nv_bfloat162*>(&q.x);
  const __nv_bfloat162 b = *reinterpret_cast<const __nv_bfloat162*>(&q.y);
  v[0] = __low2float(a); v[1] = __high2float(a);
  v[2] = __low2float(b); v[3] = __high2float(b);
}

// A lane's kLaneEdges rows from e0; past hi a row is -1 (outside every
// segment, so dropped).
template <bool Vec>
__device__ __forceinline__ void load_rows(const int* __restrict__ rows, long long e0,
                                          long long hi, int* r) {
#pragma unroll
  for (int u = 0; u < kUnits; ++u) {
    const long long e = e0 + u * kVec;
    if (Vec && e + kVec <= hi) {
      load4(rows + e, r + u * kVec);
    } else {
#pragma unroll
      for (int j = 0; j < kVec; ++j) r[u * kVec + j] = e + j < hi ? __ldg(rows + e + j) : -1;
    }
  }
}

// The same edges' values; 0 past hi.
template <bool Vec, typename In, typename Acc>
__device__ __forceinline__ void load_vals(const In* __restrict__ vals, long long e0,
                                          long long hi, Acc* v) {
#pragma unroll
  for (int u = 0; u < kUnits; ++u) {
    const long long e = e0 + u * kVec;
    if (Vec && e + kVec <= hi) {
      load4(vals + e, v + u * kVec);
    } else {
#pragma unroll
      for (int j = 0; j < kVec; ++j)
        v[u * kVec + j] = e + j < hi ? to_acc(vals[e + j]) : Acc(0);
    }
  }
}

template <bool Vec>
__global__ void __launch_bounds__(kThreads)
block_flags_kernel(const int* __restrict__ rows, const uint8_t* __restrict__ node_active,
                   long long E, int block_edges, int n, int* __restrict__ flags,
                   int* __restrict__ ids, int* __restrict__ count) {
  __shared__ int s_hit[kFlagTile];
  const int lane = threadIdx.x % kWarp;
  const int warp = threadIdx.x / kWarp;
  const long long nb = (E + block_edges - 1) / block_edges;
  const long long tile0 = (long long)blockIdx.x * kFlagTile;
  for (int k = warp; k < kFlagTile; k += kWarps) {
    const long long b = tile0 + k;
    bool hit = false;
    if (b < nb) {
      const long long lo = b * block_edges;
      const long long hi = min(lo + block_edges, E);
      for (long long c = lo; c < hi && !hit; c += kChunk) {  // warp-uniform
        int r[kLaneEdges];
        load_rows<Vec>(rows, c + (long long)lane * kLaneEdges, hi, r);
        bool any = false;
#pragma unroll
        for (int j = 0; j < kLaneEdges; ++j)
          any |= r[j] >= 0 && r[j] < n && node_active[r[j]] != 0;
        hit = __any_sync(kFull, any);
      }
    }
    if (lane == 0) s_hit[k] = hit;
  }
  __syncthreads();
  if (warp == 0) {
    const long long b = tile0 + lane;
    const bool hit = b < nb && s_hit[lane] != 0;
    if (b < nb) flags[b] = hit;
    const unsigned mask = __ballot_sync(kFull, hit);
    int base = 0;
    if (lane == 0 && mask) base = atomicAdd(count, __popc(mask));
    base = __shfl_sync(kFull, base, 0);
    if (hit) ids[base + __popc(mask & ((1u << lane) - 1u))] = (int)b;
  }
}

// One edge block [lo, hi) folded by one warp (D = 1).
template <bool Vec, typename In, typename Acc>
__device__ __forceinline__ void fold_block(const In* __restrict__ vals,
                                           const int* __restrict__ rows, long long lo,
                                           long long hi, int n, Acc* __restrict__ out,
                                           int lane) {
  // the rows whose runs may continue into a neighbour block
  const int block_first = __ldg(rows + lo);
  const int block_last = __ldg(rows + hi - 1);
  auto emit = [&](int r, Acc s) {
    if (r < 0 || r >= n) return;
    if (r == block_first || r == block_last) {
      atomicAdd(out + r, s);
    } else {
      out[r] = s;
    }
  };
  int carry_row = 0;  // the warp's open run at the end of its last step
  Acc carry = Acc(0);
  bool has_carry = false;
  for (long long c = lo; c < hi; c += kChunk) {
    const long long e0 = c + (long long)lane * kLaneEdges;
    int r[kLaneEdges];
    Acc v[kLaneEdges];
    load_rows<Vec>(rows, e0, hi, r);
    load_vals<Vec>(vals, e0, hi, v);
    // the lane's runs: its first (head), inner ones (complete: written
    // now) and its last (run); single: one run only
    const int first = r[0];
    int key = r[0];
    Acc run = v[0], head = Acc(0);
    bool single = true;
#pragma unroll
    for (int j = 1; j < kLaneEdges; ++j) {
      if (r[j] == key) {
        run += v[j];
        continue;
      }
      if (single) {
        head = run;
        single = false;
      } else {
        emit(key, run);
      }
      key = r[j];
      run = v[j];
    }
    if (lane == 0 && has_carry) {
      if (first == carry_row) {
        if (single) run += carry;
        else head += carry;
      } else {
        emit(carry_row, carry);
      }
    }
    // segmented inclusive scan of the last runs: a lane continues the one
    // before it iff it holds one run of the same row
    const int prev_key = __shfl_up_sync(kFull, key, 1);
    const bool start = lane == 0 || !single || prev_key != first;
    const unsigned starts = __ballot_sync(kFull, start);
    const int seg0 = kWarp - 1 - __clz(starts & (kFull >> (kWarp - 1 - lane)));
    Acc s = run;
#pragma unroll
    for (int o = 1; o < kWarp; o <<= 1) {
      const Acc up = __shfl_up_sync(kFull, s, o);
      if (lane - o >= seg0) s += up;
    }
    const Acc prev_s = __shfl_up_sync(kFull, s, 1);
    if (!single) emit(first, head + (lane > 0 && prev_key == first ? prev_s : Acc(0)));
    const int next_first = __shfl_down_sync(kFull, first, 1);
    if (lane < kWarp - 1 && next_first != key) emit(key, s);
    carry_row = __shfl_sync(kFull, key, kWarp - 1);
    carry = __shfl_sync(kFull, s, kWarp - 1);
    has_carry = true;
  }
  if (lane == 0 && has_carry) emit(carry_row, carry);
}

// D = 1: warps walk the list ids[0, *count) (ids set), every block whose
// flag is set (flags set, ids null) or every block (both null).
template <bool Vec, typename In, typename Acc>
__global__ void __launch_bounds__(kThreads)
segsum_warp_kernel(const In* __restrict__ vals, const int* __restrict__ rows,
                   const int* __restrict__ flags, const int* __restrict__ ids,
                   const int* __restrict__ count, long long E, int block_edges, int n,
                   Acc* __restrict__ out, unsigned long long* __restrict__ blocks_read) {
  const int nb = (int)((E + block_edges - 1) / block_edges);
  const bool by_flag = ids == nullptr && flags != nullptr;
  const int total = ids != nullptr ? *count : nb;
  if (!by_flag && blockIdx.x == 0 && threadIdx.x == 0 && total > 0)
    atomicAdd(blocks_read, (unsigned long long)total);
  const int lane = threadIdx.x % kWarp;
  const int warp = (blockIdx.x * kThreads + threadIdx.x) / kWarp;
  const int warps = gridDim.x * kWarps;
  int read = 0;
  for (int i = warp; i < total; i += warps) {  // warp-uniform
    const int b = ids != nullptr ? ids[i] : i;
    if (by_flag && flags[b] == 0) continue;  // skipped: reads nothing
    ++read;
    const long long lo = (long long)b * block_edges;
    fold_block<Vec>(vals, rows, lo, min(lo + block_edges, E), n, out, lane);
  }
  if (by_flag && lane == 0 && read > 0) atomicAdd(blocks_read, (unsigned long long)read);
}

template <typename In, typename Acc>
__global__ void __launch_bounds__(kThreads)
segsum_kernel(const In* __restrict__ vals, const int* __restrict__ rows,
              const int* __restrict__ flags, long long E, int D, int block_edges, int n,
              Acc* __restrict__ out, unsigned long long* __restrict__ blocks_read) {
  if (flags != nullptr && flags[blockIdx.x] == 0) return;  // skipped: reads nothing
  if (threadIdx.x == 0) atomicAdd(blocks_read, 1ull);

  __shared__ Acc acc[kThreads];   // one slot per run of the tile
  __shared__ int seg[kThreads];   // the row of each run
  __shared__ int warp_heads[kWarps];

  const int lane = threadIdx.x % kWarp;
  const int warp = threadIdx.x / kWarp;
  const long long lo = (long long)blockIdx.x * block_edges;
  const long long hi = min(lo + block_edges, E);

  for (long long t0 = lo; t0 < hi; t0 += kThreads) {
    const long long tile_hi = min(t0 + kThreads, hi);
    const long long e = t0 + threadIdx.x;
    const bool valid = e < tile_hi;
    const int r = valid ? __ldg(rows + e) : -1;
    const bool head = valid && (e == t0 || __ldg(rows + e - 1) != r);

    // rank of this edge's run in the tile: heads at or before e, minus one
    const unsigned heads = __ballot_sync(kFull, head);
    if (lane == 0) warp_heads[warp] = __popc(heads);
    __syncthreads();
    int before = 0, total = 0;
#pragma unroll
    for (int w = 0; w < kWarps; ++w) {
      const int c = warp_heads[w];
      before += w < warp ? c : 0;
      total += c;
    }
    const unsigned upto = lane == kWarp - 1 ? kFull : ((1u << (lane + 1)) - 1u);
    const int rank = valid ? before + __popc(heads & upto) - 1 : kThreads + lane;
    if (head) seg[rank] = r;
    // the last run of a warp is its tail lane; a run ends inside the warp
    // where the next lane's rank differs
    const int next_rank = __shfl_down_sync(kFull, rank, 1);
    const bool tail = valid && (lane == kWarp - 1 || next_rank != rank);

    for (int d = 0; d < D; ++d) {
      if (threadIdx.x < total) acc[threadIdx.x] = Acc(0);
      __syncthreads();
      Acc v = valid ? to_acc(vals[e * D + d]) : Acc(0);
#pragma unroll
      for (int o = 1; o < kWarp; o <<= 1) {  // segmented inclusive scan
        const Acc up = __shfl_up_sync(kFull, v, o);
        const int up_rank = __shfl_up_sync(kFull, rank, o);
        if (lane >= o && up_rank == rank) v += up;
      }
      if (tail) atomicAdd(&acc[rank], v);
      __syncthreads();
      if (threadIdx.x < total) {
        const int s = seg[threadIdx.x];
        if (s >= 0 && s < n) {
          const bool from_before = threadIdx.x == 0 && t0 > 0 && __ldg(rows + t0 - 1) == s;
          const bool to_after = threadIdx.x == total - 1 && tile_hi < E && __ldg(rows + tile_hi) == s;
          Acc* dst = out + (long long)s * D + d;
          if (from_before || to_after) {
            atomicAdd(dst, acc[threadIdx.x]);
          } else {
            *dst = acc[threadIdx.x];
          }
        }
      }
      __syncthreads();  // acc, seg and warp_heads are rewritten next
    }
  }
}

unsigned int blocks_of(long long E, int block_edges) {
  return (unsigned int)((E + block_edges - 1) / block_edges);
}

// A card-sized grid for `kernel`: as many blocks as fit on every SM at once.
template <typename K>
unsigned int grid_for(K kernel) {
  int dev = 0, sms = 132, per_sm = 1;
  if (cudaGetDevice(&dev) == cudaSuccess)
    cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, kernel, kThreads, 0);
  return (unsigned int)(sms * (per_sm > 0 ? per_sm : 1));
}

template <bool Vec, typename In, typename Acc>
void launch_warp(const void* vals, const int* rows, const int* flags, const int* ids,
                 const int* count, long long E, int block_edges, int n, void* out,
                 unsigned long long* blocks_read, cudaStream_t s) {
  auto kernel = segsum_warp_kernel<Vec, In, Acc>;
  kernel<<<grid_for(kernel), kThreads, 0, s>>>((const In*)vals, rows, flags, ids, count, E,
                                               block_edges, n, (Acc*)out, blocks_read);
}

template <typename In, typename Acc>
void launch_sum(const void* vals, const int* rows, const int* flags, const int* ids,
                const int* count, long long E, int D, int block_edges, int n, int vec,
                void* out, unsigned long long* blocks_read, cudaStream_t s) {
  if (D > 1) {
    segsum_kernel<In, Acc><<<blocks_of(E, block_edges), kThreads, 0, s>>>(
        (const In*)vals, rows, flags, E, D, block_edges, n, (Acc*)out, blocks_read);
  } else if (vec == kVec) {
    launch_warp<true, In, Acc>(vals, rows, flags, ids, count, E, block_edges, n, out,
                               blocks_read, s);
  } else {
    launch_warp<false, In, Acc>(vals, rows, flags, ids, count, E, block_edges, n, out,
                                blocks_read, s);
  }
}

}  // namespace

// flags: (nb,) int32; ids: (nb,) int32, the active blocks' ids in
// ids[0, *count); count: one int32, zero on entry.  vec: 4 (16-byte loads
// of rows) or 1.
extern "C" int ss_block_flags(const void* rows, const void* node_active, long long E,
                              int block_edges, int n, int vec, void* flags, void* ids,
                              void* count, void* stream) {
  if (vec != kVec && vec != 1) return (int)cudaErrorInvalidValue;
  if (E > 0) {
    const unsigned int grid = (blocks_of(E, block_edges) + kFlagTile - 1) / kFlagTile;
    cudaStream_t s = (cudaStream_t)stream;
    const int* r = (const int*)rows;
    const uint8_t* a = (const uint8_t*)node_active;
    if (vec == kVec) {
      block_flags_kernel<true><<<grid, kThreads, 0, s>>>(r, a, E, block_edges, n, (int*)flags,
                                                         (int*)ids, (int*)count);
    } else {
      block_flags_kernel<false><<<grid, kThreads, 0, s>>>(r, a, E, block_edges, n, (int*)flags,
                                                          (int*)ids, (int*)count);
    }
  }
  return (int)cudaGetLastError();
}

// out: float32 for DT_FLOAT32 and DT_BFLOAT16, int32 for DT_INT32; zeroed by
// the caller.  D = 1 walks ids[0, *count) when ids is set, else the blocks
// whose flag is set when flags is set, else every block; D > 1 reads the
// flags (null: every block).  vec: 4 (16-byte loads) or 1, for D = 1.
extern "C" int ss_segsum(const void* vals, const void* rows, const void* flags, const void* ids,
                         const void* count, long long E, int D, int block_edges, int n,
                         int dtype, int vec, void* out, void* blocks_read, void* stream) {
  if (vec != kVec && vec != 1) return (int)cudaErrorInvalidValue;
  if (E > 0 && D > 0) {
    cudaStream_t s = (cudaStream_t)stream;
    const int* r = (const int*)rows;
    const int* f = (const int*)flags;
    const int* l = (const int*)ids;
    const int* c = (const int*)count;
    unsigned long long* br = (unsigned long long*)blocks_read;
    if (dtype == DT_FLOAT32) {
      launch_sum<float, float>(vals, r, f, l, c, E, D, block_edges, n, vec, out, br, s);
    } else if (dtype == DT_BFLOAT16) {
      launch_sum<__nv_bfloat16, float>(vals, r, f, l, c, E, D, block_edges, n, vec, out, br, s);
    } else if (dtype == DT_INT32) {
      launch_sum<int, int>(vals, r, f, l, c, E, D, block_edges, n, vec, out, br, s);
    } else {
      return (int)cudaErrorInvalidValue;
    }
  }
  return (int)cudaGetLastError();
}

