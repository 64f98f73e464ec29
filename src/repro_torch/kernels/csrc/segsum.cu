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
//   block_flags   one thread block per edge block: flag[b] = 1 iff some
//                 edge e of the block has node_active[rows[e]].  Launched
//                 once per pass; every probe of the pass reads the flags.
//   segsum        one thread block per edge block.  A block whose flag is 0
//                 returns before reading any of its values (no flag array:
//                 every block is read).  An active block walks its edges in
//                 tiles of kThreads: each edge gets its run's rank in the
//                 tile (ballot + popc over the run heads), a warp-segmented
//                 shuffle scan folds each run inside a warp, one shared
//                 atomic per (warp, run) folds the warps, and one thread per
//                 run writes it out.  A run that lies wholly inside the tile
//                 is stored; a run that continues before or after the tile
//                 (a row crossing a tile or block boundary) adds its partial
//                 with a global atomic to the zeroed output.  Columns (D > 1)
//                 repeat the tile reduction one column at a time.
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
// Bound on this card: the bytes of rows and values of the active blocks
// (8 B per edge at D = 1 in int32) plus the zero fill and the write of the
// output.  Each edge is read once; the scan and the atomics stay in
// registers and shared memory.  Blocks are small (one thread block per 512
// edges on the decomposition path), so the launch and the per-tile barriers,
// not the bytes, are the first thing to cut.
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

enum DType { DT_FLOAT32 = 0, DT_BFLOAT16 = 1, DT_INT32 = 2 };

__device__ __forceinline__ float to_acc(float x) { return x; }
__device__ __forceinline__ float to_acc(__nv_bfloat16 x) { return __bfloat162float(x); }
__device__ __forceinline__ int to_acc(int x) { return x; }

__global__ void __launch_bounds__(kThreads)
block_flags_kernel(const int* __restrict__ rows, const uint8_t* __restrict__ node_active,
                   long long E, int block_edges, int n, int* __restrict__ flags) {
  const long long lo = (long long)blockIdx.x * block_edges;
  const long long hi = min(lo + block_edges, E);
  int any = 0;
  for (long long e = lo + threadIdx.x; e < hi && !any; e += kThreads) {
    const int r = __ldg(rows + e);
    any = r >= 0 && r < n && node_active[r] != 0;
  }
  any = __syncthreads_or(any);
  if (threadIdx.x == 0) flags[blockIdx.x] = any;
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

}  // namespace

extern "C" int ss_block_flags(const void* rows, const void* node_active, long long E,
                              int block_edges, int n, void* flags, void* stream) {
  if (E > 0) {
    block_flags_kernel<<<blocks_of(E, block_edges), kThreads, 0, (cudaStream_t)stream>>>(
        (const int*)rows, (const uint8_t*)node_active, E, block_edges, n, (int*)flags);
  }
  return (int)cudaGetLastError();
}

// out: float32 for DT_FLOAT32 and DT_BFLOAT16, int32 for DT_INT32; zeroed by
// the caller.  flags may be null (every block active).
extern "C" int ss_segsum(const void* vals, const void* rows, const void* flags, long long E,
                         int D, int block_edges, int n, int dtype, void* out,
                         void* blocks_read, void* stream) {
  if (E > 0 && D > 0) {
    const unsigned int grid = blocks_of(E, block_edges);
    cudaStream_t s = (cudaStream_t)stream;
    const int* r = (const int*)rows;
    const int* f = (const int*)flags;
    unsigned long long* br = (unsigned long long*)blocks_read;
    if (dtype == DT_FLOAT32) {
      segsum_kernel<float, float><<<grid, kThreads, 0, s>>>(
          (const float*)vals, r, f, E, D, block_edges, n, (float*)out, br);
    } else if (dtype == DT_BFLOAT16) {
      segsum_kernel<__nv_bfloat16, float><<<grid, kThreads, 0, s>>>(
          (const __nv_bfloat16*)vals, r, f, E, D, block_edges, n, (float*)out, br);
    } else if (dtype == DT_INT32) {
      segsum_kernel<int, int><<<grid, kThreads, 0, s>>>(
          (const int*)vals, r, f, E, D, block_edges, n, (int*)out, br);
    } else {
      return (int)cudaErrorInvalidValue;
    }
  }
  return (int)cudaGetLastError();
}
