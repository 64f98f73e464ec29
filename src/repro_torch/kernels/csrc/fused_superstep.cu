// One decomposition superstep on Hopper (sm_90a): a row pass and a push pass.
//
// Replaces the TPU kernel repro/kernels/fused_superstep.py::_superstep_kernel
// (one pallas_call per superstep over a (phase, edge-block) grid).  That
// kernel built a dense (rows x 2**num_probes) float32 histogram of capped
// neighbour cores in VMEM and addressed rows by compact rank; neither fits a
// graph of real size (the histogram grows with the maximum degree), so this
// file computes the same integers another way:
//
//   row_pass   (phase 0)  one warp per row.  A row outside the frontier (or
//              with no edges) writes its pass-through values and reads no
//              edge: the GPU counterpart of the TPU's skipped blocks.  An
//              active row gathers core[nbr] itself and binary-searches
//              h = max k <= min(cap, deg) with #(core[nbr] >= k) >= k, one
//              warp-reduced count per probe; the count at h is the refreshed
//              cnt.  Mode `counts` returns one count at a given threshold.
//              upd = #(active rows with h != core) is one atomicAdd per row.
//   push_pass  (phase 1)  runs after every row's h is known (blocks run in
//              no order, so it is a second launch).  Each active row v whose
//              core changed pushes to its neighbours u: semicore* subtracts 1
//              from cnt[u] when core2[u] lies in (h[v], core[v]] (by symmetry
//              of the undirected CSR this is the TPU kernel's row-summed
//              form); semicore+ marks u as touched.  Integer atomics make the
//              result independent of the order of the warps.
//
// Bound on this card: the bytes of the active rows' edges (4 B of nbr plus a
// random 4 B gather of core per edge, each re-read once per binary-search
// probe, which L1/L2 mostly absorb) and O(n) node state per pass.  One warp
// per row leaves lanes idle on low-degree rows; binning rows by degree and
// staging a row's values in shared memory are the next steps.
//
// Plain C interface, loaded with ctypes.  Every function launches on the
// given stream, allocates nothing and returns cudaGetLastError().
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

enum Mode {
  MODE_HINDEX = 0,        // out_a = h, out_b = cnt at h
  MODE_COUNTS = 1,        // out_a = #(core[nbr] >= aux[v])
  MODE_SEMICORE = 2,      // out_a = core2
  MODE_SEMICORE_PLUS = 3, // out_a = core2
  MODE_SEMICORE_STAR = 4, // out_a = core2, out_b = refreshed cnt (aux = cnt)
};

constexpr int kWarp = 32;
constexpr int kThreads = 256;
constexpr int kWarpsPerBlock = kThreads / kWarp;

__device__ __forceinline__ int warp_sum(int x) {
#pragma unroll
  for (int o = kWarp / 2; o > 0; o >>= 1) x += __shfl_xor_sync(0xffffffffu, x, o);
  return x;
}

// #(core[nbr[e]] >= k) over e in [lo, hi), the same value in every lane.
__device__ __forceinline__ int count_ge(const int* __restrict__ nbr,
                                        const int* __restrict__ core, int lo,
                                        int hi, int k, int lane) {
  int c = 0;
  for (int e = lo + lane; e < hi; e += kWarp) c += __ldg(core + __ldg(nbr + e)) >= k;
  return warp_sum(c);
}

__global__ void __launch_bounds__(kThreads)
row_pass_kernel(const int* __restrict__ segptr, const int* __restrict__ nbr,
                const int* __restrict__ core, const int* __restrict__ aux,
                const uint8_t* __restrict__ active, int n, int mode,
                int* __restrict__ out_a, int* __restrict__ out_b,
                int* __restrict__ upd) {
  const int lane = threadIdx.x % kWarp;
  const long long v = (long long)blockIdx.x * kWarpsPerBlock + threadIdx.x / kWarp;
  if (v >= n) return;  // warp-uniform
  const int lo = segptr[v];
  const int hi = segptr[v + 1];
  const int deg = hi - lo;
  const bool act = active[v] != 0;
  if (!act || deg == 0) {
    // h and the counts are 0 off the frontier and on empty rows; core and
    // cnt pass through off the frontier, an active empty row drops to 0
    if (lane == 0) {
      if (mode == MODE_HINDEX) {
        out_a[v] = 0;
        out_b[v] = 0;
      } else if (mode == MODE_COUNTS) {
        out_a[v] = 0;
      } else {
        out_a[v] = act ? 0 : core[v];
        if (mode == MODE_SEMICORE_STAR) out_b[v] = act ? 0 : aux[v];
      }
    }
    return;
  }
  if (mode == MODE_COUNTS) {
    const int c = count_ge(nbr, core, lo, hi, aux[v], lane);
    if (lane == 0) out_a[v] = c;
    return;
  }
  const int cap = core[v];
  int k_lo = 0, k_hi = min(cap, deg), c_lo = deg;  // #(core[nbr] >= 0)
  while (k_lo < k_hi) {  // warp-uniform: every lane holds the same counts
    const int mid = k_lo + (k_hi - k_lo + 1) / 2;
    const int c = count_ge(nbr, core, lo, hi, mid, lane);
    if (c >= mid) {
      k_lo = mid;
      c_lo = c;
    } else {
      k_hi = mid - 1;
    }
  }
  if (lane == 0) {
    out_a[v] = k_lo;
    if (mode == MODE_HINDEX || mode == MODE_SEMICORE_STAR) out_b[v] = c_lo;
    if (k_lo != cap) atomicAdd(upd, 1);
  }
}

__global__ void __launch_bounds__(kThreads)
push_pass_kernel(const int* __restrict__ segptr, const int* __restrict__ nbr,
                 const int* __restrict__ core, const int* __restrict__ core2,
                 const uint8_t* __restrict__ active, int n, int mode,
                 int* __restrict__ target) {
  const int lane = threadIdx.x % kWarp;
  const long long v = (long long)blockIdx.x * kWarpsPerBlock + threadIdx.x / kWarp;
  if (v >= n || !active[v]) return;
  const int h = core2[v];
  const int c_old = core[v];
  if (h == c_old) return;  // unchanged: empty interval (h, c_old], no push
  const int lo = segptr[v];
  const int hi = segptr[v + 1];
  if (mode == MODE_SEMICORE_STAR) {
    for (int e = lo + lane; e < hi; e += kWarp) {
      const int u = __ldg(nbr + e);
      const int c2 = core2[u];
      if (c2 > h && c2 <= c_old) atomicSub(target + u, 1);
    }
  } else {
    for (int e = lo + lane; e < hi; e += kWarp) target[__ldg(nbr + e)] = 1;
  }
}

unsigned int blocks_for(int n) {
  return (unsigned int)(((long long)n + kWarpsPerBlock - 1) / kWarpsPerBlock);
}

}  // namespace

extern "C" int fs_row_pass(const void* segptr, const void* nbr, const void* core,
                           const void* aux, const void* active, int n, int mode,
                           void* out_a, void* out_b, void* upd, void* stream) {
  if (n > 0) {
    row_pass_kernel<<<blocks_for(n), kThreads, 0, (cudaStream_t)stream>>>(
        (const int*)segptr, (const int*)nbr, (const int*)core, (const int*)aux,
        (const uint8_t*)active, n, mode, (int*)out_a, (int*)out_b, (int*)upd);
  }
  return (int)cudaGetLastError();
}

extern "C" int fs_push_pass(const void* segptr, const void* nbr, const void* core,
                            const void* core2, const void* active, int n, int mode,
                            void* target, void* stream) {
  if (n > 0) {
    push_pass_kernel<<<blocks_for(n), kThreads, 0, (cudaStream_t)stream>>>(
        (const int*)segptr, (const int*)nbr, (const int*)core, (const int*)core2,
        (const uint8_t*)active, n, mode, (int*)target);
  }
  return (int)cudaGetLastError();
}
