// One decomposition superstep on Hopper (sm_90a): a row pass and a push pass.
//
// Replaces the TPU kernel repro/kernels/fused_superstep.py::_superstep_kernel
// (one pallas_call per superstep over a (phase, edge-block) grid).  That
// kernel built a dense (rows x 2**num_probes) float32 histogram of capped
// neighbour cores in VMEM; here each active row builds the same histogram
// in shared memory, bounded by its own degree, and the work of a superstep
// follows its frontier:
//
//   sweep      kSweepRows rows a thread, at memory rate.  A row outside
//              the work (row pass: inactive or edgeless; push pass:
//              inactive or core unchanged) costs its flag and, in the row
//              pass, its pass-through values; it reads no edge.  A row with
//              work is appended, with its edge range, to the list of its
//              degree bin (degree_bin, mirrored by kernels/
//              fused_superstep.py::degree_bin), lists kept in row order,
//              one global atomic per block and bin.  Each bin's list starts
//              at bin_start[b] (from the degrees, fixed per structure) and
//              its fill lies in counts[b].
//   row_group  a fixed, card-sized grid walks one bin's list up to the
//              count in device memory (no count is read on the host): G
//              lanes a row, G = 8 for degrees 1..32 (bin 0), 32 for
//              33..512 (bin 1).  The row gathers min(core[nbr], cap), cap =
//              min(core[v], deg), once each into a shared histogram of cap
//              + 1 bins (the values at cap, most of them at the first pass,
//              are counted in registers: no atomic contention), turns it
//              into suffix counts in place, and h = #{k in [1, cap] :
//              suffix[k] >= k} (the predicate is monotone in k); the
//              refreshed cnt is suffix[h] (= deg at h = 0).  Mode `counts`
//              is one count against aux[v].  Gathers are latency-bound, so
//              each lane keeps kUnroll of them in flight (for_edges).
//   row_block  one block a row for bins 2 (513..8191) and 3 (>= 8192),
//              histogram of up to kHistBins bins; a bin-3 row whose cap
//              outgrows it binary-searches h with block-reduced counts
//              (one pass over its edges a probe).
//   push       the push pass's sweep lists the rows whose core changed, in
//              the same bins; G = 8, 32 or a block a row then walks their
//              edges: semicore* subtracts 1 from cnt[u] when core2[u] lies
//              in (h[v], core[v]] (by symmetry of the undirected CSR this is
//              the TPU kernel's row-summed form), semicore+ marks u.
//              Integer atomics make the result independent of the order.
//              A last kernel, 8 rows a thread, writes the next frontier
//              (semicore*: cnt2 < core2 & core2 > 0; semicore+: touched &
//              core2 > 0), the TPU kernel's frontier ops.
//
// upd (#(active rows with edges and h != core)) is summed per warp or block
// and added with one atomic each.  The caller zeroes counts and upd on the
// stream (torch.zeros), so no launch waits on the host.
//
// Bound on this card: the bytes of the frontier's edges (4 B of nbr, the
// 4 B gather of core through L2, a 32 B sector each) plus O(n) node state
// per pass (flags, pass-through values, the next frontier), which the
// sweeps and the frontier kernel read and write once at memory rate.  The
// first pass, every row active, is bound by the random gathers' sectors.  A pass
// with an empty frontier costs those and six launches whose blocks find
// an empty list.
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

// The bin rule (kernels/fused_superstep.py: GROUP_LANES, GROUP_MAX_DEG,
// WARP_MAX_DEG, HIST_BINS; the wrapper checks them through fs_bin_rule).
constexpr int kGroupLanes = 8;
constexpr int kGroupMaxDeg = 32;
constexpr int kWarpMaxDeg = 512;
constexpr int kHistBins = 8192;
constexpr int kBins = 4;
enum Bin { BIN_GROUP = 0, BIN_WARP = 1, BIN_BLOCK = 2, BIN_GLOBAL = 3 };

constexpr int kWarp = 32;
constexpr int kThreads = 256;
constexpr int kWarpsPerBlock = kThreads / kWarp;
constexpr unsigned kFull = 0xffffffffu;

__device__ __forceinline__ int degree_bin(int deg) {
  if (deg <= 0) return -1;
  if (deg <= kGroupMaxDeg) return BIN_GROUP;
  if (deg <= kWarpMaxDeg) return BIN_WARP;
  if (deg < kHistBins) return BIN_BLOCK;
  return BIN_GLOBAL;
}

// Sum over the G lanes of each group (every lane of the warp calls it).
template <int G>
__device__ __forceinline__ int group_sum(int x) {
#pragma unroll
  for (int o = G / 2; o > 0; o >>= 1) x += __shfl_xor_sync(kFull, x, o);
  return x;
}

// Inclusive suffix sum over the lanes of each group: lanes gl..G-1.
template <int G>
__device__ __forceinline__ int group_suffix(int x, int gl) {
#pragma unroll
  for (int o = 1; o < G; o <<= 1) {
    const int y = __shfl_down_sync(kFull, x, o, G);
    if (gl + o < G) x += y;
  }
  return x;
}

// Sum over the block (every thread calls it; s_red holds kWarpsPerBlock).
__device__ __forceinline__ int block_sum(int x, int* s_red) {
  x = group_sum<kWarp>(x);
  __syncthreads();  // s_red is free: every thread has read the last sum
  if ((threadIdx.x & (kWarp - 1)) == 0) s_red[threadIdx.x / kWarp] = x;
  __syncthreads();
  int t = 0;
#pragma unroll
  for (int i = 0; i < kWarpsPerBlock; ++i) t += s_red[i];
  return t;
}

// Exclusive suffix sum over the block's threads: threads above this one.
__device__ __forceinline__ int block_suffix_excl(int s, int* s_red) {
  const int lane = threadIdx.x & (kWarp - 1);
  const int w = threadIdx.x / kWarp;
  const int x = group_suffix<kWarp>(s, lane);
  __syncthreads();
  if (lane == 0) s_red[w] = x;  // lane 0's suffix is the warp's total
  __syncthreads();
  int above = 0;
  for (int i = w + 1; i < kWarpsPerBlock; ++i) above += s_red[i];
  return x - s + above;
}

// f(u, vals[u]) for the edges e = lo + lane, lo + lane + G, ... < hi of a
// row, kUnroll edges a lane at a time: their nbr loads, then their gathers,
// are in flight together.
constexpr int kUnroll = 4;
template <int G, typename F>
__device__ __forceinline__ void for_edges(const int* __restrict__ nbr,
                                          const int* __restrict__ vals, int lo,
                                          int hi, int lane, F f) {
  for (int e0 = lo + lane; e0 < hi; e0 += kUnroll * G) {
    int u[kUnroll], x[kUnroll];
#pragma unroll
    for (int j = 0; j < kUnroll; ++j)
      u[j] = e0 + j * G < hi ? __ldg(nbr + e0 + j * G) : 0;
#pragma unroll
    for (int j = 0; j < kUnroll; ++j)
      x[j] = e0 + j * G < hi ? __ldg(vals + u[j]) : 0;
#pragma unroll
    for (int j = 0; j < kUnroll; ++j)
      if (e0 + j * G < hi) f(u[j], x[j]);
  }
}

// The work lists: row, first edge and end of each listed row, three arrays
// of n entries; bin b's list starts at bin_start[b].
struct Lists {
  int* row;
  int* lo;
  int* hi;
};

// Item i of the concatenation of bins first..first+1's lists: (v, lo, hi).
__device__ __forceinline__ int3 list_item(const Lists& L,
                                          const int* __restrict__ bin_start,
                                          int first, int n_first, int i) {
  const int k = i < n_first ? bin_start[first] + i
                            : bin_start[first + 1] + i - n_first;
  return make_int3(L.row[k], L.lo[k], L.hi[k]);
}

// ------------------------------------------------------------------ sweep
// A thread sweeps kSweepRows consecutive rows: their flags in one 8-byte
// load, their node state in 16-byte loads and stores (the wrapper checks
// the alignment); a group crossing n goes row by row.  A block appends its
// rows with work to the lists with one global atomic per bin.
constexpr int kSweepRows = 8;
static_assert(kSweepRows == 8, "a sweep thread loads its 8 flags as one word");

__device__ __forceinline__ void load8(const int* __restrict__ p, long long v,
                                      int* out) {
  const int4 a = *reinterpret_cast<const int4*>(p + v);
  const int4 b = *reinterpret_cast<const int4*>(p + v + 4);
  out[0] = a.x; out[1] = a.y; out[2] = a.z; out[3] = a.w;
  out[4] = b.x; out[5] = b.y; out[6] = b.z; out[7] = b.w;
}

__device__ __forceinline__ void store8(int* __restrict__ p, long long v,
                                       const int* x) {
  *reinterpret_cast<int4*>(p + v) = make_int4(x[0], x[1], x[2], x[3]);
  *reinterpret_cast<int4*>(p + v + 4) = make_int4(x[4], x[5], x[6], x[7]);
}

// push == false: the row pass's sweep (pass-through values, lists of active
// rows with edges).  push == true: the push pass's (lists of active rows
// whose core changed; core2 given, nothing written but the lists).
__global__ void __launch_bounds__(kThreads)
sweep_kernel(const int* __restrict__ segptr, const int* __restrict__ core,
             const int* __restrict__ aux, const int* __restrict__ core2,
             const uint8_t* __restrict__ active, int n, int mode, bool push,
             int* __restrict__ out_a, int* __restrict__ out_b,
             const int* __restrict__ bin_start, int* __restrict__ counts,
             Lists lists) {
  constexpr int kTile = kThreads * kSweepRows;
  __shared__ int s_count[kBins];      // the block's rows per bin
  __shared__ int s_first[kBins + 1];  // their runs in the staging arrays
  __shared__ int s_base[kBins];       // and in the lists
  __shared__ int s_row[kTile], s_lo[kTile], s_hi[kTile];
  if (threadIdx.x < kBins) s_count[threadIdx.x] = 0;
  __syncthreads();
  const long long first =
      ((long long)blockIdx.x * kThreads + threadIdx.x) * kSweepRows;
  const bool whole = first + kSweepRows <= n;
  bool act[kSweepRows];
  if (whole) {
    const uint2 f = *reinterpret_cast<const uint2*>(active + first);
#pragma unroll
    for (int j = 0; j < kSweepRows; ++j)
      act[j] = ((j < 4 ? f.x >> (8 * j) : f.y >> (8 * (j - 4))) & 0xffu) != 0;
  } else {
#pragma unroll
    for (int j = 0; j < kSweepRows; ++j)
      act[j] = first + j < n && active[first + j] != 0;
  }
  if (!push) {
    // pass-through values for every row (h and the counts are 0 off the
    // frontier and on empty rows; core and cnt pass through off the
    // frontier, an active row drops to 0 unless its bin's kernel, which
    // runs after this one, writes its values)
    const bool star = mode == MODE_SEMICORE_STAR;
    const bool carry = mode != MODE_HINDEX && mode != MODE_COUNTS;
    int a[kSweepRows], b[kSweepRows];
    if (whole) {
      if (carry) load8(core, first, a);
      if (star) load8(aux, first, b);
    } else {
#pragma unroll
      for (int j = 0; j < kSweepRows; ++j) {
        a[j] = carry && first + j < n ? core[first + j] : 0;
        b[j] = star && first + j < n ? aux[first + j] : 0;
      }
    }
#pragma unroll
    for (int j = 0; j < kSweepRows; ++j) {
      a[j] = carry && !act[j] ? a[j] : 0;
      b[j] = star && !act[j] ? b[j] : 0;
    }
    const bool two = mode == MODE_HINDEX || star;
    if (whole) {
      store8(out_a, first, a);
      if (two) store8(out_b, first, b);
    } else {
      for (int j = 0; j < kSweepRows && first + j < n; ++j) {
        out_a[first + j] = a[j];
        if (two) out_b[first + j] = b[j];
      }
    }
  }
  const int lane = threadIdx.x & (kWarp - 1);
  int bin[kSweepRows], lo[kSweepRows], hi[kSweepRows], off[kSweepRows];
#pragma unroll
  for (int j = 0; j < kSweepRows; ++j) {
    const long long v = first + j;
    bin[j] = -1;
    lo[j] = hi[j] = off[j] = 0;
    if (act[j] && (!push || core2[v] != core[v])) {
      lo[j] = segptr[v];
      hi[j] = segptr[v + 1];
      bin[j] = degree_bin(hi[j] - lo[j]);
    }
  }
  // a lane's rows with work in row order, the warp's in lane order (an
  // exclusive scan of the lanes' counts per bin), the warp's run at one
  // shared atomic per bin; the block's entries are staged in shared memory
  // and written out coalesced.  Consecutive rows stay consecutive in a
  // list, so the walkers' edge loads coalesce across a warp's rows.
  bool work = false;
#pragma unroll
  for (int j = 0; j < kSweepRows; ++j) work |= bin[j] >= 0;
  if (__ballot_sync(kFull, work) != 0) {  // warp-uniform
    int pos[kBins];
#pragma unroll
    for (int b = 0; b < kBins; ++b) {
      int c = 0;
#pragma unroll
      for (int j = 0; j < kSweepRows; ++j) c += bin[j] == b;
      int incl = c;
#pragma unroll
      for (int o = 1; o < kWarp; o <<= 1) {
        const int y = __shfl_up_sync(kFull, incl, o);
        if (lane >= o) incl += y;
      }
      const int total = __shfl_sync(kFull, incl, kWarp - 1);
      int base = 0;
      if (total && lane == 0) base = atomicAdd(&s_count[b], total);
      pos[b] = __shfl_sync(kFull, base, 0) + incl - c;
    }
#pragma unroll
    for (int j = 0; j < kSweepRows; ++j) {
#pragma unroll
      for (int b = 0; b < kBins; ++b) {
        if (bin[j] == b) off[j] = pos[b]++;
      }
    }
  }
  __syncthreads();
  if (threadIdx.x == 0) {
    int start = 0;
    for (int b = 0; b < kBins; ++b) {
      const int c = s_count[b];
      s_first[b] = start;
      s_base[b] = c ? atomicAdd(counts + b, c) : 0;
      start += c;
    }
    s_first[kBins] = start;
  }
  __syncthreads();
#pragma unroll
  for (int j = 0; j < kSweepRows; ++j) {
    if (bin[j] < 0) continue;
    const int k = s_first[bin[j]] + off[j];
    s_row[k] = (int)(first + j);
    s_lo[k] = lo[j];
    s_hi[k] = hi[j];
  }
  __syncthreads();
  for (int k = threadIdx.x; k < s_first[kBins]; k += kThreads) {
    int b = 0;
#pragma unroll
    for (int c = 1; c < kBins; ++c) b += k >= s_first[c];
    const int at = bin_start[b] + s_base[b] + k - s_first[b];
    lists.row[at] = s_row[k];
    lists.lo[at] = s_lo[k];
    lists.hi[at] = s_hi[k];
  }
}

// --------------------------------------------------------------- row pass
// Bins 0 and 1: G lanes a row, a shared histogram of MaxDeg + 1 bins each.
template <int G, int MaxDeg>
__global__ void __launch_bounds__(kThreads)
row_group_kernel(const int* __restrict__ nbr, const int* __restrict__ core,
                 const int* __restrict__ aux, int mode, int bin, int* __restrict__ out_a,
                 int* __restrict__ out_b, const int* __restrict__ bin_start,
                 const int* __restrict__ counts, Lists lists,
                 int* __restrict__ upd) {
  constexpr int kGroupsPerWarp = kWarp / G;
  __shared__ int s_hist[kThreads / G][MaxDeg + 1];
  const int total = counts[bin];
  const int start = bin_start[bin];
  const int lane = threadIdx.x & (kWarp - 1);
  const int gl = lane % G;
  int* hist = s_hist[threadIdx.x / G];
  const int warp = (blockIdx.x * kThreads + threadIdx.x) / kWarp;
  const int warps = gridDim.x * kWarpsPerBlock;
  int changed = 0;
  // warp-uniform loop: every lane reaches every shuffle and __syncwarp
  for (int base = warp * kGroupsPerWarp; base < total;
       base += warps * kGroupsPerWarp) {
    const int i = base + lane / G;
    const bool valid = i < total;
    const int v = valid ? lists.row[start + i] : 0;
    const int lo = valid ? lists.lo[start + i] : 0;
    const int hi = valid ? lists.hi[start + i] : 0;
    const int deg = hi - lo;
    if (mode == MODE_COUNTS) {
      const int thr = valid ? aux[v] : 0;
      int c = 0;
      for_edges<G>(nbr, core, lo, hi, gl, [&](int, int x) { c += x >= thr; });
      c = group_sum<G>(c);
      if (valid && gl == 0) out_a[v] = c;
      continue;
    }
    const int cv = valid ? core[v] : 0;
    const int cap = max(0, min(cv, deg));
    for (int b = gl; b < cap; b += G) hist[b] = 0;
    __syncwarp();
    int top = 0;  // #(values >= cap): the histogram's last bin
    for_edges<G>(nbr, core, lo, hi, gl, [&](int, int x) {
      if (x >= cap) ++top;
      else atomicAdd(hist + max(x, 0), 1);  // a negative value counts at 0 only
    });
    top = group_sum<G>(top);
    if (gl == 0) hist[cap] = top;
    __syncwarp();
    // suffix counts in place, a contiguous run of bins per lane
    const int nb = cap + 1;
    const int per = (nb + G - 1) / G;
    const int b0 = min(gl * per, nb);
    const int b1 = min(b0 + per, nb);
    int s = 0;
    for (int b = b0; b < b1; ++b) s += hist[b];
    int run = group_suffix<G>(s, gl) - s;
    int feas = 0;
    for (int b = b1 - 1; b >= b0; --b) {
      run += hist[b];
      hist[b] = run;
      feas += (b >= 1) & (run >= b);
    }
    const int h = group_sum<G>(feas);
    __syncwarp();
    if (valid && gl == 0) {
      out_a[v] = h;
      if (mode == MODE_HINDEX || mode == MODE_SEMICORE_STAR) out_b[v] = hist[h];
      changed += h != cv;
    }
    __syncwarp();  // the next row's zeroing waits for this read
  }
  changed = group_sum<kWarp>(changed);
  if (lane == 0 && changed) atomicAdd(upd, changed);
}

// Bins 2 and 3: one block a row.
__global__ void __launch_bounds__(kThreads)
row_block_kernel(const int* __restrict__ nbr, const int* __restrict__ core,
                 const int* __restrict__ aux, int mode, int* __restrict__ out_a, int* __restrict__ out_b,
                 const int* __restrict__ bin_start,
                 const int* __restrict__ counts, Lists lists,
                 int* __restrict__ upd) {
  __shared__ int s_hist[kHistBins];
  __shared__ int s_red[kWarpsPerBlock];
  const int t = threadIdx.x;
  const int n_block = counts[BIN_BLOCK];
  const int total = n_block + counts[BIN_GLOBAL];
  int changed = 0;
  for (int i = blockIdx.x; i < total; i += gridDim.x) {  // block-uniform
    const int3 item = list_item(lists, bin_start, BIN_BLOCK, n_block, i);
    const int v = item.x, lo = item.y, hi = item.z;
    const int deg = hi - lo;
    if (mode == MODE_COUNTS) {
      const int thr = aux[v];
      int c = 0;
      for_edges<kThreads>(nbr, core, lo, hi, t, [&](int, int x) { c += x >= thr; });
      c = block_sum(c, s_red);
      if (t == 0) out_a[v] = c;
      continue;
    }
    const int cv = core[v];
    const int cap = max(0, min(cv, deg));
    int h, c_at;
    if (cap < kHistBins) {
      for (int b = t; b < cap; b += kThreads) s_hist[b] = 0;
      __syncthreads();
      int top = 0;
      for_edges<kThreads>(nbr, core, lo, hi, t, [&](int, int x) {
        if (x >= cap) ++top;
        else atomicAdd(s_hist + max(x, 0), 1);
      });
      top = block_sum(top, s_red);  // its barriers also close the atomics
      if (t == 0) s_hist[cap] = top;
      __syncthreads();
      const int nb = cap + 1;
      const int per = (nb + kThreads - 1) / kThreads;
      const int b0 = min(t * per, nb);
      const int b1 = min(b0 + per, nb);
      int s = 0;
      for (int b = b0; b < b1; ++b) s += s_hist[b];
      int run = block_suffix_excl(s, s_red);
      int feas = 0;
      for (int b = b1 - 1; b >= b0; --b) {
        run += s_hist[b];
        s_hist[b] = run;
        feas += (b >= 1) & (run >= b);
      }
      h = block_sum(feas, s_red);  // its barriers publish the suffixes
      c_at = s_hist[h];
      __syncthreads();  // the next row's zeroing waits for this read
    } else {
      // cap past the shared histogram (a bin-3 row only): binary search
      // of h, one block-reduced count over the row's edges a probe
      int k_lo = 0, k_hi = cap;
      c_at = deg;  // #(core[nbr] >= 0)
      while (k_lo < k_hi) {  // block-uniform: every thread holds the counts
        const int mid = k_lo + (k_hi - k_lo + 1) / 2;
        int c = 0;
        for_edges<kThreads>(nbr, core, lo, hi, t, [&](int, int x) { c += x >= mid; });
        c = block_sum(c, s_red);
        if (c >= mid) {
          k_lo = mid;
          c_at = c;
        } else {
          k_hi = mid - 1;
        }
      }
      h = k_lo;
    }
    if (t == 0) {
      out_a[v] = h;
      if (mode == MODE_HINDEX || mode == MODE_SEMICORE_STAR) out_b[v] = c_at;
      changed += h != cv;
    }
  }
  if (t == 0 && changed) atomicAdd(upd, changed);
}

// -------------------------------------------------------------- push pass
// G threads a listed row (G = 8, 32 or the block), bins first..last.
template <int G>
__global__ void __launch_bounds__(kThreads)
push_kernel(const int* __restrict__ nbr, const int* __restrict__ core,
            const int* __restrict__ core2, int mode, int first, int last,
            int* __restrict__ target, const int* __restrict__ bin_start,
            const int* __restrict__ counts, Lists lists) {
  constexpr int kGroupsPerBlock = kThreads / G;
  const int n_first = counts[first];
  const int total = n_first + (last > first ? counts[last] : 0);
  const int gl = threadIdx.x % G;
  const int groups = gridDim.x * kGroupsPerBlock;
  for (int i = blockIdx.x * kGroupsPerBlock + threadIdx.x / G; i < total;
       i += groups) {
    const int3 item = list_item(lists, bin_start, first, n_first, i);
    const int v = item.x;
    if (mode == MODE_SEMICORE_STAR) {
      const int h = core2[v];
      const int c_old = core[v];
      for_edges<G>(nbr, core2, item.y, item.z, gl, [&](int u, int c2) {
        if (c2 > h && c2 <= c_old) atomicSub(target + u, 1);
      });
    } else {
      for (int e = item.y + gl; e < item.z; e += G) target[__ldg(nbr + e)] = 1;
    }
  }
}

// The next frontier, one thread a row: semicore* (target = cnt2)
// cnt2 < core2, semicore+ (target = touched marks) touched; both core2 > 0.
// kSweepRows consecutive rows a thread, as the sweep.
__global__ void __launch_bounds__(kThreads)
frontier_kernel(const int* __restrict__ target, const int* __restrict__ core2,
                int n, int mode, uint8_t* __restrict__ active2) {
  const long long first =
      ((long long)blockIdx.x * kThreads + threadIdx.x) * kSweepRows;
  if (first >= n) return;
  int t[kSweepRows], c2[kSweepRows];
  const bool whole = first + kSweepRows <= n;
  if (whole) {
    load8(target, first, t);
    load8(core2, first, c2);
  } else {
    for (int j = 0; j < kSweepRows; ++j) {
      t[j] = first + j < n ? target[first + j] : 0;
      c2[j] = first + j < n ? core2[first + j] : 0;
    }
  }
  unsigned int f[2] = {0u, 0u};
#pragma unroll
  for (int j = 0; j < kSweepRows; ++j) {
    const bool a = c2[j] > 0 && (mode == MODE_SEMICORE_STAR ? t[j] < c2[j] : t[j] > 0);
    f[j / 4] |= (unsigned int)a << (8 * (j % 4));
  }
  if (whole) {
    *reinterpret_cast<uint2*>(active2 + first) = make_uint2(f[0], f[1]);
  } else {
    for (int j = 0; j < kSweepRows && first + j < n; ++j)
      active2[first + j] = (f[j / 4] >> (8 * (j % 4))) & 1u;
  }
}

// A card-sized grid: `per_sm` blocks on each SM.
unsigned int grid_for(int per_sm) {
  int dev = 0, sms = 132;
  if (cudaGetDevice(&dev) == cudaSuccess)
    cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  return (unsigned int)(sms * per_sm);
}

unsigned int sweep_blocks(int n) {
  constexpr long long kTile = (long long)kThreads * kSweepRows;
  return (unsigned int)(((long long)n + kTile - 1) / kTile);
}

Lists lists_of(void* lists, int n) {
  int* base = (int*)lists;
  return Lists{base, base + n, base + 2 * (long long)n};
}

}  // namespace

// counters: kBins list fills then upd, all zero on entry; lists: 3 n entries.
extern "C" int fs_row_pass(const void* segptr, const void* nbr, const void* core,
                           const void* aux, const void* active, int n, int mode,
                           void* out_a, void* out_b, const void* bin_start,
                           void* lists, void* counters, void* stream) {
  if (n > 0) {
    cudaStream_t s = (cudaStream_t)stream;
    const int* nb = (const int*)nbr;
    const int* co = (const int*)core;
    const int* ax = (const int*)aux;
    const int* bs = (const int*)bin_start;
    int* cnt = (int*)counters;
    const Lists li = lists_of(lists, n);
    int* upd = cnt + kBins;
    sweep_kernel<<<sweep_blocks(n), kThreads, 0, s>>>(
        (const int*)segptr, co, ax, nullptr, (const uint8_t*)active, n, mode,
        false, (int*)out_a, (int*)out_b, bs, cnt, li);
    row_group_kernel<kGroupLanes, kGroupMaxDeg><<<grid_for(8), kThreads, 0, s>>>(
        nb, co, ax, mode, BIN_GROUP, (int*)out_a, (int*)out_b, bs, cnt, li, upd);
    row_group_kernel<kWarp, kWarpMaxDeg><<<grid_for(8), kThreads, 0, s>>>(
        nb, co, ax, mode, BIN_WARP, (int*)out_a, (int*)out_b, bs, cnt, li, upd);
    row_block_kernel<<<grid_for(4), kThreads, 0, s>>>(
        nb, co, ax, mode, (int*)out_a, (int*)out_b, bs, cnt, li, upd);
  }
  return (int)cudaGetLastError();
}

// counters: kBins list fills, zero on entry; lists: 3 n entries; active2
// (n bytes) receives the next frontier.
extern "C" int fs_push_pass(const void* segptr, const void* nbr, const void* core,
                            const void* core2, const void* active, int n, int mode,
                            void* target, void* active2, const void* bin_start,
                            void* lists, void* counters, void* stream) {
  if (n > 0) {
    cudaStream_t s = (cudaStream_t)stream;
    const int* nb = (const int*)nbr;
    const int* co = (const int*)core;
    const int* c2 = (const int*)core2;
    const int* bs = (const int*)bin_start;
    int* cnt = (int*)counters;
    int* tg = (int*)target;
    const Lists li = lists_of(lists, n);
    sweep_kernel<<<sweep_blocks(n), kThreads, 0, s>>>(
        (const int*)segptr, co, nullptr, c2, (const uint8_t*)active, n, mode,
        true, nullptr, nullptr, bs, cnt, li);
    push_kernel<kGroupLanes><<<grid_for(8), kThreads, 0, s>>>(
        nb, co, c2, mode, BIN_GROUP, BIN_GROUP, tg, bs, cnt, li);
    push_kernel<kWarp><<<grid_for(8), kThreads, 0, s>>>(
        nb, co, c2, mode, BIN_WARP, BIN_WARP, tg, bs, cnt, li);
    push_kernel<kThreads><<<grid_for(4), kThreads, 0, s>>>(
        nb, co, c2, mode, BIN_BLOCK, BIN_GLOBAL, tg, bs, cnt, li);
    frontier_kernel<<<sweep_blocks(n), kThreads, 0, s>>>(tg, c2, n, mode,
                                                         (uint8_t*)active2);
  }
  return (int)cudaGetLastError();
}

// (kGroupLanes, kGroupMaxDeg, kWarpMaxDeg, kHistBins)
extern "C" void fs_bin_rule(int* out) {
  out[0] = kGroupLanes;
  out[1] = kGroupMaxDeg;
  out[2] = kWarpMaxDeg;
  out[3] = kHistBins;
}
