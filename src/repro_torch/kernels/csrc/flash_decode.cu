// Flash decode on Hopper (sm_90a): one query token of GQA attention over
// the first cache_len positions of a KV cache, softmax in float32, scale
// 1/sqrt(d), the result rounded once to q's dtype.
//
// Replaces the TPU kernel repro/kernels/flash_decode.py::_flash_decode_kernel,
// which is also the single-chip form of repro/models/layers.py::
// decode_attention.  The TPU kernel walks the cache in a sequential grid of
// KV blocks per kv head and carries the running (max, sum, acc) of its G
// query heads in VMEM scratch from one grid step to the next.  Blocks here
// run in no order on 132 SMs, so the walk becomes split-KV: each (batch row,
// kv head) is cut into splits, one thread block each, which write float32
// partials (m, l, acc) that a second kernel merges.
//
// Bound on this card: the K and V bytes below cache_len, plus q and out.  In
// bf16 the kernel does about G multiply-adds per K/V byte (G = 2 for
// Qwen3-0.6B), far below the ~295 operations a byte at which the tensor
// cores would limit it: it is bound by bytes, and by bytes in flight where
// the cache is short.  At Qwen3-0.6B's served shape (8 rows x 8 kv heads x
// d 128, cache_len 544) that is 17.8 MB, 5.3 us at 3.35 TB/s; at the full
// decode_32k layer cache (8 x 32768) 1.07 GB, 0.32 ms.  What the design
// does about it:
//
//   * Splits sized on the device.  split_plan() cuts the covered positions
//     of a (row, kv head) into n splits of `span` positions, a multiple of
//     the kTile-position tile (the last one ragged), with n at most
//     kTarget / (B * Hkv * head groups): the blocks with work fill the 132
//     SMs at most about twice (two blocks fit an SM); short lengths give
//     fewer, one tile a split at least.
//     Every block derives its split from cache_len inside the kernel; a
//     block past the split count exits.  The host sizes the partials from
//     T alone (max_splits).  kernels/flash_decode.py follows the same rule.
//   * K/V staged through shared memory by cp.async: a ring of kStages
//     (kTile x d) K and V tiles, 16-byte copies, cp.async.wait_group; two
//     tiles in flight while a third is consumed (64 KB a block at d 128 in
//     bf16, 128 KB an SM).  Rows at or past the split's end are zero-filled
//     and never read.  The copies need 16-byte aligned bases and strides and
//     d * elem a multiple of 16 bytes; the wrapper refuses other operands.
//     Tiles are stored XOR-swizzled by 16-byte chunk so that ldmatrix and
//     the row reads hit distinct banks.
//   * bf16 products on the tensor cores (mma.sync.m16n8k16, f32
//     accumulate): the block's up to 16 query heads of one kv head on M,
//     positions on N: S = Q K^T, Q's fragments held in registers for the
//     whole split, K by ldmatrix; then O += P V with V by ldmatrix.trans
//     and P from S's accumulators in registers.  P is split into two bf16
//     terms (hi + lo, two products) so the weights keep ~2^-17 relative
//     precision: the partials hold to float32 tolerances.  The float32 path
//     reads the same staged tiles with CUDA-core FMAs (TF32 would not hold
//     float32 tolerances).
//   * An online softmax per warp in registers (each warp owns 16 positions
//     of every tile), the warps merged once in shared memory at the end of
//     the split.
//
// fd_combine: one thread block per (query head, batch row) reads the split
// count from the same rule and merges the partials: the global max M,
// L = sum_s l_s exp(m_s - M), out = sum_s acc_s exp(m_s - M) / L.
//
// A sequence cut into pieces (tensor parallelism: rank r holds positions
// [r * T, (r + 1) * T) of every kv head): fd_split runs on one piece at its
// offset, covering the piece's positions below cache_len; a piece wholly
// past cache_len has no split, the neutral partial (m = -inf, l = 0,
// acc = 0).  cache_len <= 0 covers every piece whole with zero scores, so
// the merge is still the mean of V over all positions.  fd_combine takes
// the P pieces' partials stacked (P, B, Hkv, NS, G, ...), each piece's
// split count from its own plan (combine_pieces_kernel); one piece runs
// the uncut cache's combine_kernel.
//
// cache_len is read on the device (an int32 scalar, or one per batch row),
// so a decode step never waits on the host for it; positions at or past it
// are never read, and any T works.  cache_len <= 0 gives the reference's
// answer, the mean of V over all T positions (its -1e30 fill makes the
// softmax uniform): the splits then cover [0, T) with every score 0.  q is
// (B, H, d) and the caches (B, T, Hkv, d), each by its strides with a unit
// stride on d, so the TPU layout (Hkv, S, d) runs as B = 1 with no copy.
//
// Plain C interface, loaded with ctypes.  Every function launches on the
// given stream, allocates nothing and returns a CUDA error code.
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 128;
constexpr int kWarps = kThreads / 32;
constexpr int kTile = 64;            // positions a stage (TILE in flash_decode.py)
constexpr int kRowsPerWarp = kTile / kWarps;  // 16: the N of two m16n8 products
constexpr int kStages = 3;           // K/V tiles in the shared-memory ring
constexpr int kHeads = 16;           // query heads a block (HEAD_GROUP): the M of mma
constexpr int kTarget = 264;         // blocks with work the rule aims at (TARGET_BLOCKS)
constexpr unsigned kFull = 0xffffffffu;
constexpr float kLog2e = 1.4426950408889634f;
constexpr float kLn2 = 0.6931471805599453f;

static_assert(kRowsPerWarp == 16, "a warp owns 16 positions of a tile");

enum DType { DT_FLOAT32 = 0, DT_BFLOAT16 = 1 };

struct Strides {
  long long b, t, h;  // batch, position, head (elements); d has stride 1
};

// ---------------------------------------------------------------- the rule
struct Plan {
  int covered;  // positions covered: min(cache_len, T), or T for cache_len <= 0
  int span;     // positions a split (a multiple of kTile)
  int n;        // splits with work
};

__host__ __device__ __forceinline__ int split_cap(int B, int Hkv, int groups) {
  const long long units = (long long)B * Hkv * groups;
  return units >= kTarget ? 1 : (int)(kTarget / units);
}

__host__ __device__ __forceinline__ Plan split_plan(int cache_len, int T, int cap) {
  const int L = cache_len <= 0 || cache_len > T ? T : cache_len;
  const int tiles = (L + kTile - 1) / kTile;
  const int per = (tiles + cap - 1) / cap;
  return {L, per * kTile, (tiles + per - 1) / per};
}

// The plan of the piece of T positions at `offset` of a longer sequence:
// the positions below cache_len, none past it (n = 0), or every position
// with zero scores for cache_len <= 0.  offset 0 with T the whole length is
// split_plan.
__host__ __device__ __forceinline__ Plan piece_plan(int cache_len, long long offset, int T,
                                                   int cap) {
  if (cache_len <= 0) return split_plan(cache_len, T, cap);
  const long long local = (long long)cache_len - offset;
  if (local <= 0) return {0, kTile, 0};
  return split_plan(local > T ? T : (int)local, T, cap);
}

__host__ __device__ __forceinline__ int max_splits(int T, int cap) {
  const int tiles = (T + kTile - 1) / kTile;
  return cap < tiles ? cap : tiles;
}

// ------------------------------------------------------------ primitives
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

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

// 16 bytes global -> shared; src_bytes 0 zero-fills and reads nothing
__device__ __forceinline__ void cp_async16(uint32_t dst, const void* src, int src_bytes) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(dst), "l"(src),
               "r"(src_bytes));
}
__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}
template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N) : "memory");
}

__device__ __forceinline__ void ldmatrix_x4(uint32_t (&r)[4], uint32_t addr) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0,%1,%2,%3}, [%4];\n"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
               : "r"(addr));
}
__device__ __forceinline__ void ldmatrix_x4_trans(uint32_t (&r)[4], uint32_t addr) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0,%1,%2,%3}, [%4];\n"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
               : "r"(addr));
}

// c += a * b, m16n8k16, bf16 in, f32 accumulate
__device__ __forceinline__ void mma_bf16(float (&c)[4], const uint32_t (&a)[4], uint32_t b0,
                                         uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 {%0,%1,%2,%3}, "
      "{%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};\n"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
  const __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<const uint32_t*>(&v);
}

// ------------------------------------------------------------ tile layout
// A (kTile x D) tile of T in shared memory, rows of D * sizeof(T) bytes,
// 16-byte chunk c of row r stored at chunk c ^ ((r >> kShift) & kMask):
// eight consecutive rows at one logical chunk land on eight distinct bank
// groups (what ldmatrix reads), and one row's chunks stay a permutation.
template <typename T, int D>
struct Tile {
  static constexpr int kRowBytes = D * (int)sizeof(T);
  static constexpr int kChunks = kRowBytes / 16;
  static constexpr int kBytes = kTile * kRowBytes;
  static constexpr int kShift = kChunks >= 8 ? 0 : (kChunks == 4 ? 1 : 2);
  static constexpr int kMask = (kChunks >= 8 ? 8 : kChunks) - 1;
  static_assert(kRowBytes % 16 == 0 && kChunks >= 2, "d * elem must be a multiple of 16 bytes");
  __device__ static __forceinline__ int offset(int r, int c) {
    return r * kRowBytes + ((c ^ ((r >> kShift) & kMask)) << 4);
  }
};

template <typename T, int D>
constexpr int ring_bytes() {
  return kStages * 2 * Tile<T, D>::kBytes;
}
template <int D>
constexpr int merge_bytes() {  // o_s [kWarps][kHeads][D], m_s, l_s [kWarps][kHeads]
  return (int)sizeof(float) * (kWarps * kHeads * D + 2 * kWarps * kHeads);
}
template <typename T, int D>
constexpr int split_smem() {
  return ring_bytes<T, D>() > merge_bytes<D>() ? ring_bytes<T, D>() : merge_bytes<D>();
}

template <typename T>
struct MinBlocks {
  static constexpr int value = 1;
};
template <>
struct MinBlocks<__nv_bfloat16> {
  static constexpr int value = 2;  // two blocks an SM: 96 KB of ring each at d 128
};

// ------------------------------------------------------------ the split
// grid (max splits, Hkv * groups, B): block (s, h * groups + gi, b) takes
// split s of row b, kv head h, query heads [gi * kHeads, +kHeads) of its G.
template <typename T, int D>
__global__ void __launch_bounds__(kThreads, MinBlocks<T>::value) split_kernel(
    const T* __restrict__ q, Strides qs, const T* __restrict__ k, Strides ks,
    const T* __restrict__ v, Strides vs, const int* __restrict__ lens, int len_stride,
    long long offset, int T_, int Hkv, int G, int groups, int cap, float* __restrict__ part_ml,
    float* __restrict__ part_acc) {
  using TL = Tile<T, D>;
  constexpr bool kBf16 = sizeof(T) == 2;
  extern __shared__ __align__(128) unsigned char smem[];

  const int s = blockIdx.x, b = blockIdx.z;
  const int h = blockIdx.y / groups, g0 = (blockIdx.y - h * groups) * kHeads;
  const int GG = min(kHeads, G - g0);
  const int len = lens[(long long)b * len_stride];
  const Plan plan = piece_plan(len, offset, T_, cap);
  if (s >= plan.n) return;  // the whole block: nothing read, nothing written
  const bool uniform = len <= 0;
  const int start = s * plan.span;
  const int end = min(start + plan.span, plan.covered);
  const int ntiles = (end - start + kTile - 1) / kTile;
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int rbase = warp * kRowsPerWarp;
  const float scale_log2 = kLog2e / sqrtf((float)D);

  const T* kb = k + b * ks.b + (long long)h * ks.h;
  const T* vb = v + b * vs.b + (long long)h * vs.h;
  const uint32_t ring = smem_u32(smem);

  auto load_tile = [&](int i) {  // tile i of the split into its stage
    const int t0 = start + i * kTile;
    const uint32_t st = ring + (uint32_t)((i % kStages) * 2 * TL::kBytes);
    for (int c = threadIdx.x; c < 2 * kTile * TL::kChunks; c += kThreads) {
      const int isv = c >= kTile * TL::kChunks;
      const int rc = c - isv * kTile * TL::kChunks;
      const int r = rc / TL::kChunks, ch = rc - r * TL::kChunks;
      const int pos = t0 + r;
      const T* base = isv ? vb : kb;
      const long long stride = isv ? vs.t : ks.t;
      const bool in = pos < end;
      const T* src = in ? base + (long long)pos * stride + ch * (16 / (int)sizeof(T)) : base;
      cp_async16(st + isv * TL::kBytes + TL::offset(r, ch), src, in ? 16 : 0);
    }
  };

#pragma unroll
  for (int i = 0; i < kStages - 1; ++i) {
    if (i < ntiles) load_tile(i);
    cp_async_commit();
  }

  float* o_s = reinterpret_cast<float*>(smem);  // the merge reuses the ring
  float* m_s = o_s + kWarps * kHeads * D;
  float* l_s = m_s + kWarps * kHeads;

  if constexpr (kBf16) {
    // ---- tensor-core path: S^T = K Q^T as Q (M = heads) K^T (N = positions)
    const int gid = lane >> 2, tig = lane & 3;
    uint32_t qf[D / 16][4];
#pragma unroll
    for (int kk = 0; kk < D / 16; ++kk) {
#pragma unroll
      for (int r = 0; r < 4; ++r) {
        const int head = gid + (r & 1) * 8;
        const int col = kk * 16 + (r >> 1) * 8 + tig * 2;
        float lo = 0.f, hi = 0.f;
        if (head < GG) {
          const T* qr = q + b * qs.b + (long long)(h * G + g0 + head) * qs.h + col;
          lo = to_f32(qr[0]);
          hi = to_f32(qr[1]);
        }
        qf[kk][r] = pack_bf16(lo, hi);
      }
    }
    float o[D / 8][4];
#pragma unroll
    for (int n = 0; n < D / 8; ++n) o[n][0] = o[n][1] = o[n][2] = o[n][3] = 0.f;
    float m0 = -INFINITY, m1 = -INFINITY, l0 = 0.f, l1 = 0.f;  // heads gid, gid + 8

    for (int i = 0; i < ntiles; ++i) {
      cp_async_wait<kStages - 2>();
      __syncthreads();  // tile i visible to all; the stage refilled below is free
      if (i + kStages - 1 < ntiles) load_tile(i + kStages - 1);
      cp_async_commit();

      const int t0 = start + i * kTile;
      if (t0 + rbase >= end) continue;  // this warp's 16 rows all past the end
      const uint32_t kt = ring + (uint32_t)((i % kStages) * 2 * TL::kBytes);
      const uint32_t vt = kt + TL::kBytes;
      const int mi = lane >> 3, r8 = lane & 7;

      float sc[2][4] = {{0.f, 0.f, 0.f, 0.f}, {0.f, 0.f, 0.f, 0.f}};
#pragma unroll
      for (int kk = 0; kk < D / 16; ++kk) {
        uint32_t kf[4];
        ldmatrix_x4(kf, kt + TL::offset(rbase + (mi >> 1) * 8 + r8, 2 * kk + (mi & 1)));
        mma_bf16(sc[0], qf[kk], kf[0], kf[1]);
        mma_bf16(sc[1], qf[kk], kf[2], kf[3]);
      }
      float mx0 = -INFINITY, mx1 = -INFINITY;
#pragma unroll
      for (int nt = 0; nt < 2; ++nt) {
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const int pos = t0 + rbase + nt * 8 + tig * 2 + (e & 1);
          const float x = pos < end ? (uniform ? 0.f : sc[nt][e] * scale_log2) : -INFINITY;
          sc[nt][e] = x;
        }
        mx0 = fmaxf(mx0, fmaxf(sc[nt][0], sc[nt][1]));
        mx1 = fmaxf(mx1, fmaxf(sc[nt][2], sc[nt][3]));
      }
      mx0 = fmaxf(mx0, __shfl_xor_sync(kFull, mx0, 1));
      mx0 = fmaxf(mx0, __shfl_xor_sync(kFull, mx0, 2));
      mx1 = fmaxf(mx1, __shfl_xor_sync(kFull, mx1, 1));
      mx1 = fmaxf(mx1, __shfl_xor_sync(kFull, mx1, 2));
      const float n0 = fmaxf(m0, mx0), n1 = fmaxf(m1, mx1);
      const float u0 = n0 == -INFINITY ? 0.f : n0, u1 = n1 == -INFINITY ? 0.f : n1;
      const float a0 = exp2f(m0 - u0), a1 = exp2f(m1 - u1);
      m0 = n0;
      m1 = n1;
      l0 *= a0;
      l1 *= a1;
#pragma unroll
      for (int nt = 0; nt < 2; ++nt) {
        sc[nt][0] = exp2f(sc[nt][0] - u0);
        sc[nt][1] = exp2f(sc[nt][1] - u0);
        sc[nt][2] = exp2f(sc[nt][2] - u1);
        sc[nt][3] = exp2f(sc[nt][3] - u1);
        l0 += sc[nt][0] + sc[nt][1];
        l1 += sc[nt][2] + sc[nt][3];
      }
#pragma unroll
      for (int n = 0; n < D / 8; ++n) {
        o[n][0] *= a0;
        o[n][1] *= a0;
        o[n][2] *= a1;
        o[n][3] *= a1;
      }
      // P as the A operand (M = heads, K = the warp's 16 positions), in two
      // bf16 terms: hi = bf16(p), lo = bf16(p - hi)
      uint32_t ph[4], pl[4];
#pragma unroll
      for (int r = 0; r < 4; ++r) {
        const float x0 = sc[r >> 1][(r & 1) * 2], x1 = sc[r >> 1][(r & 1) * 2 + 1];
        ph[r] = pack_bf16(x0, x1);
        const __nv_bfloat162 hv = *reinterpret_cast<const __nv_bfloat162*>(&ph[r]);
        pl[r] = pack_bf16(x0 - __low2float(hv), x1 - __high2float(hv));
      }
#pragma unroll
      for (int c = 0; c < D / 16; ++c) {
        uint32_t vf[4];
        ldmatrix_x4_trans(vf, vt + TL::offset(rbase + (mi & 1) * 8 + r8, 2 * c + (mi >> 1)));
        mma_bf16(o[2 * c], ph, vf[0], vf[1]);
        mma_bf16(o[2 * c], pl, vf[0], vf[1]);
        mma_bf16(o[2 * c + 1], ph, vf[2], vf[3]);
        mma_bf16(o[2 * c + 1], pl, vf[2], vf[3]);
      }
    }
    cp_async_wait<0>();
    __syncthreads();  // the ring is free for the merge
    l0 += __shfl_xor_sync(kFull, l0, 1);
    l0 += __shfl_xor_sync(kFull, l0, 2);
    l1 += __shfl_xor_sync(kFull, l1, 1);
    l1 += __shfl_xor_sync(kFull, l1, 2);
    if (tig == 0) {
      m_s[warp * kHeads + gid] = m0;
      l_s[warp * kHeads + gid] = l0;
      m_s[warp * kHeads + gid + 8] = m1;
      l_s[warp * kHeads + gid + 8] = l1;
    }
    float* ow = o_s + warp * kHeads * D;
#pragma unroll
    for (int n = 0; n < D / 8; ++n) {
      const int j = n * 8 + tig * 2;
      ow[gid * D + j] = o[n][0];
      ow[gid * D + j + 1] = o[n][1];
      ow[(gid + 8) * D + j] = o[n][2];
      ow[(gid + 8) * D + j + 1] = o[n][3];
    }
  } else {
    // ---- float32 path: CUDA-core FMAs on the same staged tiles; lane c
    // holds 16-byte chunk c of a row (D / 4 <= 32 chunks)
    constexpr int kC = TL::kChunks;
    static_assert(kC <= 32, "float32 rows of at most 32 chunks");
    const bool mine = lane < kC;
    float4 q4[kHeads], acc[kHeads];
    float m[kHeads], l[kHeads];
#pragma unroll
    for (int g = 0; g < kHeads; ++g) {
      q4[g] = make_float4(0.f, 0.f, 0.f, 0.f);
      if (g < GG && mine) {
        const T* qr = q + b * qs.b + (long long)(h * G + g0 + g) * qs.h + lane * 4;
        q4[g] = make_float4(to_f32(qr[0]), to_f32(qr[1]), to_f32(qr[2]), to_f32(qr[3]));
      }
      acc[g] = make_float4(0.f, 0.f, 0.f, 0.f);
      m[g] = -INFINITY;
      l[g] = 0.f;
    }
    for (int i = 0; i < ntiles; ++i) {
      cp_async_wait<kStages - 2>();
      __syncthreads();
      if (i + kStages - 1 < ntiles) load_tile(i + kStages - 1);
      cp_async_commit();

      const int t0 = start + i * kTile;
      const unsigned char* kt = smem + (i % kStages) * 2 * TL::kBytes;
      const unsigned char* vt = kt + TL::kBytes;
      for (int p = 0; p < kRowsPerWarp; ++p) {
        const int r = rbase + p;
        if (t0 + r >= end) break;  // warp-uniform
        float4 kv = make_float4(0.f, 0.f, 0.f, 0.f), vv = kv;
        if (mine) {
          kv = *reinterpret_cast<const float4*>(kt + TL::offset(r, lane));
          vv = *reinterpret_cast<const float4*>(vt + TL::offset(r, lane));
        }
#pragma unroll
        for (int g = 0; g < kHeads; ++g) {
          if (g < GG) {  // warp-uniform
            float d = q4[g].x * kv.x;
            d = fmaf(q4[g].y, kv.y, d);
            d = fmaf(q4[g].z, kv.z, d);
            d = fmaf(q4[g].w, kv.w, d);
            d = warp_sum(d);
            const float x = uniform ? 0.f : d * scale_log2;
            const float mn = fmaxf(m[g], x);
            const float a = exp2f(m[g] - mn), e = exp2f(x - mn);
            m[g] = mn;
            l[g] = fmaf(l[g], a, e);
            acc[g].x = fmaf(acc[g].x, a, e * vv.x);
            acc[g].y = fmaf(acc[g].y, a, e * vv.y);
            acc[g].z = fmaf(acc[g].z, a, e * vv.z);
            acc[g].w = fmaf(acc[g].w, a, e * vv.w);
          }
        }
      }
    }
    cp_async_wait<0>();
    __syncthreads();
#pragma unroll
    for (int g = 0; g < kHeads; ++g) {
      if (g < GG) {
        if (lane == 0) {
          m_s[warp * kHeads + g] = m[g];
          l_s[warp * kHeads + g] = l[g];
        }
        if (mine)
          *reinterpret_cast<float4*>(o_s + (warp * kHeads + g) * D + lane * 4) = acc[g];
      }
    }
  }
  __syncthreads();

  // ---- merge the warps; one partial (m, l, acc) per head of the group
  const long long slot0 = ((long long)(b * Hkv + h) * gridDim.x + s) * G + g0;
  for (int i = threadIdx.x; i < GG * D; i += kThreads) {
    const int r = i / D, j = i - r * D;
    float M = -INFINITY;
#pragma unroll
    for (int w = 0; w < kWarps; ++w) M = fmaxf(M, m_s[w * kHeads + r]);
    float L = 0.f, A = 0.f;
#pragma unroll
    for (int w = 0; w < kWarps; ++w) {
      const float f = exp2f(m_s[w * kHeads + r] - M);  // 0 for a warp that saw nothing
      L = fmaf(l_s[w * kHeads + r], f, L);
      A = fmaf(o_s[(w * kHeads + r) * D + j], f, A);
    }
    part_acc[(slot0 + r) * D + j] = A;
    if (j == 0) {
      part_ml[(slot0 + r) * 2] = M * kLn2;  // back to natural-log units
      part_ml[(slot0 + r) * 2 + 1] = L;
    }
  }
}

// ------------------------------------------------------------ the combine
// grid (H, B): block (hq, b) merges query head hq of row b over its splits.
template <typename T>
__global__ void __launch_bounds__(kThreads) combine_kernel(
    const float* __restrict__ part_ml, const float* __restrict__ part_acc,
    const int* __restrict__ lens, int len_stride, int T_, int Hkv, int G, int d, int NS,
    int cap, T* __restrict__ out) {
  __shared__ float w_s[kTarget];  // n <= split_cap <= kTarget
  __shared__ float inv_s;
  const int hq = blockIdx.x, b = blockIdx.y;
  const int h = hq / G, g = hq - h * G;
  const int n = split_plan(lens[(long long)b * len_stride], T_, cap).n;
  const long long base = (long long)(b * Hkv + h) * NS * G + g;  // split s at base + s*G

  if (threadIdx.x < 32) {  // one warp: M, L and the weights exp(m_s - M)
    float M = -INFINITY;
    for (int s = threadIdx.x; s < n; s += 32) M = fmaxf(M, part_ml[(base + (long long)s * G) * 2]);
#pragma unroll
    for (int o = 16; o > 0; o >>= 1) M = fmaxf(M, __shfl_xor_sync(kFull, M, o));
    float L = 0.f;
    for (int s = threadIdx.x; s < n; s += 32) {
      const long long i = (base + (long long)s * G) * 2;
      const float w = expf(part_ml[i] - M);
      w_s[s] = w;
      L = fmaf(part_ml[i + 1], w, L);
    }
    L = warp_sum(L);
    if (threadIdx.x == 0) inv_s = 1.f / L;  // L >= 1: the split holding M has l >= 1
  }
  __syncthreads();
  const float inv = inv_s;
  T* o = out + ((long long)b * Hkv * G + hq) * d;
  for (int j = threadIdx.x; j < d; j += kThreads) {
    float acc = 0.f;
    for (int s = 0; s < n; ++s) acc = fmaf(w_s[s], part_acc[(base + (long long)s * G) * d + j], acc);
    o[j] = from_f32<T>(acc * inv);
  }
}

// combine_kernel over the P pieces' partials stacked, piece p's splits at
// p * piece: each piece's count from its own plan (splits past it are left
// unwritten by fd_split and never read), the weights in dynamic shared
// memory at p * NS + s.
template <typename T>
__global__ void __launch_bounds__(kThreads) combine_pieces_kernel(
    const float* __restrict__ part_ml, const float* __restrict__ part_acc,
    const int* __restrict__ lens, int len_stride, int T_, int B, int Hkv, int G, int d, int NS,
    int cap, int P, T* __restrict__ out) {
  extern __shared__ float w_s[];
  __shared__ float inv_s;
  const int hq = blockIdx.x, b = blockIdx.y;
  const int h = hq / G, g = hq - h * G;
  const int len = lens[(long long)b * len_stride];
  const long long piece = (long long)B * Hkv * NS * G;           // slots a piece
  const long long base = (long long)(b * Hkv + h) * NS * G + g;  // split s at base + s*G

  if (threadIdx.x < 32) {
    float M = -INFINITY;
    for (int p = 0; p < P; ++p) {
      const int n = piece_plan(len, (long long)p * T_, T_, cap).n;
      const float* ml = part_ml + (p * piece + base) * 2;
      for (int s = threadIdx.x; s < n; s += 32) M = fmaxf(M, ml[(long long)s * G * 2]);
    }
#pragma unroll
    for (int o = 16; o > 0; o >>= 1) M = fmaxf(M, __shfl_xor_sync(kFull, M, o));
    float L = 0.f;
    for (int p = 0; p < P; ++p) {
      const int n = piece_plan(len, (long long)p * T_, T_, cap).n;
      const float* ml = part_ml + (p * piece + base) * 2;
      for (int s = threadIdx.x; s < n; s += 32) {
        const long long i = (long long)s * G * 2;
        const float w = expf(ml[i] - M);
        w_s[p * NS + s] = w;
        L = fmaf(ml[i + 1], w, L);
      }
    }
    L = warp_sum(L);
    if (threadIdx.x == 0) inv_s = 1.f / L;
  }
  __syncthreads();
  const float inv = inv_s;
  T* o = out + ((long long)b * Hkv * G + hq) * d;
  for (int j = threadIdx.x; j < d; j += kThreads) {
    float acc = 0.f;
    for (int p = 0; p < P; ++p) {
      const int n = piece_plan(len, (long long)p * T_, T_, cap).n;
      const float* a = part_acc + (p * piece + base) * d + j;
      for (int s = 0; s < n; ++s) acc = fmaf(w_s[p * NS + s], a[(long long)s * G * d], acc);
    }
    o[j] = from_f32<T>(acc * inv);
  }
}

// ------------------------------------------------------------ launches
template <typename T, int D>
int launch_split(const void* q, Strides qs, const void* k, Strides ks, const void* v,
                 Strides vs, const int* lens, int len_stride, long long offset, int B, int T_,
                 int Hkv, int G, int groups, int cap, int NS, float* ml, float* acc,
                 cudaStream_t s) {
  constexpr int smem = split_smem<T, D>();
  static bool ready[64] = {false};  // the attribute, set once per device
  int dev = 0;
  cudaError_t e = cudaGetDevice(&dev);
  if (e != cudaSuccess) return (int)e;
  if (dev < 0 || dev >= 64) return (int)cudaErrorInvalidDevice;
  if (!ready[dev]) {
    e = cudaFuncSetAttribute(split_kernel<T, D>, cudaFuncAttributeMaxDynamicSharedMemorySize,
                             smem);
    if (e != cudaSuccess) return (int)e;
    ready[dev] = true;
  }
  const dim3 grid(NS, Hkv * groups, B);
  split_kernel<T, D><<<grid, kThreads, smem, s>>>((const T*)q, qs, (const T*)k, ks, (const T*)v,
                                                  vs, lens, len_stride, offset, T_, Hkv, G,
                                                  groups, cap, ml, acc);
  return 0;
}

template <typename T>
int split_by_d(int d, const void* q, Strides qs, const void* k, Strides ks, const void* v,
               Strides vs, const int* lens, int len_stride, long long offset, int B, int T_,
               int Hkv, int G, int groups, int cap, int NS, float* ml, float* acc,
               cudaStream_t s) {
  switch (d) {
    case 16:
      return launch_split<T, 16>(q, qs, k, ks, v, vs, lens, len_stride, offset, B, T_, Hkv,
                                 G, groups, cap, NS, ml, acc, s);
    case 32:
      return launch_split<T, 32>(q, qs, k, ks, v, vs, lens, len_stride, offset, B, T_, Hkv,
                                 G, groups, cap, NS, ml, acc, s);
    case 64:
      return launch_split<T, 64>(q, qs, k, ks, v, vs, lens, len_stride, offset, B, T_, Hkv,
                                 G, groups, cap, NS, ml, acc, s);
    case 128:
      return launch_split<T, 128>(q, qs, k, ks, v, vs, lens, len_stride, offset, B, T_, Hkv,
                                  G, groups, cap, NS, ml, acc, s);
    default:
      return (int)cudaErrorInvalidValue;
  }
}

bool aligned16(const void* p, long long sb, long long st, long long sh, int elem) {
  return (reinterpret_cast<uintptr_t>(p) % 16 == 0) && (sb * elem) % 16 == 0 &&
         (st * elem) % 16 == 0 && (sh * elem) % 16 == 0;
}

}  // namespace

// The rule's constants, for the wrapper to check against its own.
extern "C" int fd_tile() { return kTile; }
extern "C" int fd_head_group() { return kHeads; }
extern "C" int fd_target() { return kTarget; }

// q (B, H, d) with strides q_sb, q_sh; k, v (B, T, Hkv, d) with strides
// (*_sb, *_st, *_sh), 16-byte aligned: the piece of T positions that starts
// at position `offset` of the sequence (0: the whole cache); lens int32
// with len_stride 0 (one scalar) or 1 (per row), lengths of the whole
// sequence.  H = Hkv * G, d in {16, 32, 64, 128}.  The partials are
// float32 (B, Hkv, NS, G, 2) and (B, Hkv, NS, G, d) with NS =
// max_splits(T, split_cap(B, Hkv, groups)), the wrapper's max_splits;
// splits past a row's count stay unwritten.
extern "C" int fd_split(const void* q, long long q_sb, long long q_sh, const void* k,
                        long long k_sb, long long k_st, long long k_sh, const void* v,
                        long long v_sb, long long v_st, long long v_sh, const void* lens,
                        int len_stride, long long offset, int B, int T, int Hkv, int G, int d,
                        int dtype, int NS, void* part_ml, void* part_acc, void* stream) {
  if (B <= 0 || T <= 0 || Hkv <= 0 || G <= 0 || d <= 0) return (int)cudaGetLastError();
  if (offset < 0) return (int)cudaErrorInvalidValue;
  const int groups = (G + kHeads - 1) / kHeads;
  const int cap = split_cap(B, Hkv, groups);
  if (NS != max_splits(T, cap)) return (int)cudaErrorInvalidValue;
  const int elem = dtype == DT_BFLOAT16 ? 2 : 4;
  if (!aligned16(k, k_sb, k_st, k_sh, elem) || !aligned16(v, v_sb, v_st, v_sh, elem))
    return (int)cudaErrorMisalignedAddress;
  const Strides qs{q_sb, 0, q_sh}, ks{k_sb, k_st, k_sh}, vs{v_sb, v_st, v_sh};
  cudaStream_t s = (cudaStream_t)stream;
  const int* ln = (const int*)lens;
  float* ml = (float*)part_ml;
  float* acc = (float*)part_acc;
  int e = 0;
  if (dtype == DT_FLOAT32) {
    e = split_by_d<float>(d, q, qs, k, ks, v, vs, ln, len_stride, offset, B, T, Hkv, G, groups,
                          cap, NS, ml, acc, s);
  } else if (dtype == DT_BFLOAT16) {
    e = split_by_d<__nv_bfloat16>(d, q, qs, k, ks, v, vs, ln, len_stride, offset, B, T, Hkv, G,
                                  groups, cap, NS, ml, acc, s);
  } else {
    return (int)cudaErrorInvalidValue;
  }
  if (e) return e;
  return (int)cudaGetLastError();
}

// The partials of P pieces of T positions each (piece p at offset p * T)
// stacked: (P, B, Hkv, NS, G, 2) and (P, B, Hkv, NS, G, d); P = 1 is one
// cache.  out (B, H, d) contiguous in `dtype`.
template <typename T>
void launch_combine(const float* ml, const float* acc, const int* lens, int len_stride, int B,
                    int T_, int Hkv, int G, int d, int NS, int cap, int P, T* out,
                    cudaStream_t s) {
  const dim3 grid(Hkv * G, B);
  if (P == 1) {
    combine_kernel<T><<<grid, kThreads, 0, s>>>(ml, acc, lens, len_stride, T_, Hkv, G, d, NS, cap,
                                               out);
  } else {
    const size_t smem = sizeof(float) * (size_t)P * NS;
    combine_pieces_kernel<T><<<grid, kThreads, smem, s>>>(ml, acc, lens, len_stride, T_, B, Hkv,
                                                          G, d, NS, cap, P, out);
  }
}

extern "C" int fd_combine(const void* part_ml, const void* part_acc, const void* lens,
                          int len_stride, int B, int T, int Hkv, int G, int d, int dtype,
                          int NS, int P, void* out, void* stream) {
  if (B <= 0 || T <= 0 || Hkv <= 0 || G <= 0 || d <= 0) return (int)cudaGetLastError();
  const int cap = split_cap(B, Hkv, (G + kHeads - 1) / kHeads);
  if (NS != max_splits(T, cap) || P <= 0 || sizeof(float) * (size_t)P * NS > 48 * 1024)
    return (int)cudaErrorInvalidValue;
  cudaStream_t s = (cudaStream_t)stream;
  const float* ml = (const float*)part_ml;
  const float* acc = (const float*)part_acc;
  const int* ln = (const int*)lens;
  if (dtype == DT_FLOAT32) {
    launch_combine<float>(ml, acc, ln, len_stride, B, T, Hkv, G, d, NS, cap, P, (float*)out, s);
  } else if (dtype == DT_BFLOAT16) {
    launch_combine<__nv_bfloat16>(ml, acc, ln, len_stride, B, T, Hkv, G, d, NS, cap, P,
                                  (__nv_bfloat16*)out, s);
  } else {
    return (int)cudaErrorInvalidValue;
  }
  return (int)cudaGetLastError();
}
