// The sink-sorted row sum shared by the SpMM kernels of csrc/edge_tile.cuh
// (spmm_edge_list, spmm_onehot_dtype, spmm_win), csrc/spmm_prefetch.cu and
// csrc/spmm_pairs.cu.
//
// One block owns a tile of `rows` output rows and a tile of feature columns
// of one batch element, and the lanes (sink, source, weight) that may add
// to them, in lane order. A lane adds w * x[src] to row sink - base when
// 0 <= sink - base < rows; its source follows the kernel's rule (Src): a
// lane with a source outside 0..N-1 adds nothing (kDrop), or reads it
// clamped into 0..N-1 (kClamp), or, where the lanes are pair buckets of
// `bucket` lanes a 128-row source window, lane e of the tile reads row
// kc*128 + clamp(src - kc*128, 0, 127) with kc = e / bucket (kBucket).
//
// The design, per pass of at most kMaxLanes lanes:
// 1. warp w takes a contiguous span of the pass in rounds of 32 lanes; each
//    thread reads the sink (and source) of its lanes and keeps their tile
//    rows, kRounds registers;
// 2. a stable counting sort by tile row in shared memory: integer atomicAdd
//    counts per (row, warp), an exclusive scan of the counts in (row, warp)
//    order, and each lane's source and weight placed at its (row, warp)
//    cursor plus its rank among the lanes of its row in its round
//    (__match_any_sync), the cursor then advanced by the round's count.
//    Warp spans are in lane order and rounds within a span too, so the
//    lanes of a row end up in lane order;
// 3. warp w sums rows w, w + kWarps, ..., each lane of the warp holding V
//    adjacent feature columns: it reads a row's sorted lanes kUnroll at a
//    time, issues their x[src] gathers together, then adds them in lane
//    order, each product and each add rounded once (__fmul_rn, __fadd_rn,
//    no FMA contraction), and writes the row once from registers. A later
//    pass carries a row's partial sum on from the value the same thread
//    wrote in the pass before (float stores are exact), so the sum stays
//    one sequence in lane order.
// No float atomics: two launches give bitwise-equal results, and each
// output is summed in the order of ops/scatter.py::in_order_slots /
// in_order_sum, so a plain version that adds in lane order agrees with the
// kernels bitwise.
//
// What bounds it: the gathers of x rows, 4 * E_valid * F bytes a batch
// element, mostly from L2 (the H100's L2 serves roughly 5-7 TB/s), and
// their latency: a warp has kUnroll gathers in flight. Two blocks of 16
// warps fit an SM (64 registers a thread, kMinBlocks) where their shared
// memory does (R * 64 + 8 * cap bytes a block: up to 512 rows at full
// passes), and then one block's sort overlaps another's gathers: the
// window and per-edge kernels at the sweep's point (B=64, N=512, F=128)
// run 512 or more blocks. The whole-list kernel there runs one block of
// 512 rows a (batch element, feature tile), 128 blocks, one an SM with
// none to overlap: splitting its rows into 256 blocks measured 13% slower
// on an H100, since each row tile reads and sorts all the lanes again. So
// plan() splits rows only while a call would fill under half the SMs, or
// when a tile's rows would not fit kMaxRows. x, the lanes and the output
// are read or written once per feature tile; a block reads its lanes once
// per row tile.
//
// Rounding (Round): kF32 adds each float32 message as it is. kBf16 rounds x
// to bf16 as it is read and each weighted message w * x to bf16 (round to
// nearest even, after a float32 product) before the float32 add: the two
// rounding points of the one-hot experiments' bf16 matmuls. kBf16Msg rounds
// only the message, as the pair kernel's bf16 pass does. The conversions go
// two floats at a time (cvt.rn.bf16x2.f32), which halves the conversion
// unit's share.

#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include <climits>
#include <cstdint>
#include <type_traits>

namespace sink_sort {

constexpr int kWarps = 16;
constexpr int kThreads = 32 * kWarps;
constexpr int kMinBlocks = 2;                  // blocks an SM: 64 registers
constexpr int kMaxLanes = 8192;                // lanes sorted per pass
constexpr int kRounds = kMaxLanes / kThreads;  // lanes a thread holds
constexpr int kMaxRows = 1024;                 // rows of a block's tile
constexpr int kUnroll = 4;                     // gathers in flight a warp
constexpr int kSMs = 132;                      // H100 SXM
constexpr int kBucketRows = 128;               // a pair bucket's window
static_assert((kWarps & (kWarps - 1)) == 0, "slot() swizzles by kWarps");

enum class Round { kF32, kBf16, kBf16Msg };
enum class Src { kDrop, kClamp, kBucket };

template <int V>
struct Vec {
  float v[V];
};

template <int V>
__device__ __forceinline__ Vec<V> load_x(const float* p) {
  Vec<V> r;
  if constexpr (V == 2) {
    const float2 t = __ldg(reinterpret_cast<const float2*>(p));
    r.v[0] = t.x, r.v[1] = t.y;
  } else {
    r.v[0] = __ldg(p);
  }
  return r;
}

// out is read back only by the thread that wrote it: a plain load
template <int V>
__device__ __forceinline__ Vec<V> load_out(const float* p) {
  Vec<V> r;
  if constexpr (V == 2) {
    const float2 t = *reinterpret_cast<const float2*>(p);
    r.v[0] = t.x, r.v[1] = t.y;
  } else {
    r.v[0] = *p;
  }
  return r;
}

template <int V>
__device__ __forceinline__ void store(float* p, const Vec<V>& a) {
  if constexpr (V == 2)
    *reinterpret_cast<float2*>(p) = make_float2(a.v[0], a.v[1]);
  else
    *p = a.v[0];
}

// a and b each rounded to bf16 (round to nearest even) and back
__device__ __forceinline__ float2 round_bf16x2(float a, float b) {
  return __bfloat1622float2(__floats2bfloat162_rn(a, b));
}

__device__ __forceinline__ float round_bf16(float a) {
  return __bfloat162float(__float2bfloat16_rn(a));
}

template <Round kRound, int V>
__device__ __forceinline__ void add_msg(Vec<V>& acc, float w,
                                        const Vec<V>& x) {
  if constexpr (kRound == Round::kF32) {
#pragma unroll
    for (int q = 0; q < V; ++q)
      acc.v[q] = __fadd_rn(acc.v[q], __fmul_rn(w, x.v[q]));
  } else if constexpr (kRound == Round::kBf16Msg && V == 1) {
    acc.v[0] = __fadd_rn(acc.v[0], round_bf16(__fmul_rn(w, x.v[0])));
  } else if constexpr (kRound == Round::kBf16Msg) {
    const float2 m = round_bf16x2(__fmul_rn(w, x.v[0]), __fmul_rn(w, x.v[1]));
    acc.v[0] = __fadd_rn(acc.v[0], m.x);
    acc.v[1] = __fadd_rn(acc.v[1], m.y);
  } else if constexpr (V == 1) {  // the message rounded twice, an f32 add
    acc.v[0] = __fadd_rn(acc.v[0],
                         round_bf16(__fmul_rn(w, round_bf16(x.v[0]))));
  } else {
    const float2 xr = round_bf16x2(x.v[0], x.v[1]);
    const float2 m = round_bf16x2(__fmul_rn(w, xr.x), __fmul_rn(w, xr.y));
    acc.v[0] = __fadd_rn(acc.v[0], m.x);
    acc.v[1] = __fadd_rn(acc.v[1], m.y);
  }
}

// The count of (row r, warp w) sits at slot(r, w): row-major, each row's
// kWarps counts permuted by r, so that one warp's counts of different rows
// fall in different banks. Logical index i = r * kWarps + w.
__device__ __forceinline__ int slot(int r, int w) {
  return r * kWarps + (w ^ (r & (kWarps - 1)));
}

__device__ __forceinline__ int slot_of(int i) {
  return slot(i / kWarps, i & (kWarps - 1));
}

// Exclusive prefix sums of hist's n counts in logical order, in place.
// Called by the whole block; ends with a barrier.
__device__ __forceinline__ void exclusive_scan(int* hist, int n,
                                               int* s_part) {
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int per = (n + kThreads - 1) / kThreads;
  const int lo = min(n, tid * per), hi = min(n, lo + per);
  int sum = 0;
  for (int i = lo; i < hi; ++i) sum += hist[slot_of(i)];
  int incl = sum;
#pragma unroll
  for (int d = 1; d < 32; d <<= 1) {
    const int t = __shfl_up_sync(0xffffffffu, incl, d);
    if (lane >= d) incl += t;
  }
  if (lane == 31) s_part[warp] = incl;
  __syncthreads();
  int run = incl - sum;
  for (int i = 0; i < warp; ++i) run += s_part[i];
  for (int i = lo; i < hi; ++i) {
    const int p = slot_of(i), c = hist[p];
    hist[p] = run;
    run += c;
  }
  __syncthreads();
}

struct Tile {
  const float* x;   // x[b], [N, F]
  const int* sink;  // the block's lanes, in lane order
  const int* src;
  const float* w;
  int n;            // lanes
  int base;         // a lane's tile row is sink - base
  int rows;         // rows in the tile
  int bucket;       // Src::kBucket: lanes a pair bucket holds
  float* out;       // the tile's first output row, column 0
};

// Shared memory: hist [rows * kWarps] ints, then s_src [cap] ints and s_w
// [cap] floats (Plan::smem); s_part [kWarps] ints. f: this thread's first
// feature column.
template <int V, Round kRound, Src kSrc>
__device__ __forceinline__ void sum_tile(const Tile& t, int N, int F, int f,
                                         int cap, int* hist, int* s_src,
                                         float* s_w, int* s_part) {
  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const unsigned below = (1u << lane) - 1u;
  const int n_hist = t.rows * kWarps;
  for (int c0 = 0; c0 < t.n; c0 += cap) {
    const int cn = min(cap, t.n - c0);
    // this warp's span of the pass: whole rounds of 32 lanes, in order
    const int per = (cn + kThreads - 1) / kThreads * 32;
    const int s0 = c0 + warp * per, s1 = min(c0 + cn, s0 + per);
    int key[kRounds];  // the lane's tile row, or -1: it adds nothing
#pragma unroll
    for (int k = 0; k < kRounds; ++k) {
      const int e = s0 + 32 * k + lane;
      key[k] = -1;
      if (e < s1) {  // both loads issued before either test
        const unsigned r = unsigned(__ldg(t.sink + e)) - unsigned(t.base);
        const bool src_ok =
            kSrc != Src::kDrop || unsigned(__ldg(t.src + e)) < unsigned(N);
        if (r < unsigned(t.rows) && src_ok) key[k] = int(r);
      }
    }
    __syncthreads();  // the last pass's rows are summed
    for (int i = tid; i < n_hist; i += kThreads) hist[i] = 0;
    __syncthreads();
#pragma unroll
    for (int k = 0; k < kRounds; ++k)
      if (key[k] >= 0) atomicAdd(hist + slot(key[k], warp), 1);
    __syncthreads();
    exclusive_scan(hist, n_hist, s_part);
    // place each lane at its (row, warp) cursor plus its rank in the round
#pragma unroll
    for (int k = 0; k < kRounds; ++k) {
      if (32 * k >= per) break;  // block-uniform
      const unsigned peers = __match_any_sync(0xffffffffu, key[k]);
      int* cursor = hist + slot(max(key[k], 0), warp);
      if (key[k] >= 0) {
        const int e = s0 + 32 * k + lane;
        const int pos = *cursor + __popc(peers & below);
        const int s = __ldg(t.src + e);
        if constexpr (kSrc == Src::kBucket) {
          // e counts from the tile's first lane, whatever the pass
          const int lo = e / t.bucket * kBucketRows;
          s_src[pos] = lo + min(max(s - lo, 0), kBucketRows - 1);
        } else {
          s_src[pos] = kSrc == Src::kClamp ? min(max(s, 0), N - 1) : s;
        }
        s_w[pos] = __ldg(t.w + e);
      }
      __syncwarp();
      if (key[k] >= 0 && (peers & below) == 0) *cursor += __popc(peers);
      __syncwarp();
    }
    __syncthreads();
    // each (row, warp) cursor now holds the start of the next: row r's
    // lanes end at its last warp's cursor
    if (f >= F) continue;
    for (int r = warp; r < t.rows; r += kWarps) {
      const int beg = r ? hist[slot(r - 1, kWarps - 1)] : 0;
      const int end = hist[slot(r, kWarps - 1)];
      if (c0 && beg == end) continue;  // its partial sum stands
      float* orow = t.out + size_t(r) * F + f;
      Vec<V> acc;
      if (c0) {
        acc = load_out<V>(orow);
      } else {
#pragma unroll
        for (int q = 0; q < V; ++q) acc.v[q] = 0.0f;
      }
      for (int k = beg; k < end; k += kUnroll) {
        Vec<V> xv[kUnroll];
        float wv[kUnroll];
#pragma unroll
        for (int u = 0; u < kUnroll; ++u) {
          if (k + u < end) {
            wv[u] = s_w[k + u];
            xv[u] = load_x<V>(t.x + size_t(s_src[k + u]) * F + f);
          }
        }
#pragma unroll
        for (int u = 0; u < kUnroll; ++u)
          if (k + u < end) add_msg<kRound>(acc, wv[u], xv[u]);
      }
      store<V>(orow, acc);
    }
  }
}

// How a call is cut into blocks; the kernels take it as their last argument.
struct Plan {
  int V;          // feature columns a lane holds: 1 or 2
  int ftiles;     // feature tiles of 32 * V columns
  int R;          // rows of a block's tile
  int rtiles;     // row tiles of one group of rows
  int cap;        // lanes sorted per pass
  size_t smem;    // dynamic shared memory a block
  size_t blocks;  // groups * rtiles * ftiles
};

// groups: independent sets of `rows` output rows (a batch element's graph,
// one of its 128-row windows, a sink block), each with `lanes` lanes. V is
// 2 (float2 columns) where F is even, at least 128 (two tiles of 64
// columns) and x and out are 8-byte aligned, else 1. Rows go in tiles of at
// most kMaxRows, halved while the blocks would fill under half the SMs and
// the tile keeps 64 rows or more (a tile of 128 rows or less halves into
// tiles that divide it). Lanes go in passes of at most kMaxLanes.
inline Plan plan(int F, int rows, long long groups, int lanes,
                 const void* x, const void* out) {
  Plan p;
  const uintptr_t align =
      reinterpret_cast<uintptr_t>(x) | reinterpret_cast<uintptr_t>(out);
  p.V = F % 2 == 0 && F >= 128 && align % 8 == 0 ? 2 : 1;
  p.ftiles = (F + 32 * p.V - 1) / (32 * p.V);
  p.R = rows < kMaxRows ? rows : kMaxRows;
  for (;;) {
    p.rtiles = (rows + p.R - 1) / p.R;
    p.blocks = size_t(groups) * p.rtiles * p.ftiles;
    if (2 * p.blocks > size_t(kSMs) || p.R < 64) break;
    p.R = (p.R + 1) / 2;
  }
  p.cap = lanes < kMaxLanes ? lanes : kMaxLanes;
  p.smem = sizeof(int) * (size_t(p.R) * kWarps + 2 * size_t(p.cap));
  return p;
}

// Calls f(std::integral_constant<int, V>) for the plan's V and returns
// what it returns: the one place a plan picks a kernel's instantiation.
template <typename Fn>
inline int with_width(const Plan& p, Fn&& f) {
  if (p.V == 2) return f(std::integral_constant<int, 2>());
  return f(std::integral_constant<int, 1>());
}

// Launches k(args..., p) on a grid of (blocks / B, B) blocks of kThreads,
// with the plan's dynamic shared memory (allowed above the default 48 KB
// where it and the kernel's static shared memory need more: a plan of
// exactly 48 KB, e.g. 256 rows and 4,096 lanes, plus the kernels' s_part
// would otherwise fail to launch); returns a cudaError_t code (0 on
// success).
template <typename Kernel, typename... Args>
inline int launch(Kernel k, const Plan& p, int B, cudaStream_t stream,
                  Args... args) {
  if (p.blocks / B > size_t(INT_MAX)) return int(cudaErrorInvalidValue);
  if (p.smem > 32 * 1024) {
    cudaFuncAttributes attr;
    cudaError_t err = cudaFuncGetAttributes(&attr, k);
    if (err != cudaSuccess) return int(err);
    if (p.smem + attr.sharedSizeBytes > 48 * 1024) {
      err = cudaFuncSetAttribute(
          k, cudaFuncAttributeMaxDynamicSharedMemorySize, int(p.smem));
      if (err != cudaSuccess) return int(err);
    }
  }
  k<<<dim3(unsigned(p.blocks / B), B), kThreads, p.smem, stream>>>(args...,
                                                                     p);
  return int(cudaGetLastError());
}

}  // namespace sink_sort
