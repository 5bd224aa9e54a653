// Edge weight-gradient of the SpMMs for Hopper (sm_90a):
//   dw[b, e] = sum over f of g[b, sink_e, f] * x[b, src_e, f]
// on lanes with sink_e >= 0 and src_e >= 0 (both clamped to at most N - 1,
// as gather_nodes clamps them), 0 on every other lane.
//
// Replaces the gather-dot the JAX package computes with XLA in the
// backwards of its SpMMs: gcm_tpu/ops/dispatch.py::_spmm_bwd (dw) and
// gcm_tpu/ops/pallas/spmm_slots.py::_bwd, which the port's spmm_pairs and
// spmm_seg backwards share.
//
// What bounds it on an H100: bytes. Every valid lane reads two rows of F
// floats and its two indices and writes one float. g and x are read at
// least once (33.5 MB at the SpMM sweep's point, B=64, N=512, F=128), but
// a lane's rows are gathered: there each row is wanted by E/N = 16 lanes,
// and a warp that gathers both rows of one lane at a time moves ~537 MB
// through L2 with one lane's rows in flight.
// In practice the gathers' latency bounds it: how many rows are in flight.
//
// The design (timed against other layouts on an H100 in development; the
// choice and its reasons):
// 1. A block owns a tile of sink rows of one batch element and a split of
//    the element's lanes (a span in lane order); grid (tiles * splits, B).
//    Its warps take rounds of 32 lanes (rounds w, w + 8, ...; the next
//    round's sinks and sources loaded while this one's rows are gathered)
//    and queue the lanes whose clamped sink lies in the tile, in shared
//    memory (a ballot and its prefix). A lane with a negative index is
//    written 0 by the blocks of tile 0 and costs nothing else.
// 2. Eight threads take a queued lane: thread t reads columns 32k + 4t ..
//    32k + 4t + 3 of its x row and of its g row (a float4 where F % 4 == 0
//    and the rows are 16-byte aligned, else four scalar loads), so a warp
//    carries four lanes and each group U of them at once: U * C quads of
//    each row issued before their adds (U = 8, C = 1 where F <= 32; U = 2,
//    C = 4 above: eight quads of x and eight of g in flight a thread, at
//    most 124 registers, two blocks an SM, no spill).
// 3. g rows come through L1 and x rows through L2. Where a block's lanes
//    share sink rows, each g row is fetched from L2 about once a block:
//    within a tile (rows * F * 4 <= kTileBytes, the whole element at the
//    sweep's point) and most of all where the lanes come in sink order, as
//    the pair buckets of spmm_pairs' backward do (each split of 4,096 lanes
//    one 128-row sink window). Smaller tiles (64 or 128 KB) are faster on
//    a raw list of random sinks but slower on the pair and segment
//    buckets the main path hands the kernel (by_plan in chip_smoke.py):
//    each tile's blocks read every lane's index, and a bucket's lanes all
//    fall in one tile, leaving the other tiles' blocks only scanning.
//    Staging the tile in shared memory with cp.async measured slower:
//    shared memory cut the blocks an SM, and a split stages its whole tile
//    for the rows it touches.
// 4. dw has no sum across lanes, so how lanes are split over blocks does
//    not touch a result: a hot sink is spread over the splits of its tile.
//    splits is chosen from the shape so that the grid holds about
//    kBlocksPerSm blocks an SM (plan()).
// 5. Calls of fewer than kMinTiledLanes lanes (B * E), and calls with
//    N * F of 2^31 or more (a row's offset within an element is an int in
//    the tiled kernel), take a warp a lane instead: thread t holds part t,
//    both rows come from L2, and each lane is its own warp, spread over
//    the grid. A small call has too few lanes for a tile's reuse of g to
//    pay for its index scan and queue; there a warp a lane is the shorter
//    chain of loads. The threshold sits where the two cross on an H100:
//    chip_smoke.py runs the cases of EDGE_GRAD_CASES near it on the other
//    route too (a forced plan, by_plan): a warp a lane is the faster at 80,
//    1,554 and 8,192 lanes (F = 16,387, 13 and 260), the tiled kernel at
//    16,384 lanes and more.
//
// The order of the sum, fixed by F alone (the same for every plan, tile,
// split, route and SM count): column f goes to part f % 32; each part adds
// its columns in ascending order from 0 (one rounding per product and per
// add: __fmul_rn, __fadd_rn, no contraction); then the 32 parts are added
// by halves, part p + part p + 16 for p < 16, then p + 8, p + 4, p + 2,
// p + 1. In the tiled kernel thread t of a lane's group holds parts 4t ..
// 4t + 3, so the first three halvings are shuffles within the group of
// eight (offsets 4, 2, 1) and the last two adds in thread 0; a warp a lane
// shuffles all five.
// No atomics: the plain version (ops/cuda/edge_grad.py::
// edge_weight_grad_plain) adds in the same order, so the two agree bitwise.
//
// One kernel a call.

#include <cuda_runtime.h>

#include <cstdint>

#include "sm_count.cuh"

namespace {

constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;
constexpr int kGroup = 8;                    // threads a lane
constexpr int kGroups = 32 / kGroup;         // lanes a warp carries at once
constexpr int kTileBytes = 256 * 1024;       // g rows of a tile, at most
constexpr long long kMinTiledLanes = 16384;  // fewer lanes: a warp a lane
constexpr int kBlocksPerSm = 2;              // the grid, about
constexpr int kMinSpan = 128;                // lanes a split, at least
constexpr int kNarrowU = 8;                  // U where F <= 32 (C = 1)
constexpr int kWideU = 2, kWideC = 4;        // U and C where F > 32
constexpr int kQueue = 64, kQMask = kQueue - 1;  // a warp's queued lanes
constexpr int kMinBlocks = 2;                // blocks an SM: 128 registers
constexpr unsigned kFull = 0xffffffffu;

struct Plan {
  int rows, tiles, splits, span;  // sink rows a tile, lanes a split
  int lanes;                      // lanes a group carries at once (U)
  int tiled;                      // 0: a warp a lane
};

// tile_bytes and splits of 0 take the planner's choice. Either above 0
// asks for the tiled kernel, tile_bytes < 0 for a warp a lane; N * F of
// 2^31 or more always takes a warp a lane.
Plan plan(int B, int N, int F, int E, int sms, int tile_bytes, int splits) {
  Plan p;
  const bool forced = tile_bytes != 0 || splits > 0;
  p.tiled = (long long)N * F < (1LL << 31) &&
            (forced ? tile_bytes >= 0 : (long long)B * E >= kMinTiledLanes);
  if (!p.tiled) {
    p.rows = N, p.tiles = 1, p.splits = 1, p.span = E, p.lanes = 1;
    return p;
  }
  const long long row_bytes = 4LL * F;
  const long long rows =
      (tile_bytes > 0 ? tile_bytes : kTileBytes) / row_bytes;
  p.rows = (int)(rows < 1 ? 1 : rows < N ? rows : N);
  p.tiles = (N + p.rows - 1) / p.rows;
  if (splits <= 0) {
    const long long have = (long long)B * p.tiles;
    const long long want = (long long)kBlocksPerSm * sms;
    const int most = (E + kMinSpan - 1) / kMinSpan;
    splits = (int)(have >= want ? 1 : want / have);
    if (splits > most) splits = most;
  }
  if (splits > (E + 31) / 32) splits = (E + 31) / 32;
  p.span = ((E + splits - 1) / splits + 31) & ~31;
  p.splits = (E + p.span - 1) / p.span;
  p.lanes = F <= 32 ? kNarrowU : kWideU;
  return p;
}

// columns col .. col + 3 of a row, at p (zeros past F where not kVec: a
// column that is not there adds nothing)
template <bool kVec>
__device__ __forceinline__ float4 quad(const float* p, int col, int F) {
  if constexpr (kVec) {
    return __ldg(reinterpret_cast<const float4*>(p));
  } else {
    float v[4];
#pragma unroll
    for (int j = 0; j < 4; ++j) v[j] = col + j < F ? __ldg(p + j) : 0.f;
    return make_float4(v[0], v[1], v[2], v[3]);
  }
}

__device__ __forceinline__ void add_products(float* acc, float4 a, float4 b,
                                             int col, int F, bool vec) {
  // acc[j] holds part (col + j) % 32: a column past F adds nothing
  if (vec || col + 0 < F) acc[0] = __fadd_rn(acc[0], __fmul_rn(a.x, b.x));
  if (vec || col + 1 < F) acc[1] = __fadd_rn(acc[1], __fmul_rn(a.y, b.y));
  if (vec || col + 2 < F) acc[2] = __fadd_rn(acc[2], __fmul_rn(a.z, b.z));
  if (vec || col + 3 < F) acc[3] = __fadd_rn(acc[3], __fmul_rn(a.w, b.w));
}

struct Lane {
  int e;    // the lane
  int src;  // its source, clamped
  int row;  // its sink, clamped, less the tile's first row
};

// Lanes q[(head + 4u + group) % kQueue] for 4u + group < n (u < U) of this
// warp's queue, each summed by its group of eight and written to dw; gt is
// the tile's first g row.
template <int U, int C, bool kVec>
__device__ __forceinline__ void dots(const Lane* q, int head, int n,
                                     const float* xb, const float* gt,
                                     float* dwb, int F) {
  const int lane = threadIdx.x & 31, grp = lane >> 3, t = lane & 7;
  int xo[U], go[U];  // the rows' offsets from xb and gt (N * F < 2^31)
  bool on[U];
#pragma unroll
  for (int u = 0; u < U; ++u) {
    on[u] = u * kGroups + grp < n;
    const Lane l = q[(head + (on[u] ? u * kGroups + grp : 0)) & kQMask];
    xo[u] = l.src * F + 4 * t;
    go[u] = l.row * F + 4 * t;
  }
  float acc[U][4];
#pragma unroll
  for (int u = 0; u < U; ++u)
#pragma unroll
    for (int j = 0; j < 4; ++j) acc[u][j] = 0.f;
  // C == 1 only where F <= 32 (plan()): one pass
#pragma unroll 1
  for (int k0 = 0; C == 1 ? k0 < 1 : 32 * k0 < F; k0 += C) {
    float4 xv[U][C], gv[U][C];
#pragma unroll
    for (int u = 0; u < U; ++u)
#pragma unroll
      for (int c = 0; c < C; ++c) {
        const int k = 32 * (k0 + c), col = k + 4 * t;
        const bool in = on[u] && col < F;
        const float4 zero = make_float4(0.f, 0.f, 0.f, 0.f);
        xv[u][c] = in ? quad<kVec>(xb + xo[u] + k, col, F) : zero;
        gv[u][c] = in ? quad<kVec>(gt + go[u] + k, col, F) : zero;
      }
#pragma unroll
    for (int u = 0; u < U; ++u)
#pragma unroll
      for (int c = 0; c < C; ++c) {
        const int col = 32 * (k0 + c) + 4 * t;
        if (on[u] && col < F)
          add_products(acc[u], gv[u][c], xv[u][c], col, F, kVec);
      }
  }
#pragma unroll
  for (int u = 0; u < U; ++u) {
    float* a = acc[u];
#pragma unroll
    for (int off = 4; off > 0; off >>= 1)  // parts + 16, + 8, + 4
#pragma unroll
      for (int j = 0; j < 4; ++j)
        a[j] = __fadd_rn(a[j], __shfl_down_sync(kFull, a[j], off, kGroup));
    if (t == 0 && on[u])  // parts + 2, then + 1
      dwb[q[(head + u * kGroups + grp) & kQMask].e] =
          __fadd_rn(__fadd_rn(a[0], a[2]), __fadd_rn(a[1], a[3]));
  }
}

template <int U, int C, bool kVec>
__global__ void __launch_bounds__(kThreads, kMinBlocks)
    edge_weight_grad_kernel(const float* __restrict__ g,
                            const float* __restrict__ x,
                            const int* __restrict__ edges,
                            float* __restrict__ dw, int N, int F, int E,
                            Plan p) {
  static_assert(U * kGroups + 32 <= kQueue, "a round must fit the queue");
  constexpr int kStride = 32 * kWarps;  // from a warp's round to its next
  __shared__ Lane queue[kWarps][kQueue];
  const int b = blockIdx.y;
  const int tile = blockIdx.x / p.splits;
  const int split = blockIdx.x - tile * p.splits;
  const int r0 = tile * p.rows;
  const int nrows = min(p.rows, N - r0);
  const long long bN = (long long)b * N;
  const float* gt = g + (bN + r0) * F;
  const float* xb = x + bN * F;
  const int* sinks = edges + 2 * (long long)b * E;
  const int* srcs = sinks + E;
  float* dwb = dw + (long long)b * E;
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int l1 = min(E, (split + 1) * p.span);
  Lane* q = queue[warp];

  int e = split * p.span + 32 * warp + lane;
  int sink = e < l1 ? __ldg(sinks + e) : -1;
  int src = e < l1 ? __ldg(srcs + e) : -1;
  int head = 0, n = 0;  // the queue: n lanes from q[head], warp-uniform
  for (int base = e - lane; base < l1; base += kStride, e += kStride) {
    const int en = e + kStride;  // the warp's next round, in flight
    const int sink_n = en < l1 ? __ldg(sinks + en) : -1;
    const int src_n = en < l1 ? __ldg(srcs + en) : -1;
    const bool valid = sink >= 0 && src >= 0;
    const int row = min(sink, N - 1) - r0;
    const bool mine = valid && row >= 0 && row < nrows;
    if (e < l1 && !valid && tile == 0) dwb[e] = 0.f;
    const unsigned m = __ballot_sync(kFull, mine);
    if (mine)
      q[(head + n + __popc(m & ((1u << lane) - 1u))) & kQMask] =
          Lane{e, min(src, N - 1), row};
    n += __popc(m);
    __syncwarp();
    for (; n >= U * kGroups; n -= U * kGroups) {
      dots<U, C, kVec>(q, head, U * kGroups, xb, gt, dwb, F);
      head = (head + U * kGroups) & kQMask;
    }
    __syncwarp();
    sink = sink_n;
    src = src_n;
  }
  if (n) dots<U, C, kVec>(q, head, n, xb, gt, dwb, F);
}

// A warp a lane, thread t holding part t, both rows read from L2
// (grid-stride): small calls, and calls too large for the tiled kernel.
__global__ void __launch_bounds__(kThreads) edge_weight_grad_lane_kernel(
    const float* __restrict__ g, const float* __restrict__ x,
    const int* __restrict__ edges, float* __restrict__ dw, int N, int F,
    int E, long long lanes) {
  const int lane = threadIdx.x & 31;
  const long long step = (long long)gridDim.x * kWarps;
  for (long long w = (long long)blockIdx.x * kWarps + (threadIdx.x >> 5);
       w < lanes; w += step) {
    const long long b = w / E;
    const int e = (int)(w - b * E);
    const int* eb = edges + b * 2 * E;
    const int sink = __ldg(eb + e), src = __ldg(eb + E + e);
    float acc = 0.f;
    if (sink >= 0 && src >= 0) {  // the same for the whole warp
      const float* gr = g + (b * N + min(sink, N - 1)) * F;
      const float* xr = x + (b * N + min(src, N - 1)) * F;
      for (int f = lane; f < F; f += 32)
        acc = __fadd_rn(acc, __fmul_rn(__ldg(gr + f), __ldg(xr + f)));
#pragma unroll
      for (int off = 16; off > 0; off >>= 1)  // parts + 16, + 8, ..., + 1
        acc = __fadd_rn(acc, __shfl_down_sync(kFull, acc, off));
    }
    if (lane == 0) dw[w] = acc;
  }
}

template <int U, int C, bool kVec>
cudaError_t launch(const float* g, const float* x, const int* edges,
                   float* dw, int B, int N, int F, int E, const Plan& p,
                   cudaStream_t stream) {
  edge_weight_grad_kernel<U, C, kVec>
      <<<dim3(p.tiles * p.splits, B), kThreads, 0, stream>>>(
          g, x, edges, dw, N, F, E, p);
  return cudaGetLastError();
}

bool valid_sizes(int B, int N, int F, int E) {
  return B >= 1 && B <= 65535 && N >= 1 && F >= 1 && E >= 1;
}

}  // namespace

extern "C" {

// The plan of a call: out[0..5] = rows a tile, tiles, splits, lanes a
// split, lanes a group carries at once (U; 1: a warp a lane), tiled (0/1).
// tile_bytes and splits as in plan(). Returns a CUDA error code.
int gcm_edge_weight_grad_plan(int B, int N, int F, int E, int tile_bytes,
                              int splits, int device, int* out) {
  if (!valid_sizes(B, N, F, E)) return cudaErrorInvalidValue;
  const Plan p = plan(B, N, F, E, sm_count(device), tile_bytes, splits);
  const int v[6] = {p.rows, p.tiles, p.splits, p.span, p.lanes, p.tiled};
  for (int i = 0; i < 6; ++i) out[i] = v[i];
  return cudaSuccess;
}

// g, x [B,N,F] f32, edges [B,2,E] int32 (row 0 sink, row 1 source), dw
// [B,E] f32, on the plan that tile_bytes and splits ask for (as in plan();
// 0: the planner's). Returns a CUDA error code.
int gcm_edge_weight_grad_f32_plan(const void* g, const void* x,
                                  const void* edges, void* dw, int B, int N,
                                  int F, int E, int tile_bytes, int splits,
                                  int device, void* stream) {
  if (!valid_sizes(B, N, F, E)) return cudaErrorInvalidValue;
  const Plan p = plan(B, N, F, E, sm_count(device), tile_bytes, splits);
  const bool vec = F % 4 == 0 && reinterpret_cast<uintptr_t>(g) % 16 == 0 &&
                   reinterpret_cast<uintptr_t>(x) % 16 == 0;
  const auto* gf = static_cast<const float*>(g);
  const auto* xf = static_cast<const float*>(x);
  const auto* ef = static_cast<const int*>(edges);
  auto* df = static_cast<float*>(dw);
  const auto s = static_cast<cudaStream_t>(stream);
  if (!p.tiled) {
    const long long lanes = (long long)B * E;
    const long long want = (lanes + kWarps - 1) / kWarps;
    const long long cap = (long long)sm_count(device) * 16;
    edge_weight_grad_lane_kernel<<<(int)(want < cap ? want : cap), kThreads,
                                   0, s>>>(gf, xf, ef, df, N, F, E, lanes);
    return cudaGetLastError();
  }
  if (p.lanes == kNarrowU)
    return vec ? launch<kNarrowU, 1, true>(gf, xf, ef, df, B, N, F, E, p, s)
               : launch<kNarrowU, 1, false>(gf, xf, ef, df, B, N, F, E, p, s);
  return vec ? launch<kWideU, kWideC, true>(gf, xf, ef, df, B, N, F, E, p, s)
             : launch<kWideU, kWideC, false>(gf, xf, ef, df, B, N, F, E, p, s);
}

// The same on the planner's plan.
int gcm_edge_weight_grad_f32(const void* g, const void* x, const void* edges,
                             void* dw, int B, int N, int F, int E,
                             int device, void* stream) {
  return gcm_edge_weight_grad_f32_plan(g, x, edges, dw, B, N, F, E, 0, 0,
                                       device, stream);
}

}  // extern "C"
