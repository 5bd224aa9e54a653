// The edge-list kernel shared by csrc/spmm.cu (spmm_edge_list,
// spmm_onehot_dtype) and csrc/spmm_win.cu (spmm_win): f32 in and out.
//
//   out[b, i, :] = sum over the lanes e a block reads with sink_e = i
//                  of w_e * x[b, src_e, :]
// for x [B,N,F], edges [B,2,L] int32 (row 0 sink, row 1 source), w [B,L].
// A lane adds nothing unless 0 <= sink < N and 0 <= src < N, so the -1
// sentinel (and any index of N or more) drops out. The block that owns sink
// rows row0 .. row0+R-1 reads the `seg` lanes from lane
// (row0 / kWindow) * seg_stride: the whole list (seg = L, seg_stride = 0),
// or the segment of its window of kWindow = 128 rows (seg = seg_stride =
// cap).
//
// The design: the sink-sorted row sum of sink_sort.cuh. A block owns one
// batch element, a tile of sink rows (the whole graph up to 1,024 rows, or
// one window) and a tile of feature columns; it reads its lanes once, sorts
// them by sink row in shared memory (stable: a row's lanes stay in lane
// order), and each warp sums whole rows in registers, several gathers in
// flight, writing each output once. Every output is summed in lane order,
// each product and add rounded once, with no atomics on floats, so reruns
// are bitwise equal and the plain versions, which add in lane order, agree
// bitwise. At the sweep's point (B=64, N=512, E=8192, F=128) each batch
// element's lanes are read once per feature tile of 64 columns (128
// blocks, one an SM), and each window's segment once per feature tile (512
// blocks, two an SM): the row gathers from L2 bound it.

#pragma once

#include "sink_sort.cuh"

namespace edge_tile {

constexpr int kWindow = 128;  // rows per segment window

template <int V, bool kBf16>
__global__ void __launch_bounds__(sink_sort::kThreads, sink_sort::kMinBlocks)
kernel(const float* __restrict__ x, const int* __restrict__ edges,
       const float* __restrict__ w, float* __restrict__ out, int N, int F,
       int L, int seg, int seg_stride, const sink_sort::Plan p) {
  extern __shared__ int smem[];
  __shared__ int s_part[sink_sort::kWarps];
  const int b = blockIdx.y;
  const int ft = blockIdx.x % p.ftiles, row0 = blockIdx.x / p.ftiles * p.R;
  const size_t lane0 = size_t(row0 / kWindow) * seg_stride;
  sink_sort::Tile t;
  t.x = x + size_t(b) * N * F;
  t.sink = edges + size_t(b) * 2 * L + lane0;
  t.src = t.sink + L;
  t.w = w + size_t(b) * L + lane0;
  t.n = seg;
  t.base = row0;
  t.rows = min(p.R, N - row0);
  t.out = out + (size_t(b) * N + row0) * F;
  int* s_src = smem + p.R * sink_sort::kWarps;
  const int f = (ft * 32 + (threadIdx.x & 31)) * V;
  constexpr sink_sort::Round kRound =
      kBf16 ? sink_sort::Round::kBf16 : sink_sort::Round::kF32;
  sink_sort::sum_tile<V, kRound, sink_sort::Src::kDrop>(
      t, N, F, f, p.cap, smem, s_src, reinterpret_cast<float*>(s_src + p.cap),
      s_part);
}

// Launches the kernel over B batch elements and N rows on `stream`;
// returns a cudaError_t code (0 on success). seg_stride > 0: window mode
// (N a multiple of kWindow).
inline int launch(bool bf16, const void* x, const void* edges, const void* w,
                  void* out, int B, int N, int F, int L, int seg,
                  int seg_stride, int device, void* stream) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return int(err);
  const bool windows = seg_stride > 0;
  const sink_sort::Plan p = sink_sort::plan(
      F, windows ? kWindow : N,
      windows ? (long long)B * (N / kWindow) : B, seg, x, out);
  return sink_sort::with_width(p, [&](auto v) {
    constexpr int V = decltype(v)::value;
    return sink_sort::launch(bf16 ? kernel<V, true> : kernel<V, false>, p, B,
                             static_cast<cudaStream_t>(stream),
                             static_cast<const float*>(x),
                             static_cast<const int*>(edges),
                             static_cast<const float*>(w),
                             static_cast<float*>(out), N, F, L, seg,
                             seg_stride);
  });
}

}  // namespace edge_tile
