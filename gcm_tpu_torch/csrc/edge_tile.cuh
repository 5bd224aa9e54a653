// The edge-list tile kernel shared by csrc/spmm.cu (spmm_edge_list,
// spmm_onehot_dtype) and csrc/spmm_win.cu (spmm_win): f32 in and out.
//
//   out[b, i, :] = sum over the lanes e a block reads with sink_e = i
//                  of w_e * x[b, src_e, :]
// for x [B,N,F], edges [B,2,L] int32 (row 0 sink, row 1 source), w [B,L].
// A lane adds nothing unless 0 <= sink < N and 0 <= src < N, so the -1
// sentinel (and any index of N or more) drops out. The block that owns sink
// rows row0 .. row0+kRows-1 reads the `seg` lanes from lane
// (row0 / kWindow) * seg_stride: the whole list (seg = L, seg_stride = 0),
// or the segment of its window of kWindow = 128 rows (seg = seg_stride =
// cap).
//
// The design: one block owns one batch element, a tile of kRows sink rows
// and kFeat feature columns. It streams its lanes in chunks of kChunk;
// each chunk is compacted in shared memory (warp ballots, order kept) to
// the lanes whose sink falls in the tile, and the warp that owns that sink
// row adds w * x[src] to its registers, each lane holding up to 4 feature
// columns of up to 4 rows. Every output element is summed by one thread in
// lane order and written once: no atomics, so two launches give
// bitwise-equal results. Each message is w * x rounded to float32 and each
// add rounded (__fmul_rn, __fadd_rn: no FMA contraction), in lane order, so
// a plain version that adds in the same order agrees with it bitwise. The
// row tiles of a batch element (or window) each re-read its lanes; a
// sink-sorted (CSR) pass would not, and is left to a later version.
//
// With kBf16 set, x is rounded to bf16 as it is read, each weighted message
// w * x is rounded to bf16 (round to nearest even, after a float32 product),
// and the messages are summed in float32: the two rounding points of the
// one-hot experiments' bf16 matmuls.

#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>

namespace edge_tile {

constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;
constexpr int kRows = 32;                      // sink rows per block
constexpr int kRowsPerWarp = kRows / kWarps;   // warp w owns rows w + 8 j
constexpr int kColsPerLane = 4;
constexpr int kFeat = 32 * kColsPerLane;       // feature columns per block
constexpr int kChunk = kThreads;               // edge lanes staged per round
constexpr int kWindow = 128;                   // rows per segment window
static_assert(kWindow % kRows == 0, "a row tile lies inside one window");

__device__ __forceinline__ float round_bf16(float v) {
  return __bfloat162float(__float2bfloat16_rn(v));
}

template <bool kBf16>
__global__ void __launch_bounds__(kThreads)
kernel(const float* __restrict__ x, const int* __restrict__ edges,
       const float* __restrict__ w, float* __restrict__ out, int N, int F,
       int L, int seg, int seg_stride) {
  __shared__ int s_row[kChunk];
  __shared__ int s_src[kChunk];
  __shared__ float s_w[kChunk];
  __shared__ int s_count[kWarps];

  const int b = blockIdx.z;
  const int row0 = blockIdx.x * kRows;
  const int f0 = blockIdx.y * kFeat;
  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const size_t lane0 = size_t(row0 / kWindow) * seg_stride;
  const int* sink_b = edges + size_t(b) * 2 * L + lane0;
  const int* src_b = sink_b + L;
  const float* w_b = w + size_t(b) * L + lane0;
  const float* x_b = x + size_t(b) * N * F;

  float acc[kRowsPerWarp][kColsPerLane];
#pragma unroll
  for (int r = 0; r < kRowsPerWarp; ++r)
#pragma unroll
    for (int q = 0; q < kColsPerLane; ++q) acc[r][q] = 0.0f;

  for (int base = 0; base < seg; base += kChunk) {
    // compact this chunk to the lanes that land in the tile, in lane order
    const int e = base + tid;
    int r = 0, s = 0;
    float wt = 0.0f;
    bool keep = false;
    if (e < seg) {
      const int sink = sink_b[e];
      s = src_b[e];
      r = sink - row0;
      keep = sink >= 0 && sink < N && r >= 0 && r < kRows && s >= 0 && s < N;
      if (keep) wt = w_b[e];
    }
    const unsigned ballot = __ballot_sync(0xffffffffu, keep);
    if (lane == 0) s_count[warp] = __popc(ballot);
    __syncthreads();
    int offset = 0, total = 0;
#pragma unroll
    for (int i = 0; i < kWarps; ++i) {
      const int c = s_count[i];
      offset += i < warp ? c : 0;
      total += c;
    }
    if (keep) {
      const int j = offset + __popc(ballot & ((1u << lane) - 1u));
      s_row[j] = r;
      s_src[j] = s;
      s_w[j] = wt;
    }
    __syncthreads();

    // each warp adds the lanes whose sink row it owns (a warp-uniform test)
    for (int j = 0; j < total; ++j) {
      const int rr = s_row[j];
      if ((rr % kWarps) != warp) continue;
      const int slot = rr / kWarps;
      const float wj = s_w[j];
      const float* xrow = x_b + size_t(s_src[j]) * F;
#pragma unroll
      for (int q = 0; q < kColsPerLane; ++q) {
        const int f = f0 + lane + 32 * q;
        if (f < F) {
          const float xv = __ldg(xrow + f);
#pragma unroll
          for (int sl = 0; sl < kRowsPerWarp; ++sl) {
            if (sl != slot) continue;
            if constexpr (kBf16)  // the message rounded twice, an f32 add
              acc[sl][q] = __fadd_rn(
                  acc[sl][q], round_bf16(__fmul_rn(wj, round_bf16(xv))));
            else
              acc[sl][q] = __fadd_rn(acc[sl][q], __fmul_rn(wj, xv));
          }
        }
      }
    }
    __syncthreads();  // the staging arrays are rewritten by the next chunk
  }

#pragma unroll
  for (int sl = 0; sl < kRowsPerWarp; ++sl) {
    const int row = row0 + warp + kWarps * sl;
    if (row >= N) continue;
    float* orow = out + (size_t(b) * N + row) * F;
#pragma unroll
    for (int q = 0; q < kColsPerLane; ++q) {
      const int f = f0 + lane + 32 * q;
      if (f < F) orow[f] = acc[sl][q];
    }
  }
}

// Launches the kernel over B batch elements and N rows on `stream`;
// returns a cudaError_t code (0 on success).
inline int launch(bool bf16, const void* x, const void* edges, const void* w,
                  void* out, int B, int N, int F, int L, int seg,
                  int seg_stride, int device, void* stream) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return int(err);
  const dim3 grid((N + kRows - 1) / kRows, (F + kFeat - 1) / kFeat, B);
  auto k = bf16 ? kernel<true> : kernel<false>;
  k<<<grid, kThreads, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float*>(x), static_cast<const int*>(edges),
      static_cast<const float*>(w), static_cast<float*>(out), N, F, L, seg,
      seg_stride);
  return int(cudaGetLastError());
}

}  // namespace edge_tile
