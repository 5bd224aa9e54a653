// Pair-window bucketed SpMM for Hopper (sm_90a).
//
// Replaces the Pallas kernel gcm_tpu/ops/pallas/spmm2.py::spmm_pairs_T:
//   out[b, i, :] = sum over lanes e with sink_e = i of w_e * x[b, src_e, :]
// over an edge list grouped into (sink window ks, source window kc) pair
// buckets of W = 128 nodes: edges [B,2,P*cap] int32 (row 0 sink, row 1
// source), w [B,P*cap], P = nw * nw with nw = N / W, bucket p = ks * nw + kc
// holding lanes p*cap .. p*cap+cap-1. As in the Pallas kernel, a lane of
// bucket (ks, kc) adds to out row `sink` only if that row lies in window ks
// (so the -1 sentinel and any sink of N or more drop out), and it reads the
// source row kc*W + clamp(src - kc*W, 0, W-1): a source outside window kc
// is clamped into it, not dropped. x and out are [B,N,F] here; the TPU
// kernel's transposed [B,F,N] layout served its lane gathers.
//
// Modes: f32x2 computes in float32, each message w * x and each add
// rounded once (__fmul_rn, __fadd_rn), in lane order (the TPU's hi+lo bf16
// pair approximated a float32 sum; float32 is at least as exact), so the
// plain version, which adds in the same order, agrees with it bitwise. bf16
// rounds each f32 message w*x to bf16 (round to nearest even) before the
// float32 sum, the rounding of the TPU kernel's single bf16 pass.
//
// What bounds it on an H100: the function reads x and the bucketed lanes
// once, 4*B*(N*F + 3*P*cap) bytes, and writes out once, 4*B*N*F bytes,
// against 2*B*E_valid*F flops: bound by bytes (~13.8 us at B=64, N=512,
// F=128, cap=1024).
//
// What the design does about it: the design of csrc/spmm.cu (one block per
// batch element, tile of kRows sink rows and kFeat feature columns; lanes
// compacted in shared memory with warp ballots, order kept; the warp that
// owns a sink row sums it in registers), with each block reading only the
// nw buckets of its own sink window, kc ascending: nw*cap lanes instead of
// the whole list. Every output element is summed by one thread in lane
// order and written once: no atomics, so reruns are bitwise equal. The nw
// row tiles of a window each re-read its buckets; a sink-sorted pass would
// not, and is left to a later version.

#include <cuda_bf16.h>
#include <cuda_runtime.h>

namespace {

constexpr int kW = 128;                        // node window
constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;
constexpr int kRows = 32;                      // sink rows per block
constexpr int kRowsPerWarp = kRows / kWarps;   // warp w owns rows w + 8 j
constexpr int kColsPerLane = 4;
constexpr int kFeat = 32 * kColsPerLane;       // feature columns per block
constexpr int kChunk = kThreads;               // edge lanes staged per round

__device__ __forceinline__ float round_bf16(float v) {
  return __bfloat162float(__float2bfloat16_rn(v));
}

template <bool kBf16>
__global__ void __launch_bounds__(kThreads)
spmm_pairs_kernel(const float* __restrict__ x, const int* __restrict__ edges,
                  const float* __restrict__ w, float* __restrict__ out,
                  int N, int F, int cap) {
  __shared__ int s_row[kChunk];
  __shared__ int s_src[kChunk];
  __shared__ float s_w[kChunk];
  __shared__ int s_count[kWarps];

  const int b = blockIdx.z;
  const int row0 = blockIdx.x * kRows;         // inside window ks
  const int ks = row0 / kW;
  const int nw = N / kW;
  const int f0 = blockIdx.y * kFeat;
  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const size_t lanes = size_t(nw) * nw * cap;
  const int* sink_b = edges + size_t(b) * 2 * lanes;
  const int* src_b = sink_b + lanes;
  const float* w_b = w + size_t(b) * lanes;
  const float* x_b = x + size_t(b) * N * F;

  float acc[kRowsPerWarp][kColsPerLane];
#pragma unroll
  for (int r = 0; r < kRowsPerWarp; ++r)
#pragma unroll
    for (int q = 0; q < kColsPerLane; ++q) acc[r][q] = 0.0f;

  for (int kc = 0; kc < nw; ++kc) {
    const size_t bucket = (size_t(ks) * nw + kc) * cap;
    for (int base = 0; base < cap; base += kChunk) {
      // compact this chunk to the lanes that land in the tile, in lane order
      const int e = base + tid;
      int r = 0, s = 0;
      float wt = 0.0f;
      bool keep = false;
      if (e < cap) {
        r = sink_b[bucket + e] - row0;
        keep = r >= 0 && r < kRows;
        if (keep) {
          s = kc * kW + min(max(src_b[bucket + e] - kc * kW, 0), kW - 1);
          wt = w_b[bucket + e];
        }
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
              float m = __fmul_rn(wj, xv);
              if constexpr (kBf16) m = round_bf16(m);
              acc[sl][q] = __fadd_rn(acc[sl][q], m);
            }
          }
        }
      }
      __syncthreads();  // the staging arrays are rewritten by the next chunk
    }
  }

#pragma unroll
  for (int sl = 0; sl < kRowsPerWarp; ++sl) {
    const int row = row0 + warp + kWarps * sl;
    float* orow = out + (size_t(b) * N + row) * F;
#pragma unroll
    for (int q = 0; q < kColsPerLane; ++q) {
      const int f = f0 + lane + 32 * q;
      if (f < F) orow[f] = acc[sl][q];
    }
  }
}

}  // namespace

extern "C" {

// x [B,N,F] f32, edges [B,2,P*cap] int32, w [B,P*cap] f32, out [B,N,F] f32,
// all contiguous on `device`; N and cap multiples of 128; bf16 0 (f32x2) or
// 1. Returns a cudaError_t code (0 on success).
int gcm_spmm_pairs(const void* x, const void* edges, const void* w, void* out,
                   int B, int N, int F, int cap, int bf16, int device,
                   void* stream) {
  if (B < 1 || B > 65535 || N < kW || N % kW || F < 1 || cap < kW ||
      cap % kW)
    return int(cudaErrorInvalidValue);
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return int(err);
  const dim3 grid(N / kRows, (F + kFeat - 1) / kFeat, B);
  auto kernel = bf16 ? spmm_pairs_kernel<true> : spmm_pairs_kernel<false>;
  kernel<<<grid, kThreads, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float*>(x), static_cast<const int*>(edges),
      static_cast<const float*>(w), static_cast<float*>(out), N, F, cap);
  return int(cudaGetLastError());
}

}  // extern "C"
