// Sink-sorted segmented SpMM for Hopper (sm_90a): f32 in and out.
//
// Replaces the Pallas kernel gcm_tpu/ops/pallas/spmm_seg.py::spmm_seg_T:
//   out[b, i, :] = sum over lanes e with sink_e = i of w_e * x[b, src_e, :]
// over the pair buckets of csrc/spmm_pairs.cu (W = 128, bucket
// p = ks * nw + kc of capacity cap), sorted by sink inside each bucket, and
// cut into chunks of C = 128 lanes. Tables begin/end [B,P,cap/C,W] int32
// give each sink lane s of window ks its segment [begin, end) inside each
// chunk; the kernel reads the sources, the weights and these tables, never
// the sink row, as the Pallas kernel does. A source outside window kc is
// clamped into it (row kc*W + clamp(src - kc*W, 0, W-1)), as there. The
// tables are clamped into the chunk, [max(begin, 0), min(end, C)).
//
// The Pallas kernel took a Hillis-Steele lane cumsum of each chunk's
// messages and read a segment as a difference of two prefix sums, because
// the TPU had no other way to reduce segments; here each segment is summed
// directly, so no prefix cancels against another. Each message w * x and
// each add is rounded once (__fmul_rn, __fadd_rn), in the order of the walk
// below (lane order, for the tables bucket_edges_segments builds): the plain
// version walks the tables in the same order and agrees with it bitwise.
//
// What bounds it on an H100: the function reads x, the bucketed lanes and
// the two tables once, 4*B*(N*F + 3*P*cap + 2*P*(cap/C)*W) bytes, and writes
// out once, 4*B*N*F bytes, against 2*B*E_valid*F flops: bound by bytes
// (~16.3 us at B=64, N=512, F=128, cap=1024).
//
// What the design does about it: one warp per (batch element, sink lane),
// its 32 lanes across features (up to kColsPerLane = 4 columns each), so a
// message's source row is read coalesced and its index, weight and table
// entries are one broadcast. The warp walks its segment of every chunk of
// its window's buckets, kc ascending, chunks in order, lanes in order, and
// sums in registers: each output element is summed by one thread and
// written once, with no atomics, so reruns are bitwise equal. Every lane is
// read by exactly one warp per feature tile.

#include <cuda_runtime.h>

namespace {

constexpr int kW = 128;                        // node window
constexpr int kC = 128;                        // lanes per chunk
constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;          // sink rows per block
constexpr int kColsPerLane = 4;
constexpr int kFeat = 32 * kColsPerLane;       // feature columns per block

__global__ void __launch_bounds__(kThreads)
spmm_seg_kernel(const float* __restrict__ x, const int* __restrict__ edges,
                const float* __restrict__ w, const int* __restrict__ begin,
                const int* __restrict__ end, float* __restrict__ out, int N,
                int F, int cap) {
  const int b = blockIdx.z;
  const int lane = threadIdx.x & 31;
  const int row = blockIdx.x * kWarps + (threadIdx.x >> 5);
  const int ks = row / kW, s = row - ks * kW;
  const int f0 = blockIdx.y * kFeat;
  const int nw = N / kW, nch = cap / kC;
  const size_t lanes = size_t(nw) * nw * cap;
  const int* src_b = edges + size_t(b) * 2 * lanes + lanes;
  const float* w_b = w + size_t(b) * lanes;
  const float* x_b = x + size_t(b) * N * F;
  const size_t tables = size_t(nw) * nw * nch * kW;
  const int* begin_b = begin + size_t(b) * tables;
  const int* end_b = end + size_t(b) * tables;

  float acc[kColsPerLane];
#pragma unroll
  for (int q = 0; q < kColsPerLane; ++q) acc[q] = 0.0f;

  for (int kc = 0; kc < nw; ++kc) {
    const int p = ks * nw + kc;
    for (int j = 0; j < nch; ++j) {
      const size_t t = (size_t(p) * nch + j) * kW + s;
      const int lo = max(__ldg(begin_b + t), 0);
      const int hi = min(__ldg(end_b + t), kC);
      const size_t chunk = size_t(p) * cap + size_t(j) * kC;
      for (int i = lo; i < hi; ++i) {
        const int src =
            kc * kW + min(max(__ldg(src_b + chunk + i) - kc * kW, 0), kW - 1);
        const float wi = __ldg(w_b + chunk + i);
        const float* xrow = x_b + size_t(src) * F;
#pragma unroll
        for (int q = 0; q < kColsPerLane; ++q) {
          const int f = f0 + lane + 32 * q;
          if (f < F)
            acc[q] = __fadd_rn(acc[q], __fmul_rn(wi, __ldg(xrow + f)));
        }
      }
    }
  }

  float* orow = out + (size_t(b) * N + row) * F;
#pragma unroll
  for (int q = 0; q < kColsPerLane; ++q) {
    const int f = f0 + lane + 32 * q;
    if (f < F) orow[f] = acc[q];
  }
}

}  // namespace

extern "C" {

// x [B,N,F] f32, edges [B,2,P*cap] int32, w [B,P*cap] f32, begin/end
// [B,P,cap/128,128] int32, out [B,N,F] f32, all contiguous on `device`; N
// and cap multiples of 128. Returns a cudaError_t code (0 on success).
int gcm_spmm_seg_f32(const void* x, const void* edges, const void* w,
                     const void* begin, const void* end, void* out, int B,
                     int N, int F, int cap, int device, void* stream) {
  if (B < 1 || B > 65535 || N < kW || N % kW || F < 1 || cap < kC ||
      cap % kC)
    return int(cudaErrorInvalidValue);
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return int(err);
  const dim3 grid(N / kWarps, (F + kFeat - 1) / kFeat, B);
  spmm_seg_kernel<<<grid, kThreads, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float*>(x), static_cast<const int*>(edges),
      static_cast<const float*>(w), static_cast<const int*>(begin),
      static_cast<const int*>(end), static_cast<float*>(out), N, F, cap);
  return int(cudaGetLastError());
}

}  // extern "C"
