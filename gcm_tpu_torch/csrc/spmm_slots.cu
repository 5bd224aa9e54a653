// Sink-slot SpMM for Hopper (sm_90a), f32 throughout.
//
// Replaces the Pallas kernel gcm_tpu/ops/pallas/spmm_slots.py::spmm_slots_T.
// The layout comes from bucket_sink_slots: for each of the P = nw * nw pairs
// (sink window sw, source window kc) of W = 128 nodes, p = sw * nw + kc, each
// sink lane owns k source slots, srcs/ws [B,P,k,W] (srcs local to the source
// window, weight 0 in an empty slot). For x [B,N,F], N = nw * W:
//   out[b, sw*W + lane, :] = sum over kc ascending of
//       (sum over c = 0..k-1 of ws[b,p,c,lane] * x[b, kc*W + srcs[b,p,c,lane], :])
// A slot whose local source is outside 0..W-1 adds nothing. The Pallas grid
// carried the sum over kc from one sequential grid step to the next; blocks
// on Hopper run in no order, so that axis is a loop inside the block. The
// kernel reads x as [B,N,F]: no transpose, unlike the TPU entry's xT.
//
// What bounds it on an H100: each input read once is
// 4*B*(N*F + 2*P*k*W) bytes plus 4*B*N*F written, against
// 2*B*(valid slots)*F flops: bound by bytes at every shape the model gives it.
//
// What the design does about it: one block owns one batch element, one sink
// window (one thread per sink lane) and kFeat feature columns. It stages each
// source window of x, [W, kFeat], in shared memory with coalesced loads
// (rows padded to kFeat + 1 floats, so lanes gathering different source rows
// hit different banks), then every thread gathers its k slots from it. The
// result goes out through the same shared tile, so the store is coalesced.
// Every output element is summed by one thread in a fixed order and written
// once: no atomics, and two launches give bitwise-equal results.

#include <cuda_runtime.h>

namespace {

constexpr int kW = 128;    // node window; one thread per sink lane
constexpr int kFeat = 32;  // feature columns per block

__global__ void __launch_bounds__(kW)
spmm_slots_kernel(const float* __restrict__ x, const int* __restrict__ srcs,
                  const float* __restrict__ ws, float* __restrict__ out,
                  int N, int F, int k) {
  __shared__ float xs[kW][kFeat + 1];

  const int sw = blockIdx.x;
  const int f0 = blockIdx.y * kFeat;
  const int b = blockIdx.z;
  const int lane = threadIdx.x;
  const int nw = N / kW;
  const float* x_b = x + size_t(b) * N * F;

  float tot[kFeat];
#pragma unroll
  for (int f = 0; f < kFeat; ++f) tot[f] = 0.0f;

  for (int kc = 0; kc < nw; ++kc) {
    __syncthreads();  // the previous window's gathers are done
    for (int i = lane; i < kW * kFeat; i += kW) {
      const int r = i / kFeat, f = i % kFeat;
      xs[r][f] = f0 + f < F ? x_b[size_t(kc * kW + r) * F + f0 + f] : 0.0f;
    }
    __syncthreads();

    float acc[kFeat];
#pragma unroll
    for (int f = 0; f < kFeat; ++f) acc[f] = 0.0f;
    const size_t p = (size_t(b) * nw + sw) * nw + kc;
    for (int c = 0; c < k; ++c) {
      const size_t slot = (p * k + c) * kW + lane;
      const int s = srcs[slot];
      const float wt = ws[slot];
      if (s >= 0 && s < kW) {
#pragma unroll
        for (int f = 0; f < kFeat; ++f) acc[f] = fmaf(xs[s][f], wt, acc[f]);
      }
    }
#pragma unroll
    for (int f = 0; f < kFeat; ++f) tot[f] += acc[f];
  }

  __syncthreads();
#pragma unroll
  for (int f = 0; f < kFeat; ++f) xs[lane][f] = tot[f];
  __syncthreads();
  float* out_w = out + (size_t(b) * N + size_t(sw) * kW) * F;
  for (int i = lane; i < kW * kFeat; i += kW) {
    const int r = i / kFeat, f = i % kFeat;
    if (f0 + f < F) out_w[size_t(r) * F + f0 + f] = xs[r][f];
  }
}

}  // namespace

extern "C" {

// x [B,N,F] f32, srcs [B,P,k,128] int32, ws [B,P,k,128] f32 with
// P = (N/128)^2, out [B,N,F] f32, all contiguous on `device`. Returns a
// cudaError_t code (0 on success).
int gcm_spmm_slots_f32(const void* x, const void* srcs, const void* ws,
                       void* out, int B, int N, int F, int k, int device,
                       void* stream) {
  if (B < 1 || B > 65535 || N < kW || N % kW || F < 1 || k < 1)
    return int(cudaErrorInvalidValue);
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return int(err);
  const dim3 grid(N / kW, (F + kFeat - 1) / kFeat, B);
  spmm_slots_kernel<<<grid, kW, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float*>(x), static_cast<const int*>(srcs),
      static_cast<const float*>(ws), static_cast<float*>(out), N, F, k);
  return int(cudaGetLastError());
}

}  // extern "C"
