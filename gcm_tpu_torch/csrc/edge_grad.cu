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
// floats (at most g and x whole) and its two indices, and writes one
// float; at the SpMM sweep's point (B=64, E=8192, F=128) ~270 MB of row
// reads against 134 MFLOP.
//
// What the design does about it: one warp a lane, its 32 threads reading
// each row as 32 neighbouring floats (128-byte coalesced loads, from L2
// where the rows repeat); thread t adds the products of columns t, t + 32,
// ... in ascending order (__fmul_rn, __fadd_rn: no contraction), then the
// warp adds its 32 sums by halves (16, 8, 4, 2, 1) with shuffles. No
// atomics: the plain version (ops/cuda/edge_grad.py::
// edge_weight_grad_plain) adds in the same order, so the two agree bitwise.

#include <cuda_runtime.h>

#include <cstdint>

#include "sm_count.cuh"

namespace {

constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;

__global__ void __launch_bounds__(kThreads) edge_weight_grad_kernel(
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
      for (int off = 16; off > 0; off >>= 1)
        acc = __fadd_rn(acc, __shfl_down_sync(0xffffffffu, acc, off));
    }
    if (lane == 0) dw[w] = acc;
  }
}

}  // namespace

extern "C" {

// g, x [B,N,F] f32, edges [B,2,E] int32 (row 0 sink, row 1 source), dw
// [B,E] f32. Returns a CUDA error code.
int gcm_edge_weight_grad_f32(const void* g, const void* x, const void* edges,
                             void* dw, int B, int N, int F, int E,
                             int device, void* stream) {
  if (B < 1 || B > 65535 || N < 1 || F < 1 || E < 1)
    return cudaErrorInvalidValue;
  const long long lanes = (long long)B * E;
  const long long want = (lanes + kWarps - 1) / kWarps;
  const long long cap = (long long)sm_count(device) * 16;
  const int blocks = (int)(want < cap ? want : cap);
  edge_weight_grad_kernel<<<blocks, kThreads, 0,
                            static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float*>(g), static_cast<const float*>(x),
      static_cast<const int*>(edges), static_cast<float*>(dw), N, F, E,
      lanes);
  return cudaGetLastError();
}

}  // extern "C"
