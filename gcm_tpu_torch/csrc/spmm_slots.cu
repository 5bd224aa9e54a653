// Sink-slot SpMM for Hopper (sm_90a), f32 throughout.
//
// Replaces the Pallas kernel gcm_tpu/ops/pallas/spmm_slots.py::spmm_slots_T.
// The layout comes from bucket_sink_slots: for each of the P = nw * nw pairs
// (sink window sw, source window kc) of W = 128 nodes, p = sw * nw + kc, each
// sink lane owns k source slots, srcs/ws [B,P,k,W] (srcs local to the source
// window, weight 0 in an empty slot). For x [B,N,F], N = nw * W:
//   out[b, sw*W + lane, :] = sum over kc ascending of
//       (sum over c = 0..k-1 of ws[b,p,c,lane] * x[b, kc*W + srcs[b,p,c,lane], :])
// A slot whose local source is outside 0..W-1 adds weight 0 times the
// window's row 0, as the plain version does: nothing, for finite x. Every
// slot is multiplied, weight 0 included, as the Pallas kernel does. The
// Pallas grid carried the sum over kc from one sequential grid step to the
// next; blocks on Hopper run in no order, so that axis is a loop inside the
// thread. The kernel reads x as [B,N,F]: no transpose, unlike the TPU
// entry's xT.
//
// Numerics: acc = acc + w * x with one rounding per multiply and per add
// (__fmul_rn/__fadd_rn: no FMA contraction), c ascending, then tot = tot +
// acc per kc ascending: the plain version's (ops/cuda/spmm_slots.py::
// spmm_slots_plain) operations in its order, so the two are bitwise equal.
//
// What bounds it on an H100: each input read once is
// 4*B*(N*F + 2*P*k*W) bytes plus 4*B*N*F written, against
// 2*B*(valid slots)*F flops: bound by bytes at every shape the model gives it,
// and by the latency of a few dependent loads (slot, then row) at its small
// shapes.
//
// What the design does about it. The direct kernel (spmm_slots_kernel): a
// sink row belongs to L = 1..32 threads, L the least power of two that
// covers its columns (float4 columns where F % 4 == 0 and x and out sit on 16
// bytes, else single floats), so a block of 128 threads takes 128 / L whole
// rows and the grid B*N*L/128 blocks: 256 at the sparse path's B=32, N=128,
// F=32. Each thread walks its row's nw * k slots kSlots at a time: it loads
// their sources and weights (one address for the row's L threads,
// consecutive lanes for consecutive rows: coalesced), gathers their x rows
// from global memory (L2-resident) straight into registers, all kSlots in
// flight, and adds them in order. No shared memory, no barrier.
// From k = kStagedMinK slots a window on, each window row serves about k
// gathers of a sink window, and the staged kernel (spmm_slots_staged_kernel)
// reads it once instead: a block per (batch element, sink window, 8 float4
// columns) stages each source window's tile in shared memory and its 128
// threads, one a sink lane, gather from there. It is chosen there (float4
// columns only) where its blocks still give every SM one; measured on an
// H100 at B=64, N=512, F=128 the direct kernel wins up to k = 3 and the
// staged one from k = 4, and the direct one wins at single-float columns.
// Either way every output element is summed by one thread in a fixed order
// and written once: no atomics, and two launches give bitwise-equal results.

#include <cuda_runtime.h>

#include "sm_count.cuh"

namespace {

constexpr int kW = 128;        // node window
constexpr int kThreads = 128;  // threads a block
constexpr int kSlots = 8;      // slots whose gathers are in flight together
constexpr int kStagedMinK = 4; // slots a window from which staging it pays
constexpr int kTileCols = 8;   // float4 columns a staged tile: 128 bytes a row

__device__ __forceinline__ float zero(float) { return 0.0f; }
__device__ __forceinline__ float4 zero(float4) {
  return make_float4(0.0f, 0.0f, 0.0f, 0.0f);
}

__device__ __forceinline__ float madd(float acc, float w, float x) {
  return __fadd_rn(acc, __fmul_rn(w, x));
}
__device__ __forceinline__ float4 madd(float4 a, float w, float4 x) {
  return make_float4(madd(a.x, w, x.x), madd(a.y, w, x.y), madd(a.z, w, x.z),
                     madd(a.w, w, x.w));
}

__device__ __forceinline__ float add(float a, float b) { return __fadd_rn(a, b); }
__device__ __forceinline__ float4 add(float4 a, float4 b) {
  return make_float4(__fadd_rn(a.x, b.x), __fadd_rn(a.y, b.y),
                     __fadd_rn(a.z, b.z), __fadd_rn(a.w, b.w));
}

// T: float or float4, one column of x and out as the kernel reads it; FV
// such columns a row, each sink row on 1 << lanes_log2 threads. A row's
// nw * k slots lie kW apart in slot order i = kc * k + c, so the kernel walks
// them in that order kSlots at a time across window boundaries: the loads of
// one batch of slots, then its gathers, then its adds (closing a window's sum
// into the total at its last slot).
template <typename T>
__global__ void __launch_bounds__(kThreads)
spmm_slots_kernel(const T* __restrict__ x, const int* __restrict__ srcs,
                  const float* __restrict__ ws, T* __restrict__ out, int N,
                  int FV, int k, int lanes_log2) {
  const int t = threadIdx.x & ((1 << lanes_log2) - 1);
  const long long row = static_cast<long long>(blockIdx.x) *
                            (kThreads >> lanes_log2) +
                        (threadIdx.x >> lanes_log2);  // b * N + sink
  const int b = static_cast<int>(row / N);
  const int n = static_cast<int>(row - static_cast<long long>(b) * N);
  const int nw = N / kW, sw = n / kW, lane = n % kW, total = nw * k;
  const T* x_b = x + static_cast<size_t>(b) * N * FV;
  // slot (b, p = sw*nw + kc, c, lane) at slots + (kc * k + c) * kW
  const int* s_row = srcs + (static_cast<size_t>(b) * nw + sw) * total * kW + lane;
  const float* w_row = ws + (static_cast<size_t>(b) * nw + sw) * total * kW + lane;

  for (int col = t; col < FV; col += 1 << lanes_log2) {
    T tot = zero(T()), acc = zero(T());
    int kc = 0, c = 0;  // the window and slot of slot i0
    for (int i0 = 0; i0 < total; i0 += kSlots) {
      int s[kSlots];
      float w[kSlots];
      T g[kSlots];
      bool last[kSlots];
#pragma unroll
      for (int u = 0; u < kSlots; ++u) {
        if (i0 + u < total) {
          s[u] = __ldg(s_row + static_cast<size_t>(i0 + u) * kW);
          w[u] = __ldg(w_row + static_cast<size_t>(i0 + u) * kW);
        }
      }
#pragma unroll
      for (int u = 0; u < kSlots; ++u) {
        if (i0 + u < total) {
          const bool ok = s[u] >= 0 && s[u] < kW;
          w[u] = ok ? w[u] : 0.0f;
          g[u] = __ldg(x_b + static_cast<size_t>(kc * kW + (ok ? s[u] : 0)) * FV +
                       col);
          last[u] = ++c == k;
          if (last[u]) c = 0, ++kc;
        }
      }
#pragma unroll
      for (int u = 0; u < kSlots; ++u) {
        if (i0 + u < total) {
          acc = madd(acc, w[u], g[u]);
          if (last[u]) tot = add(tot, acc), acc = zero(T());
        }
      }
    }
    out[static_cast<size_t>(row) * FV + col] = tot;
  }
}

// Where each row's k slots reuse a window's rows: one block per (batch
// element, sink window, column tile), one thread per sink lane, the source
// window's tile staged in shared memory (rows padded by one column, so lanes
// gathering different rows hit different banks) and the gathers served from
// there. A lane's slots are loaded before the barrier that waits for the
// window, so the two round trips overlap. The result goes out through the
// same tile, so the store is coalesced. Same operations in the same order as
// spmm_slots_kernel.
__global__ void __launch_bounds__(kW)
spmm_slots_staged_kernel(const float4* __restrict__ x,
                         const int* __restrict__ srcs,
                         const float* __restrict__ ws,
                         float4* __restrict__ out, int N, int FV, int k) {
  __shared__ float4 xs[kW][kTileCols + 1];

  const int c0 = blockIdx.x * kTileCols, sw = blockIdx.y, b = blockIdx.z;
  const int lane = threadIdx.x, nw = N / kW, cols = min(kTileCols, FV - c0);
  const float4* x_b = x + static_cast<size_t>(b) * N * FV + c0;
  const size_t slots_b = (static_cast<size_t>(b) * nw + sw) * nw * k * kW + lane;

  float4 tot[kTileCols];
#pragma unroll
  for (int c = 0; c < kTileCols; ++c) tot[c] = zero(float4());

  for (int kc = 0; kc < nw; ++kc) {
    const size_t slots = slots_b + static_cast<size_t>(kc) * k * kW;
    int s[kSlots];
    float w[kSlots];
#pragma unroll
    for (int u = 0; u < kSlots; ++u) {
      if (u < k) {
        s[u] = __ldg(srcs + slots + static_cast<size_t>(u) * kW);
        w[u] = __ldg(ws + slots + static_cast<size_t>(u) * kW);
      }
    }
    __syncthreads();  // the previous window's gathers are done
#pragma unroll
    for (int i = lane; i < kW * kTileCols; i += kW) {
      const int r = i / kTileCols, c = i % kTileCols;
      if (c < cols) xs[r][c] = __ldg(x_b + static_cast<size_t>(kc * kW + r) * FV + c);
    }
    __syncthreads();

    float4 acc[kTileCols];
#pragma unroll
    for (int c = 0; c < kTileCols; ++c) acc[c] = zero(float4());
    for (int cs = 0;;) {
#pragma unroll
      for (int u = 0; u < kSlots; ++u) {
        if (cs + u < k) {
          const bool ok = s[u] >= 0 && s[u] < kW;
          const float wt = ok ? w[u] : 0.0f;
          const float4* row = xs[ok ? s[u] : 0];
#pragma unroll
          for (int c = 0; c < kTileCols; ++c)
            if (c < cols) acc[c] = madd(acc[c], wt, row[c]);
        }
      }
      cs += kSlots;
      if (cs >= k) break;
#pragma unroll
      for (int u = 0; u < kSlots; ++u) {
        if (cs + u < k) {
          const size_t i = slots + static_cast<size_t>(cs + u) * kW;
          s[u] = __ldg(srcs + i);
          w[u] = __ldg(ws + i);
        }
      }
    }
#pragma unroll
    for (int c = 0; c < kTileCols; ++c) tot[c] = add(tot[c], acc[c]);
  }

  __syncthreads();
#pragma unroll
  for (int c = 0; c < kTileCols; ++c) xs[lane][c] = tot[c];
  __syncthreads();
  float4* out_w = out + (static_cast<size_t>(b) * N + static_cast<size_t>(sw) * kW) * FV + c0;
#pragma unroll
  for (int i = lane; i < kW * kTileCols; i += kW) {
    const int r = i / kTileCols, c = i % kTileCols;
    if (c < cols) out_w[static_cast<size_t>(r) * FV + c] = xs[r][c];
  }
}

bool on16(const void* p) { return reinterpret_cast<size_t>(p) % 16 == 0; }

template <typename T>
void launch_direct(const void* x, const int* srcs, const float* ws, void* out,
                   int B, int N, int FV, int k, cudaStream_t s) {
  int lanes_log2 = 0;
  while (lanes_log2 < 5 && (1 << lanes_log2) < FV) ++lanes_log2;
  const long long blocks =
      static_cast<long long>(B) * N / (kThreads >> lanes_log2);
  spmm_slots_kernel<T><<<unsigned(blocks), kThreads, 0, s>>>(
      static_cast<const T*>(x), srcs, ws, static_cast<T*>(out), N, FV, k,
      lanes_log2);
}

}  // namespace

extern "C" {

// x [B,N,F] f32, srcs [B,P,k,128] int32, ws [B,P,k,128] f32 with
// P = (N/128)^2, out [B,N,F] f32, all contiguous on `device`. Returns a
// cudaError_t code (0 on success).
int gcm_spmm_slots_f32(const void* x, const void* srcs, const void* ws,
                       void* out, int B, int N, int F, int k, int device,
                       void* stream) {
  if (B < 1 || B > 65535 || N < kW || N % kW || N / kW > 65535 || F < 1 ||
      k < 1 || static_cast<long long>(B) * N / 4 > 0x7fffffffLL)
    return int(cudaErrorInvalidValue);
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return int(err);
  auto s = static_cast<cudaStream_t>(stream);
  auto si = static_cast<const int*>(srcs);
  auto wf = static_cast<const float*>(ws);
  if (F % 4 || !on16(x) || !on16(out)) {
    launch_direct<float>(x, si, wf, out, B, N, F, k, s);
  } else {
    // the staged kernel from kStagedMinK slots a window, where its blocks
    // still give every SM one; else the direct gather
    const int FV = F / 4, ctiles = (FV + kTileCols - 1) / kTileCols;
    const long long blocks = static_cast<long long>(B) * (N / kW) * ctiles;
    if (k >= kStagedMinK && blocks >= sm_count(device))
      spmm_slots_staged_kernel<<<dim3(ctiles, N / kW, B), kW, 0, s>>>(
          static_cast<const float4*>(x), si, wf, static_cast<float4*>(out), N,
          FV, k);
    else
      launch_direct<float4>(x, si, wf, out, B, N, FV, k, s);
  }
  return int(cudaGetLastError());
}

}  // extern "C"
