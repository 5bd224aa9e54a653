// Three gathers for Hopper (sm_90a): f32 data, int32 indices.
//
// Replace the three Pallas kernels of the capability probe
// benchmarks/spmm_variants.py::probe_dynamic_gather, with their semantics
// in Pallas's interpret mode, at any shape:
//   take_rows       (k_rows, jnp.take along rows):     out[m, :] = x[i, :]
//   take_lanes      (k_lanes, take_along_axis, lanes): out[r, m] = x[r, i]
//   take_rows_loop  (k_dyn_rows, a fori_loop of dynamic row slices):
//                                                      out[m, :] = x[i', :]
// with x [R,C]. take_rows and take_lanes follow jnp.take's default mode: an
// index i in -D..-1 (D the gathered dimension's size) wraps to i + D, and
// one outside -D..D-1 gives NaN. take_rows_loop follows the dynamic-slice
// rule: i < 0 becomes i + R, then i' is clamped into 0..R-1.
//
// What bounds them on an H100: bytes. Each copies its output from x: the
// index and output are read and written once (4 bytes an element), x at
// most once; no arithmetic. At the sweep's message gather (x [32768,128],
// 524,288 indices) that is ~287 MB, ~86 us at 3.35 TB/s.
//
// What the designs do about it: every access is as wide and as coalesced
// as the layout allows. take_rows gives one thread one output float4 (four
// scalars where C % 4 != 0 or a pointer is not 16-byte aligned), so a warp
// stores 512 contiguous bytes, and reads its index through the read-only
// path. take_lanes gives one thread one output element; neighbouring threads
// store neighbouring elements and read their indices coalesced. The loop
// keeps the shape of the TPU's: one warp walks a run of kRun output rows in
// order, loads the run's indices once (one a lane) and broadcasts each with
// __shfl_sync, and copies the row with 16-byte loads and stores where the
// layout allows. All three only copy, so the plain versions agree with them
// bit for bit.

#include <cuda_runtime.h>

#include <cstdint>

namespace {

constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;
constexpr int kRun = 32;  // output rows one warp of the loop walks in order
constexpr int kMaxBlocks = 132 * 16;  // grid-stride beyond this

__device__ __forceinline__ float nan_f32() {
  return __int_as_float(0x7fc00000);  // the NaN torch writes for nan
}

// jnp.take's default mode: the wrapped index, or -1 for a NaN fill
__device__ __forceinline__ int64_t wrap_or_fill(int i, int64_t D) {
  const int64_t j = i < 0 ? i + D : i;
  return (j >= 0 && j < D) ? j : -1;
}

// x [R,C] viewed as [R,C/V] of V-float vectors
template <int V>
struct Vec;
template <>
struct Vec<1> { using T = float; };
template <>
struct Vec<4> { using T = float4; };

template <int V>
__device__ __forceinline__ typename Vec<V>::T fill_nan();
template <>
__device__ __forceinline__ float fill_nan<1>() { return nan_f32(); }
template <>
__device__ __forceinline__ float4 fill_nan<4>() {
  const float n = nan_f32();
  return make_float4(n, n, n, n);
}

template <int V>
__global__ void __launch_bounds__(kThreads)
take_rows_kernel(const float* __restrict__ x, const int* __restrict__ idx,
                 float* __restrict__ out, int64_t R, int64_t C, int64_t M) {
  using T = typename Vec<V>::T;
  const int64_t cv = C / V;
  const int64_t n = M * cv;
  const T* xv = reinterpret_cast<const T*>(x);
  T* ov = reinterpret_cast<T*>(out);
  for (int64_t t = blockIdx.x * int64_t(kThreads) + threadIdx.x; t < n;
       t += int64_t(gridDim.x) * kThreads) {
    const int64_t m = t / cv, c = t - m * cv;
    const int64_t i = wrap_or_fill(__ldg(idx + m), R);
    ov[t] = i >= 0 ? __ldg(xv + i * cv + c) : fill_nan<V>();
  }
}

__global__ void __launch_bounds__(kThreads)
take_lanes_kernel(const float* __restrict__ x, const int* __restrict__ idx,
                  float* __restrict__ out, int64_t R, int64_t C, int64_t M) {
  const int64_t n = R * M;
  for (int64_t t = blockIdx.x * int64_t(kThreads) + threadIdx.x; t < n;
       t += int64_t(gridDim.x) * kThreads) {
    const int64_t r = t / M;
    const int64_t i = wrap_or_fill(__ldg(idx + t), C);
    out[t] = i >= 0 ? __ldg(x + r * C + i) : nan_f32();
  }
}

template <int V>
__global__ void __launch_bounds__(kThreads)
take_rows_loop_kernel(const float* __restrict__ x, const int* __restrict__ idx,
                      float* __restrict__ out, int64_t R, int64_t C,
                      int64_t M) {
  using T = typename Vec<V>::T;
  const int lane = threadIdx.x & 31;
  const int64_t cv = C / V;
  const T* xv = reinterpret_cast<const T*>(x);
  T* ov = reinterpret_cast<T*>(out);
  const int64_t warps = int64_t(gridDim.x) * kWarps;
  for (int64_t run = blockIdx.x * int64_t(kWarps) + (threadIdx.x >> 5);
       run * kRun < M; run += warps) {
    const int64_t m0 = run * kRun;
    const int rows = M - m0 < kRun ? int(M - m0) : kRun;
    // the run's indices, one a lane, each read once
    int mine = lane < rows ? __ldg(idx + m0 + lane) : 0;
    for (int j = 0; j < rows; ++j) {
      int64_t i = __shfl_sync(0xffffffffu, mine, j);
      if (i < 0) i += R;
      i = i < 0 ? 0 : (i >= R ? R - 1 : i);
      const T* src = xv + i * cv;
      T* dst = ov + (m0 + j) * cv;
      for (int64_t c = lane; c < cv; c += 32) dst[c] = __ldg(src + c);
    }
  }
}

int blocks_for(int64_t work) {
  const int64_t b = (work + kThreads - 1) / kThreads;
  return int(b < kMaxBlocks ? b : kMaxBlocks);
}

bool aligned16(const void* a, const void* b) {
  return (reinterpret_cast<uintptr_t>(a) | reinterpret_cast<uintptr_t>(b)) %
             16 == 0;
}

int finish() { return int(cudaGetLastError()); }

}  // namespace

extern "C" {

// x [R,C] f32, idx [M] int32, out [M,C] f32, all contiguous on `device`;
// R, C, M >= 1. Each returns a cudaError_t code (0 on success).
int gcm_take_rows(const void* x, const void* idx, void* out, int64_t R,
                  int64_t C, int64_t M, int device, void* stream) {
  if (R < 1 || C < 1 || M < 1) return int(cudaErrorInvalidValue);
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return int(err);
  auto s = static_cast<cudaStream_t>(stream);
  const float* xf = static_cast<const float*>(x);
  const int* ii = static_cast<const int*>(idx);
  float* of = static_cast<float*>(out);
  if (C % 4 == 0 && aligned16(x, out))
    take_rows_kernel<4><<<blocks_for(M * C / 4), kThreads, 0, s>>>(
        xf, ii, of, R, C, M);
  else
    take_rows_kernel<1><<<blocks_for(M * C), kThreads, 0, s>>>(xf, ii, of, R,
                                                                C, M);
  return finish();
}

// x [R,C] f32, idx [R,M] int32, out [R,M] f32.
int gcm_take_lanes(const void* x, const void* idx, void* out, int64_t R,
                   int64_t C, int64_t M, int device, void* stream) {
  if (R < 1 || C < 1 || M < 1) return int(cudaErrorInvalidValue);
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return int(err);
  take_lanes_kernel<<<blocks_for(R * M), kThreads, 0,
                      static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float*>(x), static_cast<const int*>(idx),
      static_cast<float*>(out), R, C, M);
  return finish();
}

// x [R,C] f32, idx [M] int32, out [M,C] f32.
int gcm_take_rows_loop(const void* x, const void* idx, void* out, int64_t R,
                       int64_t C, int64_t M, int device, void* stream) {
  if (R < 1 || C < 1 || M < 1) return int(cudaErrorInvalidValue);
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return int(err);
  auto s = static_cast<cudaStream_t>(stream);
  const int64_t runs = (M + kRun - 1) / kRun;
  const int blocks = blocks_for(runs * 32);  // one warp a run
  const float* xf = static_cast<const float*>(x);
  const int* ii = static_cast<const int*>(idx);
  float* of = static_cast<float*>(out);
  if (C % 4 == 0 && aligned16(x, out))
    take_rows_loop_kernel<4><<<blocks, kThreads, 0, s>>>(xf, ii, of, R, C, M);
  else
    take_rows_loop_kernel<1><<<blocks, kThreads, 0, s>>>(xf, ii, of, R, C, M);
  return finish();
}

}  // extern "C"
