// Thresholded score row for Hopper (sm_90a), f32 throughout.
//
// Replaces the Pallas kernel gcm_tpu/ops/pallas/sddmm.py::sddmm_threshold_row:
//   out[b, j] = score(curr[b], nodes[b, j]) < threshold  and  j < num_nodes[b]
// for curr [B,F], nodes [B,N,F] f32 and num_nodes [B] int32, with
//   euclidean: sqrt(sum_f (q_f - n_f)^2)          (the difference form)
//   cosine:    (q . n) / (max(|q|, 1e-8) * max(|n|, 1e-8))
// The TPU kernel wrote the euclidean distance as |q|^2 - 2 q.n + |n|^2 to put
// q.n on its matrix unit; that form cancels badly near 0, and a plain loop
// serves as well here.
//
// Numerics: every sum runs over f in order 0..F-1, one rounding per add and
// per multiply (__fmul_rn/__fadd_rn/__fsub_rn: no FMA contraction), with
// correctly rounded sqrt and division. The plain PyTorch version
// (ops/cuda/sddmm.py::sddmm_threshold_row_plain) does the same operations in
// the same order, so the masks are bitwise equal on the card and on the CPU:
// a threshold test flips an edge at the last ulp otherwise.
//
// What bounds it on an H100: each input is read once, 4*B*(N*F + F + 1)
// bytes, and B*N bytes are written, against ~3-6*B*N*F flops: it is bound by
// bytes (a few microseconds at the served shape at 3.35 TB/s), and in
// practice by latency at the model's small shapes.
//
// What the design does about it: one block of kRows threads owns kRows node
// rows of one batch element, one thread per row. The block stages the rows
// kChunk features at a time in shared memory with coalesced loads (rows
// padded to kChunk + 1 floats against bank conflicts) beside the same
// features of curr, and each thread runs its row's sums in registers. No
// atomics: two launches give bitwise-equal masks.

#include <cuda_runtime.h>

namespace {

constexpr int kRows = 128;   // node rows per block, one thread each
constexpr int kChunk = 32;   // features staged per round

template <bool kCosine>
__global__ void __launch_bounds__(kRows)
sddmm_threshold_row_kernel(const float* __restrict__ curr,
                           const float* __restrict__ nodes,
                           const int* __restrict__ num_nodes, float threshold,
                           unsigned char* __restrict__ out, int N, int F) {
  __shared__ float s_nodes[kRows][kChunk + 1];
  __shared__ float s_q[kChunk];

  const int b = blockIdx.y;
  const int row0 = blockIdx.x * kRows;
  const int tid = threadIdx.x;
  const int rows = min(kRows, N - row0);
  const float* nodes_b = nodes + (size_t(b) * N + row0) * F;
  const float* q_b = curr + size_t(b) * F;

  float acc = 0.0f, qq = 0.0f, nn = 0.0f;
  for (int f0 = 0; f0 < F; f0 += kChunk) {
    const int cols = min(kChunk, F - f0);
    for (int i = tid; i < rows * cols; i += kRows) {
      const int r = i / cols, c = i - r * cols;
      s_nodes[r][c] = nodes_b[size_t(r) * F + f0 + c];
    }
    if (tid < cols) s_q[tid] = q_b[f0 + tid];
    __syncthreads();
    if (tid < rows) {
      for (int c = 0; c < cols; ++c) {
        const float q = s_q[c], n = s_nodes[tid][c];
        if (kCosine) {
          acc = __fadd_rn(acc, __fmul_rn(q, n));
          qq = __fadd_rn(qq, __fmul_rn(q, q));
          nn = __fadd_rn(nn, __fmul_rn(n, n));
        } else {
          const float d = __fsub_rn(q, n);
          acc = __fadd_rn(acc, __fmul_rn(d, d));
        }
      }
    }
    __syncthreads();  // the staging arrays are rewritten by the next chunk
  }
  if (tid >= rows) return;

  float score;
  if (kCosine) {
    // max(x, eps) that keeps a NaN, as torch.clamp_min does
    const float nq_raw = __fsqrt_rn(qq), nn_raw = __fsqrt_rn(nn);
    const float nq = nq_raw < 1e-8f ? 1e-8f : nq_raw;
    const float nv = nn_raw < 1e-8f ? 1e-8f : nn_raw;
    score = __fdiv_rn(acc, __fmul_rn(nq, nv));
  } else {
    score = __fsqrt_rn(acc);
  }
  const int j = row0 + tid;
  out[size_t(b) * N + j] = (score < threshold && j < num_nodes[b]) ? 1 : 0;
}

}  // namespace

extern "C" {

// curr [B,F] f32, nodes [B,N,F] f32, num_nodes [B] int32, out [B,N] uint8,
// all contiguous on `device`; cosine != 0 picks the cosine score. Returns a
// cudaError_t code (0 on success).
int gcm_sddmm_threshold_row_f32(const void* curr, const void* nodes,
                                const void* num_nodes, float threshold,
                                int cosine, void* out, int B, int N, int F,
                                int device, void* stream) {
  if (B < 1 || B > 65535 || N < 1 || N > (1 << 24) || F < 1 || F > (1 << 16))
    return int(cudaErrorInvalidValue);
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return int(err);
  const dim3 grid((N + kRows - 1) / kRows, B);
  auto s = static_cast<cudaStream_t>(stream);
  auto q = static_cast<const float*>(curr);
  auto x = static_cast<const float*>(nodes);
  auto nn = static_cast<const int*>(num_nodes);
  auto o = static_cast<unsigned char*>(out);
  if (cosine)
    sddmm_threshold_row_kernel<true><<<grid, kRows, 0, s>>>(q, x, nn, threshold,
                                                            o, N, F);
  else
    sddmm_threshold_row_kernel<false><<<grid, kRows, 0, s>>>(q, x, nn,
                                                             threshold, o, N, F);
  return int(cudaGetLastError());
}

}  // extern "C"
