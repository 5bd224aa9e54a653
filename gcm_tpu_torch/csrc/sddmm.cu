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
// Both operands are read where they lie, through strides: node j of batch
// element b at nodes + b*node_sb + j*node_sn, its features at unit stride,
// and the current node at curr + b*curr_sb + clamp(num_nodes[b], 0, N-1) *
// curr_sn. The explicit entry passes curr [B,F] with curr_sn = 0; the
// selectors pass a column range of the node tensor itself, so that the
// current node nodes[b, clamp(num_nodes[b])] and a pose slice need no
// gather or copy of their own (the counterpart of JAX's one fusion).
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
// practice by the latency of a few dependent loads at the model's small
// shapes.
//
// What the design does about it: one thread owns one node row and keeps its
// sums in registers; there is no shared staging and no barrier. num_nodes[b]
// is loaded first, then the row's features and the current node's go
// straight to registers kChunk at a time (float4 where both column ranges
// and both strides sit on 16 bytes, else scalar), so the row loads overlap
// the num_nodes -> current node chain. A block's rows all belong to one
// batch element, so every lane of a warp loads the same current-node
// address, which the load unit serves as one broadcast. The rows a block
// takes (128, 64 or 32) are chosen so that B*N rows give every SM a block.
// No atomics: two launches give bitwise-equal masks.

#include <cuda_runtime.h>

#include "sm_count.cuh"

namespace {

constexpr int kMaxRows = 128;  // node rows per block at most, one thread each
constexpr int kMinRows = 32;
constexpr int kChunk = 32;     // features held in registers per round

// v[0..kChunk) = p[0..cols) (zero past cols): float4 loads where kVec4 (p on
// 16 bytes), scalar loads for the rest.
template <bool kVec4>
__device__ __forceinline__ void load_chunk(const float* __restrict__ p,
                                           int cols, float (&v)[kChunk]) {
#pragma unroll
  for (int c = 0; c < kChunk; c += 4) {
    if (kVec4 && c + 4 <= cols) {
      const float4 t = __ldg(reinterpret_cast<const float4*>(p + c));
      v[c] = t.x;
      v[c + 1] = t.y;
      v[c + 2] = t.z;
      v[c + 3] = t.w;
    } else {
#pragma unroll
      for (int u = 0; u < 4; ++u)
        v[c + u] = c + u < cols ? __ldg(p + c + u) : 0.0f;
    }
  }
}

template <bool kCosine, bool kVec4>
__global__ void __launch_bounds__(kMaxRows)
sddmm_threshold_row_kernel(const float* __restrict__ curr, long long curr_sb,
                           long long curr_sn, const float* __restrict__ nodes,
                           long long node_sb, long long node_sn,
                           const int* __restrict__ num_nodes, float threshold,
                           unsigned char* __restrict__ out, int N, int F) {
  const int b = blockIdx.y;
  const int j = blockIdx.x * blockDim.x + threadIdx.x;
  const int nb = __ldg(num_nodes + b);  // first: the current node waits on it
  if (j >= N) return;
  const float* x = nodes + b * node_sb + j * node_sn;
  const float* q = curr + b * curr_sb + min(max(nb, 0), N - 1) * curr_sn;

  float acc = 0.0f, qq = 0.0f, nn = 0.0f;
  for (int f0 = 0; f0 < F; f0 += kChunk) {
    float xv[kChunk], qv[kChunk];
    load_chunk<kVec4>(x + f0, F - f0, xv);
    load_chunk<kVec4>(q + f0, F - f0, qv);
#pragma unroll
    for (int c = 0; c < kChunk; ++c) {
      if (f0 + c < F) {
        if (kCosine) {
          acc = __fadd_rn(acc, __fmul_rn(qv[c], xv[c]));
          qq = __fadd_rn(qq, __fmul_rn(qv[c], qv[c]));
          nn = __fadd_rn(nn, __fmul_rn(xv[c], xv[c]));
        } else {
          const float d = __fsub_rn(qv[c], xv[c]);
          acc = __fadd_rn(acc, __fmul_rn(d, d));
        }
      }
    }
  }

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
  out[size_t(b) * N + j] = (score < threshold && j < nb) ? 1 : 0;
}

template <bool kCosine, bool kVec4>
void launch(dim3 grid, int rows, cudaStream_t s, const float* q, long long qsb,
            long long qsn, const float* x, long long sb, long long sn,
            const int* nn, float threshold, unsigned char* o, int N, int F) {
  sddmm_threshold_row_kernel<kCosine, kVec4><<<grid, rows, 0, s>>>(
      q, qsb, qsn, x, sb, sn, nn, threshold, o, N, F);
}

bool on16(const void* p) { return reinterpret_cast<size_t>(p) % 16 == 0; }

}  // namespace

extern "C" {

// Scores node j of batch element b, the F floats at nodes + b*node_sb +
// j*node_sn, against the F floats at curr + b*curr_sb + clamp(num_nodes[b],
// 0, N-1)*curr_sn (strides in floats, none negative); num_nodes [B] int32,
// out [B,N] uint8 contiguous, all on `device`; cosine != 0 picks the cosine
// score. Returns a cudaError_t code (0 on success).
int gcm_sddmm_threshold_row_f32(const void* curr, long long curr_sb,
                                long long curr_sn, const void* nodes,
                                long long node_sb, long long node_sn,
                                const void* num_nodes, float threshold,
                                int cosine, void* out, int B, int N, int F,
                                int device, void* stream) {
  if (B < 1 || B > 65535 || N < 1 || N > (1 << 24) || F < 1 || F > (1 << 16) ||
      curr_sb < 0 || curr_sn < 0 || node_sb < 0 || node_sn < 0)
    return int(cudaErrorInvalidValue);
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return int(err);
  // the most rows a block that still leaves no SM without a block
  int rows = kMaxRows;
  while (rows > kMinRows &&
         static_cast<long long>(B) * ((N + rows - 1) / rows) < sm_count(device))
    rows /= 2;
  const dim3 grid((N + rows - 1) / rows, B);
  auto s = static_cast<cudaStream_t>(stream);
  auto q = static_cast<const float*>(curr);
  auto x = static_cast<const float*>(nodes);
  auto nn = static_cast<const int*>(num_nodes);
  auto o = static_cast<unsigned char*>(out);
  const bool vec4 = on16(q) && on16(x) && curr_sb % 4 == 0 &&
                    curr_sn % 4 == 0 && node_sb % 4 == 0 && node_sn % 4 == 0;
  if (cosine && vec4)
    launch<true, true>(grid, rows, s, q, curr_sb, curr_sn, x, node_sb, node_sn,
                       nn, threshold, o, N, F);
  else if (cosine)
    launch<true, false>(grid, rows, s, q, curr_sb, curr_sn, x, node_sb,
                        node_sn, nn, threshold, o, N, F);
  else if (vec4)
    launch<false, true>(grid, rows, s, q, curr_sb, curr_sn, x, node_sb,
                        node_sn, nn, threshold, o, N, F);
  else
    launch<false, false>(grid, rows, s, q, curr_sb, curr_sn, x, node_sb,
                         node_sn, nn, threshold, o, N, F);
  return int(cudaGetLastError());
}

}  // extern "C"
