// Per-edge SpMM over sink-block buckets for Hopper (sm_90a): f32 throughout.
//
// Replaces the Pallas kernel
// gcm_tpu/ops/pallas/spmm_prefetch.py::spmm_prefetch_bucketed:
//   out[b, j*S + sl_k, :] += w_k * x[b, src_k, :]   for k = 0 .. K-1 in order
// for each sink block j of S = num_nodes / n_blocks rows, over per-block
// edge slots sl/src [B,n_blocks,K] int32 (sl local to the block, -1 empty)
// and w [B,n_blocks,K] f32, x [B,N,F] f32, out [B,num_nodes,F]. The TPU
// kernel left an index out of range undefined (its interpret mode clamps
// both). Here a source is clamped into 0..N-1, as the interpret mode and
// gather_nodes do, and a slot whose local sink lies outside 0..S-1 adds
// nothing (the sentinel -1 among them).
//
// What bounds it on an H100: the function reads x and the slots once,
// 4*B*(N*F + 3*n_blocks*K) bytes, and writes out once, 4*B*num_nodes*F
// bytes, against 2*B*E_valid*F flops: bound by bytes (~13.8 us at B=64,
// N=512, F=128, n_blocks*K=16384). In practice it is bound by latency: each
// thread walks all K slots of its block in order.
//
// What the design does about it: one block per (batch element, sink block,
// tile of kFeat = 64 feature columns), one thread per column. The block's
// out tile [S, kFeat] sits in shared memory (32 KB at S = 128; above 48 KB
// it is opted in, up to the SM's 227 KB), the slots are staged kFeat at a
// time with coalesced loads, and each thread adds w * x[src] into its
// column slot after slot, each product and each add rounded once
// (__fmul_rn, __fadd_rn), as the TPU kernel's float32 loop added them: the
// plain version, which adds in the same order, agrees with it bitwise. No
// atomics: reruns are bitwise equal.

#include <cuda_runtime.h>

namespace {

constexpr int kFeat = 64;                      // feature columns per block
constexpr int kMaxSmem = 232448;               // per block, opted in

// the tile [S][kFeat] and one staged slot (sl, src, w) per thread
size_t smem_bytes(int S) {
  return size_t(S) * kFeat * sizeof(float) +
         size_t(kFeat) * (2 * sizeof(int) + sizeof(float));
}

__global__ void __launch_bounds__(kFeat)
spmm_prefetch_kernel(const float* __restrict__ x, const int* __restrict__ sl,
                     const int* __restrict__ src, const float* __restrict__ w,
                     float* __restrict__ out, int N, int F, int S, int nblk,
                     int K) {
  extern __shared__ float smem[];
  float* tile = smem;                                   // [S][kFeat]
  int* s_sl = reinterpret_cast<int*>(tile + size_t(S) * kFeat);
  int* s_src = s_sl + kFeat;
  float* s_w = reinterpret_cast<float*>(s_src + kFeat);

  const int j = blockIdx.x, b = blockIdx.z, tid = threadIdx.x;
  const int f = blockIdx.y * kFeat + tid;
  const size_t slots = (size_t(b) * nblk + j) * K;
  const float* x_b = x + size_t(b) * N * F;

  for (int i = tid; i < S * kFeat; i += kFeat) tile[i] = 0.0f;

  for (int base = 0; base < K; base += kFeat) {
    __syncthreads();  // the tile is zeroed, or the last slots are consumed
    const int k = base + tid;
    if (k < K) {
      s_sl[tid] = sl[slots + k];
      s_src[tid] = min(max(src[slots + k], 0), N - 1);
      s_w[tid] = w[slots + k];
    } else {
      s_sl[tid] = -1;
    }
    __syncthreads();
    if (f < F) {
      for (int t = 0; t < kFeat; ++t) {
        const int s = s_sl[t];
        if (s < 0 || s >= S) continue;
        float* cell = tile + s * kFeat + tid;
        *cell = __fadd_rn(
            *cell, __fmul_rn(s_w[t], __ldg(x_b + size_t(s_src[t]) * F + f)));
      }
    }
  }
  __syncthreads();

  if (f < F) {
    float* out_b = out + (size_t(b) * nblk * S + size_t(j) * S) * F;
    for (int s = 0; s < S; ++s)
      out_b[size_t(s) * F + f] = tile[s * kFeat + tid];
  }
}

}  // namespace

extern "C" {

// x [B,N,F] f32, sl/src [B,nblk,K] int32, w [B,nblk,K] f32, out
// [B,nblk*S,F] f32, all contiguous on `device`; S at most 905 (the shared
// memory of smem_bytes). Returns a cudaError_t code (0 on success).
int gcm_spmm_prefetch_f32(const void* x, const void* sl, const void* src,
                          const void* w, void* out, int B, int N, int F,
                          int S, int nblk, int K, int device, void* stream) {
  const size_t smem = smem_bytes(S);
  if (B < 1 || B > 65535 || N < 1 || F < 1 || S < 1 || nblk < 1 ||
      nblk > 65535 || K < 1 || smem > size_t(kMaxSmem))
    return int(cudaErrorInvalidValue);
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return int(err);
  if (smem > 48 * 1024) {
    err = cudaFuncSetAttribute(spmm_prefetch_kernel,
                               cudaFuncAttributeMaxDynamicSharedMemorySize,
                               int(smem));
    if (err != cudaSuccess) return int(err);
  }
  const dim3 grid(nblk, (F + kFeat - 1) / kFeat, B);
  spmm_prefetch_kernel<<<grid, kFeat, smem,
                         static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float*>(x), static_cast<const int*>(sl),
      static_cast<const int*>(src), static_cast<const float*>(w),
      static_cast<float*>(out), N, F, S, nblk, K);
  return int(cudaGetLastError());
}

}  // extern "C"
