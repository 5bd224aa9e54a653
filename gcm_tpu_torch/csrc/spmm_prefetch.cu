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
// bytes, against 2*B*E_valid*F flops: bound by bytes (~12.5 us at B=64,
// N=512, F=128, n_blocks*K=16384). In practice the row gathers bound it,
// 4*B*E_valid*F bytes from L2 (~268 MB at that point).
//
// What the design does about it: the sink-sorted row sum of sink_sort.cuh.
// A block owns one (batch element, sink block) - or a tile of at most
// 1,024 of its rows - and a tile of feature columns. It reads the block's
// K slots once, sorts them by local sink in shared memory (stable: a row's
// slots stay in slot order), and each warp sums whole rows in registers,
// several gathers in flight, and writes out[b, j*S + s, :] once. Each
// product and each add is rounded once (__fmul_rn, __fadd_rn) in slot
// order, as the TPU kernel's float32 loop added them: the plain version,
// which adds in the same order, agrees with it bitwise. No atomics on
// floats: reruns are bitwise equal. Any S is taken: a sink block of more
// than 1,024 rows goes in row tiles, each reading the block's slots.

#include "sink_sort.cuh"

namespace {

template <int V>
__global__ void __launch_bounds__(sink_sort::kThreads, sink_sort::kMinBlocks)
spmm_prefetch_kernel(const float* __restrict__ x, const int* __restrict__ sl,
                     const int* __restrict__ src, const float* __restrict__ w,
                     float* __restrict__ out, int N, int F, int S, int nblk,
                     int K, const sink_sort::Plan p) {
  extern __shared__ int smem[];
  __shared__ int s_part[sink_sort::kWarps];
  const int b = blockIdx.y;
  const int ft = blockIdx.x % p.ftiles, tile = blockIdx.x / p.ftiles;
  const int j = tile / p.rtiles, row0 = tile % p.rtiles * p.R;
  const size_t slots = (size_t(b) * nblk + j) * K;
  sink_sort::Tile t;
  t.x = x + size_t(b) * N * F;
  t.sink = sl + slots;
  t.src = src + slots;
  t.w = w + slots;
  t.n = K;
  t.base = row0;
  t.rows = min(p.R, S - row0);
  t.out = out + ((size_t(b) * nblk + j) * S + row0) * F;
  int* s_src = smem + p.R * sink_sort::kWarps;
  const int f = (ft * 32 + (threadIdx.x & 31)) * V;
  sink_sort::sum_tile<V, sink_sort::Round::kF32, sink_sort::Src::kClamp>(
      t, N, F, f, p.cap, smem, s_src, reinterpret_cast<float*>(s_src + p.cap),
      s_part);
}

}  // namespace

extern "C" {

// x [B,N,F] f32, sl/src [B,nblk,K] int32, w [B,nblk,K] f32, out
// [B,nblk*S,F] f32, all contiguous on `device`. Returns a cudaError_t code
// (0 on success).
int gcm_spmm_prefetch_f32(const void* x, const void* sl, const void* src,
                          const void* w, void* out, int B, int N, int F,
                          int S, int nblk, int K, int device, void* stream) {
  if (B < 1 || B > 65535 || N < 1 || F < 1 || S < 1 || nblk < 1 ||
      nblk > 65535 || K < 1)
    return int(cudaErrorInvalidValue);
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return int(err);
  const sink_sort::Plan p =
      sink_sort::plan(F, S, (long long)B * nblk, K, x, out);
  return sink_sort::with_width(p, [&](auto v) {
    return sink_sort::launch(spmm_prefetch_kernel<decltype(v)::value>, p, B,
                             static_cast<cudaStream_t>(stream),
                             static_cast<const float*>(x),
                             static_cast<const int*>(sl),
                             static_cast<const int*>(src),
                             static_cast<const float*>(w),
                             static_cast<float*>(out), N, F, S, nblk, K);
  });
}

}  // extern "C"
