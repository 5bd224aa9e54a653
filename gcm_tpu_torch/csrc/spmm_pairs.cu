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
// against 2*B*E_valid*F flops: bound by bytes (~12.5 us at B=64, N=512,
// F=128, cap=1024). In practice the row gathers bound it, 4*B*E_valid*F
// bytes from L2 (~268 MB at that point).
//
// What the design does about it: the sink-sorted row sum of sink_sort.cuh,
// one group per (batch element, sink window ks). Window ks's nw buckets lie
// contiguously, kc ascending, in the plain version's lane order, so a
// stable sort of those lanes by sink row gives each row its lanes in that
// order, and the window test is the tile-row test itself. A block reads
// its window's nw*cap lanes once per feature tile (and row tile, where a
// small call splits a window), sorts them in shared memory, and each warp
// sums whole rows in registers, several gathers in flight, writing each
// output once. A lane's bucket kc comes from its index in the window
// (Src::kBucket), its bf16 mode rounds the message alone
// (Round::kBf16Msg). No atomics on floats: reruns are bitwise equal. A
// window of more than 8,192 lanes goes in passes; a hot row is one warp's
// walk of its lanes, in order.

#include "sink_sort.cuh"

namespace {

constexpr int kW = sink_sort::kBucketRows;  // node window

template <int V, sink_sort::Round kRound>
__global__ void __launch_bounds__(sink_sort::kThreads, sink_sort::kMinBlocks)
spmm_pairs_kernel(const float* __restrict__ x, const int* __restrict__ edges,
                  const float* __restrict__ w, float* __restrict__ out, int N,
                  int F, int cap, const sink_sort::Plan p) {
  extern __shared__ int smem[];
  __shared__ int s_part[sink_sort::kWarps];
  const int b = blockIdx.y;
  const int ft = blockIdx.x % p.ftiles, row0 = blockIdx.x / p.ftiles * p.R;
  const int nw = N / kW;
  const size_t lanes = size_t(nw) * nw * cap;
  const size_t lane0 = size_t(row0 / kW) * nw * cap;  // window ks's buckets
  sink_sort::Tile t;
  t.x = x + size_t(b) * N * F;
  t.sink = edges + size_t(b) * 2 * lanes + lane0;
  t.src = t.sink + lanes;
  t.w = w + size_t(b) * lanes + lane0;
  t.n = nw * cap;
  t.base = row0;
  t.rows = p.R;  // R divides the window's 128 rows
  t.bucket = cap;
  t.out = out + (size_t(b) * N + row0) * F;
  int* s_src = smem + p.R * sink_sort::kWarps;
  const int f = (ft * 32 + (threadIdx.x & 31)) * V;
  sink_sort::sum_tile<V, kRound, sink_sort::Src::kBucket>(
      t, N, F, f, p.cap, smem, s_src, reinterpret_cast<float*>(s_src + p.cap),
      s_part);
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
      cap % kW || (long long)(N / kW) * cap > INT_MAX)
    return int(cudaErrorInvalidValue);
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return int(err);
  const int nw = N / kW;
  const sink_sort::Plan p =
      sink_sort::plan(F, kW, (long long)B * nw, nw * cap, x, out);
  return sink_sort::with_width(p, [&](auto v) {
    constexpr int V = decltype(v)::value;
    using sink_sort::Round;
    return sink_sort::launch(
        bf16 ? spmm_pairs_kernel<V, Round::kBf16Msg>
             : spmm_pairs_kernel<V, Round::kF32>,
        p, B, static_cast<cudaStream_t>(stream),
        static_cast<const float*>(x), static_cast<const int*>(edges),
        static_cast<const float*>(w), static_cast<float*>(out), N, F, cap);
  });
}

}  // extern "C"
