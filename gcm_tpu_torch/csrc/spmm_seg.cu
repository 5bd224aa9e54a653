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
// (~15.0 us at B=64, N=512, F=128, cap=1024). In practice the row gathers
// bound it, 4*B*E_valid*F bytes from L2 (~268 MB at that point), and their
// latency.
//
// What the design does about it: one warp per (batch element, sink row),
// which walks the row's table entries (kc ascending, chunks in order) and
// each entry's lanes in order, and sums in registers: each output element
// is summed by one thread and written once, with no atomics, so reruns are
// bitwise equal. The walk is batched, so no load waits on another of its
// kind: the warp's 32 threads load 32 table entries at once (a block's 8
// consecutive rows share each entry's 32-byte sector) and scan their
// clamped lengths; then, 32 of the row's lanes a round, each thread finds
// its lane's entry by a binary search of the scan and loads its source and
// weight; then the warp broadcasts kUnroll sources at a time, issues their
// x-row gathers together and adds them in order. A thread holds 4 feature
// columns of a 128-column tile: adjacent (one 16-byte load a row) where F
// is a multiple of 4 and x and out are 16-byte aligned, else 32 apart.

#include <cuda_runtime.h>

#include <climits>
#include <cstdint>

namespace {

constexpr int kW = 128;                        // node window
constexpr int kC = 128;                        // lanes per chunk
constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;          // sink rows per block
constexpr int kCols = 4;                       // feature columns a thread
constexpr int kFeat = 32 * kCols;              // feature columns per block
constexpr int kUnroll = 8;                     // gathers in flight a warp
constexpr unsigned kAll = 0xffffffffu;

// The kCols columns of row p that this thread holds: p[0..3] (kVec4) or
// p[0], p[32], p[64], p[96]; columns at F or beyond read 0.
template <bool kVec4>
__device__ __forceinline__ float4 load_cols(const float* p, int f, int F) {
  if constexpr (kVec4) {
    return f < F ? __ldg(reinterpret_cast<const float4*>(p))
                 : make_float4(0.0f, 0.0f, 0.0f, 0.0f);
  } else {
    float4 r;
    r.x = f < F ? __ldg(p) : 0.0f;
    r.y = f + 32 < F ? __ldg(p + 32) : 0.0f;
    r.z = f + 64 < F ? __ldg(p + 64) : 0.0f;
    r.w = f + 96 < F ? __ldg(p + 96) : 0.0f;
    return r;
  }
}

__device__ __forceinline__ void add_msg(float4& acc, float w, float4 x) {
  acc.x = __fadd_rn(acc.x, __fmul_rn(w, x.x));
  acc.y = __fadd_rn(acc.y, __fmul_rn(w, x.y));
  acc.z = __fadd_rn(acc.z, __fmul_rn(w, x.z));
  acc.w = __fadd_rn(acc.w, __fmul_rn(w, x.w));
}

template <bool kVec4>
__global__ void __launch_bounds__(kThreads)
spmm_seg_kernel(const float* __restrict__ x, const int* __restrict__ edges,
                const float* __restrict__ w, const int* __restrict__ begin,
                const int* __restrict__ end, float* __restrict__ out, int N,
                int F, int cap) {
  const int b = blockIdx.z;
  const int lane = threadIdx.x & 31;
  const int row = blockIdx.x * kWarps + (threadIdx.x >> 5);
  const int ks = row / kW, s = row - ks * kW;
  const int f = blockIdx.y * kFeat + (kVec4 ? kCols * lane : lane);
  const int nw = N / kW, nch = cap / kC;
  const int n_ent = nw * nch;  // the row's table entries, (kc, chunk) order
  const size_t lanes = size_t(nw) * nw * cap;
  // window ks's buckets: entry k's chunk starts at lane k * kC
  const size_t win = size_t(ks) * nw * cap;
  const int* src_w = edges + size_t(b) * 2 * lanes + lanes + win;
  const float* w_w = w + size_t(b) * lanes + win;
  const float* x_b = x + size_t(b) * N * F + f;
  const size_t tables = size_t(nw) * nw * nch * kW;
  const size_t t0 = size_t(b) * tables + size_t(ks) * n_ent * kW + s;
  const int* begin_r = begin + t0;  // entry k at begin_r[k * kW]
  const int* end_r = end + t0;

  float4 acc = make_float4(0.0f, 0.0f, 0.0f, 0.0f);
  for (int k0 = 0; k0 < n_ent; k0 += 32) {
    // 1. 32 entries at once: each thread's clamped segment, then a scan
    const int k = k0 + lane;
    int lo = 0, len = 0;
    if (k < n_ent) {
      const int bg = __ldg(begin_r + size_t(k) * kW);
      const int en = __ldg(end_r + size_t(k) * kW);
      lo = max(bg, 0);
      len = max(min(en, kC) - lo, 0);
    }
    int incl = len;
#pragma unroll
    for (int d = 1; d < 32; d <<= 1) {
      const int t = __shfl_up_sync(kAll, incl, d);
      if (lane >= d) incl += t;
    }
    const int total = __shfl_sync(kAll, incl, 31);
    const int first = k * kC + lo - (incl - len);  // + position = lane
    for (int q0 = 0; q0 < total; q0 += 32) {
      // 2. 32 of the row's lanes at once: the entry of position q is the
      // count of entries whose segments end at or before it
      const int q = q0 + lane;
      int e = 0;
#pragma unroll
      for (int step = 16; step; step >>= 1)
        if (__shfl_sync(kAll, incl, e + step - 1) <= q) e += step;
      const int base = __shfl_sync(kAll, first, e);
      int src = 0;
      float wt = 0.0f;
      if (q < total) {
        const int i = base + q;
        const int kc_lo = (k0 + e) / nch * kW;
        src = kc_lo + min(max(__ldg(src_w + i) - kc_lo, 0), kW - 1);
        wt = __ldg(w_w + i);
      }
      // 3. kUnroll gathers issued together, then added in lane order
      const int m = min(32, total - q0);
      for (int u0 = 0; u0 < m; u0 += kUnroll) {
        float4 xv[kUnroll];
#pragma unroll
        for (int u = 0; u < kUnroll; ++u) {
          if (u0 + u < m) {
            const int su = __shfl_sync(kAll, src, u0 + u);
            xv[u] = load_cols<kVec4>(x_b + size_t(su) * F, f, F);
          }
        }
#pragma unroll
        for (int u = 0; u < kUnroll; ++u)
          if (u0 + u < m)
            add_msg(acc, __shfl_sync(kAll, wt, u0 + u), xv[u]);
      }
    }
  }

  float* orow = out + (size_t(b) * N + row) * F + f;
  if constexpr (kVec4) {
    if (f < F) *reinterpret_cast<float4*>(orow) = acc;
  } else {
    if (f < F) orow[0] = acc.x;
    if (f + 32 < F) orow[32] = acc.y;
    if (f + 64 < F) orow[64] = acc.z;
    if (f + 96 < F) orow[96] = acc.w;
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
      cap % kC || (long long)(N / kW) * cap > INT_MAX)
    return int(cudaErrorInvalidValue);
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return int(err);
  const uintptr_t align =
      reinterpret_cast<uintptr_t>(x) | reinterpret_cast<uintptr_t>(out);
  const dim3 grid(N / kWarps, (F + kFeat - 1) / kFeat, B);
  auto kernel = F % kCols == 0 && align % 16 == 0 ? spmm_seg_kernel<true>
                                                  : spmm_seg_kernel<false>;
  kernel<<<grid, kThreads, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float*>(x), static_cast<const int*>(edges),
      static_cast<const float*>(w), static_cast<const int*>(begin),
      static_cast<const int*>(end), static_cast<float*>(out), N, F, cap);
  return int(cudaGetLastError());
}

}  // extern "C"
