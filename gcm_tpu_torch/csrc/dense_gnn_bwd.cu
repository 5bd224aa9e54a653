// Backward of the fused dense graph-conv stack for Hopper (sm_90a), in
// plain f32 FMAs.
//
// Replaces the backwards the JAX package gives its dense graph convs:
//   gcm_tpu/ops/pallas/fused_gnn.py::_bwd  (the stack's custom VJP, which
//       replays the XLA forward under jax.vjp)
//   gcm_tpu/ops/dispatch.py::_gconv_bwd    (one layer, L = 1 here)
// The forward layer l computes, for h_0 = x [B,N,F0], adj [B,N,N],
//   agg_l = adj . h_l,  z_l = agg_l . W_rel + b_rel + h_l . W_root,
//   h_{l+1} = act(z_l), act in {none, tanh, relu}.
// For the cotangent g of h_L the backward recomputes every h_l and agg_l
// (as the replay does) and then, layer by layer in reverse,
//   gz = g * act'(z)   (tanh: 1 - h_{l+1}^2; relu: h_{l+1} > 0)
//   dW_rel += agg_l^T . gz,  db_rel += sum_n gz,  dW_root += h_l^T . gz
//   dagg = gz . W_rel^T
//   dadj += dagg . h_l^T          (only where adj carries a gradient)
//   g <- adj^T . dagg + gz . W_root^T  (dx after layer 0).
//
// What bounds it on an H100: at the dense scan's shape (B=32, N=128,
// 32->32->32) its inputs and outputs are ~2.7 MB (0.8 us at 3.35 TB/s) and
// its ~0.25 GFLOP of f32 FMAs take 3.7 us at 67 TFLOP/s: operations.
//
// What the design does about it (simple first, as the bring-up of a
// backward):
// - A cluster of C blocks (C = 1..8, chosen so that the B x C blocks come
//   near one wave on the card) shares a batch element, each block R = N / C
//   of its rows. A layer's phases need whole matrices of other blocks only
//   twice: the next layer's agg reads every row of h, and adj^T . dagg
//   every row of dagg; there the cluster meets at its hardware barrier
//   (barrier.cluster, release / acquire, after a __threadfence), elsewhere
//   the block at __syncthreads. dagg alternates between two buffers by
//   layer, so that no block overwrites rows another still reads.
// - A block reads its rows of adj (for adj . h) and its columns (for
//   adj^T . dagg) from device memory, mostly L2, through the staged chunks
//   below, coalesced either way.
// - Each product runs over 32 x 32 output tiles of the block, k ascending
//   in chunks of 32 that the block stages in shared memory (loads along
//   each operand's contiguous axis, all in flight at once, the next chunk's
//   during the current one's products), a 2x2 tile a thread. The h_l, agg_l, gz, dagg and dh matrices live in a per-element
//   global scratch, which stays in L2.
// - No float atomics: each block's dW and db partials over its rows go to
//   scratch, and a second kernel sums them over the batch and the blocks in
//   order; every output is summed in a fixed order, so reruns are bitwise
//   equal.

#include <cuda_runtime.h>

#include <cstdint>

#include "sm_count.cuh"

namespace {

constexpr int kThreads = 256;
constexpr int kTM = 2;   // output rows of a thread's tile
constexpr int kTN = 2;   // output columns of a thread's tile
constexpr int kMT = 32;  // output rows of the block's tile
constexpr int kNT = 32;  // output columns of the block's tile
constexpr int kKC = 32;  // k of one staged chunk
constexpr int kStageFloats = kMT * (kKC + 1) + kKC * (kNT + 1);
static_assert((kMT / kTM) * (kNT / kTN) == kThreads, "a tile a thread");
constexpr int kMaxLayers = 4;
constexpr int kMaxWidth = 128;
constexpr int kMaxNodes = 1024;
constexpr int kMaxCluster = 8;          // the portable cluster size

enum Act { kNone = 0, kTanh = 1, kRelu = 2 };
enum Need { kNeedX = 1, kNeedAdj = 2, kNeedParams = 4 };

struct Stack {
  const float* w_rel[kMaxLayers];
  const float* b_rel[kMaxLayers];
  const float* w_root[kMaxLayers];
  int width[kMaxLayers + 1];
  int act[kMaxLayers];
  int poff[kMaxLayers];  // offset of layer l's (dW_rel, db_rel, dW_root)
  int n_layers;
  int fmax;
  int n_params;          // floats of all parameter gradients
};

// Element (r, c) of a matrix at p[r * sr + c * sc]: a transpose swaps the
// strides, rows(r0) starts at row r0.
struct View {
  const float* p;
  int sr, sc;
  __device__ float operator()(int r, int c) const { return p[r * sr + c * sc]; }
  __device__ View t() const { return View{p, sc, sr}; }
  __device__ View rows(int r0) const { return View{p + r0 * sr, sr, sc}; }
};

__device__ __forceinline__ float act_fwd(float v, int act) {
  if (act == kTanh) return tanhf(v);
  if (act == kRelu) return fmaxf(v, 0.f);
  return v;
}

__device__ __forceinline__ float act_grad(float out, int act) {
  if (act == kTanh) return 1.f - out * out;
  if (act == kRelu) return out > 0.f ? 1.f : 0.f;
  return 1.f;
}

// Every block of the cluster has reached this point, and what each wrote
// to device memory before it is visible to all.
__device__ __forceinline__ void cluster_sync(int C) {
  if (C == 1) {
    __syncthreads();
    return;
  }
  __threadfence();
  asm volatile(
      "barrier.cluster.arrive.release.aligned;\n\t"
      "barrier.cluster.wait.acquire.aligned;" ::: "memory");
}

// A chunk of one operand, zero outside the matrix: thread t holds elements
// e = t, t + kThreads, ... of As [kMT][kKC] = a(m0 + r, k0 + kk) (or Bs
// [kKC][kNT] = b(k0 + kk, n0 + j)), taken so that neighbouring threads read
// neighbouring elements along the operand's contiguous axis (the loads
// coalesce). fetch_* loads them into registers, put_* stores them into
// shared memory, whose rows are padded by one so that stores down a
// column hit distinct banks.
constexpr int kPerThread = kMT * kKC / kThreads;  // = kKC * kNT / kThreads
static_assert(kKC * kNT / kThreads == kPerThread, "equal chunks");

__device__ __forceinline__ void chunk_a(int e, bool along_k, int& r, int& kk) {
  r = along_k ? e / kKC : e % kMT;
  kk = along_k ? e % kKC : e / kMT;
}

__device__ __forceinline__ void chunk_b(int e, bool along_n, int& kk, int& j) {
  kk = along_n ? e / kNT : e % kKC;
  j = along_n ? e % kNT : e / kKC;
}

__device__ __forceinline__ void fetch_a(float* v, View a, int M, int K,
                                        int m0, int k0) {
#pragma unroll
  for (int t = 0; t < kPerThread; ++t) {
    int r, kk;
    chunk_a(threadIdx.x + t * kThreads, a.sc == 1, r, kk);
    const int i = m0 + r, k = k0 + kk;
    v[t] = (i < M && k < K) ? a(i, k) : 0.f;
  }
}

__device__ __forceinline__ void fetch_b(float* v, View b, int Nc, int K,
                                        int n0, int k0) {
#pragma unroll
  for (int t = 0; t < kPerThread; ++t) {
    int kk, j;
    chunk_b(threadIdx.x + t * kThreads, b.sc == 1, kk, j);
    const int k = k0 + kk, n = n0 + j;
    v[t] = (k < K && n < Nc) ? b(k, n) : 0.f;
  }
}

__device__ __forceinline__ void put_a(float* As, const float* v, View a) {
#pragma unroll
  for (int t = 0; t < kPerThread; ++t) {
    int r, kk;
    chunk_a(threadIdx.x + t * kThreads, a.sc == 1, r, kk);
    As[r * (kKC + 1) + kk] = v[t];
  }
}

__device__ __forceinline__ void put_b(float* Bs, const float* v, View b) {
#pragma unroll
  for (int t = 0; t < kPerThread; ++t) {
    int kk, j;
    chunk_b(threadIdx.x + t * kThreads, b.sc == 1, kk, j);
    Bs[kk * (kNT + 1) + j] = v[t];
  }
}

// For i < M, j < Nc: acc = sum_k a1(i, k) b1(k, j), k ascending, then
// sum_k a2(i, k) b2(k, j) into the same accumulator (k2 = 0: none);
// epi(i, j, acc) stores it. The block walks kMT x kNT output tiles, each
// over k in chunks of kKC staged in shared memory (`stage`), each thread a
// kTM x kTN tile of the outputs; the zeros past the matrix's edge add
// nothing. The next chunk's loads are in flight while the block multiplies
// the current one.
template <class Epi>
__device__ void block_gemm(float* stage, int M, int Nc, View a1, View b1,
                           int k1, View a2, View b2, int k2, Epi epi) {
  float* As = stage;
  float* Bs = stage + kMT * (kKC + 1);
  const int ti = threadIdx.x / (kNT / kTN), tj = threadIdx.x % (kNT / kTN);
  const int n1 = (k1 + kKC - 1) / kKC, chunks = n1 + (k2 + kKC - 1) / kKC;
  for (int m0 = 0; m0 < M; m0 += kMT) {
    for (int n0 = 0; n0 < Nc; n0 += kNT) {
      float acc[kTM][kTN] = {};
      float va[kPerThread], vb[kPerThread];
      for (int q = 0; q < chunks; ++q) {
        if (q == 0) {
          const bool first = n1 > 0;
          fetch_a(va, first ? a1 : a2, M, first ? k1 : k2, m0, 0);
          fetch_b(vb, first ? b1 : b2, Nc, first ? k1 : k2, n0, 0);
        }
        const bool first = q < n1;
        put_a(As, va, first ? a1 : a2);
        put_b(Bs, vb, first ? b1 : b2);
        __syncthreads();
        if (q + 1 < chunks) {  // the next chunk's loads, in flight meanwhile
          const bool next_first = q + 1 < n1;
          const int k0 = (next_first ? q + 1 : q + 1 - n1) * kKC;
          fetch_a(va, next_first ? a1 : a2, M, next_first ? k1 : k2, m0, k0);
          fetch_b(vb, next_first ? b1 : b2, Nc, next_first ? k1 : k2, n0, k0);
        }
#pragma unroll 8
        for (int kk = 0; kk < kKC; ++kk) {
          float av[kTM], bv[kTN];
#pragma unroll
          for (int r = 0; r < kTM; ++r)
            av[r] = As[(ti * kTM + r) * (kKC + 1) + kk];
#pragma unroll
          for (int c = 0; c < kTN; ++c)
            bv[c] = Bs[kk * (kNT + 1) + tj * kTN + c];
#pragma unroll
          for (int r = 0; r < kTM; ++r)
#pragma unroll
            for (int c = 0; c < kTN; ++c)
              acc[r][c] = fmaf(av[r], bv[c], acc[r][c]);
        }
        __syncthreads();
      }
#pragma unroll
      for (int r = 0; r < kTM; ++r)
#pragma unroll
        for (int c = 0; c < kTN; ++c) {
          const int i = m0 + ti * kTM + r, j = n0 + tj * kTN + c;
          if (i < M && j < Nc) epi(i, j, acc[r][c]);
        }
    }
  }
}

// A cluster of C blocks a batch element, block c owning rows
// [c R, c R + R): the forward replay, then the layers' backwards in
// reverse.
__global__ void __launch_bounds__(kThreads) dense_gnn_bwd_kernel(
    const float* __restrict__ x, const float* __restrict__ adj,
    const float* __restrict__ g, Stack st, int N, int C, int need,
    float* __restrict__ dx, float* __restrict__ dadj,
    float* scratch, float* partial, long long scratch_per_b) {
  __shared__ float stage[kStageFloats];
  const int b = blockIdx.x / C, c = blockIdx.x % C;
  const int R = N / C, r0 = c * R;
  const int L = st.n_layers;
  const float* adj_b = adj + (size_t)b * N * N;
  // Ar(i, k) = adj[r0 + i][k] and At(i, k) = adj[k][r0 + i], i < R, read
  // from device memory through the staged chunks (each coalesced)
  const View Ar = View{adj_b, N, 1}.rows(r0);
  const View At = View{adj_b, N, 1}.t().rows(r0);

  // scratch of element b: h_1..h_L, agg_0..agg_{L-1} (row stride their own
  // width), gz, dh and two dagg buffers (row stride fmax, so that a block's
  // rows stay its own from layer to layer), each N x fmax floats
  float* s = scratch + (size_t)b * scratch_per_b;
  const int ld = st.fmax;
  const size_t mat = (size_t)N * ld;
  const float* x_b = x + (size_t)b * N * st.width[0];
  auto H = [&](int l) -> float* {
    return l == 0 ? const_cast<float*>(x_b) : s + (l - 1) * mat;
  };
  auto AGG = [&](int l) -> float* { return s + (L + l) * mat; };
  float* GZ = s + 2 * L * mat;
  float* DH = GZ + mat;
  auto DAGG = [&](int l) -> float* { return DH + (1 + (l & 1)) * mat; };
  float* part = partial + ((size_t)b * C + c) * st.n_params;
  const View none{nullptr, 0, 0};

  // the forward replay, rows r0.. of each layer
  for (int l = 0; l < L; ++l) {
    const int fi = st.width[l], fo = st.width[l + 1], act = st.act[l];
    const float* br = st.b_rel[l];
    float* agg = AGG(l) + (size_t)r0 * fi;
    float* h1 = H(l + 1) + (size_t)r0 * fo;
    const View h{H(l), fi, 1};
    block_gemm(stage, R, fi, Ar, h, N, none, none, 0,
               [&](int i, int j, float v) { agg[i * fi + j] = v; });
    __syncthreads();
    block_gemm(stage, R, fo, View{agg, fi, 1}, View{st.w_rel[l], fo, 1}, fi,
               h.rows(r0), View{st.w_root[l], fo, 1}, fi,
               [&](int i, int j, float v) {
                 h1[i * fo + j] = act_fwd(v + br[j], act);
               });
    cluster_sync(C);  // the next layer reads every row of h
  }

  // the layers' backwards, in reverse, rows r0.. of each output but the
  // parameters' partials, which sum over rows r0.. only
  const float* cur = g + ((size_t)b * N + r0) * st.width[L];
  int cur_ld = st.width[L];
  float* dx_b = dx ? dx + ((size_t)b * N + r0) * st.width[0] : nullptr;
  float* dadj_b = dadj ? dadj + ((size_t)b * N + r0) * N : nullptr;
  float* gz_r = GZ + (size_t)r0 * ld;
  float* dh_r = DH + (size_t)r0 * ld;
  const View gz{gz_r, ld, 1};
  for (int l = L - 1; l >= 0; --l) {
    const int fi = st.width[l], fo = st.width[l + 1], act = st.act[l];
    const float* h1 = H(l + 1) + (size_t)r0 * fo;
    for (int e = threadIdx.x; e < R * fo; e += blockDim.x) {
      const int i = e / fo, j = e % fo;
      gz_r[i * ld + j] = cur[i * cur_ld + j] * act_grad(h1[e], act);
    }
    __syncthreads();

    float* dagg_all = DAGG(l);
    float* dagg_r = dagg_all + (size_t)r0 * ld;
    const View h_r = View{H(l), fi, 1}.rows(r0);
    block_gemm(stage, R, fi, gz, View{st.w_rel[l], fo, 1}.t(), fo, none,
               none, 0,
               [&](int i, int j, float v) { dagg_r[i * ld + j] = v; });
    if (need & kNeedParams) {
      float* dwr = part + st.poff[l];
      float* dbr = dwr + fi * fo;
      float* dwo = dbr + fo;
      block_gemm(stage, fi, fo, View{AGG(l), fi, 1}.rows(r0).t(), gz, R,
                 none, none, 0,
                 [&](int i, int j, float v) { dwr[i * fo + j] = v; });
      block_gemm(stage, fi, fo, h_r.t(), gz, R, none, none, 0,
                 [&](int i, int j, float v) { dwo[i * fo + j] = v; });
      for (int j = threadIdx.x; j < fo; j += blockDim.x) {
        float acc = 0.f;
        for (int n = 0; n < R; ++n) acc += gz_r[n * ld + j];
        dbr[j] = acc;
      }
    }
    cluster_sync(C);  // adj^T . dagg reads every row of dagg

    if (need & kNeedAdj) {
      const bool first = l == L - 1;
      block_gemm(stage, R, N, View{dagg_r, ld, 1}, View{H(l), fi, 1}.t(), fi,
                 none, none, 0, [&](int i, int j, float v) {
                   float* d = dadj_b + (size_t)i * N + j;
                   *d = first ? v : *d + v;
                 });
    }
    if (l > 0 || (need & kNeedX)) {
      float* out = l > 0 ? dh_r : dx_b;
      const int out_ld = l > 0 ? ld : fi;
      block_gemm(stage, R, fi, At, View{dagg_all, ld, 1}, N, gz,
                 View{st.w_root[l], fo, 1}.t(), fo,
                 [&](int i, int j, float v) { out[i * out_ld + j] = v; });
    }
    __syncthreads();
    cur = dh_r;
    cur_ld = ld;
  }
}

// dparams[e] = sum over (b, c) of partial[b][c][e], in that order.
__global__ void sum_partials_kernel(const float* __restrict__ partial,
                                    float* __restrict__ out, int parts,
                                    int P) {
  const int e = blockIdx.x * blockDim.x + threadIdx.x;
  if (e >= P) return;
  float acc = partial[e];
  for (int q = 1; q < parts; ++q) acc += partial[(size_t)q * P + e];
  out[e] = acc;
}

bool valid_stack(const int* widths, int n_layers, int B, int N) {
  if (n_layers < 1 || n_layers > kMaxLayers || B < 1 || B > 65535) return false;
  if (N < 16 || N > kMaxNodes || N % 16) return false;
  for (int l = 0; l <= n_layers; ++l)
    if (widths[l] < 1 || widths[l] > kMaxWidth) return false;
  return true;
}

int max_width(const int* widths, int n_layers) {
  int f = 0;
  for (int l = 0; l <= n_layers; ++l) f = widths[l] > f ? widths[l] : f;
  return f;
}

long long per_element_floats(const int* widths, int n_layers, int N) {
  return (long long)(2 * n_layers + 4) * N * max_width(widths, n_layers);
}

int param_floats(const int* widths, int n_layers) {
  int p = 0;
  for (int l = 0; l < n_layers; ++l)
    p += 2 * widths[l] * widths[l + 1] + widths[l + 1];
  return p;
}

// Blocks a batch element: the largest of 1, 2, 4, 8 that keeps B x C within
// the card's SMs (at least 1; 8 where B is small).
int cluster_size(int B, int sms) {
  int C = 1;
  while (C < kMaxCluster && (long long)B * C * 2 <= sms) C *= 2;
  return C;
}

}  // namespace

extern "C" {

// Floats of global scratch that gcm_fused_dense_gnn_bwd_f32 needs on
// `device`, or -1 for shapes it does not take.
long long gcm_dense_gnn_bwd_scratch_floats(const int* widths, int n_layers,
                                           int B, int N, int device) {
  if (!valid_stack(widths, n_layers, B, N)) return -1;
  const int C = cluster_size(B, sm_count(device));
  return (long long)B * per_element_floats(widths, n_layers, N) +
         (long long)B * C * param_floats(widths, n_layers);
}

// need: 1 dx, 2 dadj, 4 the parameters' gradients into dparams (w_rel,
// b_rel, w_root a layer, row-major, in layer order). Returns a CUDA error
// code (cudaErrorInvalidValue for shapes the kernel does not take).
int gcm_fused_dense_gnn_bwd_f32(
    const void* x, const void* adj, const void* g, const void* const* w_rel,
    const void* const* b_rel, const void* const* w_root, const int* widths,
    const int* acts, int n_layers, int B, int N, int need, void* dx,
    void* dadj, void* dparams, void* scratch, int device, void* stream) {
  if (!valid_stack(widths, n_layers, B, N)) return cudaErrorInvalidValue;
  if (((need & kNeedX) && !dx) || ((need & kNeedAdj) && !dadj) ||
      ((need & kNeedParams) && !dparams) || !scratch)
    return cudaErrorInvalidValue;
  Stack st{};
  st.n_layers = n_layers;
  st.fmax = max_width(widths, n_layers);
  int off = 0;
  for (int l = 0; l < n_layers; ++l) {
    st.w_rel[l] = static_cast<const float*>(w_rel[l]);
    st.b_rel[l] = static_cast<const float*>(b_rel[l]);
    st.w_root[l] = static_cast<const float*>(w_root[l]);
    st.act[l] = acts[l];
    st.poff[l] = off;
    off += 2 * widths[l] * widths[l + 1] + widths[l + 1];
  }
  for (int l = 0; l <= n_layers; ++l) st.width[l] = widths[l];
  st.n_params = off;

  const int C = cluster_size(B, sm_count(device));
  const long long per_b = per_element_floats(widths, n_layers, N);
  float* s = static_cast<float*>(scratch);
  float* partial = s + (size_t)B * per_b;
  cudaStream_t cs = static_cast<cudaStream_t>(stream);

  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3(B * C);
  cfg.blockDim = dim3(kThreads);
  cfg.dynamicSmemBytes = 0;
  cfg.stream = cs;
  cudaLaunchAttribute cluster[1];
  cluster[0].id = cudaLaunchAttributeClusterDimension;
  cluster[0].val.clusterDim.x = C;
  cluster[0].val.clusterDim.y = 1;
  cluster[0].val.clusterDim.z = 1;
  cfg.attrs = cluster;
  cfg.numAttrs = 1;
  cudaError_t e = cudaLaunchKernelEx(
      &cfg, dense_gnn_bwd_kernel, static_cast<const float*>(x),
      static_cast<const float*>(adj), static_cast<const float*>(g), st, N, C,
      need, static_cast<float*>(dx), static_cast<float*>(dadj), s, partial,
      per_b);
  if (e == cudaSuccess) e = cudaGetLastError();
  if (e != cudaSuccess || !(need & kNeedParams)) return e;
  sum_partials_kernel<<<(st.n_params + 255) / 256, 256, 0, cs>>>(
      partial, static_cast<float*>(dparams), B * C, st.n_params);
  return cudaGetLastError();
}

}  // extern "C"
