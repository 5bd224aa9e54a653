// Fused dense graph-conv stacks for Hopper (sm_90a), f32 throughout.
//
// Replaces two Pallas kernels of the JAX package:
//   gcm_tpu/ops/pallas/fused_gnn.py::_pallas_forward   (L-layer stack)
//   gcm_tpu/ops/pallas/dense_gconv.py::fused_dense_graph_conv (one layer)
// Each layer computes
//   h <- act((adj . h) . W_rel + b_rel + h . W_root),  act in {none, tanh, relu}
// for x [B,N,F], adj [B,N,N] (row = sink), W [F,Fo], b [Fo], all row-major.
//
// What bounds it on an H100: at the flagship serving shape (B=256, N=128,
// F=32, L=2) the inputs are ~25 MB, read once (~7.5 us at 3.35 TB/s), while
// the products are ~0.8 GFLOP, ~12 us at the 67 TFLOP/s non-tensor f32 rate.
// So the kernel is bound by operations, and this simple version, which does
// its FMAs one thread per output element from shared memory, is further
// bound by shared-memory bandwidth. Tensor cores (TF32 or bf16 wgmma) are
// the lever for a later version.
//
// What the design does about it: one block owns one batch element (and, for
// a single layer, one range of row tiles), so every adjacency byte is read
// from device memory once and every intermediate activation stays in shared
// memory between layers (falling back to a global scratch ping-pong, which
// stays in L2, only when 2*N*F floats do not fit). Every output element is
// summed by one thread in a fixed order: no atomics, and results are bitwise
// repeatable from run to run.

#include <cuda_runtime.h>

namespace {

constexpr int kThreads = 256;
constexpr int kRows = 16;         // adjacency rows staged per tile
constexpr int kMaxLayers = 4;
constexpr int kMaxWidth = 128;
constexpr int kMaxNodes = 1024;
constexpr int kSmemLimit = 232448;  // dynamic shared memory a block may use

enum Act { kNone = 0, kTanh = 1, kRelu = 2 };

struct Layer {
  const float* w_rel;   // [fin, fout]
  const float* b_rel;   // [fout]
  const float* w_root;  // [fin, fout]
  int fin, fout, act;
};

struct Stack {
  Layer layer[kMaxLayers];
  int n_layers;
};

struct Plan {
  int fmax, w_floats;
  size_t base_bytes, h_bytes;
  bool h_on_chip;
};

// Shared-memory regions start on 16-byte boundaries: the adjacency tile is
// written with float4 stores, whatever the feature widths.
__host__ __device__ __forceinline__ int round4(int n) { return (n + 3) & ~3; }

Plan make_plan(const Stack& s, int N) {
  Plan p{};
  p.fmax = s.layer[0].fin;
  for (int l = 0; l < s.n_layers; ++l) {
    const Layer& L = s.layer[l];
    p.fmax = L.fout > p.fmax ? L.fout : p.fmax;
    p.w_floats = L.fin * L.fout > p.w_floats ? L.fin * L.fout : p.w_floats;
  }
  p.w_floats = round4(p.w_floats);
  p.base_bytes = sizeof(float) * (size_t(2) * p.w_floats + round4(p.fmax) +
                                  size_t(kRows) * N + size_t(kRows) * p.fmax);
  p.h_bytes = sizeof(float) * size_t(2) * N * p.fmax;
  p.h_on_chip = p.base_bytes + p.h_bytes <= size_t(kSmemLimit);
  return p;
}

__device__ __forceinline__ float apply_act(float v, int act) {
  if (act == kTanh) return tanhf(v);
  if (act == kRelu) return fmaxf(v, 0.0f);
  return v;
}

// Shared memory: [w_rel | w_root | b_rel | adj tile | agg tile | h0 | h1],
// w_floats and the b_rel region rounded up to a multiple of 4 floats, the
// two h buffers only when h_on_chip. Otherwise h0/h1 live in `scratch`
// ([2, B, N, fmax]) and are reached through the same generic pointers.
__global__ void __launch_bounds__(kThreads)
dense_gnn_kernel(const float* __restrict__ x, const float* __restrict__ adj,
                 float* __restrict__ out, float* scratch, Stack stack, int N,
                 int fmax, int w_floats, int h_on_chip) {
  extern __shared__ float smem[];
  const int b = blockIdx.x;
  const int B = gridDim.x;
  const int tid = threadIdx.x;
  const int L = stack.n_layers;

  float* w_rel_s = smem;
  float* w_root_s = w_rel_s + w_floats;
  float* b_s = w_root_s + w_floats;
  float* adj_s = b_s + round4(fmax);
  float* agg_s = adj_s + kRows * N;
  float* buf[2];
  if (h_on_chip) {
    buf[0] = agg_s + kRows * fmax;
    buf[1] = buf[0] + N * fmax;
  } else {
    buf[0] = scratch + (size_t(0) * B + b) * N * fmax;
    buf[1] = scratch + (size_t(1) * B + b) * N * fmax;
  }

  const float* x_b = x + size_t(b) * N * stack.layer[0].fin;
  const float* adj_b = adj + size_t(b) * N * N;
  float* out_b = out + size_t(b) * N * stack.layer[L - 1].fout;

  for (int l = 0; l < L; ++l) {
    const Layer ly = stack.layer[l];
    const int fin = ly.fin, fout = ly.fout;
    __syncthreads();  // the previous layer is done with weights and h
    for (int i = tid; i < fin * fout; i += kThreads) {
      w_rel_s[i] = ly.w_rel[i];
      w_root_s[i] = ly.w_root[i];
    }
    for (int i = tid; i < fout; i += kThreads) b_s[i] = ly.b_rel[i];
    const float* hin;
    if (l == 0) {
      if (h_on_chip) {
        // layer 0 writes buf[0], so x is staged in buf[1]
        for (int i = tid; i < N * fin; i += kThreads) buf[1][i] = x_b[i];
        hin = buf[1];
      } else {
        hin = x_b;
      }
    } else {
      hin = buf[(l - 1) & 1];
    }
    float* hout = (l == L - 1) ? out_b : buf[l & 1];

    for (int r0 = blockIdx.y * kRows; r0 < N; r0 += gridDim.y * kRows) {
      // adjacency rows r0 .. r0+kRows-1 are contiguous: kRows*N floats
      const float4* src = reinterpret_cast<const float4*>(adj_b + size_t(r0) * N);
      float4* dst = reinterpret_cast<float4*>(adj_s);
      for (int i = tid; i < kRows * N / 4; i += kThreads) dst[i] = src[i];
      __syncthreads();

      // agg[r, f] = sum_j adj[r0+r, j] * h[j, f], j ascending
      for (int i = tid; i < kRows * fin; i += kThreads) {
        const int r = i / fin, f = i - r * fin;
        const float* arow = adj_s + r * N;
        float acc = 0.0f;
        for (int j = 0; j < N; ++j) acc = fmaf(arow[j], hin[j * fin + f], acc);
        agg_s[i] = acc;
      }
      __syncthreads();

      // out[r, o] = act(agg[r] . W_rel[:, o] + b[o] + h[r0+r] . W_root[:, o])
      for (int i = tid; i < kRows * fout; i += kThreads) {
        const int r = i / fout, o = i - r * fout;
        const float* arow = agg_s + r * fin;
        const float* hrow = hin + (r0 + r) * fin;
        float rel = 0.0f, root = 0.0f;
        for (int f = 0; f < fin; ++f) {
          rel = fmaf(arow[f], w_rel_s[f * fout + o], rel);
          root = fmaf(hrow[f], w_root_s[f * fout + o], root);
        }
        hout[(r0 + r) * fout + o] = apply_act(rel + b_s[o] + root, ly.act);
      }
      __syncthreads();  // adj_s and agg_s are reused by the next tile
    }
  }
}

bool valid_stack(const Stack& s, int B, int N) {
  if (B < 1 || B > 65535 || N < kRows || N > kMaxNodes || N % kRows) return false;
  if (s.n_layers < 1 || s.n_layers > kMaxLayers) return false;
  for (int l = 0; l < s.n_layers; ++l) {
    const Layer& L = s.layer[l];
    if (L.fin < 1 || L.fin > kMaxWidth || L.fout < 1 || L.fout > kMaxWidth) return false;
    if (L.act < kNone || L.act > kRelu) return false;
    if (l > 0 && L.fin != s.layer[l - 1].fout) return false;
  }
  return true;
}

int launch(const float* x, const float* adj, float* out, float* scratch,
           const Stack& s, int B, int N, int device, cudaStream_t stream) {
  if (!valid_stack(s, B, N)) return int(cudaErrorInvalidValue);
  const Plan p = make_plan(s, N);
  if (!p.h_on_chip && s.n_layers > 1 && scratch == nullptr)
    return int(cudaErrorInvalidValue);
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return int(err);
  const size_t smem = p.base_bytes + (p.h_on_chip ? p.h_bytes : 0);
  err = cudaFuncSetAttribute(dense_gnn_kernel,
                             cudaFuncAttributeMaxDynamicSharedMemorySize,
                             int(smem));
  if (err != cudaSuccess) return int(err);
  // A single layer has no dependency between row tiles, so its tiles get
  // blocks of their own; a stack needs all rows of h between layers.
  const dim3 grid(B, s.n_layers == 1 ? N / kRows : 1);
  dense_gnn_kernel<<<grid, kThreads, smem, stream>>>(
      x, adj, out, scratch, s, N, p.fmax, p.w_floats, p.h_on_chip ? 1 : 0);
  return int(cudaGetLastError());
}

}  // namespace

extern "C" {

// Floats of global scratch that gcm_fused_dense_gnn_f32 needs: 0 when the
// intermediate activations fit in shared memory.
long long gcm_dense_gnn_scratch_floats(const int* widths, int n_layers, int B,
                                       int N) {
  Stack s{};
  s.n_layers = n_layers;
  for (int l = 0; l < n_layers && l < kMaxLayers; ++l) {
    s.layer[l].fin = widths[l];
    s.layer[l].fout = widths[l + 1];
  }
  if (!valid_stack(s, B, N)) return -1;
  const Plan p = make_plan(s, N);
  if (p.h_on_chip || n_layers == 1) return 0;
  return 2LL * B * N * p.fmax;
}

// x [B,N,widths[0]], adj [B,N,N], out [B,N,widths[L]]; per layer l the
// pointers w_rel[l], w_root[l] ([widths[l], widths[l+1]]) and b_rel[l]
// ([widths[l+1]]); acts[l] in {0 none, 1 tanh, 2 relu}.
int gcm_fused_dense_gnn_f32(const void* x, const void* adj, void* out,
                            void* scratch, const void* const* w_rel,
                            const void* const* b_rel,
                            const void* const* w_root, const int* widths,
                            const int* acts, int n_layers, int B, int N,
                            int device, void* stream) {
  if (n_layers < 1 || n_layers > kMaxLayers) return int(cudaErrorInvalidValue);
  Stack s{};
  s.n_layers = n_layers;
  for (int l = 0; l < n_layers; ++l) {
    s.layer[l] = Layer{static_cast<const float*>(w_rel[l]),
                       static_cast<const float*>(b_rel[l]),
                       static_cast<const float*>(w_root[l]), widths[l],
                       widths[l + 1], acts[l]};
  }
  return launch(static_cast<const float*>(x), static_cast<const float*>(adj),
                static_cast<float*>(out), static_cast<float*>(scratch), s, B, N,
                device, static_cast<cudaStream_t>(stream));
}

// One layer: x [B,N,F], adj [B,N,N], w_rel/w_root [F,Fo], b_rel [Fo],
// out [B,N,Fo].
int gcm_fused_dense_graph_conv_f32(const void* x, const void* adj,
                                   const void* w_rel, const void* b_rel,
                                   const void* w_root, void* out, int B, int N,
                                   int F, int Fo, int act, int device,
                                   void* stream) {
  Stack s{};
  s.n_layers = 1;
  s.layer[0] = Layer{static_cast<const float*>(w_rel),
                     static_cast<const float*>(b_rel),
                     static_cast<const float*>(w_root), F, Fo, act};
  return launch(static_cast<const float*>(x), static_cast<const float*>(adj),
                static_cast<float*>(out), nullptr, s, B, N, device,
                static_cast<cudaStream_t>(stream));
}

}  // extern "C"
