// Fused dense graph-conv stacks for Hopper (sm_90a), f32-accurate products
// on the tensor cores (3xTF32 mma.sync).
//
// Replaces two Pallas kernels of the JAX package:
//   gcm_tpu/ops/pallas/fused_gnn.py::_pallas_forward   (L-layer stack)
//   gcm_tpu/ops/pallas/dense_gconv.py::fused_dense_graph_conv (one layer)
// Each layer computes
//   h <- act((adj . h) . W_rel + b_rel + h . W_root), act in {none, tanh, relu}
// for x [B,N,F], adj [B,N,N] (row = sink; 0/1, or edge weights), W [F,Fo],
// b [Fo], all row-major.
//
// What bounds it on an H100: bytes. At the flagship serving shape (B=256,
// N=128, F=32, L=2) the inputs and output are 25.2 MB, 7.5 us at 3.35 TB/s,
// while the 0.8 GFLOP of products, done three times over as 3xTF32, take
// 4.9 us at the 495 TFLOP/s dense TF32 rate (67 TFLOP/s on the CUDA cores
// would take 12 us).
//
// What the design does about it:
// - Every product runs on the tensor cores as 3xTF32: each f32 operand is
//   split into hi = tf32(a) (rounded to nearest, ties away) and lo = a - hi,
//   and a.b = a_lo.b_hi + a_hi.b_lo + a_hi.b_hi, the two small terms first,
//   in m16n8k8 mma.sync, each k-step into a fresh accumulator added in f32.
//   That keeps the result within 1e-5 of the f32 plain version (one TF32
//   product alone misses it by 200x). The adjacency is split too, since a
//   weighted one has a nonzero lo.
// - Each warp owns 16 rows. Per layer it computes agg = adj . h (K = the
//   graph size) and then [agg | h] . [W_rel; W_root] (K = 2F), b_rel and the
//   activation in the epilogue. agg goes from the first product's
//   accumulators to the second's A operand through warp shuffles, with no
//   shared-memory round trip (the MMA's accumulator layout is not its A
//   layout, but two shuffles a value remap it).
// - One block owns one batch element of a stack (8 warps, 128 rows a pass),
//   so the adjacency is read from device memory once; with one pass it
//   stays in shared memory for every layer. It streams in with 16-byte
//   cp.async in chunks of 32 columns, the next chunk in flight while the
//   warps multiply the current one (all chunks in flight at once when the
//   adjacency stays resident), its 16-byte quads XOR-swizzled by row so that
//   the A loads hit distinct banks without padding.
// - h stays in shared memory between layers (in place with one pass; a
//   ping-pong pair with more), split once where it is written (x in the
//   prologue, each layer's epilogue) rather than by every warp that reads
//   it, in B-fragment order (quad_stride), so that a B fragment is one
//   128-bit load straight into the MMA's registers. Only where h does not
//   fit does it fall back to a global scratch ping-pong, which stays in L2,
//   split at each use. The weights sit in shared memory, zero-padded. At the
//   serving shape a block takes 108 KiB and 128 registers a thread, so two
//   blocks share each SM and the 256 blocks run in one wave.
// - Row strides are chosen so that every fragment load of a warp hits
//   distinct banks (the A loads of f32 h two ways at most).
// - Every output element is summed in a fixed order: no atomics, and
//   results are bitwise repeatable from run to run.
// - Every inner loop has a compile-time bound (the widest layer's n-tiles),
//   so that it unrolls into straight code and the MMAs of different n-tiles
//   interleave; a narrower layer's extra tiles load zeros. (Loops that
//   stopped at each layer's own width compiled into a branch between every
//   3-MMA chain, each chain then waiting out its full latency.)
// - A single layer whose batch leaves SMs without a block has no
//   dependency between row tiles: its grid splits the rows over blocks of
//   one or two 16-row tiles, and each tile gets 4 warps, which split its
//   columns and hand agg to each other through a shared-memory tile, so
//   that B=32, N=128 runs 1,024 warps, not 256.

#include <cuda_runtime.h>

#include <cstdint>

namespace {

constexpr int kTile = 16;        // rows of one warp's MMA tile
constexpr int kPassRows = 128;   // rows of one pass: 8 warps
constexpr int kChunk = 32;       // adjacency columns per cp.async chunk
constexpr int kMaxLayers = 4;
constexpr int kMaxWidth = 128;
constexpr int kMaxNodes = 1024;
constexpr int kSmemLimit = 232448;  // dynamic shared memory a block may use
constexpr int kSMs = 132;           // H100 SXM
constexpr int kXLoads = 4;          // loads of x a thread has in flight
constexpr int kSplit = 4;           // warps per row tile of a single layer

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

// How a block walks its rows and what it keeps in shared memory.
struct Plan {
  int rows;       // rows of a pass: 16 per row tile
  int passes;     // passes of a block over its rows
  int grid_y;     // blocks per batch element
  int nsplit;     // warps per row tile, each with its share of the columns
  int agg_stride; // floats per row of the agg tile (nsplit > 1)
  int chunks;     // adjacency chunks of kChunk columns
  int adj_bufs;   // chunk buffers: every chunk (resident) or 2 (streamed)
  int resident;   // one pass whose adjacency stays for every layer
  int fmax;
  int h_quads;    // quad stride of h in shared memory; 0: h in global memory
  int h_bufs;     // h buffers in shared memory
  int x_stride;   // a single layer's x staged as f32 with this stride; 0: not
  int w_floats;   // W_rel ; W_root of the largest layer, padded
  int smem;       // bytes
};

__host__ __device__ __forceinline__ int round8(int n) { return (n + 7) & ~7; }

// A row stride == 8 or 24 (mod 32) floats, at least n rounded up to 8: a
// B fragment's 4 rows x 8 columns then hit 32 distinct banks.
__host__ __device__ __forceinline__ int b_stride(int n) {
  const int r = round8(n);
  return r % 16 ? r : r + 8;
}

// h in shared memory, split and in B-fragment order: for rows k = 8G + t
// (t < 4) and column n, the quad at (4G + t) * stride + n holds
// (hi[k][n], hi[k+4][n], lo[k][n], lo[k+4][n]), so that a B fragment is one
// 128-bit load. A stride == 2 (mod 8) quads: the loads of a quarter-warp,
// 4 rows x 2 columns, hit distinct banks.
__host__ __device__ __forceinline__ int quad_stride(int n) {
  return round8(n) + 2;
}

__host__ __device__ __forceinline__ int quad_at(int k, int n, int stride) {
  return ((k >> 3) * 4 + (k & 3)) * stride + n;
}

// A block walks all N rows of one batch element, 8 warps, a 16-row tile
// each. A single layer has no dependency between row tiles, so where that
// would leave SMs idle its grid splits the rows over blocks of one or two
// tiles (one while the grid would have fewer than two blocks an SM), and
// each tile gets kSplit warps, which split its columns and hand agg to
// each other through a shared-memory tile (B=32, N=128: 1,024 warps, not
// 256).
Plan make_plan(const Stack& s, int B, int N) {
  Plan p{};
  const int L = s.n_layers;
  p.rows = N < kPassRows ? N : kPassRows;
  p.passes = (N + p.rows - 1) / p.rows;
  p.grid_y = 1;
  p.nsplit = 1;
  if (L == 1 && static_cast<long long>(B) * p.passes < kSMs) {
    p.nsplit = kSplit;
    p.rows = N < kPassRows / kSplit ? N : kPassRows / kSplit;
    while (p.rows % 32 == 0 &&
           static_cast<long long>(B) * ((N + p.rows - 1) / p.rows) < 2 * kSMs)
      p.rows /= 2;
    p.grid_y = (N + p.rows - 1) / p.rows;
    p.passes = 1;
  }
  p.agg_stride = round8(s.layer[0].fin) + 4;  // == 4 (mod 8): conflict-free A
  p.chunks = (N + kChunk - 1) / kChunk;
  p.fmax = s.layer[0].fin;
  for (int l = 0; l < L; ++l) {
    const Layer& ly = s.layer[l];
    p.fmax = ly.fout > p.fmax ? ly.fout : p.fmax;
    const int w = 2 * round8(ly.fin) * b_stride(ly.fout);
    p.w_floats = w > p.w_floats ? w : p.w_floats;
  }
  // h as quads: in place with one pass, when the second product's output
  // columns come in one piece (NTO covers them), else a ping-pong pair
  // (one buffer, x, for a single layer). Split blocks read x for their few
  // rows only, so they stage it as f32, 16 bytes a copy, and split at use.
  const bool quads = p.nsplit == 1;
  const bool in_place = p.passes == 1 && round8(p.fmax) <= 32;
  const int h_bufs = in_place || L == 1 ? 1 : 2;
  const long long chunk = 4LL * p.rows * kChunk;
  const int x_stride = b_stride(s.layer[0].fin);
  const long long h = quads ? 8LL * h_bufs * N * quad_stride(p.fmax)
                            : 4LL * N * x_stride;
  const long long w = 4LL * p.w_floats +
                      (p.nsplit > 1 ? 4LL * p.rows * p.agg_stride : 0);
  // the resident adjacency and h first, then a streamed adjacency with h,
  // then without (the weights always fit, beside two chunks)
  const struct { int adj_bufs, h; } options[] = {
      {p.passes == 1 ? p.chunks : 0, 1}, {2, 1}, {2, 0}};
  for (const auto& o : options) {
    if (!o.adj_bufs) continue;
    const long long bytes = o.adj_bufs * chunk + o.h * h + w;
    if (bytes > kSmemLimit) continue;
    p.adj_bufs = o.adj_bufs;
    p.resident = p.passes == 1 && o.adj_bufs == p.chunks;
    p.h_bufs = o.h && quads ? h_bufs : 0;
    p.h_quads = o.h && quads ? quad_stride(p.fmax) : 0;
    p.x_stride = o.h && !quads ? x_stride : 0;
    p.smem = int(bytes);
    return p;
  }
  p.adj_bufs = 0;  // unreachable for the shapes valid_stack takes
  return p;
}

// -- device helpers -----------------------------------------------------------

__device__ __forceinline__ void cp_async16(float* dst, const float* src) {
  const unsigned s = static_cast<unsigned>(__cvta_generic_to_shared(dst));
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(s),
               "l"(src)
               : "memory");
}

__device__ __forceinline__ void cp_async4(float* dst, const float* src) {
  const unsigned s = static_cast<unsigned>(__cvta_generic_to_shared(dst));
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4;\n" ::"r"(s), "l"(src)
               : "memory");
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}

// Waits until at most n groups of this thread's copies are in flight
// (n above 7 waits for 7: more than enough).
__device__ __forceinline__ void cp_async_wait(int n) {
  switch (n) {
    case 0: asm volatile("cp.async.wait_group 0;\n" ::: "memory"); break;
    case 1: asm volatile("cp.async.wait_group 1;\n" ::: "memory"); break;
    case 2: asm volatile("cp.async.wait_group 2;\n" ::: "memory"); break;
    case 3: asm volatile("cp.async.wait_group 3;\n" ::: "memory"); break;
    case 4: asm volatile("cp.async.wait_group 4;\n" ::: "memory"); break;
    case 5: asm volatile("cp.async.wait_group 5;\n" ::: "memory"); break;
    case 6: asm volatile("cp.async.wait_group 6;\n" ::: "memory"); break;
    default: asm volatile("cp.async.wait_group 7;\n" ::: "memory"); break;
  }
}

// v = hi + lo: hi is v rounded to TF32, to nearest with ties away from
// zero, the value cvt.rna.tf32.f32 gives, in two integer operations (the
// conversions cost more: measured); lo = v - hi is exact in f32, and the
// MMA reads its top 19 bits, so v - hi - lo is below 2^-21 of |v|.
__device__ __forceinline__ void split(float v, uint32_t& hi, uint32_t& lo) {
  hi = (__float_as_uint(v) + 0x1000u) & 0xffffe000u;
  lo = __float_as_uint(v - __uint_as_float(hi));
}

__device__ __forceinline__ float2 split2(float v) {
  uint32_t hi, lo;
  split(v, hi, lo);
  return make_float2(__uint_as_float(hi), __uint_as_float(lo));
}

__device__ __forceinline__ void mma(float* d, const uint32_t* a,
                                    const uint32_t* b) {
  asm("mma.sync.aligned.m16n8k8.row.col.f32.tf32.tf32.f32 "
      "{%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b[0]), "r"(b[1]));
}

// acc += a.b in 3xTF32: the two cross terms, then hi.hi, into a fresh
// accumulator, which is then added to acc in f32 (round to nearest): the
// tensor cores' own accumulation truncates, and would drift over a long K.
__device__ __forceinline__ void mma3(float* acc, const uint32_t* ah,
                                     const uint32_t* al, const uint32_t* bh,
                                     const uint32_t* bl) {
  float d[4] = {0.0f, 0.0f, 0.0f, 0.0f};
  mma(d, al, bh);
  mma(d, ah, bl);
  mma(d, ah, bh);
#pragma unroll
  for (int i = 0; i < 4; ++i) acc[i] += d[i];
}

// The B fragment of a row-major [K, n] f32 matrix at rows k, k+4 and column
// col, split; zero unless ok.
__device__ __forceinline__ void b_frag(const float* m, int stride, int k,
                                       int col, bool ok, uint32_t* hi,
                                       uint32_t* lo) {
  split(ok ? m[k * stride + col] : 0.0f, hi[0], lo[0]);
  split(ok ? m[(k + 4) * stride + col] : 0.0f, hi[1], lo[1]);
}

// The same from h's quads, split already.
__device__ __forceinline__ void b_frag(const float4* m, int stride, int k,
                                       int col, bool ok, uint32_t* hi,
                                       uint32_t* lo) {
  const float4 q = ok ? m[quad_at(k, col, stride)]
                      : make_float4(0.0f, 0.0f, 0.0f, 0.0f);
  hi[0] = __float_as_uint(q.x);
  hi[1] = __float_as_uint(q.y);
  lo[0] = __float_as_uint(q.z);
  lo[1] = __float_as_uint(q.w);
}

// Element (k, n) of h's quads: its hi, and its lo two floats further on.
__device__ __forceinline__ float* quad_elem(float4* m, int k, int n,
                                            int stride) {
  return reinterpret_cast<float*>(m + quad_at(k, n, stride)) + ((k >> 2) & 1);
}

__device__ __forceinline__ void put_split(float4* m, int k, int n,
                                          int stride, float v) {
  float* e = quad_elem(m, k, n, stride);
  const float2 q = split2(v);
  e[0] = q.x;
  e[2] = q.y;
}

__device__ __forceinline__ float apply_act(float v, int act) {
  if (act == kTanh) return tanhf(v);
  if (act == kRelu) return fmaxf(v, 0.0f);
  return v;
}

// Offset of (row, col) in an adjacency chunk buffer [rows][kChunk]: the
// 16-byte quads of a row are XOR-swizzled by row % 8, so that the A loads
// of a warp (8 rows x 4 columns) hit 32 distinct banks with no padding.
__device__ __forceinline__ int chunk_at(int row, int col) {
  return row * kChunk + ((((col >> 2) ^ row) & 7) << 2) + (col & 3);
}

// Copies adjacency rows row0 .. row0+nrows-1, columns of chunk c, into a
// chunk buffer, 16 bytes a copy.
__device__ __forceinline__ void load_chunk(float* buf, const float* adj_b,
                                           int N, int row0, int nrows, int c) {
  const int col0 = c * kChunk;
  const int q4 = (N - col0 < kChunk ? N - col0 : kChunk) / 4;
  for (int i = threadIdx.x; i < nrows * q4; i += blockDim.x) {
    const int r = i / q4, q = i - r * q4;
    cp_async16(buf + chunk_at(r, 4 * q),
               adj_b + size_t(row0 + r) * N + col0 + 4 * q);
  }
}

// Copies a row-major [rows, cols] matrix into shared memory with row stride
// `stride` (a multiple of 4), 16 bytes a copy where the rows allow, else 4.
// A thread keeps one column (of vectors) and strides over rows: one
// division per thread, not one per element.
__device__ __forceinline__ void stage(float* dst, int stride, const float* src,
                                      int rows, int cols) {
  const bool vec =
      cols % 4 == 0 && reinterpret_cast<uintptr_t>(src) % 16 == 0;
  const int v = vec ? 4 : 1, n = cols / v;
  auto copy = [&](int r, int q) {
    float* d = dst + r * stride + v * q;
    const float* s = src + size_t(r) * cols + v * q;
    if (vec) {
      cp_async16(d, s);
    } else {
      cp_async4(d, s);
    }
  };
  const int per = blockDim.x / n;  // rows a sweep of the block covers
  if (per == 0) {  // a row wider than the block
    for (int r = 0; r < rows; ++r)
      for (int q = threadIdx.x; q < n; q += blockDim.x) copy(r, q);
    return;
  }
  const int r0 = threadIdx.x / n, q = threadIdx.x - r0 * n;
  if (r0 >= per) return;
  for (int r = r0; r < rows; r += per) copy(r, q);
}

// Shared memory: [adjacency chunk buffers | h quads | W_rel ; W_root].
// NT: n-tiles of 8 columns that cover the widest layer, a compile-time
// bound for every inner loop, so that they unroll into straight code with
// no branch between the MMAs: a narrower layer's extra tiles load zeros.
// The second product takes its output columns NTO n-tiles at a time (the
// accumulators of both products stay in registers). QUADS: h lies in
// shared memory as quads (quad_stride), split once when written and
// zero-padded to a multiple of 8 columns; otherwise it is f32, split at
// each use: a single layer's x staged in shared memory, or x and a scratch
// ping-pong [2, B, N, fmax] in global memory.
template <int NT, int NTO, int MIN_BLOCKS, bool QUADS, int NSPLIT>
__global__ void __launch_bounds__(kPassRows / kTile * 32, MIN_BLOCKS)
dense_gnn_kernel(const float* __restrict__ x, const float* __restrict__ adj,
                 float* __restrict__ out, float* scratch, Stack stack, int N,
                 Plan p) {
  extern __shared__ __align__(16) float smem[];
  const int b = blockIdx.x;
  const int B = gridDim.x;
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int g = lane >> 2, t = lane & 3;
  const int L = stack.n_layers;
  const int fin0 = stack.layer[0].fin, fout_last = stack.layer[L - 1].fout;
  const int S4 = p.h_quads;

  float* adj_s = smem;
  float4* h4 =
      reinterpret_cast<float4*>(adj_s + p.adj_bufs * p.rows * kChunk);
  float* x_s = reinterpret_cast<float*>(h4);  // x_stride: f32 x
  float* w_s = p.x_stride
                   ? x_s + N * p.x_stride
                   : reinterpret_cast<float*>(h4 + p.h_bufs * N / 2 * S4);
  float* agg_s = w_s + p.w_floats;
  // a row tile per NSPLIT warps: this warp's tile and its share of the
  // n-tiles (NT of them; KT in all)
  constexpr int KT = NT * NSPLIT;
  const int rt = warp / NSPLIT, ng = warp - rt * NSPLIT;

  const float* x_b = x + size_t(b) * N * fin0;
  const float* adj_b = adj + size_t(b) * N * N;
  float* out_b = out + size_t(b) * N * fout_last;
  const int block_row0 = blockIdx.y * p.rows * p.passes;

  // The adjacency stream: chunk s of the sequence over (layer, pass, chunk)
  // goes to buffer s (resident) or s % 2 (streamed).
  const int per_layer = p.passes * p.chunks;
  const int n_seq = p.resident ? p.chunks : L * per_layer;
  auto issue = [&](int s) {
    const int pass = (s % per_layer) / p.chunks, c = s % p.chunks;
    const int row0 = block_row0 + pass * p.rows;
    const int nrows = N - row0 < p.rows ? N - row0 : p.rows;
    float* buf = adj_s + (p.resident ? c : s & 1) * p.rows * kChunk;
    load_chunk(buf, adj_b, N, row0, nrows, c);
    cp_async_commit();
  };
  // W_rel ; W_root of layer l, [round8(fin), b_stride(fout)] each, zero in
  // the padding
  auto stage_w = [&](int l) {
    const Layer& ly = stack.layer[l];
    const int st = b_stride(ly.fout), kp = round8(ly.fin);
    for (int r = threadIdx.x; r < 2 * kp; r += blockDim.x) {
      const bool pad_row = (r < kp ? r : r - kp) >= ly.fin;
      for (int c = pad_row ? 0 : ly.fout; c < st; ++c) w_s[r * st + c] = 0.0f;
    }
    stage(w_s, st, ly.w_rel, ly.fin, ly.fout);
    stage(w_s + kp * st, st, ly.w_root, ly.fin, ly.fout);
  };

  // x goes into its quads through registers: the first loads are issued
  // before any copy of the weights or the adjacency, so that x does not
  // queue behind them in device memory
  float4* x4 = h4 + (p.h_bufs - 1) * N / 2 * S4;
  const bool x_vec =
      fin0 % 4 == 0 && reinterpret_cast<uintptr_t>(x) % 16 == 0;
  const int x_n = x_vec ? N * fin0 / 4 : N * fin0;  // float4s or floats
  float4 xv[kXLoads];
  auto x_load = [&](int base) {
#pragma unroll
    for (int u = 0; u < kXLoads; ++u) {
      const int i = base + u * int(blockDim.x) + threadIdx.x;
      if (i >= x_n) break;
      if (x_vec) {
        xv[u] = __ldg(reinterpret_cast<const float4*>(x_b) + i);
      } else {
        xv[u].x = __ldg(x_b + i);
      }
    }
  };
  auto x_store = [&](int base) {
#pragma unroll
    for (int u = 0; u < kXLoads; ++u) {
      const int i = base + u * int(blockDim.x) + threadIdx.x;
      if (i >= x_n) break;
      if (x_vec) {
        const int r = 4 * i / fin0, c = 4 * i - r * fin0;
        put_split(x4, r, c, S4, xv[u].x);
        put_split(x4, r, c + 1, S4, xv[u].y);
        put_split(x4, r, c + 2, S4, xv[u].z);
        put_split(x4, r, c + 3, S4, xv[u].w);
      } else {
        const int r = i / fin0;
        put_split(x4, r, i - r * fin0, S4, xv[u].x);
      }
    }
  };
  if (QUADS) x_load(0);
  if (p.x_stride) stage(x_s, p.x_stride, x_b, N, fin0);
  stage_w(0);
  cp_async_commit();
  if (p.resident) {
    for (int s = 0; s < n_seq; ++s) issue(s);
  } else {
    issue(0);
  }
  if (QUADS) {
    const int step = kXLoads * blockDim.x;
    x_store(0);
    for (int base = step; base < x_n; base += step) {
      x_load(base);
      x_store(base);
    }
    const int fp = round8(fin0);  // zeros in the padded columns
    for (int r = threadIdx.x; r < N; r += blockDim.x)
      for (int c = fin0; c < fp; ++c) put_split(x4, r, c, S4, 0.0f);
  }

  int seq = 0;  // chunks consumed
  for (int l = 0; l < L; ++l) {
    const Layer ly = stack.layer[l];
    const int fin = ly.fin, fout = ly.fout;
    const int nt_in = round8(fin) / 8, nt_out = round8(fout) / 8;
    const bool last = l == L - 1;
    if (l) {
      __syncthreads();  // every warp is done with the last layer's W, h
      stage_w(l);       // waited for with the layer's first chunk
      cp_async_commit();
    }
    const int w_st = b_stride(fout);
    const float* w_rel = w_s;
    const float* w_root = w_s + round8(fin) * w_st;

    // h: quads in shared memory, or f32 in global memory
    const int hb = p.h_bufs - 1;  // 0 or 1: the ping-pong's mask
    const float4* hin4 = h4 + (l == 0 ? hb : (l - 1) & hb) * N / 2 * S4;
    float4* hout4 = h4 + (l & hb) * N / 2 * S4;
    const float* hin =
        l == 0 ? (p.x_stride ? x_s : x_b)
               : scratch + (size_t((l - 1) & 1) * B + b) * N * p.fmax;
    const int h_st = l == 0 ? (p.x_stride ? p.x_stride : fin0) : p.fmax;
    float* hout = last ? out_b : scratch + (size_t(l & 1) * B + b) * N * p.fmax;
    const int o_st = last ? fout : p.fmax;
    const bool quads_out = QUADS && !last;
    const bool in_place = quads_out && hout4 == hin4;

    for (int pass = 0; pass < p.passes; ++pass) {
      const int row0 = block_row0 + pass * p.rows;
      const int tile0 = row0 + rt * kTile;  // this warp's first row
      const bool active = tile0 < N;

      // agg = adj[tile rows, :] . h, chunk by chunk
      float acc1[NT][4];
#pragma unroll
      for (int nt = 0; nt < NT; ++nt)
        acc1[nt][0] = acc1[nt][1] = acc1[nt][2] = acc1[nt][3] = 0.0f;
      for (int c = 0; c < p.chunks; ++c, ++seq) {
        if (p.resident) {
          cp_async_wait(l ? 0 : p.chunks - 1 - c);
        } else {
          cp_async_wait(0);
        }
        __syncthreads();  // chunk c has landed; the other buffer is free
        if (!p.resident && seq + 1 < n_seq) issue(seq + 1);
        if (!active) continue;
        const float* A = adj_s + (p.resident ? c : seq & 1) * p.rows * kChunk +
                         rt * kTile * kChunk;
        const int kw = N - c * kChunk < kChunk ? N - c * kChunk : kChunk;
#pragma unroll
        for (int ks = 0; ks < kChunk; ks += 8) {
          const bool k_ok = ks < kw;  // a half chunk: zeros past its end
          uint32_t ah[4], al[4];
          split(k_ok ? A[chunk_at(g, ks + t)] : 0.0f, ah[0], al[0]);
          split(k_ok ? A[chunk_at(g + 8, ks + t)] : 0.0f, ah[1], al[1]);
          split(k_ok ? A[chunk_at(g, ks + t + 4)] : 0.0f, ah[2], al[2]);
          split(k_ok ? A[chunk_at(g + 8, ks + t + 4)] : 0.0f, ah[3], al[3]);
          const int k = c * kChunk + ks + t;
#pragma unroll
          for (int j = 0; j < NT; ++j) {
            const int col = (ng * NT + j) * 8 + g;
            uint32_t bh[2], bl[2];
            const bool ok = k_ok && ng * NT + j < nt_in;
            if (QUADS) {
              b_frag(hin4, S4, k, col, ok, bh, bl);
            } else {
              b_frag(hin, h_st, k, col, ok && col < fin, bh, bl);
            }
            mma3(acc1[j], ah, al, bh, bl);
          }
        }
      }
      float* a_s = agg_s + rt * kTile * p.agg_stride;
      if constexpr (NSPLIT > 1) {  // hand agg to the other warps of the row tile
#pragma unroll
        for (int j = 0; j < NT; ++j) {
          const int col = (ng * NT + j) * 8 + 2 * t;
          if (!active || ng * NT + j >= nt_in) break;
          a_s[g * p.agg_stride + col] = acc1[j][0];
          a_s[g * p.agg_stride + col + 1] = acc1[j][1];
          a_s[(g + 8) * p.agg_stride + col] = acc1[j][2];
          a_s[(g + 8) * p.agg_stride + col + 1] = acc1[j][3];
        }
        __syncthreads();
      }
      if (in_place) __syncthreads();  // no warp reads h as B any more
      if (!active) continue;

      // out = [agg | h] . [W_rel; W_root] + b_rel, NTO n-tiles at a time
      const int src = (lane & ~3) | (t >> 1);
      const bool odd = t & 1;
#pragma unroll
      for (int n0 = 0; n0 < NT; n0 += NTO) {
        const int o0 = ng * NT + n0;  // this pass's first output n-tile
        if (o0 >= nt_out) break;
        float acc2[NTO][4];
#pragma unroll
        for (int nt = 0; nt < NTO; ++nt)
          acc2[nt][0] = acc2[nt][1] = acc2[nt][2] = acc2[nt][3] = 0.0f;
#pragma unroll
        for (int kt = 0; kt < KT; ++kt) {  // agg . W_rel
          float a[4];
          if constexpr (NSPLIT == 1) {
            // agg's A fragment from the accumulators: lane (g, t) holds
            // columns 2t, 2t+1 of rows g, g+8; the fragment wants t, t+4
#pragma unroll
            for (int half = 0; half < 2; ++half) {
              const int from = src + 2 * half;
              const float c0 = __shfl_sync(0xffffffffu, acc1[kt][0], from);
              const float c1 = __shfl_sync(0xffffffffu, acc1[kt][1], from);
              const float c2 = __shfl_sync(0xffffffffu, acc1[kt][2], from);
              const float c3 = __shfl_sync(0xffffffffu, acc1[kt][3], from);
              a[2 * half] = odd ? c1 : c0;
              a[2 * half + 1] = odd ? c3 : c2;
            }
          } else {
            const bool ok = kt < nt_in;
            const int k0 = kt * 8 + t;
            a[0] = ok ? a_s[g * p.agg_stride + k0] : 0.0f;
            a[1] = ok ? a_s[(g + 8) * p.agg_stride + k0] : 0.0f;
            a[2] = ok ? a_s[g * p.agg_stride + k0 + 4] : 0.0f;
            a[3] = ok ? a_s[(g + 8) * p.agg_stride + k0 + 4] : 0.0f;
          }
          uint32_t ah[4], al[4];
#pragma unroll
          for (int i = 0; i < 4; ++i) split(a[i], ah[i], al[i]);
#pragma unroll
          for (int nt = 0; nt < NTO; ++nt) {
            uint32_t bh[2], bl[2];
            b_frag(w_rel, w_st, kt * 8 + t, (o0 + nt) * 8 + g,
                   kt < nt_in && o0 + nt < nt_out, bh, bl);
            mma3(acc2[nt], ah, al, bh, bl);
          }
        }
#pragma unroll
        for (int kt = 0; kt < KT; ++kt) {  // h . W_root
          const int k0 = kt * 8 + t, k1 = k0 + 4;
          const bool k_ok = kt < nt_in;
          uint32_t ah[4], al[4];
          if (QUADS) {
            float4* hq = const_cast<float4*>(hin4);
            const float* e[4] = {quad_elem(hq, tile0 + g, k0, S4),
                                 quad_elem(hq, tile0 + g + 8, k0, S4),
                                 quad_elem(hq, tile0 + g, k1, S4),
                                 quad_elem(hq, tile0 + g + 8, k1, S4)};
#pragma unroll
            for (int i = 0; i < 4; ++i) {
              ah[i] = k_ok ? __float_as_uint(e[i][0]) : 0u;
              al[i] = k_ok ? __float_as_uint(e[i][2]) : 0u;
            }
          } else {
            const float* hr = hin + tile0 * h_st;
            const float a[4] = {k0 < fin ? hr[g * h_st + k0] : 0.0f,
                                k0 < fin ? hr[(g + 8) * h_st + k0] : 0.0f,
                                k1 < fin ? hr[g * h_st + k1] : 0.0f,
                                k1 < fin ? hr[(g + 8) * h_st + k1] : 0.0f};
#pragma unroll
            for (int i = 0; i < 4; ++i) split(a[i], ah[i], al[i]);
          }
#pragma unroll
          for (int nt = 0; nt < NTO; ++nt) {
            uint32_t bh[2], bl[2];
            b_frag(w_root, w_st, k0, (o0 + nt) * 8 + g,
                   k_ok && o0 + nt < nt_out, bh, bl);
            mma3(acc2[nt], ah, al, bh, bl);
          }
        }
        __syncwarp();  // every lane has read its h rows before any is rewritten

#pragma unroll
        for (int nt = 0; nt < NTO; ++nt) {
          if (o0 + nt >= nt_out) break;
          const int col = (o0 + nt) * 8 + 2 * t;
          float v[4];
#pragma unroll
          for (int e = 0; e < 2; ++e) {
            const float bias =
                col + e < fout ? __ldg(ly.b_rel + col + e) : 0.0f;
            v[e] = apply_act(acc2[nt][e] + bias, ly.act);
            v[2 + e] = apply_act(acc2[nt][2 + e] + bias, ly.act);
          }
          if (quads_out) {  // the padded columns come out 0: W is 0 there
#pragma unroll
            for (int e = 0; e < 2; ++e) {
              put_split(hout4, tile0 + g, col + e, S4, v[e]);
              put_split(hout4, tile0 + g + 8, col + e, S4, v[2 + e]);
            }
          } else {
            float* o = hout + tile0 * o_st;
#pragma unroll
            for (int e = 0; e < 2; ++e) {
              if (col + e >= fout) continue;
              o[g * o_st + col + e] = v[e];
              o[(g + 8) * o_st + col + e] = v[2 + e];
            }
          }
        }
      }
    }
  }
}

bool valid_stack(const Stack& s, int B, int N) {
  if (B < 1 || B > 65535 || N < kTile || N > kMaxNodes || N % kTile)
    return false;
  if (s.n_layers < 1 || s.n_layers > kMaxLayers) return false;
  for (int l = 0; l < s.n_layers; ++l) {
    const Layer& L = s.layer[l];
    if (L.fin < 1 || L.fin > kMaxWidth || L.fout < 1 || L.fout > kMaxWidth)
      return false;
    if (L.act < kNone || L.act > kRelu) return false;
    if (l > 0 && L.fin != s.layer[l - 1].fout) return false;
  }
  return true;
}

template <int NT, int NTO, int MIN_BLOCKS, bool QUADS, int NSPLIT>
cudaError_t launch_k(const float* x, const float* adj, float* out,
                     float* scratch, const Stack& s, int B, int N,
                     const Plan& p, cudaStream_t stream) {
  auto kernel = dense_gnn_kernel<NT, NTO, MIN_BLOCKS, QUADS, NSPLIT>;
  cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, p.smem);
  if (err != cudaSuccess) return err;
  kernel<<<dim3(B, p.grid_y), p.rows / kTile * NSPLIT * 32, p.smem,
           stream>>>(x, adj, out, scratch, s, N, p);
  return cudaGetLastError();
}

template <int NT, int NTO, int MIN_BLOCKS>
cudaError_t launch_nt(const float* x, const float* adj, float* out,
                      float* scratch, const Stack& s, int B, int N,
                      const Plan& p, cudaStream_t stream) {
  if (p.h_quads)
    return launch_k<NT, NTO, MIN_BLOCKS, true, 1>(x, adj, out, scratch, s, B,
                                                  N, p, stream);
  return launch_k<NT, NTO, MIN_BLOCKS, false, 1>(x, adj, out, scratch, s, B,
                                                 N, p, stream);
}

int launch(const float* x, const float* adj, float* out, float* scratch,
           const Stack& s, int B, int N, int device, cudaStream_t stream) {
  if (!valid_stack(s, B, N)) return int(cudaErrorInvalidValue);
  const Plan p = make_plan(s, B, N);
  if (!p.adj_bufs) return int(cudaErrorInvalidValue);
  if (!p.h_quads && s.n_layers > 1 && scratch == nullptr)
    return int(cudaErrorInvalidValue);
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return int(err);
  if (p.nsplit > 1) {  // split blocks of a single layer: NT n-tiles a warp
    if (p.fmax <= 32)
      return int(launch_k<1, 1, 2, false, kSplit>(x, adj, out, scratch, s, B,
                                                  N, p, stream));
    if (p.fmax <= 64)
      return int(launch_k<2, 2, 2, false, kSplit>(x, adj, out, scratch, s, B,
                                                  N, p, stream));
    return int(launch_k<4, 4, 2, false, kSplit>(x, adj, out, scratch, s, B, N,
                                                p, stream));
  }
  // widths <= 32 in 128 registers, two blocks an SM (the serving shape)
  if (p.fmax <= 32)
    err = launch_nt<4, 4, 2>(x, adj, out, scratch, s, B, N, p, stream);
  else if (p.fmax <= 64)
    err = launch_nt<8, 4, 1>(x, adj, out, scratch, s, B, N, p, stream);
  else
    err = launch_nt<16, 4, 1>(x, adj, out, scratch, s, B, N, p, stream);
  return int(err);
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
  const Plan p = make_plan(s, B, N);
  if (p.h_quads || n_layers == 1) return 0;
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
