// Backward of the fused dense graph-conv stack for Hopper (sm_90a), its
// products f32-accurate on the tensor cores (3xTF32 mma.sync).
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
// What bounds it on an H100: operations, three TF32 products for each
// f32-accurate one at the dense TF32 rate of 495 TFLOP/s; the bytes (each
// input read once, each output written once) at 3.35 TB/s take less. The
// dense scan's training step (B=32, N=128, 32->32->32, no dadj): 1.42 us,
// bytes 1.11; the served batch (B=256): 11.4 us, bytes 8.8; the streamed
// shape (B=8, N=512, 64->64->64, dadj): 12.2 us, bytes 6.0. At these sizes
// a block's fixed costs weigh more than its products: the loads of its
// adjacency rows and columns, the barriers between the phases (a layer's
// products depend on each other in turn), the copies of its peers' rows.
//
// What the design does about it:
// - Every product runs on the tensor cores as 3xTF32 m16n8k8 mma.sync, as
//   in csrc/dense_gnn.cu: each f32 operand (the adjacency too: a weighted
//   one has a nonzero low half) is split into hi = tf32(v) and lo = v - hi,
//   and each k-step's a_lo.b_hi + a_hi.b_lo + a_hi.b_hi goes into a fresh
//   accumulator, added in f32; a warp loads the fragments of two k-steps
//   (one at eight n-tiles) before their MMAs, so that several chains of
//   three dependent MMAs are in flight.
// - A cluster of C blocks (C of 1, 2, 4, 8, 16; above 8 non-portable)
//   shares a batch element, block c owning rows [c R, c R + R), R a
//   multiple of 16 up to 64 (the last block may own fewer), 8 warps a
//   block, each a 16-row tile and every wn-th n-tile of 8 columns (NT of
//   them, the template argument, 1 to 8). C is the size of the least
//   estimated time (choose_plan): waves of blocks over the SMs, clusters
//   of C holding at most what cudaOccupancyMaxActiveClusters says, times a
//   block's rows plus its fixed costs, which grow with C. The dense scan
//   (B=32) runs C = 4, 128 blocks in one wave (two fit an SM); the served
//   batch (B=256) C = 2, 512 blocks a block an SM; the streamed shape
//   (B=8, N=512) C = 8, 64 blocks: clusters of 16 fill 128 SMs but their
//   barriers and copies over 16 blocks cost more than the idle SMs
//   (chip_smoke.py times every C of every case beside the plan's). N =
//   1,024 needs C = 16 (32 blocks at B=2). A size the card cannot hold is
//   never chosen; none at all raises.
// - What a block keeps in shared memory (kRoutes, in order of preference;
//   chip_smoke.py has a case on each): its rows, the adjacency's rows and
//   columns and the weights, at N <= 128 and widths to 32 (the scan, the
//   served batch); its rows and the weights, the adjacency streamed in
//   chunks, at N = 1,024 and width 32; its rows only, the weights read
//   from device memory, at N = 512 and width 64 (the streamed shape) or
//   width 128 at N = 128; nothing but chunks, the rows in a per-element
//   global scratch, only where no C holds them on chip: N >= 768 with wide
//   stacks (N = 768 at L >= 3 and width 128, N = 1,024 at L >= 2 and
//   widths over 96). The rows are h_0..h_{L-1}, agg_0..agg_{L-1}, gz (two
//   buffers) and dagg (two: no block overwrites rows a peer still reads).
//   The products that need every row of h or dagg (agg = adj . h, dadj =
//   dagg . h^T, dh = adj^T . dagg) copy them in chunks, 16 bytes a load,
//   peers' rows by ld.shared::cluster (distributed shared memory, after
//   barrier.cluster), the next chunk's loads in flight during the current
//   chunk's MMAs; from scratch, which stays in L2, they are read past L1
//   (ld.cg) and published by __threadfence before the cluster barrier.
// - cp.async, 16 bytes a copy (4 where a row is not a multiple of 4): x's
//   and the adjacency's rows before the first product; the weights, the
//   biases, the adjacency's columns and g during it; where the adjacency
//   does not fit, its row and column chunks double-buffered beside the
//   h / dagg chunks, the next in flight during the current one's MMAs.
// - Row strides are chosen so that the A loads of a warp (the adjacency's
//   rows, its columns transposed, the block's own rows) and the B loads of
//   the staged chunks hit distinct banks; the transposed reads of the dW
//   products and of W^T conflict two ways at most.
// - No float atomics: each block's dW and db partials over its rows go to
//   a buffer, and a second kernel sums them over (b, block), 16 strided
//   slices a parameter, each in order, then the slices in order; db sums
//   its rows in 8 groups, then the groups, in order. Every output is summed
//   in a fixed order, so reruns are bitwise equal.
//
// Registers and shared memory a block (ptxas -v of the sm_90a build, which
// chip_smoke.py prints and checks for spills; the plans it prints): the
// kernel at NT = 1, held to 128 registers so that two blocks fit an SM,
// uses 128, NT = 2 221, NT = 4 241, NT = 8 255, none spills; the scan's
// plan takes 115,456 bytes of dynamic shared memory, the served batch's
// 185,600, the streamed shape's 195,072. sum_partials_kernel: 24
// registers, 2,112 bytes of static shared memory.

#include <cooperative_groups.h>
#include <cuda_runtime.h>

#include <cstdint>
#include <mutex>

#include "sm_count.cuh"

namespace {

namespace cg = cooperative_groups;

constexpr int kMaxLayers = 4;
constexpr int kMaxWidth = 128;
constexpr int kMaxNodes = 1024;
constexpr int kMaxCluster = 16;
constexpr int kSmemLimit = 232448;  // dynamic shared memory a block may use
constexpr int kSmemPerSM = 233472;  // shared memory of an SM
constexpr int kSmemReserved = 1024; // of it, the system's a block
constexpr int kMaxStage = 4;        // float4s a thread holds of a chunk
constexpr int kWarps = 8;           // warps a block
constexpr int kMaxTiles = 4;        // 16-row tiles a block: R <= 64

enum Act { kNone = 0, kTanh = 1, kRelu = 2 };
enum Need { kNeedX = 1, kNeedAdj = 2, kNeedParams = 4 };

struct Stack {
  const float* w_rel[kMaxLayers];
  const float* b_rel[kMaxLayers];
  const float* w_root[kMaxLayers];
  int width[kMaxLayers + 1];
  int act[kMaxLayers];
  int poff[kMaxLayers];  // offset of layer l's (dW_rel, db_rel, dW_root)
  int woff[kMaxLayers];  // offset of layer l's resident W_rel ; W_root
  int n_layers;
  int fmax;
  int n_params;          // floats of all parameter gradients
};

// How the blocks of a batch element split it and what they keep where.
struct Plan {
  int C;         // blocks a batch element: one cluster
  int R;         // rows a block (the last may own fewer)
  int wn;        // warps across the n-tiles of a row tile
  int nt;        // n-tiles a warp (the kernel's template argument)
  int onchip;    // the blocks' rows in shared memory, else global scratch
  int adj_res;   // the adjacency's rows and columns resident
  int w_res;     // the weights resident
  int gk;        // rows of a staged chunk
  int sf;        // row stride of the rows' matrices
  int bs;        // row stride of the biases (one row a layer)
  int cs;        // row stride of a staged chunk
  int o_w, o_b, o_adj, o_buf;  // shared-memory offsets (floats)
  int smem;      // bytes
  int resident;  // blocks the card holds at once in clusters of C
  long long scratch_per_b;  // floats of global scratch a batch element
};

__host__ __device__ __forceinline__ int round8(int n) { return (n + 7) & ~7; }

// A row stride == 8 or 24 (mod 32), at least n rounded up to 8: the B
// loads of a warp (4 rows x 8 columns) hit 32 distinct banks.
__host__ __device__ __forceinline__ int b_stride(int n) {
  const int r = round8(n);
  return r % 16 ? r : r + 8;
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

__device__ __forceinline__ void cp_async_wait_all() {
  asm volatile("cp.async.wait_group 0;\n" ::: "memory");
}

// Copies a [rows, cols] matrix (row stride sld) to dst (row stride dld, a
// multiple of 4): into shared memory with cp.async, 16 bytes a copy where
// the rows allow, else 4; into global scratch through registers. A thread
// keeps one column (of vectors) and strides over rows.
__device__ __forceinline__ void copy_in(float* dst, int dld,
                                        const float* src, int sld, int rows,
                                        int cols, bool shared) {
  const bool vec = cols % 4 == 0 && sld % 4 == 0 &&
                   reinterpret_cast<uintptr_t>(src) % 16 == 0;
  const int v = vec ? 4 : 1, n = cols / v, per = blockDim.x / n;
  int r = 0, rstep = 1, q0 = threadIdx.x, qstep = blockDim.x;
  if (per > 0) {  // rows of at most blockDim.x vectors: a column a thread
    r = threadIdx.x / n;
    rstep = per;
    q0 = threadIdx.x - r * n;
    qstep = n;
    if (r >= per) return;
  }
  for (; r < rows; r += rstep)
    for (int q = q0; q < n; q += qstep) {
      float* d = dst + r * dld + v * q;
      const float* s = src + size_t(r) * sld + v * q;
      if (!shared) {
        for (int i = 0; i < v; ++i) d[i] = s[i];
      } else if (vec) {
        cp_async16(d, s);
      } else {
        cp_async4(d, s);
      }
    }
}

// v = hi + lo: hi is v rounded to TF32, to nearest with ties away from
// zero; lo = v - hi is exact in f32, and the MMA reads its top 19 bits.
__device__ __forceinline__ void split(float v, uint32_t& hi, uint32_t& lo) {
  hi = (__float_as_uint(v) + 0x1000u) & 0xffffe000u;
  lo = __float_as_uint(v - __uint_as_float(hi));
}

__device__ __forceinline__ void mma(float* d, const uint32_t* a,
                                    const uint32_t* b) {
  asm("mma.sync.aligned.m16n8k8.row.col.f32.tf32.tf32.f32 "
      "{%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b[0]), "r"(b[1]));
}

// An MMA operand: element (r, c) at p[r * sr + c * sc], zero outside
// [0, rows) x [0, cols) (a transpose swaps the strides).
struct Opnd {
  const float* p;
  int sr, sc, rows, cols;
};

// acc[4 j + e] += sum over k < K of a(i, k) b(k, n) in 3xTF32 (for each
// k-step, a_lo.b_hi + a_hi.b_lo + a_hi.b_hi, the two small terms first,
// into a fresh accumulator, then added to acc in f32: the tensor cores'
// own accumulation truncates), for the warp's 16 rows i of a and the
// columns n of its n-tiles slice + j wn of b (j < NT), k ascending in
// steps of 8; e: row g (e < 2) or g + 8, column 8 (slice + j wn) + 2t +
// e % 2.
template <int NT>
__device__ __forceinline__ void warp_gemm(float* acc, Opnd a, Opnd b, int K,
                                          int slice, int wn) {
  const int lane = threadIdx.x & 31, g = lane >> 2, t = lane & 3;
  float c[NT][4];
#pragma unroll
  for (int j = 0; j < NT; ++j)
#pragma unroll
    for (int e = 0; e < 4; ++e) c[j][e] = acc[4 * j + e];
  const bool r0 = g < a.rows, r1 = g + 8 < a.rows;
  const float* pa = a.p + g * a.sr + t * a.sc;
  const int a8 = 8 * a.sr, a4 = 4 * a.sc;
  const float* pb = b.p + t * b.sr;
  const int b4 = 4 * b.sr;
  // KG k-steps a pass, their fragments loaded first, so that NT x KG
  // chains of three dependent MMAs are in flight at once; each k-step's
  // sum still joins the accumulator in ascending k
  constexpr int KG = NT >= 8 ? 1 : 2;
  for (int k0 = 0; k0 < K; k0 += 8 * KG) {
    uint32_t ah[KG][4], al[KG][4];
#pragma unroll
    for (int s = 0; s < KG; ++s) {
      const int k = k0 + 8 * s;
      const bool ka0 = k + t < a.cols, ka1 = k + t + 4 < a.cols;
      const float* q = pa + 8 * s * a.sc;
      split(r0 && ka0 ? q[0] : 0.f, ah[s][0], al[s][0]);
      split(r1 && ka0 ? q[a8] : 0.f, ah[s][1], al[s][1]);
      split(r0 && ka1 ? q[a4] : 0.f, ah[s][2], al[s][2]);
      split(r1 && ka1 ? q[a8 + a4] : 0.f, ah[s][3], al[s][3]);
    }
#pragma unroll
    for (int j = 0; j < NT; ++j) {
      float d[KG][4];
#pragma unroll
      for (int s = 0; s < KG; ++s) {
        const int k = k0 + 8 * s, n = (slice + j * wn) * 8 + g;
        const bool kb0 = n < b.cols && k + t < b.rows;
        const bool kb1 = n < b.cols && k + t + 4 < b.rows;
        const float* q = pb + 8 * s * b.sr + n * b.sc;
        uint32_t bh[2], bl[2];
        split(kb0 ? q[0] : 0.f, bh[0], bl[0]);
        split(kb1 ? q[b4] : 0.f, bh[1], bl[1]);
        d[s][0] = d[s][1] = d[s][2] = d[s][3] = 0.f;
        mma(d[s], al[s], bh);
        mma(d[s], ah[s], bl);
        mma(d[s], ah[s], bh);
      }
#pragma unroll
      for (int s = 0; s < KG; ++s)
#pragma unroll
        for (int e = 0; e < 4; ++e) c[j][e] += d[s][e];
    }
    pa += 8 * KG * a.sc;
    pb += 8 * KG * b.sr;
  }
#pragma unroll
  for (int j = 0; j < NT; ++j)
#pragma unroll
    for (int e = 0; e < 4; ++e) acc[4 * j + e] = c[j][e];
}

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

// What an epilogue stores at (row, col) of dst for an accumulator v:
// kPut v; kAct act(v + bias[col]); kGzLast dst * act'(act(v + bias[col]))
// (dst holds g); kGzNext v * act'(aux[row][col]); kAccum v, or dst + v
// unless first.
enum EpiMode { kPut, kAct, kGzLast, kGzNext, kAccum };

struct Epi {
  float* dst;   // the warp's first output row
  int ld;
  int rows, cols;  // stored where row < rows and col < cols
  int mode, act;
  const float* bias;
  const float* aux;  // the warp's first row of act''s input (kGzNext)
  int first;
};

// The warp's accumulators (as warp_gemm leaves them) into e.dst, G tiles
// at a time (four, two at eight n-tiles a warp), their values computed (and
// loads made) before their stores.
template <int NT>
__device__ __forceinline__ void epilogue(const float* acc, int slice, int wn,
                                         Epi e) {
  constexpr int G = NT < 4 ? NT : NT >= 8 ? 2 : 4;
  const int lane = threadIdx.x & 31, g = lane >> 2, t = lane & 3;
#pragma unroll
  for (int j0 = 0; j0 < NT; j0 += G) {
    float v[G][4];
    bool ok[G][4];
    int at[G][4];
#pragma unroll
    for (int jj = 0; jj < G; ++jj)
#pragma unroll
      for (int q = 0; q < 4; ++q) {
        const int j = j0 + jj;
        const int row = g + 8 * (q >> 1);
        const int col = (slice + j * wn) * 8 + 2 * t + (q & 1);
        const bool o = row < e.rows && col < e.cols;
        const int a = row * e.ld + col;
        const float x = acc[4 * j + q];
        float r = x;
        if (e.mode == kAct || e.mode == kGzLast) {
          r = act_fwd(x + (o ? e.bias[col] : 0.f), e.act);
          if (e.mode == kGzLast) r = (o ? e.dst[a] : 0.f) * act_grad(r, e.act);
        } else if (e.mode == kGzNext) {
          r = x * act_grad(o ? e.aux[a] : 0.f, e.act);
        } else if (e.mode == kAccum && !e.first) {
          r = (o ? e.dst[a] : 0.f) + x;
        }
        v[jj][q] = r;
        ok[jj][q] = o;
        at[jj][q] = a;
      }
#pragma unroll
    for (int jj = 0; jj < G; ++jj)
#pragma unroll
      for (int q = 0; q < 4; ++q)
        if (ok[jj][q]) e.dst[at[jj][q]] = v[jj][q];
  }
}

// Every block of the cluster has reached this point, and what each wrote
// before it (to shared memory, or to device memory with scratch) is
// visible to all; a block-wide barrier where C = 1.
__device__ __forceinline__ void cluster_sync(int C, bool fence) {
  if (C == 1) {
    __syncthreads();
    return;
  }
  if (fence) __threadfence();
  asm volatile(
      "barrier.cluster.arrive.release.aligned;\n\t"
      "barrier.cluster.wait.acquire.aligned;" ::: "memory");
}

// A [N, fw] matrix whose rows [c R, c R + R) block c of the cluster holds:
// `own` points at this block's rows, in its shared memory (on chip: the
// same offset in every block) or in a global scratch matrix (row stride
// ld either way).
struct Rows {
  float* own;
  int ld;
};

// The block-wide context of one batch element.
struct Ctx {
  int N, R, rank, r0, rc, onchip;
  float inv_r;              // 1 / R, for a row's block
  int gk, cs;
  int adj_res, ldr, ldc;    // adjacency row / column buffers' strides
  float* adj_rows;          // resident [R][N + 4], or 2 chunks [R][gk + 4]
  float* adj_cols;          // resident [N][R + 8], or 2 chunks [gk][R + 8]
  float* buf;               // staged chunks [gk][cs], one or two
  const float* adj_b;       // the element's adjacency in device memory
};

// A warp's share of the block's row-tile products: row tile row0, n-tiles
// slice + j wn.
struct Warp {
  int row0, slice, wn, active, warp, warps;
};

// Rows [k0, k0 + kw) of m, its first ceil(fw / 4) float4s a row, as this
// thread's share (a column of float4s, every `per`-th row; kw at most
// kMaxStage per): on chip from the cluster's blocks' shared memory
// (ld.shared::cluster), else from scratch past L1. load() puts them in
// flight, store() writes them into a chunk buffer.
struct Stage {
  float4 v[kMaxStage];
  int col, row0, per;

  __device__ __forceinline__ void init(int fw) {
    const int fq = (fw + 3) / 4;
    per = blockDim.x / fq;
    row0 = threadIdx.x / fq;
    col = threadIdx.x - row0 * fq;
    if (row0 >= per) row0 = 1 << 20;  // no rows for this thread
  }

  __device__ __forceinline__ void load(const Ctx& cx, Rows m, int k0,
                                       int kw) {
#pragma unroll
    for (int u = 0; u < kMaxStage; ++u) {
      const int r = row0 + u * per;
      if (r >= kw) continue;
      const int row = k0 + r;
      const int o = __float2int_rz((row + 0.5f) * cx.inv_r);
      if (cx.onchip && o != cx.rank) {  // a peer's row
        const unsigned local = static_cast<unsigned>(__cvta_generic_to_shared(
            m.own + (row - o * cx.R) * m.ld + 4 * col));
        unsigned remote;
        asm volatile("mapa.shared::cluster.u32 %0, %1, %2;"
                     : "=r"(remote) : "r"(local), "r"(o));
        asm volatile("ld.shared::cluster.v4.f32 {%0, %1, %2, %3}, [%4];"
                     : "=f"(v[u].x), "=f"(v[u].y), "=f"(v[u].z), "=f"(v[u].w)
                     : "r"(remote));
      } else if (cx.onchip) {  // this block's own row
        v[u] = *reinterpret_cast<const float4*>(m.own + (row - cx.r0) * m.ld +
                                                4 * col);
      } else {
        v[u] = __ldcg(reinterpret_cast<const float4*>(
            m.own + (row - cx.r0) * m.ld + 4 * col));
      }
    }
  }

  __device__ __forceinline__ void store(float* dst, int cs, int kw) const {
#pragma unroll
    for (int u = 0; u < kMaxStage; ++u) {
      const int r = row0 + u * per;
      if (r < kw) *reinterpret_cast<float4*>(dst + r * cs + 4 * col) = v[u];
    }
  }
};

// The adjacency's chunk q (columns, or rows, [q gk, q gk + kw)) of this
// block's rows and of its columns, into chunk buffer q % 2; rows / cols
// say which of the two the caller reads.
__device__ __forceinline__ void issue_adj(const Ctx& cx, int q, bool rows,
                                          bool cols) {
  const int k0 = q * cx.gk, kw = min(cx.gk, cx.N - k0);
  if (rows)
    copy_in(cx.adj_rows + (q & 1) * cx.R * cx.ldr, cx.ldr,
            cx.adj_b + size_t(cx.r0) * cx.N + k0, cx.N, cx.rc, kw, true);
  if (cols)
    copy_in(cx.adj_cols + (q & 1) * cx.gk * cx.ldc, cx.ldc,
            cx.adj_b + size_t(k0) * cx.N + cx.r0, cx.N, kw, cx.rc, true);
}

// The products over every row of m (fw columns), walked in chunks of gk
// rows gathered into the chunk buffers (the adjacency's chunks, where it
// streams, double-buffered with cp.async, the next in flight during the
// current one's MMAs):
//   kAggSweep  acc += adj[rows, :] . m
//   kDhSweep   acc += adj^T[rows, :] . m
//   kDadjSweep dadj[rows, :] = dagg[rows] . m^T (+ dadj unless first),
//              16 x 32 strips a warp, round robin.
enum Sweep { kAggSweep, kDhSweep, kDadjSweep };

template <int NT>
__device__ __forceinline__ void sweep(const Ctx& cx, int mode, Rows m, int fw,
                                      float* acc, Warp w, Rows dg,
                                      float* dadj_b, int first) {
  const int n = (cx.N + cx.gk - 1) / cx.gk;
  const bool rows = mode == kAggSweep, cols = mode == kDhSweep;
  const bool stream_adj = !cx.adj_res && (rows || cols);
  Stage s;
  s.init(fw);
  s.load(cx, m, 0, min(cx.gk, cx.N));
  __syncthreads();  // the buffers' last readers are done
  if (stream_adj) issue_adj(cx, 0, rows, cols);
  cp_async_commit();
  s.store(cx.buf, cx.cs, min(cx.gk, cx.N));
  for (int q = 0; q < n; ++q) {
    const int k0 = q * cx.gk, kw = min(cx.gk, cx.N - k0);
    const float* bb = cx.buf + (q & 1) * cx.gk * cx.cs;
    if (stream_adj) cp_async_wait_all();
    __syncthreads();  // chunk q is in place; the other buffers are free
    const bool next = q + 1 < n;
    if (next) {
      if (stream_adj) issue_adj(cx, q + 1, rows, cols);
      cp_async_commit();
      s.load(cx, m, k0 + cx.gk, min(cx.gk, cx.N - k0 - cx.gk));
    }
    if (mode == kDadjSweep) {
      const int mtiles = cx.rc / 16, strips = (kw + 31) / 32;
      for (int task = w.warp; task < mtiles * strips; task += w.warps) {
        const int m0 = (task / strips) * 16, n0 = (task % strips) * 32;
        float t4[16] = {};
        warp_gemm<4>(t4, Opnd{dg.own + m0 * dg.ld, dg.ld, 1, 16, fw},
                     Opnd{bb + n0 * cx.cs, 1, cx.cs, fw, kw - n0}, fw, 0, 1);
        epilogue<4>(t4, 0, 1,
                    Epi{dadj_b + size_t(m0) * cx.N + k0 + n0, cx.N, 16,
                        kw - n0, kAccum, 0, nullptr, nullptr, first});
      }
    } else if (w.active) {
      const Opnd b{bb, cx.cs, 1, kw, fw};
      if (rows) {
        const float* ar = cx.adj_res ? cx.adj_rows + k0
                                     : cx.adj_rows + (q & 1) * cx.R * cx.ldr;
        warp_gemm<NT>(acc, Opnd{ar + w.row0 * cx.ldr, cx.ldr, 1, 16, kw}, b,
                      kw, w.slice, w.wn);
      } else {
        const float* ac = cx.adj_res ? cx.adj_cols + size_t(k0) * cx.ldc
                                     : cx.adj_cols + (q & 1) * cx.gk * cx.ldc;
        warp_gemm<NT>(acc, Opnd{ac + w.row0, 1, cx.ldc, 16, kw}, b, kw,
                      w.slice, w.wn);
      }
    }
    if (next) s.store(cx.buf + ((q + 1) & 1) * cx.gk * cx.cs, cx.cs,
                      min(cx.gk, cx.N - k0 - cx.gk));
  }
}

// A cluster of C blocks a batch element, block c owning rows
// [c R, c R + rc): the forward replay, then the layers' backwards in
// reverse.
template <int NT>
__global__ void __launch_bounds__(kWarps * 32, NT == 1 ? 2 : 1)
dense_gnn_bwd_kernel(const float* __restrict__ x, const float* __restrict__ adj,
                     const float* __restrict__ g, Stack st, Plan p, int N,
                     int need, float* __restrict__ dx,
                     float* __restrict__ dadj, float* scratch,
                     float* __restrict__ partial) {
  extern __shared__ __align__(16) float smem[];
  const int C = p.C, R = p.R, L = st.n_layers;
  const int b = blockIdx.x / C;
  const int c = C > 1 ? int(cg::this_cluster().block_rank()) : 0;
  const int r0 = c * R, rc = min(R, N - r0);
  const int sf = p.sf;
  const bool onchip = p.onchip;
  Warp w;
  w.warp = threadIdx.x >> 5;
  w.warps = blockDim.x >> 5;
  w.wn = p.wn;
  w.slice = w.warp % p.wn;
  w.row0 = (w.warp / p.wn) * 16;
  w.active = w.row0 < rc;

  Ctx cx;
  cx.N = N;
  cx.R = R;
  cx.rank = c;
  cx.r0 = r0;
  cx.rc = rc;
  cx.onchip = p.onchip;
  cx.inv_r = 1.0f / R;
  cx.gk = p.gk;
  cx.cs = p.cs;
  cx.adj_res = p.adj_res;
  cx.ldr = (p.adj_res ? N : p.gk) + 4;
  cx.ldc = R + 8;
  cx.adj_rows = smem + p.o_adj;
  cx.adj_cols = cx.adj_rows + (p.adj_res ? R * cx.ldr : 2 * R * cx.ldr);
  cx.buf = smem + p.o_buf;
  cx.adj_b = adj + size_t(b) * N * N;

  // the rows' matrices: h_0..h_{L-1}, agg_0..agg_{L-1}, gz x2, dagg x2
  auto mat = [&](int i) -> Rows {
    if (onchip) return Rows{smem + i * R * sf, sf};
    return Rows{scratch + size_t(b) * p.scratch_per_b + (size_t(i) * N + r0) * sf,
                sf};
  };
  auto H = [&](int l) { return mat(l); };
  auto AGG = [&](int l) { return mat(L + l); };
  auto GZ = [&](int i) { return mat(2 * L + i); };
  auto DAGG = [&](int i) { return mat(2 * L + 2 + i); };
  // W_rel and W_root of layer l: resident [fi][b_stride(fo)] each, or in
  // device memory [fi][fo]; b_rel always resident
  auto wrel = [&](int l, int& ld) -> const float* {
    ld = p.w_res ? b_stride(st.width[l + 1]) : st.width[l + 1];
    return p.w_res ? smem + p.o_w + st.woff[l] : st.w_rel[l];
  };
  auto wroot = [&](int l, int& ld) -> const float* {
    ld = p.w_res ? b_stride(st.width[l + 1]) : st.width[l + 1];
    return p.w_res ? smem + p.o_w + st.woff[l] + st.width[l] * ld
                   : st.w_root[l];
  };
  auto bias = [&](int l) -> const float* { return smem + p.o_b + l * p.bs; };

  // prologue: x's rows and the adjacency's rows (where resident), which
  // the first product reads; the weights, the biases, the adjacency's
  // columns and g's rows land during it
  const int f0 = st.width[0], fL = st.width[L];
  if (p.adj_res)
    copy_in(cx.adj_rows, cx.ldr, cx.adj_b + size_t(r0) * N, N, rc, N, true);
  copy_in(H(0).own, sf, x + (size_t(b) * N + r0) * f0, f0, rc, f0, onchip);
  cp_async_commit();
  cp_async_wait_all();
  cluster_sync(C, !onchip);  // every block runs, and has its h_0 rows
  for (int l = 0; l < L; ++l) {
    const int fi = st.width[l], fo = st.width[l + 1], ld = b_stride(fo);
    if (p.w_res) {
      float* wl = smem + p.o_w + st.woff[l];
      copy_in(wl, ld, st.w_rel[l], fo, fi, fo, true);
      copy_in(wl + fi * ld, ld, st.w_root[l], fo, fi, fo, true);
    }
    copy_in(smem + p.o_b + l * p.bs, p.bs, st.b_rel[l], fo, 1, fo, true);
  }
  if (p.adj_res) copy_in(cx.adj_cols, cx.ldc, cx.adj_b + r0, N, N, rc, true);
  copy_in(GZ(0).own, sf, g + (size_t(b) * N + r0) * fL, fL, rc, fL, onchip);
  cp_async_commit();

  float acc[NT * 4];
  // the forward replay, rows r0.. of each layer
  for (int l = 0; l < L; ++l) {
    const int fi = st.width[l], fo = st.width[l + 1];
    const bool last = l == L - 1;
    const Rows h = H(l), ag = AGG(l);
    const Rows h1 = last ? GZ(0) : H(l + 1);  // the last layer writes gz
    // agg = adj[rows, :] . h
    for (float& v : acc) v = 0.f;
    sweep<NT>(cx, kAggSweep, h, fi, acc, w, h, nullptr, 0);
    if (w.active)
      epilogue<NT>(acc, w.slice, w.wn,
                   Epi{ag.own + w.row0 * sf, sf, 16, fi, kPut, 0, nullptr,
                       nullptr, 0});
    if (l == 0) cp_async_wait_all();  // the prologue's second group
    __syncthreads();
    // h_{l+1} = act(agg . W_rel + b_rel + h . W_root), or at the last
    // layer gz = g * act'(z) in place of g
    if (w.active) {
      int ldw;
      const float* wr = wrel(l, ldw);
      const float* wo = wroot(l, ldw);
      for (float& v : acc) v = 0.f;
      warp_gemm<NT>(acc, Opnd{ag.own + w.row0 * sf, sf, 1, 16, fi},
                    Opnd{wr, ldw, 1, fi, fo}, fi, w.slice, w.wn);
      warp_gemm<NT>(acc, Opnd{h.own + w.row0 * sf, sf, 1, 16, fi},
                    Opnd{wo, ldw, 1, fi, fo}, fi, w.slice, w.wn);
      epilogue<NT>(acc, w.slice, w.wn,
                   Epi{h1.own + w.row0 * sf, sf, 16, fo, last ? kGzLast : kAct,
                       st.act[l], bias(l), nullptr, 0});
    }
    if (!last) {
      cluster_sync(C, !onchip);  // the next layer reads every row of h
    } else {
      __syncthreads();
    }
  }

  // the layers' backwards, in reverse
  float* part = partial + (size_t(b) * C + c) * st.n_params;
  float* dx_b = dx ? dx + (size_t(b) * N + r0) * f0 : nullptr;
  float* dadj_b = dadj ? dadj + (size_t(b) * N + r0) * N : nullptr;
  int cur = 0;
  for (int l = L - 1; l >= 0; --l) {
    const int fi = st.width[l], fo = st.width[l + 1];
    const Rows gz = GZ(cur), h = H(l), ag = AGG(l), dg = DAGG(l & 1);
    int ldw;
    const float* wr = wrel(l, ldw);
    const float* wo = wroot(l, ldw);
    // dagg = gz . W_rel^T
    if (w.active) {
      for (float& v : acc) v = 0.f;
      warp_gemm<NT>(acc, Opnd{gz.own + w.row0 * sf, sf, 1, 16, fo},
                    Opnd{wr, 1, ldw, fo, fi}, fo, w.slice, w.wn);
      epilogue<NT>(acc, w.slice, w.wn,
                   Epi{dg.own + w.row0 * sf, sf, 16, fi, kPut, 0, nullptr,
                       nullptr, 0});
    }
    // the parameters' partials over this block's rows: dW_rel = agg^T gz,
    // dW_root = h^T gz (16 x 16 strips, a warp each, round robin), db;
    // while peers finish their dagg rows
    if (need & kNeedParams) {
      float* dwr = part + st.poff[l];
      float* dbr = dwr + fi * fo;
      float* dwo = dbr + fo;
      const int mtiles = (fi + 15) / 16, strips = (fo + 15) / 16;
      for (int task = w.warp; task < 2 * mtiles * strips; task += w.warps) {
        const bool root = task >= mtiles * strips;
        const int q = root ? task - mtiles * strips : task;
        const int m0 = (q / strips) * 16, n0 = (q % strips) * 16;
        float t2[8] = {};
        warp_gemm<2>(t2, Opnd{(root ? h : ag).own + m0, 1, sf, fi - m0, rc},
                     Opnd{gz.own + n0, sf, 1, rc, fo - n0}, rc, 0, 1);
        epilogue<2>(t2, 0, 1,
                    Epi{(root ? dwo : dwr) + m0 * fo + n0, fo, fi - m0,
                        fo - n0, kPut, 0, nullptr, nullptr, 0});
      }
      // db: kWarps row groups a column (a warp's lanes over columns), each
      // in row order, then the groups in order through shared memory
      float* red = cx.buf;  // free: the last sweep is done with it
      for (int j0 = 0; j0 < fo; j0 += 32) {
        const int j = j0 + (threadIdx.x & 31), grp = w.warp;
        if (j < fo) {
          float s = 0.f;
          for (int n = grp; n < rc; n += kWarps) s += gz.own[n * sf + j];
          red[grp * 32 + (j & 31)] = s;
        }
        __syncthreads();
        if (grp == 0 && j < fo) {
          float s = red[j & 31];
          for (int q = 1; q < kWarps; ++q) s += red[q * 32 + (j & 31)];
          dbr[j] = s;
        }
        __syncthreads();
      }
    }
    cluster_sync(C, !onchip);  // dadj and dh read every row of h and dagg

    if (need & kNeedAdj)  // dadj[rows, :] (+)= dagg[rows] . h^T
      sweep<NT>(cx, kDadjSweep, h, fi, acc, w, dg, dadj_b, l == L - 1);
    if (l > 0 || (need & kNeedX)) {  // dh = adj^T[rows, :] . dagg + gz . W_root^T
      for (float& v : acc) v = 0.f;
      sweep<NT>(cx, kDhSweep, dg, fi, acc, w, dg, nullptr, 0);
      if (w.active) {
        warp_gemm<NT>(acc, Opnd{gz.own + w.row0 * sf, sf, 1, 16, fo},
                      Opnd{wo, 1, ldw, fo, fi}, fo, w.slice, w.wn);
        if (l > 0)  // the next layer's gz: dh * act'(h_l)
          epilogue<NT>(acc, w.slice, w.wn,
                       Epi{GZ(cur ^ 1).own + w.row0 * sf, sf, 16, fi, kGzNext,
                           st.act[l - 1], nullptr, h.own + w.row0 * sf, 0});
        else
          epilogue<NT>(acc, w.slice, w.wn,
                       Epi{dx_b + w.row0 * f0, f0, 16, fi, kPut, 0, nullptr,
                           nullptr, 0});
      }
    }
    __syncthreads();
    cur ^= 1;
  }
  if (C > 1) cluster_sync(C, false);  // no block leaves while peers read it
}

// dparams[e] = sum over q of partial[q][e]: 16 slices, slice s summing
// parts s, s + 16, ... in order, then the slices added in order.
constexpr int kSumCols = 32, kSumSlices = 16;
__global__ void __launch_bounds__(kSumCols * kSumSlices) sum_partials_kernel(
    const float* __restrict__ partial, float* __restrict__ out, int parts,
    int P) {
  __shared__ float red[kSumSlices][kSumCols + 1];
  const int e = blockIdx.x * kSumCols + threadIdx.x, s = threadIdx.y;
  float acc = 0.f;
  if (e < P)
    for (int q = s; q < parts; q += kSumSlices) acc += partial[size_t(q) * P + e];
  red[s][threadIdx.x] = acc;
  __syncthreads();
  if (s || e >= P) return;
  float t = red[0][threadIdx.x];
  for (int i = 1; i < kSumSlices; ++i) t += red[i][threadIdx.x];
  out[e] = t;
}

bool valid_stack(const int* widths, int n_layers, int B, int N) {
  if (n_layers < 1 || n_layers > kMaxLayers || B < 1 || B > 65535) return false;
  if (N < 16 || N > kMaxNodes || N % 16) return false;
  for (int l = 0; l <= n_layers; ++l)
    if (widths[l] < 1 || widths[l] > kMaxWidth) return false;
  return true;
}

Stack make_stack(const int* widths, int n_layers) {
  Stack st{};
  st.n_layers = n_layers;
  int off = 0, woff = 0;
  for (int l = 0; l < n_layers; ++l) {
    st.poff[l] = off;
    off += 2 * widths[l] * widths[l + 1] + widths[l + 1];
    st.woff[l] = woff;
    woff += 2 * widths[l] * b_stride(widths[l + 1]);
  }
  for (int l = 0; l <= n_layers; ++l) {
    st.width[l] = widths[l];
    st.fmax = widths[l] > st.fmax ? widths[l] : st.fmax;
  }
  st.n_params = off;
  return st;
}

int pow2_ceil(int n) {
  int p = 1;
  while (p < n) p *= 2;
  return p;
}

using Kernel = void (*)(const float*, const float*, const float*, Stack, Plan,
                        int, int, float*, float*, float*, float*);

Kernel kernel_for(const Plan& p) {
  switch (p.nt) {
    case 1: return dense_gnn_bwd_kernel<1>;
    case 2: return dense_gnn_bwd_kernel<2>;
    case 4: return dense_gnn_bwd_kernel<4>;
    default: return dense_gnn_bwd_kernel<8>;
  }
}

// Sets the kernel's attributes once a device: all the shared memory a
// block may have, and clusters above the portable 8.
cudaError_t prepare(Kernel k, int device) {
  struct Done { Kernel k; int device; };
  static std::mutex mu;
  static Done done[64];
  static int n_done = 0;
  const std::lock_guard<std::mutex> lock(mu);
  for (int i = 0; i < n_done; ++i)
    if (done[i].k == k && done[i].device == device) return cudaSuccess;
  cudaError_t e = cudaFuncSetAttribute(
      k, cudaFuncAttributeMaxDynamicSharedMemorySize, kSmemLimit);
  if (e == cudaSuccess)
    e = cudaFuncSetAttribute(
        k, cudaFuncAttributeNonPortableClusterSizeAllowed, 1);
  if (e == cudaSuccess && n_done < 64) done[n_done++] = Done{k, device};
  return e;
}

cudaLaunchConfig_t launch_config(const Plan& p, int B, cudaStream_t stream,
                                 cudaLaunchAttribute* attr) {
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3(B * p.C);
  cfg.blockDim = dim3(kWarps * 32);
  cfg.dynamicSmemBytes = p.smem;
  cfg.stream = stream;
  attr->id = cudaLaunchAttributeClusterDimension;
  attr->val.clusterDim.x = p.C;
  attr->val.clusterDim.y = 1;
  attr->val.clusterDim.z = 1;
  cfg.attrs = attr;
  cfg.numAttrs = 1;
  return cfg;
}

// Blocks the card holds at once in clusters of p.C (0: none), asked once
// per (device, kernel, cluster size, threads, shared memory).
int resident_blocks(int device, const Plan& p) {
  struct Entry { int device, nt, C, smem, blocks; };
  static std::mutex mu;
  static Entry cache[64];
  static int n_cache = 0;
  const std::lock_guard<std::mutex> lock(mu);
  for (int i = 0; i < n_cache; ++i) {
    const Entry& e = cache[i];
    if (e.device == device && e.nt == p.nt && e.C == p.C && e.smem == p.smem)
      return e.blocks;
  }
  const Kernel k = kernel_for(p);
  int clusters = 0;
  if (prepare(k, device) == cudaSuccess) {
    cudaLaunchAttribute attr;
    const cudaLaunchConfig_t cfg = launch_config(p, 1, nullptr, &attr);
    if (cudaOccupancyMaxActiveClusters(&clusters, reinterpret_cast<const void*>(k),
                                       &cfg) != cudaSuccess)
      clusters = 0;
  }
  cudaGetLastError();  // a refused query leaves no error behind
  const int blocks = clusters * p.C;
  if (n_cache < 64)
    cache[n_cache++] = Entry{device, p.nt, p.C, p.smem, blocks};
  return blocks;
}

// What a block keeps in shared memory besides the biases and the chunk
// buffers, in order of preference: its rows, the adjacency's rows and
// columns and the weights; its rows and the weights (the adjacency
// streams in chunks); its rows only (the weights read from device memory);
// nothing (the rows in global scratch, where they do not fit).
struct Route { int onchip, adj_res, w_res; };
constexpr Route kRoutes[] = {{1, 1, 1}, {1, 0, 1}, {1, 0, 0}, {0, 0, 0}};

// The plan for clusters of C blocks with the rows on chip (onchip) or in
// global scratch, or false where C does not split N into row tiles of at
// most 4 a block (R <= 64) with no block left empty, or no route fits in
// shared memory.
bool plan_for(const Stack& st, int N, int C, int onchip, Plan& p) {
  const int T = N / 16, L = st.n_layers;
  if (C > T) return false;
  const int tiles = (T + C - 1) / C;
  if (tiles > kMaxTiles || (C - 1) * tiles >= T) return false;
  p = Plan{};
  p.C = C;
  p.R = 16 * tiles;
  p.wn = kWarps / pow2_ceil(tiles);
  p.nt = pow2_ceil(((st.fmax + 7) / 8 + p.wn - 1) / p.wn);
  p.sf = round8(st.fmax) + 4;
  p.cs = b_stride(st.fmax);
  // rows of a chunk: at most kMaxStage a thread, and two chunks or more from
  // N = 64, so that the second chunk's loads fly during the first's MMAs
  const int per = kWarps * 32 / ((st.fmax + 3) / 4);
  int gk_max = 8;
  while (gk_max * 2 <= kMaxStage * per && gk_max * 2 <= (N >= 64 ? N / 2 : N))
    gk_max *= 2;
  const int rows = (2 * L + 4) * p.R * p.sf;
  p.bs = round8(st.fmax);
  const int bias = L * p.bs;
  int w = 0;
  for (int l = 0; l < L; ++l) w += 2 * st.width[l] * b_stride(st.width[l + 1]);
  const int adj_res = p.R * (N + 4) + N * (p.R + 8);
  // room for two blocks an SM first (everything resident), then chunks of
  // 32 rows or more before smaller ones, the routes in order
  for (int limit : {kSmemPerSM / 2 - kSmemReserved, kSmemLimit})
    for (int gk_min : {32, 8})
      for (const Route& r : kRoutes) {
        if (r.onchip != onchip || (limit < kSmemLimit && !r.adj_res)) continue;
        for (int gk = gk_max; gk >= gk_min; gk /= 2) {
          const int adj =
              r.adj_res ? adj_res : 2 * (p.R * (gk + 4) + gk * (p.R + 8));
          // the chunk buffers also hold the bias gradient's row groups
          const int bufs = (N + gk - 1) / gk > 1 ? 2 : 1;
          const int buf = bufs * gk * p.cs > kWarps * 32 ? bufs * gk * p.cs
                                                      : kWarps * 32;
          const int own = onchip ? rows : 0, ww = r.w_res ? w : 0;
          const long long bytes = 4LL * (own + ww + bias + adj + buf);
          if (bytes > limit) continue;
          p.onchip = onchip;
          p.adj_res = r.adj_res;
          p.w_res = r.w_res;
          p.gk = gk;
          p.o_w = own;
          p.o_b = own + ww;
          p.o_adj = own + ww + bias;
          p.o_buf = own + ww + bias + adj;
          p.smem = int(bytes);
          p.scratch_per_b = onchip ? 0 : (2LL * L + 4) * N * p.sf;
          return true;
        }
      }
  return false;
}

// The plan for clusters of C blocks (1, 2, 4, 8 or 16): its rows on chip
// where they fit, else in scratch; false where there is none or the card
// holds no cluster of it.
bool plan_at(const Stack& st, int N, int C, int device, Plan& p) {
  for (int onchip = 1; onchip >= 0; --onchip)
    if (plan_for(st, N, C, onchip, p)) {
      p.resident = resident_blocks(device, p);
      if (p.resident > 0) return true;
    }
  return false;
}

// The cluster size C of 1, 2, 4, 8, 16 of the least estimated time, among
// the sizes whose rows fit on chip, and only where none does among those
// with scratch: waves of B x C blocks, each wave a block on every SM the
// card can give clusters of C (two blocks sharing an SM run no faster than
// one after the other), times a block's time, its rows plus kBlockCost
// (the prologue's loads, the phases' barriers and epilogues) plus
// kClusterCost a block of the cluster (the copies from peers and the
// cluster barriers grow with C), both in rows, chosen so that the plan
// takes the fastest size found on an H100 at the scan, served and
// streamed shapes (chip_smoke.py times every size of every case of the
// backward). False where the card holds no cluster of any size for the
// shape.
constexpr int kBlockCost = 96;
constexpr int kClusterCost = 8;
bool choose_plan(const Stack& st, int B, int N, int device, Plan& out) {
  const int sms = sm_count(device);
  for (int onchip = 1; onchip >= 0; --onchip) {
    long long best = -1;
    for (int C = 1; C <= kMaxCluster; C *= 2) {
      Plan p;
      if (!plan_for(st, N, C, onchip, p)) continue;
      p.resident = resident_blocks(device, p);
      if (p.resident == 0) continue;
      const int wave = p.resident < sms ? p.resident : sms;
      const long long waves = ((long long)B * C + wave - 1) / wave;
      const long long cost = waves * (p.R + kBlockCost + kClusterCost * C);
      if (best < 0 || cost < best) {
        best = cost;
        out = p;
      }
    }
    if (best >= 0) return true;
  }
  return false;
}

// The plan for `cluster` blocks a batch element (0: the planner's choice).
bool plan_call(const Stack& st, int B, int N, int cluster, int device,
               Plan& p) {
  if (cluster == 0) return choose_plan(st, B, N, device, p);
  return plan_at(st, N, cluster, device, p);
}

bool valid_cluster(int cluster) {
  return cluster == 0 || (cluster <= kMaxCluster && cluster > 0 &&
                          (cluster & (cluster - 1)) == 0);
}

int param_floats(const int* widths, int n_layers) {
  int p = 0;
  for (int l = 0; l < n_layers; ++l)
    p += 2 * widths[l] * widths[l + 1] + widths[l + 1];
  return p;
}

}  // namespace

extern "C" {

// `cluster` below: the blocks a batch element, 1, 2, 4, 8 or 16, or 0 for
// the planner's choice (choose_plan); a size other than the choice serves
// to time the choice against.

// The plan of gcm_fused_dense_gnn_bwd_f32 on `device` for this shape, as
// 10 ints: C, R, wn, nt, onchip, adj_res, w_res, gk, shared-memory bytes,
// resident blocks. Returns a CUDA error code (cudaErrorInvalidValue
// for shapes the kernel does not take, cudaErrorInvalidConfiguration where
// there is no plan at `cluster` or the card holds no cluster of it, or, at
// 0, of any size).
int gcm_dense_gnn_bwd_plan(const int* widths, int n_layers, int B, int N,
                           int cluster, int device, int* out) {
  if (!valid_stack(widths, n_layers, B, N) || !valid_cluster(cluster))
    return cudaErrorInvalidValue;
  cudaError_t e = cudaSetDevice(device);
  if (e != cudaSuccess) return e;
  Plan p;
  if (!plan_call(make_stack(widths, n_layers), B, N, cluster, device, p))
    return cudaErrorInvalidConfiguration;
  const int v[] = {p.C, p.R, p.wn, p.nt, p.onchip, p.adj_res, p.w_res, p.gk,
                   p.smem, p.resident};
  for (int i = 0; i < 10; ++i) out[i] = v[i];
  return cudaSuccess;
}

// Floats of global scratch that gcm_fused_dense_gnn_bwd_f32 needs on
// `device` (at least 1), or -1 for shapes it does not take.
long long gcm_dense_gnn_bwd_scratch_floats(const int* widths, int n_layers,
                                           int B, int N, int cluster,
                                           int device) {
  if (!valid_stack(widths, n_layers, B, N) || !valid_cluster(cluster))
    return -1;
  if (cudaSetDevice(device) != cudaSuccess) return -1;
  Plan p;
  if (!plan_call(make_stack(widths, n_layers), B, N, cluster, device, p))
    return 1;
  const long long n = (long long)B * p.scratch_per_b +
                      (long long)B * p.C * param_floats(widths, n_layers);
  return n > 0 ? n : 1;
}

// need: 1 dx, 2 dadj, 4 the parameters' gradients into dparams (w_rel,
// b_rel, w_root a layer, row-major, in layer order). Returns a CUDA error
// code (cudaErrorInvalidValue for shapes the kernel does not take,
// cudaErrorInvalidConfiguration as gcm_dense_gnn_bwd_plan says).
int gcm_fused_dense_gnn_bwd_f32(
    const void* x, const void* adj, const void* g, const void* const* w_rel,
    const void* const* b_rel, const void* const* w_root, const int* widths,
    const int* acts, int n_layers, int B, int N, int need, void* dx,
    void* dadj, void* dparams, void* scratch, int cluster, int device,
    void* stream) {
  if (!valid_stack(widths, n_layers, B, N) || !valid_cluster(cluster))
    return cudaErrorInvalidValue;
  if (((need & kNeedX) && !dx) || ((need & kNeedAdj) && !dadj) ||
      ((need & kNeedParams) && !dparams) || !scratch)
    return cudaErrorInvalidValue;
  cudaError_t e = cudaSetDevice(device);
  if (e != cudaSuccess) return e;
  Stack st = make_stack(widths, n_layers);
  for (int l = 0; l < n_layers; ++l) {
    st.w_rel[l] = static_cast<const float*>(w_rel[l]);
    st.b_rel[l] = static_cast<const float*>(b_rel[l]);
    st.w_root[l] = static_cast<const float*>(w_root[l]);
    st.act[l] = acts[l];
  }
  Plan p;
  if (!plan_call(st, B, N, cluster, device, p))
    return cudaErrorInvalidConfiguration;
  float* s = static_cast<float*>(scratch);
  float* partial = s + (size_t)B * p.scratch_per_b;
  cudaStream_t cs = static_cast<cudaStream_t>(stream);

  const Kernel k = kernel_for(p);
  e = prepare(k, device);
  if (e != cudaSuccess) return e;
  cudaLaunchAttribute attr;
  const cudaLaunchConfig_t cfg = launch_config(p, B, cs, &attr);
  e = cudaLaunchKernelEx(&cfg, k, static_cast<const float*>(x),
                         static_cast<const float*>(adj),
                         static_cast<const float*>(g), st, p, N, need,
                         static_cast<float*>(dx), static_cast<float*>(dadj), s,
                         partial);
  if (e == cudaSuccess) e = cudaGetLastError();
  if (e != cudaSuccess || !(need & kNeedParams)) return e;
  sum_partials_kernel<<<(st.n_params + kSumCols - 1) / kSumCols,
                        dim3(kSumCols, kSumSlices), 0, cs>>>(
      partial, static_cast<float*>(dparams), B * p.C, st.n_params);
  return cudaGetLastError();
}

}  // extern "C"
