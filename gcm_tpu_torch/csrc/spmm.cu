// Padded-edge-list SpMM for Hopper (sm_90a): f32 in and out.
//
// Replaces the Pallas kernel gcm_tpu/ops/pallas/spmm.py::spmm_edge_list:
//   out[b, i, :] = sum over lanes e with sink_e = i of w_e * x[b, src_e, :]
// for x [B,N,F], edges [B,2,E] int32 (row 0 sink, row 1 source), w [B,E].
// A lane adds nothing unless 0 <= sink < N and 0 <= src < N, so the -1
// sentinel (and any index of N or more) drops out, as in the Pallas
// one-hots. The TPU kernel wrote the gather and the scatter as two one-hot
// matmuls for its matrix unit; here the sum is written directly.
//
// What bounds it on an H100: the function needs each input read once,
// 4*B*(N*F + 3*E) bytes, and the output written once, 4*B*N*F bytes, against
// 2*B*E_valid*F flops: at the model's shapes it is bound by bytes (well under
// a microsecond at 3.35 TB/s) and in practice by latency, since a call is a
// few hundred small blocks; at the sweep's point by the row gathers from L2,
// 4*B*E_valid*F bytes.
//
// What the design does about it: the edge-list kernel of edge_tile.cuh, on
// the sink-sorted row sum of sink_sort.cuh: a block owns a batch element, a
// tile of sink rows (the whole graph up to 1,024 rows; smaller tiles only to
// fill the SMs at small batches) and a tile of feature columns, reads the
// edge list once, sorts its lanes by sink row in shared memory (stable), and
// each warp sums whole rows in registers in lane order, each product and
// add rounded once, with no atomics on floats.
//
// The same kernel, with kBf16 set, also replaces the bf16 mode of the
// one-hot SpMM experiment benchmarks/spmm_variants.py::pallas_onehot_dtype
// (its f32 mode is the function above): x is rounded to bf16 as it is read,
// each weighted message w * x is rounded to bf16 (round to nearest even,
// after a float32 product), and the messages are summed in float32, the two
// rounding points of that kernel's one-hot matmuls (bf16 messages sum nearly
// exactly in float32). The bound is the same.

#include "edge_tile.cuh"

namespace {

int launch(bool bf16, const void* x, const void* edges, const void* w,
           void* out, int B, int N, int F, int E, int device, void* stream) {
  if (B < 1 || B > 65535 || N < 1 || F < 1 || E < 1)
    return int(cudaErrorInvalidValue);
  return edge_tile::launch(bf16, x, edges, w, out, B, N, F, E, E, 0, device,
                           stream);
}

}  // namespace

extern "C" {

// x [B,N,F] f32, edges [B,2,E] int32, w [B,E] f32, out [B,N,F] f32, all
// contiguous on `device`. Returns a cudaError_t code (0 on success).
int gcm_spmm_edge_list_f32(const void* x, const void* edges, const void* w,
                           void* out, int B, int N, int F, int E, int device,
                           void* stream) {
  return launch(false, x, edges, w, out, B, N, F, E, device, stream);
}

// The same arguments; the messages rounded to bf16 as described above.
int gcm_spmm_onehot_bf16(const void* x, const void* edges, const void* w,
                         void* out, int B, int N, int F, int E, int device,
                         void* stream) {
  return launch(true, x, edges, w, out, B, N, F, E, device, stream);
}

}  // extern "C"
