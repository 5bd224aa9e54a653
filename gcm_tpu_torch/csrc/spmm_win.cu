// Sink-window bucketed SpMM for Hopper (sm_90a): f32 in and out.
//
// Replaces the Pallas experiment benchmarks/spmm_variants.py::pallas_win
// (kernel _win_kernel): an edge list routed into one segment of `cap` lanes
// per window of kW = 128 sink rows, edges [B,2,n_win*cap] int32 (row 0 sink,
// row 1 source), w [B,n_win*cap], segment k in lanes k*cap .. k*cap+cap-1:
//   out[b, k*128 + r, :] = sum over the lanes e of segment k with
//                          sink_e - k*128 = r and 0 <= src_e < N
//                          of w_e * x[b, src_e, :]
// As in the Pallas kernel's one-hots, a source outside 0..N-1 and a sink
// outside its segment's window (the -1 sentinel included) add nothing. The
// TPU kernel built a full-N source one-hot and a 128-wide sink one-hot per
// lane block for its matrix unit; here the sum is written directly.
//
// Modes: float32 computes each message w * x and each add rounded once
// (__fmul_rn, __fadd_rn: no FMA contraction), in lane order, so the plain
// version, which adds in the same order, agrees with it bitwise. bf16
// rounds x to bf16 as it is read and each float32 message to bf16 (round to
// nearest even) before the float32 sum: the two rounding points of the
// experiment's bf16 matmuls.
//
// What bounds it on an H100: the function reads x and the bucketed lanes
// once, 4*B*(N*F + 3*n_win*cap) bytes, and writes out once, 4*B*N*F bytes,
// against 2*B*E_valid*F flops: bound by bytes (~12.5 us at B=64, N=512,
// F=128, cap=4096, a padding lane read as its sink alone). In practice the
// row gathers bound it, 4*B*E_valid*F bytes from L2.
//
// What the design does about it: the edge-list kernel of edge_tile.cuh,
// which csrc/spmm.cu runs over the whole edge list, here with each block's
// row tile one window (or a half or quarter of one, only to fill the SMs at
// small batches) and the block reading only that window's segment: cap
// lanes, read once per feature tile, sorted by sink row in shared memory
// (stable: a row's lanes stay in lane order); each warp sums whole rows in
// registers, several gathers in flight. Every output element is summed by
// one thread in lane order and written once: no atomics on floats, so
// reruns are bitwise equal.

#include "edge_tile.cuh"

extern "C" {

// x [B,N,F] f32, edges [B,2,n_win*cap] int32, w [B,n_win*cap] f32, out
// [B,N,F] f32, all contiguous on `device`; N a multiple of 128, cap >= 1;
// bf16 0 (float32) or 1. Returns a cudaError_t code (0 on success).
int gcm_spmm_win(const void* x, const void* edges, const void* w, void* out,
                 int B, int N, int F, int cap, int bf16, int device,
                 void* stream) {
  constexpr int kW = edge_tile::kWindow;
  if (B < 1 || B > 65535 || N < kW || N % kW || F < 1 || cap < 1)
    return int(cudaErrorInvalidValue);
  return edge_tile::launch(bf16, x, edges, w, out, B, N, F, N / kW * cap,
                           cap, cap, device, stream);
}

}  // extern "C"
