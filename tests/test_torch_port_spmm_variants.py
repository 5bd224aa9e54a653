"""The port's SpMM variants (gcm_tpu_torch/ops/cuda/spmm2.py, spmm_seg.py,
spmm_prefetch.py, spmm_win.py, spmm.py::spmm_onehot_dtype), its gathers
(ops/cuda/gather.py) and its SpMM sweep
(gcm_tpu_torch/benchmarks/spmm_variants.py) against the JAX package: the
Pallas kernels run in interpret mode on the CPU, as
tests/test_pallas_kernels.py runs them, and the one-hot, sink-window and
gather-probe experiments of benchmarks/spmm_variants.py are loaded from its
file with its shape globals set to the test's.

On the CPU the wrappers take their plain PyTorch versions; the CUDA kernels
themselves are checked against those plain versions on the card by
chip_smoke.py. Tolerances, by what differs:
- the pair kernel's 'f32x2' mode: 1e-4. The port sums in float32; the TPU
  kernel sums a hi + lo bf16 split of each message (about 2^-17 relative
  per message);
- spmm_seg: 1e-4. The Pallas kernel reads each segment as a difference of
  two prefix sums of a 128-lane chunk, which cancels against the prefix's
  magnitude; the port sums each segment directly;
- everything else (the 'bf16' modes included, where both sides round the
  same float32 message to bf16): 1e-5, the summation order;
- the integer layouts of the bucketing helpers and the gathers (copies,
  NaN where NaN): exactly equal.

Cases of one check run in a loop inside one test (the failure message names
the case), as in tests/test_torch_port_sparse_kernels.py.
"""

import importlib.util
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from gcm_tpu.ops.pallas import spmm2 as jax_pairs
from gcm_tpu.ops.pallas import spmm_prefetch as jax_prefetch
from gcm_tpu.ops.pallas import spmm_seg as jax_seg
from gcm_tpu_torch.benchmarks import spmm_variants as sweep_mod
from gcm_tpu_torch.benchmarks.spmm_variants import run_sweep
from gcm_tpu_torch.ops import _build
from gcm_tpu_torch.ops.cuda import gather as gather_mod
from gcm_tpu_torch.ops.cuda import spmm as spmm_mod
from gcm_tpu_torch.ops.cuda import spmm2 as pairs_mod
from gcm_tpu_torch.ops.cuda import spmm_prefetch as prefetch_mod
from gcm_tpu_torch.ops.cuda import spmm_seg as seg_mod
from gcm_tpu_torch.ops.cuda import spmm_win as win_mod
from gcm_tpu_torch.ops.cuda.gather import (take_lanes, take_rows,
                                           take_rows_loop)
from gcm_tpu_torch.ops.cuda.spmm import spmm_edge_list, spmm_onehot_dtype
from gcm_tpu_torch.ops.cuda.spmm2 import (bucket_edges_pairs,
                                          check_bucket_overflow, spmm_pairs,
                                          spmm_pairs_T, transpose_pairs)
from gcm_tpu_torch.ops.cuda.spmm_prefetch import (bucket_edges_sink_blocks,
                                                  spmm_prefetch,
                                                  spmm_prefetch_bucketed)
from gcm_tpu_torch.ops.cuda.spmm_seg import (bucket_edges_segments, spmm_seg,
                                             spmm_seg_T)
from gcm_tpu_torch.ops.cuda.spmm_win import (bucket_by_sink_window, spmm_win,
                                             window_overflow)

torch.set_num_threads(1)

ROOT = Path(__file__).resolve().parent.parent
TOL_F32X2 = 1e-4
TOL_SEG = 1e-4
TOL = 1e-5


def graph(B, N, E, F, seed, holes=True):
    """x, edges, w (numpy): random edges with sentinel lanes (sink only,
    source only, both, and an all-sentinel tail)."""
    rng = np.random.default_rng(seed)
    edges = rng.integers(0, N, (B, 2, E)).astype(np.int32)
    if holes:
        edges[:, 0, 1::7] = -1
        edges[:, 1, 2::7] = -1
        edges[:, :, 3::7] = -1
        edges[:, :, -4:] = -1
    w = rng.uniform(0.5, 1.5, (B, E)).astype(np.float32)
    x = rng.standard_normal((B, N, F)).astype(np.float32)
    return x, edges, w


def t(*arrays):
    return [torch.from_numpy(np.asarray(a)) for a in arrays]


def j(*arrays):
    return [jnp.asarray(np.asarray(a)) for a in arrays]


def assert_same(got, want, name):
    for i, (g, w) in enumerate(zip(got, want)):
        np.testing.assert_array_equal(g.numpy(), np.asarray(w),
                                      err_msg=f"{name} output {i}")
        assert g.numpy().dtype == np.asarray(w).dtype, name


def test_layouts_match_jax_exactly():
    """bucket_edges_pairs, transpose_pairs, bucket_edges_segments and
    bucket_edges_sink_blocks give the JAX package's integer layouts,
    weights, counts and dropped counts, with overflowing buckets, sentinels
    and sinks and sources of N or more among the inputs."""
    for N, E, cap, seed in [(128, 300, 128, 0),   # one window, overflow
                            (256, 512, 256, 1), (384, 700, 128, 2)]:
        _, edges, w = graph(2, N, E, 4, seed)
        edges[0, 0, 5::50] = N + 3
        edges[1, 1, 6::50] = N + 140
        te, tw = t(edges, w)
        got = bucket_edges_pairs(te, tw, N, cap)
        want = jax_pairs.bucket_edges_pairs(*j(edges, w), N, cap)
        assert_same(got, want, f"pairs N={N} cap={cap}")
        assert all(a.is_contiguous() for a in got)
        assert_same(transpose_pairs(got[0], got[1], N, cap),
                    jax_pairs.transpose_pairs(want[0], want[1], N, cap),
                    f"transpose N={N}")
        got = bucket_edges_segments(te, tw, N, cap)
        want = jax_seg.bucket_edges_segments(*j(edges, w), N, cap)
        assert_same(got, want, f"segments N={N} cap={cap}")
        assert all(a.is_contiguous() for a in got)
    _, edges, w = graph(3, 16, 40, 4, seed=3)
    edges[0, 0, 7] = 19  # a local sink past the last block
    edges[1, 1, 8] = 30
    for nblk, cap in [(1, None), (2, None), (4, None), (4, 2), (4, 60)]:
        got = bucket_edges_sink_blocks(*t(edges, w), 16, nblk, cap)
        want = jax_prefetch.bucket_edges_sink_blocks(*j(edges, w), 16, nblk,
                                                     cap)
        assert_same(got, want, f"sink blocks nblk={nblk} cap={cap}")


def test_spmm_pairs_matches_pallas():
    for N, E, F, cap in [(256, 512, 64, 256), (128, 200, 13, 256)]:
        x, edges, w = graph(2, N, E, F, seed=N)
        be, bw, counts = bucket_edges_pairs(*t(edges, w), N, cap)
        check_bucket_overflow(counts, cap)
        jbe, jbw, _ = jax_pairs.bucket_edges_pairs(*j(edges, w), N, cap)
        for precision, tol in (("f32x2", TOL_F32X2), ("bf16", TOL)):
            want = jax_pairs.spmm_pairs(jnp.asarray(x), jbe, jbw, N, cap,
                                        precision)
            got = spmm_pairs(torch.from_numpy(x), be, bw, N, cap, precision)
            np.testing.assert_allclose(got.numpy(), np.asarray(want),
                                       atol=tol, rtol=0,
                                       err_msg=f"N={N} {precision}")
            # the transposed entry computes the same
            gotT = spmm_pairs_T(torch.from_numpy(x).transpose(1, 2), be, bw,
                                cap, precision)
            np.testing.assert_array_equal(gotT.transpose(1, 2).numpy(),
                                          got.numpy())
        # and the sum it stands for: the edge-list SpMM of the graph
        np.testing.assert_allclose(
            spmm_pairs(torch.from_numpy(x), be, bw, N, cap).numpy(),
            spmm_edge_list(*t(x, edges, w)).numpy(), atol=TOL, rtol=0)


def test_spmm_seg_matches_pallas():
    x, edges, w = graph(2, 256, 512, 16, seed=5)
    # a sink whose 200 edges span two 128-lane chunks of its bucket
    xs = np.random.default_rng(6).standard_normal((1, 128, 8)) \
        .astype(np.float32)
    spans = np.full((1, 2, 256), -1, np.int32)
    spans[0, 0, :200] = 7
    spans[0, 1, :200] = np.arange(200) % 128
    cases = {"random": (x, edges, w, 256, 256),
             "chunk_spanning": (xs, spans, np.ones((1, 256), np.float32),
                                128, 256)}
    for name, (x, edges, w, N, cap) in cases.items():
        be, bw, begin, end, tot = bucket_edges_segments(*t(edges, w), N, cap)
        assert int(tot.max()) <= cap
        want = jax_seg.spmm_seg(jnp.asarray(x),
                                *jax_seg.bucket_edges_segments(
                                    *j(edges, w), N, cap)[:4], N, cap)
        got = spmm_seg(torch.from_numpy(x), be, bw, begin, end, N, cap)
        np.testing.assert_allclose(got.numpy(), np.asarray(want),
                                   atol=TOL_SEG, rtol=0, err_msg=name)
        np.testing.assert_allclose(got.numpy(),
                                   spmm_edge_list(*t(x, edges, w)).numpy(),
                                   atol=TOL, rtol=0, err_msg=name)
        gotT = spmm_seg_T(torch.from_numpy(x).transpose(1, 2), be, bw, begin,
                          end, cap)
        np.testing.assert_array_equal(gotT.transpose(1, 2).numpy(),
                                      got.numpy())


def test_spmm_prefetch_matches_pallas():
    """nblk 1, 2 and 4 at TestSpmmPrefetch's shape, and the on-chip shape
    of benchmarks/drive_r5c.py (4, 32, 128) with E=64 and four blocks."""
    cases = [(3, 16, 40, 8, 1), (3, 16, 40, 8, 2), (3, 16, 40, 8, 4),
             (4, 32, 64, 128, 4)]
    for B, N, E, F, nblk in cases:
        x, edges, w = graph(B, N, E, F, seed=nblk + N)
        want = jax_prefetch.spmm_prefetch(*j(x, edges, w), n_blocks=nblk)
        got = spmm_prefetch(*t(x, edges, w), n_blocks=nblk)
        np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=TOL,
                                   rtol=0, err_msg=f"{(B, N, E, F, nblk)}")
        sl, src, pw, dropped = bucket_edges_sink_blocks(*t(edges, w), N,
                                                        nblk)
        assert int(dropped.max()) == 0  # lossless at K = E
        np.testing.assert_array_equal(
            spmm_prefetch_bucketed(torch.from_numpy(x), sl, src, pw,
                                   N).numpy(), got.numpy())


def load_jax_sweep(monkeypatch, B, N, E, F):
    """benchmarks/spmm_variants.py, loaded from its file, with its shape
    globals (read by pallas_onehot_dtype) set to the test's."""
    spec = importlib.util.spec_from_file_location(
        "jax_spmm_variants", ROOT / "benchmarks" / "spmm_variants.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    for name, value in dict(B=B, N=N, E=E, F=F).items():
        monkeypatch.setattr(mod, name, value)
    return mod


def test_spmm_onehot_dtype_matches_pallas(monkeypatch):
    B, N, E, F = 2, 64, 512, 16  # E a whole number of the kernel's blocks
    sweep = load_jax_sweep(monkeypatch, B, N, E, F)
    x, edges, w = graph(B, N, E, F, seed=7)
    edges[0, 1, 9::40] = N + 1   # sources and sinks of N or more
    edges[1, 0, 10::40] = N
    for dtype, jdtype in ((torch.float32, jnp.float32),
                          (torch.bfloat16, jnp.bfloat16)):
        want = sweep.pallas_onehot_dtype(*j(x, edges, w), jdtype)
        got = spmm_onehot_dtype(*t(x, edges, w), dtype)
        np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=TOL,
                                   rtol=0, err_msg=str(dtype))
        assert got.dtype == torch.float32
    np.testing.assert_array_equal(
        spmm_onehot_dtype(*t(x, edges, w), torch.float32).numpy(),
        spmm_edge_list(*t(x, edges, w)).numpy())


def test_bucket_by_sink_window_matches_jax(monkeypatch):
    """bucket_by_sink_window gives the JAX experiment's layout and weights
    exactly, with overflowing windows, sentinels, sinks and sources of N or
    more, and the default cap; its counts hold every valid lane of each
    window, and window_overflow names the windows past the cap."""
    for B, N, E, cap, seed in [(2, 256, 300, 100, 20),   # overflow
                               (2, 384, 700, None, 21),  # cap = E
                               (3, 256, 512, 512, 22)]:
        sweep = load_jax_sweep(monkeypatch, B, N, E, 4)
        _, edges, w = graph(B, N, E, 4, seed)
        edges[0, 0, 5::50] = N + 3
        edges[-1, 1, 6::50] = N + 140
        got = bucket_by_sink_window(*t(edges, w), N, cap=cap)
        want = sweep.bucket_by_sink_window(*j(edges, w), cap=cap)
        assert_same(got[:2], want, f"N={N} cap={cap}")
        assert all(a.is_contiguous() for a in got)
        sink = edges[:, 0].astype(np.int64)
        ok = (sink >= 0) & (edges[:, 1] >= 0) & (sink < N)
        counts = np.stack([((sink // 128 == k) & ok).sum(-1)
                           for k in range(N // 128)], -1)
        np.testing.assert_array_equal(got[2].numpy(), counts)
        cap = E if cap is None else cap
        assert (window_overflow(got[2], cap) is None) == (counts.max() <= cap)
    assert "overflow" in window_overflow(got[2], 1)


def test_spmm_win_matches_pallas(monkeypatch):
    """spmm_win (float32, bf16) against pallas_win in interpret mode at
    caps of one and two lane blocks, on bucketed lanes with sources of N or
    more, and on raw lanes whose sinks leave their windows; on a lossless
    bucketing it is, bitwise, the edge-list (one-hot) SpMM of the graph."""
    B, N, E, F = 2, 256, 512, 16
    sweep = load_jax_sweep(monkeypatch, B, N, E, F)
    x, edges, w = graph(B, N, E, F, seed=23)
    edges[0, 1, 9::40] = N + 1
    rng = np.random.default_rng(24)
    raw = rng.integers(-1, N + 5, (B, 2, 2 * 512)).astype(np.int32)
    cases = {f"cap {cap}": (*bucket_by_sink_window(*t(edges, w), N,
                                                   cap=cap)[:2], cap)
             for cap in (512, 1024)}
    cases["raw lanes"] = (*t(raw, rng.uniform(0.5, 1.5, (B, 1024))
                             .astype(np.float32)), 512)
    for name, (be, bw, cap) in cases.items():
        for dtype, jdtype in ((torch.float32, jnp.float32),
                              (torch.bfloat16, jnp.bfloat16)):
            want = sweep.pallas_win(*j(x, be.numpy(), bw.numpy()), jdtype,
                                    cap=cap)
            got = spmm_win(torch.from_numpy(x), be, bw, N, cap, dtype)
            np.testing.assert_allclose(got.numpy(), np.asarray(want),
                                       atol=TOL, rtol=0,
                                       err_msg=f"{name} {dtype}")
            assert got.dtype == torch.float32
            if name != "raw lanes":
                np.testing.assert_array_equal(
                    got.numpy(), spmm_onehot_dtype(*t(x, edges, w),
                                                   dtype).numpy())


def probe_kernels(M):
    """The three Pallas kernels of the JAX script's probe_dynamic_gather
    (benchmarks/spmm_variants.py:295-346; closures there), for M indices,
    in interpret mode."""
    from jax.experimental import pallas as pl
    from jax.experimental.pallas import tpu as pltpu

    def k_rows(x_ref, i_ref, o_ref):
        o_ref[:] = jnp.take(x_ref[:], i_ref[:], axis=0)

    def k_lanes(x_ref, i_ref, o_ref):
        o_ref[:] = jnp.take_along_axis(x_ref[:], i_ref[:], axis=1)

    def k_dyn_rows(x_ref, i_ref, o_ref):
        def body(j, _):
            o_ref[j, :] = x_ref[i_ref[j], :]
            return 0
        jax.lax.fori_loop(0, M, body, 0)

    def call(kernel, idx_space):
        def run(x, idx):
            shape = (idx.shape[0], x.shape[1]) if idx.ndim == 1 else idx.shape
            return pl.pallas_call(
                kernel, out_shape=jax.ShapeDtypeStruct(shape, jnp.float32),
                in_specs=[pl.BlockSpec(memory_space=pltpu.VMEM),
                          pl.BlockSpec(memory_space=idx_space)],
                out_specs=pl.BlockSpec(memory_space=pltpu.VMEM),
                interpret=True)(x, idx)
        return run

    return {take_rows: call(k_rows, pltpu.VMEM),
            take_lanes: call(k_lanes, pltpu.VMEM),
            take_rows_loop: call(k_dyn_rows, pltpu.SMEM)}


def test_gathers_match_pallas_probes():
    """take_rows, take_lanes and take_rows_loop equal the probe's Pallas
    kernels at the probe's shapes and at odd ones, with indices past either
    end: a NaN where jnp.take fills, wrapped or clamped rows where the
    Pallas kernels wrap or clamp."""
    rng = np.random.default_rng(25)
    for (R, C), M in [((64, 128), 128), ((40, 13), 56)]:
        x = rng.standard_normal((R, C)).astype(np.float32)
        idx = rng.integers(-R - 8, R + 8, M).astype(np.int32)
        idx[:4] = [R + 6, -1, -R - 36, -R]
        idxl = rng.integers(-C - 88, C + 88, (R, M)).astype(np.int32)
        idxl[0, :2] = [C + 88, -1]
        kernels = probe_kernels(M)
        for fn, i in ((take_rows, idx), (take_lanes, idxl),
                      (take_rows_loop, idx)):
            want = np.asarray(kernels[fn](*j(x, i)))
            got = fn(*t(x, i)).numpy()
            np.testing.assert_array_equal(got, want,
                                          err_msg=f"{fn.__name__} {R}x{C}")
            assert np.isnan(got).any() == (fn is not take_rows_loop)
    x = np.arange(64 * 2, dtype=np.float32).reshape(64, 2)
    idx = np.array([70, -1, -100, -64], np.int32)
    np.testing.assert_array_equal(take_rows_loop(*t(x, idx)).numpy(),
                                  x[[63, 63, 0, 0]])
    got = take_rows(*t(x, idx)).numpy()
    assert np.isnan(got[[0, 2]]).all()
    np.testing.assert_array_equal(got[[1, 3]], x[[63, 0]])


def test_probe_matches_jax(monkeypatch):
    """The port's probe_dynamic_gather on the CPU reports what the JAX
    script's reports in interpret mode: every gather "ok"."""
    sweep = load_jax_sweep(monkeypatch, 2, 128, 128, 8)
    got = sweep_mod.probe_dynamic_gather(device="cpu")
    assert got == sweep.probe_dynamic_gather()
    assert got == dict.fromkeys(("take_rows", "take_lanes", "dynslice_loop"),
                                "ok")


def test_gradients_match_jax():
    """torch.autograd through spmm_pairs and spmm_seg against jax.grad
    through their custom VJPs: dx, and dw lane by lane in the bucketed
    layout (tolerance 1e-4: dx runs the forward sums again)."""
    N, cap = 256, 256
    x, edges, w = graph(2, N, 512, 16, seed=8)
    cot = np.random.default_rng(9).standard_normal(x.shape).astype(np.float32)
    pe = bucket_edges_pairs(*t(edges, w), N, cap)
    se = bucket_edges_segments(*t(edges, w), N, cap)
    jpe = jax_pairs.bucket_edges_pairs(*j(edges, w), N, cap)
    jse = jax_seg.bucket_edges_segments(*j(edges, w), N, cap)
    cases = {
        "pairs f32x2": (
            lambda a, b: spmm_pairs(a, pe[0], b, N, cap, "f32x2"),
            lambda a, b: jax_pairs.spmm_pairs(a, jpe[0], b, N, cap, "f32x2"),
            pe[1], jpe[1]),
        "pairs bf16": (
            lambda a, b: spmm_pairs(a, pe[0], b, N, cap, "bf16"),
            lambda a, b: jax_pairs.spmm_pairs(a, jpe[0], b, N, cap, "bf16"),
            pe[1], jpe[1]),
        "seg": (
            lambda a, b: spmm_seg(a, se[0], b, se[2], se[3], N, cap),
            lambda a, b: jax_seg.spmm_seg(a, jse[0], b, jse[2], jse[3], N,
                                          cap),
            se[1], jse[1]),
    }
    for name, (fn, jfn, bw, jbw) in cases.items():
        tx = torch.from_numpy(x).requires_grad_()
        tw = bw.clone().requires_grad_()
        (fn(tx, tw) * torch.from_numpy(cot)).sum().backward()
        jdx, jdw = jax.grad(lambda a, b: jnp.sum(jfn(a, b) * cot),
                            argnums=(0, 1))(jnp.asarray(x), jbw)
        np.testing.assert_allclose(tx.grad.numpy(), np.asarray(jdx),
                                   atol=1e-4, rtol=0, err_msg=f"{name} dx")
        np.testing.assert_allclose(tw.grad.numpy(), np.asarray(jdw),
                                   atol=1e-4, rtol=0, err_msg=f"{name} dw")
        assert float(tw.grad.abs().sum()) > 0


def test_out_of_range_indices():
    """The pair and segment kernels clamp a source into its bucket's
    source window (one of N or more reads row N-1) and drop a sink outside
    the bucket's sink window, as their Pallas kernels do; the edge-list and
    one-hot kernels drop both. The per-edge kernel clamps a source into
    0..N-1 and drops a local sink outside its block, where the Pallas
    kernel's interpret mode writes the block's last row."""
    N, cap = 128, 128
    x = np.random.default_rng(10).standard_normal((1, N, 4)) \
        .astype(np.float32)
    edges = np.full((1, 2, 8), -1, np.int32)
    edges[0, :, :2] = [[5, 140], [133, 3]]   # (5, 133) and (140, 3)
    w = np.ones((1, 8), np.float32)
    clamped = np.zeros_like(x)
    clamped[0, 5] = x[0, N - 1]
    be, bw, _ = bucket_edges_pairs(*t(edges, w), N, cap)
    got = spmm_pairs(torch.from_numpy(x), be, bw, N, cap).numpy()
    np.testing.assert_array_equal(got, clamped)
    want = jax_pairs.spmm_pairs(jnp.asarray(x), *jax_pairs.bucket_edges_pairs(
        *j(edges, w), N, cap)[:2], N, cap)
    np.testing.assert_allclose(got, np.asarray(want), atol=TOL_F32X2, rtol=0)
    se = bucket_edges_segments(*t(edges, w), N, cap)
    got = spmm_seg(torch.from_numpy(x), *se[:4], N, cap).numpy()
    np.testing.assert_array_equal(got, clamped)
    want = jax_seg.spmm_seg(jnp.asarray(x), *jax_seg.bucket_edges_segments(
        *j(edges, w), N, cap)[:4], N, cap)
    np.testing.assert_allclose(got, np.asarray(want), atol=TOL_SEG, rtol=0)
    for dtype in (torch.float32, torch.bfloat16):
        assert not spmm_onehot_dtype(*t(x, edges, w), dtype).numpy().any()

    # the per-edge kernel: S = 32 rows per block
    got = spmm_prefetch(*t(x, edges, w)).numpy()
    np.testing.assert_array_equal(got, clamped)
    want = np.asarray(jax_prefetch.spmm_prefetch(*j(x, edges, w)))
    np.testing.assert_allclose(got[0, :N - 1], want[0, :N - 1], atol=TOL)
    assert np.abs(want[0, N - 1] - x[0, 3]).max() < TOL  # the Pallas write
    assert not got[0, N - 1].any()                        # dropped here


def lane_loop(x, dest, src, w):
    """out[b, dest] = out[b, dest] + w * x[b, src], lane after lane in
    numpy float32 (each product and add rounded once); dest -1 adds
    nothing."""
    out = np.zeros_like(x)
    for b in range(x.shape[0]):
        for d, s_, wt in zip(dest[b], src[b], w[b]):
            if d >= 0:
                out[b, d] = out[b, d] + np.float32(wt) * x[b, s_]
    return out


def sorted_row_sum(x, dest, src, w, round_msg=None):
    """The sink-sorted kernels' order (csrc/sink_sort.cuh) in numpy: each
    batch element's lanes stably sorted by dest, then each row summed over
    its lanes in that order from 0 in float32 (each product and add rounded
    once, and each message w * x passed through round_msg where given);
    dest outside 0..rows-1 adds nothing."""
    out = np.zeros_like(x)
    for b in range(x.shape[0]):
        ok = (dest[b] >= 0) & (dest[b] < x.shape[1])
        for e in np.argsort(np.where(ok, dest[b], -1), kind="stable"):
            if ok[e]:
                d = dest[b, e]
                msg = np.float32(w[b, e]) * x[b, src[b, e]]
                if round_msg is not None:
                    msg = round_msg(msg)
                out[b, d] = out[b, d] + msg
    return out


def round_bf16(a):
    """float32 values rounded to bf16 (round to nearest even) and back."""
    return torch.from_numpy(np.asarray(a, np.float32)).to(
        torch.bfloat16).float().numpy()


def table_walk(x, bsrc, bw, begin, end, cap):
    """spmm_seg's order in numpy: each sink row sums its segment
    [max(begin, 0), min(end, 128)) of every chunk of its window's buckets,
    kc ascending, chunks in order, lanes in order, from 0 in float32; a
    source is read clamped into its bucket's window."""
    B, N, F = x.shape
    nw, nch = N // 128, cap // 128
    out = np.zeros_like(x)
    for b, row, kc, j in np.ndindex(B, N, nw, nch):
        ks, s = divmod(row, 128)
        p = ks * nw + kc
        chunk = p * cap + j * 128
        for i in range(chunk + max(begin[b, p, j, s], 0),
                       chunk + min(end[b, p, j, s], 128)):
            src = kc * 128 + min(max(bsrc[b, i] - kc * 128, 0), 127)
            out[b, row] = out[b, row] + np.float32(bw[b, i]) * x[b, src]
    return out


def test_plain_versions_add_in_lane_order():
    """Each plain version is bitwise the lane-by-lane float32 sum that its
    kernel computes (the chip check then holds kernel and plain version
    bitwise equal); a depth above the most lanes into one row, as a caller
    may pass it, changes nothing; spmm_seg's walk of its tables is lane
    order, so it equals spmm_pairs on the same sink-sorted layout; the
    window layout keeps each sink's lanes in order, so spmm_win's plain
    version sums exactly the edge list's lane-by-lane sum; spmm_seg's plain
    version is bitwise a numpy walk of its tables in (kc, chunk, lane)
    order, as built and with entries clamped (begin < 0, end > 128), a
    sink's lanes over several chunks. The edge-list, window, per-edge and
    pair plain versions are also bitwise the sink-sorted kernels' order, a
    stable sort by sink and then one sum a row (for the pairs, a window's
    lanes with their sources clamped into their buckets' windows, and in
    bf16 mode each message alone rounded to bf16), on a hot row, sinks
    descending in lane order, and odd lanes (the -1 sentinel, indices of N
    or more, a window's lanes outside it)."""
    B, N, E, F, cap = 2, 256, 900, 5, 256
    x, edges, w = graph(B, N, E, F, seed=12)
    edges[:, 0, :150] = 9  # a segment over two 128-lane chunks
    edges[0, 1, 5::40] = N + 2
    sink, src = edges[:, 0].astype(np.int64), edges[:, 1].astype(np.int64)
    ok = (sink >= 0) & (sink < N) & (src >= 0) & (src < N)
    want = lane_loop(x, np.where(ok, sink, -1), np.where(ok, src, 0), w)
    tx, te, tw = t(x, edges, w)
    plains = {
        "edge_list": lambda d: spmm_mod.spmm_edge_list_plain(tx, te, tw, d),
        "onehot_f32": lambda d: spmm_mod.spmm_onehot_dtype_plain(
            tx, te, tw, torch.float32, d)}
    we, ww, counts = bucket_by_sink_window(te, tw, N, cap=512)
    assert int(counts.max()) <= 512
    plains["win"] = lambda d: win_mod.spmm_win_plain(tx, we, ww, N, 512,
                                                     depth=d)
    for name, plain in plains.items():
        for depth in (None, 160, 400):
            np.testing.assert_array_equal(plain(depth).numpy(), want,
                                          err_msg=f"{name} depth={depth}")

    be, bw, begin, end, _ = bucket_edges_segments(te, tw, N, cap)
    nw = N // 128
    bsink = be[:, 0].numpy().reshape(B, nw, nw, cap).astype(np.int64)
    bsrc = be[:, 1].numpy().reshape(B, nw, nw, cap).astype(np.int64)
    ks = np.arange(nw)[:, None, None]
    kc = np.arange(nw)[None, :, None]
    bdest = np.where((bsink >= ks * 128) & (bsink < ks * 128 + 128), bsink,
                     -1)
    bsrc = kc * 128 + np.clip(bsrc - kc * 128, 0, 127)
    want = lane_loop(x, bdest.reshape(B, -1), bsrc.reshape(B, -1),
                     bw.numpy())
    for depth in (None, 400):
        for name, got in (
                ("pairs", pairs_mod.spmm_pairs_plain(tx, be, bw, cap,
                                                     "f32x2", depth)),
                ("seg", seg_mod.spmm_seg_plain(tx, be, bw, begin, end, cap,
                                               depth))):
            np.testing.assert_array_equal(got.numpy(), want,
                                          err_msg=f"{name} depth={depth}")
    # spmm_seg's tables walked, as built and with entries clamped: 500
    # lanes into sink 9, over two chunks of each of its two buckets
    hot = edges.copy()
    hot[:, 0, :500] = 9
    be, bw, begin, end, tot = bucket_edges_segments(*t(hot, w), N, 384)
    assert int(tot.max()) <= 384
    lens = (end.clamp(max=128) - begin.clamp(min=0)).clamp(min=0)
    assert int((lens[:, :nw, :, 9] > 0).sum(dim=(1, 2)).min()) == 4
    for label in ("as built", "clamped"):
        if label == "clamped":
            begin, end = begin.clone(), end.clone()
            begin.view(-1)[::5] -= 7
            end.view(-1)[3::7] += 40
            assert bool((begin < 0).any()) and bool((end > 128).any())
        np.testing.assert_array_equal(
            seg_mod.spmm_seg_plain(tx, be, bw, begin, end, 384).numpy(),
            table_walk(x, be[:, 1].numpy(), bw.numpy(), begin.numpy(),
                       end.numpy(), 384), err_msg=f"seg walk {label}")

    sl, psrc, pw, _ = bucket_edges_sink_blocks(te, tw, N, 4)
    S = N // 4
    slv = sl.numpy().astype(np.int64)
    pdest = np.where((slv >= 0) & (slv < S),
                     np.arange(4)[None, :, None] * S + slv, -1)
    want = lane_loop(x, pdest.reshape(B, -1),
                     np.clip(psrc.numpy(), 0, N - 1).reshape(B, -1),
                     pw.numpy().reshape(B, -1))
    for depth in (None, 400):
        np.testing.assert_array_equal(
            prefetch_mod.spmm_prefetch_plain(tx, sl, psrc, pw, N,
                                             depth).numpy(), want,
            err_msg=f"prefetch depth={depth}")

    # the sink-sorted order on raw lanes, as the kernels take them
    B, N, F, E, nw, nblk = 2, 256, 5, 768, 2, 4
    S = N // nblk
    rng = np.random.default_rng(13)
    x = rng.standard_normal((B, N, F)).astype(np.float32)
    w = rng.uniform(0.5, 1.5, (B, E)).astype(np.float32)
    for case in ("hot row", "descending", "odd"):
        edges = rng.integers(0, N, (B, 2, E)).astype(np.int32)
        if case == "hot row":
            edges[:, 0] = 7
        elif case == "descending":
            edges[:, 0] = N - 1 - np.arange(E) * N // E
        edges[:, 0, 5::9] = -1
        edges[:, 1, 7::11] = -1
        edges[:, 0, 8::13] = N + 1
        edges[:, 1, 9::17] = N
        sink, src = edges[:, 0].astype(np.int64), edges[:, 1]
        src_ok = (src >= 0) & (src < N)
        tx, te, tw = t(x, edges, w)
        np.testing.assert_array_equal(
            spmm_mod.spmm_edge_list_plain(tx, te, tw).numpy(),
            sorted_row_sum(x, np.where(src_ok, sink, -1), src, w),
            err_msg=f"edge_list {case}")
        # the lanes as a window layout, E / nw lanes a segment
        lo = np.repeat(np.arange(nw) * 128, E // nw)
        dest = np.where(src_ok & (sink >= lo) & (sink < lo + 128), sink, -1)
        np.testing.assert_array_equal(
            win_mod.spmm_win_plain(tx, te, tw, N, E // nw).numpy(),
            sorted_row_sum(x, dest, src, w), err_msg=f"win {case}")
        # the lanes as per-edge slots of nblk sink blocks: local sinks
        # sink // 4 - 1, some S or more; sources clamped
        sl = (sink // 4 - 1).reshape(B, nblk, -1).astype(np.int32)
        sl[..., 3::19] = S
        j = np.arange(nblk)[None, :, None]
        dest = np.where((sl >= 0) & (sl < S), j * S + sl, -1)
        np.testing.assert_array_equal(
            prefetch_mod.spmm_prefetch_plain(
                tx, *t(sl, src.reshape(B, nblk, -1), w.reshape(B, nblk, -1)),
                N).numpy(),
            sorted_row_sum(x, dest.reshape(B, -1), np.clip(src, 0, N - 1),
                           w),
            err_msg=f"prefetch {case}")
        # the first nw * nw * 128 lanes as a pair layout (cap 128): a lane
        # of window ks adds only inside it, and reads its source clamped
        # into the window of its bucket kc, from its index in the window
        cap = 128
        L = nw * nw * cap
        e = np.arange(L)
        ks_lo, kc_lo = e // (nw * cap) * 128, e // cap % nw * 128
        dest = np.where((sink[:, :L] >= ks_lo) & (sink[:, :L] < ks_lo + 128),
                        sink[:, :L], -1)
        psrc = kc_lo + np.clip(src[:, :L] - kc_lo, 0, 127)
        for mode, round_msg in (("f32x2", None), ("bf16", round_bf16)):
            np.testing.assert_array_equal(
                pairs_mod.spmm_pairs_plain(
                    tx, te[..., :L].contiguous(), tw[:, :L].contiguous(),
                    cap, mode).numpy(),
                sorted_row_sum(x, dest, psrc, w[:, :L], round_msg),
                err_msg=f"pairs {mode} {case}")


def test_guards():
    """The overflow guards raise; the wrappers refuse a graph that is not a
    whole number of 128-node windows, a cap that is not a multiple of 128
    (of 512 above 512 for spmm_win), wrong layout or gather shapes, unknown
    modes and (forward-only entries) inputs that autograd tracks."""
    _, edges, w = graph(2, 128, 300, 4, seed=11, holes=False)
    _, _, counts = bucket_edges_pairs(*t(edges, w), 128, 128)
    assert int(counts.max()) > 128
    with pytest.raises(ValueError, match="overflow"):
        check_bucket_overflow(counts, 128)
    check_bucket_overflow(counts, int(counts.max()))
    *_, tot = bucket_edges_segments(*t(edges, w), 128, 128)
    np.testing.assert_array_equal(tot.numpy(), counts.numpy())
    *_, dropped = bucket_edges_sink_blocks(*t(edges, w), 128, 4, cap=8)
    assert int(dropped.min()) > 0

    x = torch.zeros(2, 128, 4)
    be, bw, _ = bucket_edges_pairs(*t(edges, w), 128, 256)
    seg = bucket_edges_segments(*t(edges, w), 128, 256)[:4]
    raises = {
        "N not a multiple of 128": lambda: spmm_pairs(
            torch.zeros(2, 100, 4), be, bw, 100, 256),
        "cap not a multiple of 128": lambda: bucket_edges_pairs(
            *t(edges, w), 128, 200),
        "pair layout of another cap": lambda: spmm_pairs(x, be, bw, 128,
                                                         128),
        "seg tables of another cap": lambda: spmm_seg(x, *seg, 128, 128),
        "seg N not a multiple of 128": lambda: bucket_edges_segments(
            *t(edges, w), 192, 128),
        "unknown precision": lambda: spmm_pairs(x, be, bw, 128, 256,
                                                "highest"),
        "onehot float64": lambda: spmm_onehot_dtype(
            x, *t(edges, w), torch.float64),
        "prefetch blocks": lambda: spmm_prefetch(x, *t(edges, w),
                                                 n_blocks=3),
    }
    we, ww, _ = bucket_by_sink_window(*t(edges, w), 128, cap=512)
    x2 = torch.zeros(4, 2)
    raises.update({
        "win N not a multiple of 128": lambda: spmm_win(
            torch.zeros(2, 192, 4), we, ww, 192, 512),
        "win cap above 512, not a multiple": lambda: spmm_win(
            x, *bucket_by_sink_window(*t(edges, w), 128, cap=600)[:2], 128,
            600),
        "win layout of another cap": lambda: spmm_win(x, we, ww, 128, 256),
        "win x of another N": lambda: spmm_win(x, we, ww, 256, 512),
        "win float16": lambda: spmm_win(x, we, ww, 128, 512, torch.float16),
        "window bucketing cap 0": lambda: bucket_by_sink_window(
            *t(edges, w), 128, cap=0),
        "take_rows 1-D x": lambda: take_rows(
            torch.zeros(4), torch.zeros(2, dtype=torch.int32)),
        "take_rows 2-D idx": lambda: take_rows(
            x2, torch.zeros(1, 2, dtype=torch.int32)),
        "take_lanes rows differ": lambda: take_lanes(
            x2, torch.zeros(3, 2, dtype=torch.int32)),
        "take_rows_loop empty x": lambda: take_rows_loop(
            torch.zeros(0, 2), torch.zeros(2, dtype=torch.int32)),
    })
    for name, call in raises.items():
        with pytest.raises(ValueError):
            call()
            pytest.fail(name)
    tracked = x.clone().requires_grad_()
    for call in (lambda: spmm_prefetch(tracked, *t(edges, w)),
                 lambda: spmm_pairs_T(tracked.transpose(1, 2), be, bw, 256),
                 lambda: spmm_seg_T(tracked.transpose(1, 2), *seg, 256),
                 lambda: spmm_onehot_dtype(tracked, *t(edges, w)),
                 lambda: spmm_win(tracked, we, ww, 128, 512),
                 lambda: take_rows(x2.requires_grad_(),
                                   torch.zeros(1, dtype=torch.int32))):
        with pytest.raises(NotImplementedError, match="no_grad"):
            call()


def test_non_cpu_tensors_never_reach_the_plain_versions(monkeypatch):
    """A tensor that is not on the CPU launches the kernel or raises; the
    plain version is never taken for it."""

    def refuse(*args, **kwargs):
        raise AssertionError("plain version called for a non-CPU tensor")

    for mod, name in ((spmm_mod, "spmm_onehot_dtype_plain"),
                      (pairs_mod, "spmm_pairs_plain"),
                      (seg_mod, "spmm_seg_plain"),
                      (prefetch_mod, "spmm_prefetch_plain"),
                      (win_mod, "spmm_win_plain"),
                      (gather_mod, "take_rows_plain"),
                      (gather_mod, "take_lanes_plain"),
                      (gather_mod, "take_rows_loop_plain")):
        monkeypatch.setattr(mod, name, refuse)
    B, N, F, cap = 2, 128, 8, 128

    def meta(*shape, dtype=torch.float32):
        return torch.empty(shape, dtype=dtype, device="meta")

    x = meta(B, N, F)
    ints = torch.int32
    calls = {
        spmm_onehot_dtype: lambda: spmm_onehot_dtype(
            x, meta(B, 2, 16, dtype=ints), meta(B, 16), torch.bfloat16),
        spmm_pairs: lambda: spmm_pairs(x, meta(B, 2, cap, dtype=ints),
                                       meta(B, cap), N, cap),
        spmm_seg: lambda: spmm_seg(x, meta(B, 2, cap, dtype=ints),
                                   meta(B, cap), meta(B, 1, 1, 128,
                                                      dtype=ints),
                                   meta(B, 1, 1, 128, dtype=ints), N, cap),
        spmm_prefetch: lambda: spmm_prefetch_bucketed(
            x, meta(B, 4, 8, dtype=ints), meta(B, 4, 8, dtype=ints),
            meta(B, 4, 8), N),
        spmm_win: lambda: spmm_win(x, meta(B, 2, cap, dtype=ints),
                                   meta(B, cap), N, cap // (N // 128)),
        take_rows: lambda: take_rows(meta(4, 8), meta(6, dtype=ints)),
        take_lanes: lambda: take_lanes(meta(4, 8), meta(4, 6, dtype=ints)),
        take_rows_loop: lambda: take_rows_loop(meta(4, 8),
                                               meta(6, dtype=ints)),
    }
    for wrapper, call in calls.items():
        before = wrapper.launches
        with pytest.raises(ValueError, match="CUDA tensors"):
            call()
        assert wrapper.launches == before, wrapper.__name__


def test_kernel_build(monkeypatch):
    """The new sources are built by build_all(); without the CUDA toolkit,
    loading their libraries raises instead of falling back."""
    assert {"spmm", "spmm_pairs", "spmm_seg", "spmm_prefetch", "spmm_win",
            "gather"} <= set(_build.sources())
    monkeypatch.setattr(_build.shutil, "which", lambda name: None)
    monkeypatch.setattr(_build.os.path, "exists", lambda path: False)
    for mod in (pairs_mod, seg_mod, prefetch_mod, win_mod, gather_mod):
        _build.load.cache_clear()
        mod._lib.cache_clear()
        with pytest.raises(RuntimeError, match="nvcc not found"):
            mod._lib()


def test_run_sweep_on_cpu(capsys, monkeypatch):
    """The sweep runs every row at a small shape on the CPU (the plain
    versions), each within its check, and leaves no JAX row out; a skipped
    row is not run. N=512 gives the window rows, at the JAX script's cap of
    E/2 lanes, room for twice their mean load, as at the sweep's point."""
    monkeypatch.setattr(sweep_mod, "ITERS", 1)
    monkeypatch.setattr(sweep_mod, "ROUNDS", 1)
    out = run_sweep(B=2, N=512, E=1024, F=16, device="cpu", skip=("sorted",))
    rows = out["results"]
    assert set(rows) == {
        "scatter", "sorted_hint", "cumsum", "sparse_mm", "edge_list_f32x2",
        "onehot_f32", "onehot_bf16", "win_f32", "win_bf16", "seg",
        "prefetch_nblk4", "prefetch_nblk8", "pairs_f32x2", "pairs_bf16"}
    for name, row in rows.items():
        assert "error" not in row, (name, row)
        assert row["edges_per_s"] > 0 and row["max_abs_err"] <= 1e-3 or \
            name.endswith("bf16"), (name, row)
    assert rows["onehot_bf16"]["max_abs_err"] > 0  # the rounding shows
    assert rows["win_f32"]["launches"] == 0  # the plain version on the CPU
    assert out["cap"] == 128 and out["device"] == "cpu"
    assert out["not_ported"] == []
    assert capsys.readouterr().out.count("\n") == len(rows)
