"""The port's SpMM kernels (gcm_tpu_torch/ops/cuda/spmm.py, spmm_slots.py)
against the JAX package's Pallas kernels, run in interpret mode on the CPU
as tests/test_pallas_kernels.py runs them, and the slot-layout helpers
against the JAX ones.

On the CPU the wrappers take their plain PyTorch versions; the CUDA kernels
themselves are checked against those plain versions on the card by
chip_smoke.py. Tolerance 1e-5: both sides compute in float32 and differ
only in summation order.

Cases of one check run in a loop inside one test (the failure message names
the case) rather than as separate parametrised items: the suite runs under
pytest-xdist's load scheduling, and every item collected after the heavy
tests/test_sharded_sparse.py cases lengthens the run's tail.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from gcm_tpu.ops.pallas import spmm_slots as jax_slots
from gcm_tpu.ops.pallas.spmm import spmm_edge_list as jax_spmm_edge_list
from gcm_tpu_torch.ops import _build
from gcm_tpu_torch.ops.cuda import spmm as spmm_mod
from gcm_tpu_torch.ops.cuda import spmm_slots as slots_mod
from gcm_tpu_torch.ops.cuda.spmm import spmm_edge_list, spmm_onehot_dtype
from gcm_tpu_torch.ops.cuda.spmm_slots import (bucket_sink_slots,
                                               check_slot_overflow, spmm_slots)

torch.set_num_threads(1)

ATOL = 1e-5


def random_edges(B, N, E, seed, holes=True):
    """Random edges with sentinel lanes: sink only, source only, both, and
    a tail of all-sentinel lanes."""
    rng = np.random.default_rng(seed)
    edges = rng.integers(0, N, (B, 2, E)).astype(np.int32)
    if holes:
        edges[:, 0, 1::7] = -1
        edges[:, 1, 2::7] = -1
        edges[:, :, 3::7] = -1
        edges[:, :, -4:] = -1
    w = rng.uniform(0.5, 1.5, (B, E)).astype(np.float32)
    return edges, w


def features(B, N, F, seed):
    return np.random.default_rng(seed).standard_normal(
        (B, N, F)).astype(np.float32)


def torch_spmm(x, edges, w, precision="default"):
    return spmm_edge_list(torch.from_numpy(x), torch.from_numpy(edges),
                          torch.from_numpy(w), precision=precision).numpy()


def test_spmm_edge_list_matches_pallas():
    cases = {"small": dict(B=3, N=16, F=8, E=24),  # as TestSpMM
             "odd": dict(B=2, N=12, F=13, E=37),   # odd widths, E < one tile
             "two_tiles": dict(B=2, N=20, F=4, E=600)}  # E % 512 != 0
    for name, c in cases.items():
        x = features(c["B"], c["N"], c["F"], seed=0)
        edges, w = random_edges(c["B"], c["N"], c["E"], seed=1)
        for precision in ("default", "highest"):
            want = jax_spmm_edge_list(jnp.asarray(x), jnp.asarray(edges),
                                      jnp.asarray(w), precision=precision)
            got = torch_spmm(x, edges, w, precision)
            np.testing.assert_allclose(got, np.asarray(want), atol=ATOL,
                                       rtol=0, err_msg=f"{name} {precision}")


def test_spmm_precision_f32x2_is_float32():
    """'f32x2' is accepted and computes in float32, as the other modes do:
    on the TPU it was a two-pass bf16 approximation, which in interpret mode
    still rounds through bf16, so the port is held to the exact mode and to
    the f32x2 kernel within that kernel's own tolerance (2e-3, as
    tests/test_pallas_kernels.py holds it)."""
    x = features(3, 16, 8, seed=2)
    edges, w = random_edges(3, 16, 24, seed=3)
    got = torch_spmm(x, edges, w, "f32x2")
    np.testing.assert_array_equal(got, torch_spmm(x, edges, w, "highest"))
    exact = jax_spmm_edge_list(jnp.asarray(x), jnp.asarray(edges),
                               jnp.asarray(w), precision="highest")
    np.testing.assert_allclose(got, np.asarray(exact), atol=ATOL, rtol=0)
    approx = jax_spmm_edge_list(jnp.asarray(x), jnp.asarray(edges),
                                jnp.asarray(w), precision="f32x2")
    np.testing.assert_allclose(got, np.asarray(approx), atol=2e-3, rtol=0)


def test_spmm_sentinels_and_ranges():
    """All-sentinel edges give zeros. A lane with a sink or source of N or
    more adds nothing, as in the Pallas one-hots (the XLA fallback would
    clamp the source instead). An unknown precision raises."""
    x = features(2, 8, 4, seed=4)
    edges = np.full((2, 2, 6), -1, np.int32)
    w = np.ones((2, 6), np.float32)
    want = jax_spmm_edge_list(jnp.asarray(x), jnp.asarray(edges),
                              jnp.asarray(w))
    got = torch_spmm(x, edges, w)
    np.testing.assert_array_equal(got, np.asarray(want))
    assert not got.any()

    x = features(1, 6, 3, seed=5)
    edges = np.array([[[2, 6, 3, 9], [1, 1, 7, 0]]], np.int32)
    w = np.ones((1, 4), np.float32)
    want = jax_spmm_edge_list(jnp.asarray(x), jnp.asarray(edges),
                              jnp.asarray(w))
    got = torch_spmm(x, edges, w)
    np.testing.assert_allclose(got, np.asarray(want), atol=ATOL, rtol=0)
    expect = np.zeros_like(x)
    expect[0, 2] = x[0, 1]
    np.testing.assert_array_equal(got, expect)

    with pytest.raises(ValueError, match="precision"):
        spmm_edge_list(torch.zeros(1, 4, 2),
                       torch.full((1, 2, 3), -1, dtype=torch.int32),
                       torch.ones(1, 3), precision="bf16")


def temporal_hop_edges(B, N, hops, T):
    """The edge list TemporalEdge(hops) leaves after T steps."""
    sinks, srcs = [], []
    for i in range(1, T):
        for h in sorted(hops, reverse=True):
            if i - h >= 0:
                sinks.append(i)
                srcs.append(i - h)
    e = np.array([sinks, srcs], np.int32)
    return np.broadcast_to(e, (B, 2, e.shape[1])).copy()


def slot_case(N, k, seed):
    B, F = 2, 8
    if k == 1:
        edges = temporal_hop_edges(B, N, (1,), N)
    else:
        edges = temporal_hop_edges(B, N, (1, 2), N)
        edges[1, :, ::5] = -1  # holes in one batch
    w = np.random.default_rng(seed).uniform(
        0.5, 1.5, edges.shape[::2]).astype(np.float32)
    return features(B, N, F, seed), edges, w


def test_spmm_slots_matches_pallas():
    for N in (128, 256):
        for k in (1, 2):
            x, edges, w = slot_case(N, k, seed=N + k)
            j_srcs, j_ws, j_counts = jax_slots.bucket_sink_slots(
                jnp.asarray(edges), jnp.asarray(w), N, k)
            jax_slots.check_slot_overflow(j_counts, k)
            want = jax_slots.spmm_slots(jnp.asarray(x), j_srcs, j_ws, N, k)
            srcs, ws, counts = bucket_sink_slots(torch.from_numpy(edges),
                                                 torch.from_numpy(w), N, k)
            got = spmm_slots(torch.from_numpy(x), srcs, ws, N, k)
            np.testing.assert_allclose(got.numpy(), np.asarray(want),
                                       atol=ATOL, rtol=0, err_msg=f"{N} {k}")
            # and the sum it stands for: the edge-list SpMM of the graph
            np.testing.assert_allclose(got.numpy(), torch_spmm(x, edges, w),
                                       atol=ATOL, rtol=0, err_msg=f"{N} {k}")


def test_bucket_sink_slots_matches_jax():
    for N, k, E, seed in [(128, 1, 64, 0),   # some buckets overflow at k=1
                          (256, 3, 300, 1), (256, 8, 256, 2)]:
        edges, w = random_edges(2, N, E, seed)
        want = jax_slots.bucket_sink_slots(jnp.asarray(edges),
                                           jnp.asarray(w), N, k)
        got = bucket_sink_slots(torch.from_numpy(edges), torch.from_numpy(w),
                                N, k)
        for name, g, j in zip(("srcs", "ws", "counts"), got, want):
            np.testing.assert_array_equal(g.numpy(), np.asarray(j),
                                          err_msg=f"{name} N={N} k={k}")
        assert got[0].dtype == torch.int32 and got[2].dtype == torch.int32
        assert got[0].is_contiguous() and got[1].is_contiguous()  # kernel


def test_slot_guards():
    """check_slot_overflow raises on an overflowing bucket; spmm_slots
    refuses a graph that is not a whole number of 128-node windows."""
    edges, w = random_edges(2, 128, 64, seed=0)
    _, _, counts = bucket_sink_slots(torch.from_numpy(edges),
                                     torch.from_numpy(w), 128, 1)
    assert int(counts.max()) > 1
    with pytest.raises(ValueError, match="overflow"):
        check_slot_overflow(counts, 1)
    check_slot_overflow(counts, int(counts.max()))
    with pytest.raises(ValueError, match="multiple of 128"):
        spmm_slots(torch.zeros(1, 100, 4), torch.zeros(1, 1, 1, 128,
                                                        dtype=torch.int32),
                   torch.zeros(1, 1, 1, 128), 100, 1)


def test_non_cpu_tensors_never_reach_the_plain_versions(monkeypatch):
    """A tensor that is not on the CPU launches the kernel or raises; the
    plain version is never taken for it."""

    def refuse(*args, **kwargs):
        raise AssertionError("plain version called for a non-CPU tensor")

    monkeypatch.setattr(spmm_mod, "spmm_edge_list_plain", refuse)
    monkeypatch.setattr(slots_mod, "spmm_slots_plain", refuse)
    x = torch.empty((2, 128, 8), device="meta")
    edges = torch.empty((2, 2, 16), dtype=torch.int32, device="meta")
    w = torch.empty((2, 16), device="meta")
    srcs = torch.empty((2, 1, 1, 128), dtype=torch.int32, device="meta")
    ws = torch.empty((2, 1, 1, 128), device="meta")
    launches = (spmm_edge_list.launches, spmm_slots.launches)
    with pytest.raises(ValueError, match="CUDA tensors"):
        spmm_edge_list(x, edges, w)
    with pytest.raises(ValueError, match="CUDA tensors"):
        spmm_slots(x, srcs, ws, 128, 1)
    assert (spmm_edge_list.launches, spmm_slots.launches) == launches


def test_kernel_build(monkeypatch):
    """build_all() builds the new sources; without the CUDA toolkit,
    loading their libraries raises instead of falling back."""
    assert {"dense_gnn", "spmm", "spmm_slots"} <= set(_build.sources())
    monkeypatch.setattr(_build.shutil, "which", lambda name: None)
    monkeypatch.setattr(_build.os.path, "exists", lambda path: False)
    for mod in (spmm_mod, slots_mod):
        _build.load.cache_clear()
        mod._lib.cache_clear()
        with pytest.raises(RuntimeError, match="nvcc not found"):
            mod._lib()


def test_forward_only_refuses_tracked_inputs():
    """Of this file's kernels only the one-hot SpMM stays forward only (no
    VJP in the JAX experiment either): it refuses a tracked input. The
    edge-list and slot SpMMs are differentiable in x and their weights,
    and their gradients flow through (values against JAX in
    tests/test_torch_port_training.py)."""
    x = torch.zeros(1, 128, 4, requires_grad=True)
    edges = torch.full((1, 2, 3), -1, dtype=torch.int32)
    with pytest.raises(NotImplementedError, match="no_grad"):
        spmm_onehot_dtype(x, edges, torch.ones(1, 3), torch.bfloat16)
    with torch.no_grad():
        spmm_onehot_dtype(x, edges, torch.ones(1, 3), torch.bfloat16)
    srcs, ws, _ = bucket_sink_slots(edges, torch.ones(1, 3), 128, 1)
    w = torch.ones(1, 3, requires_grad=True)
    ws = ws.clone().requires_grad_()
    for out, inputs in ((spmm_edge_list(x, edges, w), (x, w)),
                        (spmm_slots(x, srcs, ws, 128, 1), (x, ws))):
        grads = torch.autograd.grad(out.sum(), inputs)
        assert all(not g.any() for g in grads)  # no edge: zero gradients
