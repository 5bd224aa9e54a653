"""The port's graph-conv kernels (gcm_tpu_torch/ops/cuda) against the JAX
package's Pallas kernels, run in interpret mode on the CPU as
tests/test_pallas_kernels.py runs them.

On the CPU the wrappers take their plain PyTorch versions; the CUDA kernels
themselves are checked against those plain versions on the card by
chip_smoke.py. Tolerance 1e-5: both sides compute in float32 and differ
only in summation order.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from gcm_tpu.ops.pallas.dense_gconv import (
    fused_dense_graph_conv as jax_fused_dense_graph_conv)
from gcm_tpu.ops.pallas.fused_gnn import _pallas_forward
from gcm_tpu_torch.ops import _build
from gcm_tpu_torch.ops.cuda import dense_gconv, fused_gnn
from gcm_tpu_torch.ops.cuda.dense_gconv import fused_dense_graph_conv
from gcm_tpu_torch.ops.cuda.fused_gnn import fused_dense_gnn

torch.set_num_threads(1)

ATOL = 1e-5
B, N, F = 3, 16, 8


def make_inputs(n_layers, seed=0, weighted=False):
    """x, adj and flat params; adj 0/1, or with weighted the mask times
    uniform (0, 1) edge weights, as DenseGNN builds it with edge weights
    (the card's 3xTF32 split of a 0/1 adjacency has no low half)."""
    rng = np.random.default_rng(seed)
    x = rng.standard_normal((B, N, F)).astype(np.float32)
    adj = (rng.random((B, N, N)) < 0.3).astype(np.float32)
    adj[:, 0, :] = 0.0  # a row with no edges
    if weighted:
        adj *= rng.random((B, N, N)).astype(np.float32)
    flat = []
    for _ in range(n_layers):
        flat += [rng.uniform(-0.35, 0.35, (F, F)).astype(np.float32),
                 rng.uniform(-0.35, 0.35, (F,)).astype(np.float32),
                 rng.uniform(-0.35, 0.35, (F, F)).astype(np.float32)]
    return x, adj, flat


@pytest.mark.parametrize("act", [None, "tanh", "relu"])
@pytest.mark.parametrize("n_layers", [1, 2])
def test_fused_dense_gnn_matches_pallas(n_layers, act):
    acts = (act,) * n_layers
    for weighted in (False, True):
        x, adj, flat = make_inputs(n_layers, weighted=weighted)
        want = _pallas_forward(jnp.asarray(x), jnp.asarray(adj),
                               tuple(jnp.asarray(p) for p in flat), acts)
        got = fused_dense_gnn(torch.from_numpy(x), torch.from_numpy(adj),
                              [torch.from_numpy(p) for p in flat], acts)
        np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=ATOL,
                                   rtol=0, err_msg=f"weighted={weighted}")


@pytest.mark.parametrize("act", [None, "tanh", "relu"])
def test_fused_dense_graph_conv_matches_pallas(act):
    x, adj, (wr, br, wo) = make_inputs(1, seed=1)
    want = jax_fused_dense_graph_conv(jnp.asarray(x), jnp.asarray(adj),
                                      jnp.asarray(wr), jnp.asarray(br),
                                      jnp.asarray(wo), activation=act)
    got = fused_dense_graph_conv(*(torch.from_numpy(a)
                                   for a in (x, adj, wr, br, wo)),
                                 activation=act)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=ATOL,
                               rtol=0)


def _meta_inputs():
    x, adj, flat = make_inputs(2)
    return (torch.empty(x.shape, device="meta"),
            torch.empty(adj.shape, device="meta"),
            [torch.empty(p.shape, device="meta") for p in flat])


def test_non_cpu_tensors_never_reach_the_plain_version(monkeypatch):
    """A tensor that is not on the CPU launches the kernel or raises; the
    plain version is never taken for it."""

    def refuse(*args, **kwargs):
        raise AssertionError("plain version called for a non-CPU tensor")

    monkeypatch.setattr(fused_gnn, "fused_dense_gnn_plain", refuse)
    monkeypatch.setattr(dense_gconv, "fused_dense_graph_conv_plain", refuse)
    x, adj, flat = _meta_inputs()
    launches = (fused_dense_gnn.launches, fused_dense_graph_conv.launches)
    with pytest.raises(ValueError, match="CUDA tensors"):
        fused_dense_gnn(x, adj, flat, ("tanh", "tanh"))
    with pytest.raises(ValueError, match="CUDA tensors"):
        fused_dense_graph_conv(x, adj, *flat[:3])
    assert (fused_dense_gnn.launches,
            fused_dense_graph_conv.launches) == launches


def test_kernel_build_without_nvcc_raises(monkeypatch):
    """Without the CUDA toolkit the kernel library cannot be built, and
    loading it says so instead of falling back."""
    monkeypatch.setattr(_build.shutil, "which", lambda name: None)
    monkeypatch.setattr(_build.os.path, "exists", lambda path: False)
    _build.load.cache_clear()
    fused_gnn._lib.cache_clear()
    with pytest.raises(RuntimeError, match="nvcc not found"):
        fused_gnn._lib()


@pytest.mark.parametrize("sizes", [
    dict(B=2, N=100, widths=(8, 8)),         # N not a multiple of 16
    dict(B=2, N=2048, widths=(8, 8)),        # N above 1024
    dict(B=2, N=128, widths=(8, 256)),       # width above 128
    dict(B=2, N=128, widths=(8,) * 6),       # 5 layers
])
def test_shapes_the_kernel_does_not_take_raise(sizes):
    from gcm_tpu_torch.ops.cuda._launch import check_sizes

    with pytest.raises(ValueError):
        check_sizes(sizes["B"], sizes["N"], sizes["widths"])


def test_forward_only_refuses_tracked_inputs():
    x, adj, flat = make_inputs(1)
    w = torch.from_numpy(flat[0]).requires_grad_()
    with pytest.raises(NotImplementedError, match="no_grad"):
        fused_dense_graph_conv(torch.from_numpy(x), torch.from_numpy(adj), w,
                               torch.from_numpy(flat[1]),
                               torch.from_numpy(flat[2]))
    with torch.no_grad():
        fused_dense_graph_conv(torch.from_numpy(x), torch.from_numpy(adj), w,
                               torch.from_numpy(flat[1]),
                               torch.from_numpy(flat[2]))


def test_dense_bound_counts_3xtf32_on_tensor_cores():
    """chip_smoke.py's bound for the dense kernels counts their products
    three times (3xTF32) at the tensor cores' dense TF32 rate, and so is
    set by the bytes at the served tick's shape: 25.18 MB over 3.35 TB/s,
    not 805 MFLOP over the CUDA cores' 67 TFLOP/s."""
    import importlib.util
    from pathlib import Path

    path = Path(__file__).resolve().parent.parent / "chip_smoke.py"
    spec = importlib.util.spec_from_file_location("chip_smoke_bounds", path)
    chip_smoke = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(chip_smoke)
    ms, by = chip_smoke.dense_bound_ms(256, 128, (32, 32, 32))
    assert by == "bytes" and ms == pytest.approx(25.18e6 / 3.35e12 * 1e3,
                                                 rel=1e-3)
    ms, by = chip_smoke.dense_bound_ms(32, 128, (32, 32))
    assert by == "bytes" and ms == pytest.approx(0.00094, rel=2e-3)
