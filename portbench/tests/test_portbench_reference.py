"""The plain reference against the port on the CPU at small sizes, for each
cell's entry: the dense scan (with wraparound), the sparse window, the
dense and sparse ticks with resets, Adam, and the TF32 rounding."""

import numpy as np
import pytest
import torch

from portbench import harness, program
from portbench.reference import adam, gcm


def _model(name, graph_size):
    cfg = harness.load_json(harness.HERE / "configs" / f"{name}.json")
    cfg["preset_kwargs"]["graph_size"] = graph_size
    w = program.draw_weights(cfg, 7, "cpu")
    return cfg, w, program.build(cfg, w, "cpu")


def test_dense_trajectory_matches_the_scan_through_wraparound():
    cfg, w, model = _model("readme_dense", 8)
    xs = torch.randn(3, 21, 8, generator=torch.Generator().manual_seed(1))
    with torch.no_grad():
        got, _ = model.scan(xs, model.initial_state(3, 8))
    want = gcm.dense_trajectory(xs, w, 8, [1], 2)
    torch.testing.assert_close(got, want, rtol=0, atol=2e-6)


def test_sparse_window_matches_the_core():
    cfg, w, model = _model("readme_sparse", 16)
    g = torch.Generator().manual_seed(2)
    xs = torch.randn(4, 16, 8, generator=g)
    taus = torch.tensor([1, 5, 16, 9], dtype=torch.int32)
    xs = torch.where(torch.arange(16)[None, :, None] < taus[:, None, None],
                     xs, 0.0)
    with torch.no_grad():
        got, _ = model(xs, taus, model.initial_state(4, 8))
    want = gcm.sparse_window(xs, taus, w, 16, [1], 2)
    torch.testing.assert_close(got, want, rtol=0, atol=2e-6)


@pytest.mark.parametrize("core", ["dense", "sparse"])
def test_ticks_with_resets_match_the_core(core):
    from gcm_tpu_torch.core.graph_state import reset_where

    N, B, ticks = 6, 5, 40
    cfg, w, model = _model(f"readme_{core}", N)
    rng = np.random.default_rng(3)
    if core == "dense":
        ref = gcm.dense_state(B, N, 8, "cpu")
        step, reset = gcm.dense_step, gcm.dense_reset
    else:
        ref = gcm.sparse_state(B, N, 8, 512, "cpu")
        step, reset = gcm.sparse_tick, gcm.sparse_reset
    state = model.initial_state(B, 8)
    pos = np.zeros(B, dtype=int)
    ones = torch.ones(B, dtype=torch.int32)
    for _ in range(ticks):
        x = torch.from_numpy(rng.standard_normal((B, 8), dtype=np.float32))
        with torch.no_grad():
            if core == "dense":
                got, state = model(x, state)
            else:
                got, state = model(x[:, None], ones, state)
                got = got[:, 0]
        want, ref = step(ref, x, w, [1], 2)
        torch.testing.assert_close(got, want, rtol=0, atol=2e-6)
        pos += 1
        # dense episodes run past the graph (it wraps); sparse ones never
        done = rng.random(B) < 0.1 if core == "dense" else pos >= N
        done |= pos >= (3 * N if core == "dense" else N)
        pos[done] = 0
        d = torch.from_numpy(done)
        state, ref = reset_where(state, d), reset(ref, d)
    fields = [t for t in state if t.numel()]
    assert len(fields) == len(ref)
    for a, b in zip(fields, ref):
        assert torch.equal(a.to(b.dtype), b)


def test_adam_matches_torch():
    g = torch.Generator().manual_seed(4)
    p0 = torch.randn(6, 3, generator=g)
    grads = [torch.randn(6, 3, generator=g) for _ in range(3)]
    t = torch.nn.Parameter(p0.clone())
    opt = torch.optim.Adam([t], lr=1e-3)
    ref = adam.Adam({"p": p0.clone()}, lr=1e-3)
    for gr in grads:
        t.grad = gr.clone()
        opt.step()
        ref.step({"p": gr})
    torch.testing.assert_close(ref.params["p"], t.detach(), rtol=0,
                               atol=1e-7)


def test_tf32_rounding():
    ulp = 2.0 ** -10
    x = torch.tensor([1.0, 1 + ulp / 2, 1 + 1.5 * ulp, -(1 + 1.5 * ulp),
                      1 + 0.49 * ulp, 3.0e-39, 0.0])
    want = torch.tensor([1.0, 1.0, 1 + 2 * ulp, -(1 + 2 * ulp), 1.0,
                         gcm.tf32_round(torch.tensor([3.0e-39]))[0], 0.0])
    assert torch.equal(gcm.tf32_round(x), want)
    r = gcm.tf32_round(torch.randn(1000))
    assert torch.all((r.view(torch.int32) & 0x1FFF) == 0)
