"""The check fails where it must: each cell driven through the harness on
the CPU at a tiny size with its timed path broken underneath comes out not
correct, once for each fault it can have, and the control (the reference
in TF32 in the program's place) reads above the cell's limits."""

import time
from types import SimpleNamespace

import pytest
import torch

from portbench import compare, harness, traffic

CELLS = [w["name"] for w in harness.benchmark()["workloads"]]
TRAIN = [c for c in CELLS if "train" in c]
ROLLOUT = [c for c in CELLS if "rollout" in c]


def _run(tiny, name):
    return tiny.run(name, 2 ** 31 + 23, 0.3, False, time.perf_counter(),
                    device="cpu")


@pytest.mark.parametrize("name", TRAIN)
def test_a_step_that_leaves_the_state_unchanged(tiny, monkeypatch, name):
    monkeypatch.setattr(torch.optim.Adam, "step",
                        lambda self, closure=None: None)
    r = _run(tiny, name)
    assert r["correct"] is False
    assert r["checks"]["change_gap"]["value"] == pytest.approx(1.0)


@pytest.mark.parametrize("name", TRAIN)
def test_half_of_the_batch_left_out(tiny, monkeypatch, name):
    from gcm_tpu_torch.train import train_step

    def halved(make):
        def factory(model, opt):
            step = make(model, opt)

            def faulty(xs, targets, *rest):
                h = xs.shape[0] // 2
                return step(xs[:h], targets[:h], *(r[:h] for r in rest))
            return faulty
        return factory

    for f in ("make_dense_supervised_step", "make_sparse_supervised_step"):
        monkeypatch.setattr(train_step, f, halved(getattr(train_step, f)))
    assert _run(tiny, name)["correct"] is False


def _patch_forward(monkeypatch, change):
    from gcm_tpu_torch.models.dense_gcm import DenseGCM
    from gcm_tpu_torch.models.sparse_gcm import SparseGCM

    for cls in (DenseGCM, SparseGCM):
        orig = cls.forward

        def forward(self, *args, _orig=orig, **kw):
            out, state = _orig(self, *args, **kw)
            return change(out, state, args[-1])
        monkeypatch.setattr(cls, "forward", forward)


@pytest.mark.parametrize("name", ROLLOUT)
def test_a_tick_that_leaves_the_state_unchanged(tiny, monkeypatch, name):
    _patch_forward(monkeypatch, lambda out, state, before: (out, before))
    r = _run(tiny, name)
    assert r["correct"] is False
    assert r["checks"]["state_mismatch"]["value"] > 0


@pytest.mark.parametrize("name", ROLLOUT)
def test_an_answer_altered_where_it_is_produced(tiny, monkeypatch, name):
    def alter(out, state, before):
        out = out.clone()
        out[..., 0] += 1e-3
        return out, state
    _patch_forward(monkeypatch, alter)
    r = _run(tiny, name)
    assert r["correct"] is False
    assert r["checks"]["belief_gap"]["value"] >= 1e-3 * 0.99


@pytest.mark.parametrize("name", CELLS)
def test_the_control_reads_above_the_limits(tiny, name):
    cell, wl, cfg = tiny.cell_files(harness.benchmark(), name)
    ctx = SimpleNamespace(name=name, workload=wl, config=cfg, seed=31,
                          seeds=traffic.sub_seeds(31), device="cpu")
    driver = __import__(f"portbench.drivers.{wl['driver']}",
                        fromlist=["Driver"]).Driver(ctx)
    driver.setup()
    if wl["driver"] == "rollout":
        harness.measure(driver, 0.3, None)
    out = driver.check(extra=("control",))
    assert compare.judge(out["program"], wl["limits"])[0]
    assert not compare.judge(out["control"], wl["limits"])[0]
