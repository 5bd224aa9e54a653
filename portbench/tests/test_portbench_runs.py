"""Each cell rehearsed on the CPU at a tiny size through the harness, its
line's keys; the entry point without a card; the import check; and each
cell on the card (marked)."""

import json
import subprocess
import sys
import time

import pytest

from conftest import REPO

from portbench import harness

CELLS = [w["name"] for w in harness.benchmark()["workloads"]]
KEYS = ["correct", "attempted", "failed", "metrics", "device", "checks"]


@pytest.mark.parametrize("name", CELLS)
def test_a_tiny_rehearsal_prints_the_contracts_keys(tiny, name):
    for traced in (False, True):
        r = tiny.run(name, 2 ** 31 + 11, 0.3, traced, time.perf_counter(),
                     device="cpu")
        assert list(r) == KEYS, r  # "checks" comes last
        assert r["correct"] is True and r["failed"] == 0, r
        assert r["attempted"] >= 1
        assert set(r["device"]) == {"platform", "kind", "count",
                                    "memory_peak_bytes"}
        wl = json.loads((REPO / "portbench" / "workloads" / f"{name}.json")
                        .read_text())
        assert set(r["checks"]) == set(wl["limits"])
        if not traced:
            want = {m["name"] for m in
                    harness.cell_metrics(harness.benchmark(), name, False)}
            assert set(r["metrics"]) == want
            assert all(v["value"] > 0 for v in r["metrics"].values())


def test_without_a_card_the_entry_point_prints_no_result():
    import torch

    if torch.cuda.is_available():
        pytest.skip("this machine has a card")
    out = subprocess.run(
        [sys.executable, "portbench/run.py", "--workload", CELLS[0],
         "--seed", "3", "--seconds", "1", "--trace", "0"],
        cwd=REPO, capture_output=True, text=True, timeout=300)
    assert out.returncode != 0 and out.stdout.strip() == ""
    assert "cuda" in out.stderr.lower()


@pytest.mark.parametrize("names,found", [
    (["gcm_tpu_torch", "gcm_tpu_torch.ops.cuda", "torch"], []),
    (["gcm_tpu", "gcm_tpu.models.dense_gcm"], ["gcm_tpu"]),
    (["jaxlib.xla_client", "jaxtyping", "flax.linen"], ["flax", "jaxlib"]),
    (["jax"], ["jax"]),
])
def test_the_import_check_compares_whole_top_level_names(monkeypatch, names,
                                                         found):
    fake = {n: object() for n in names}
    monkeypatch.setattr(sys, "modules", fake)
    assert harness.forbidden_modules() == found


def test_the_benchmark_and_its_reference_import_neither_jax_nor_the_program():
    import ast

    for path in (REPO / "portbench").rglob("*.py"):
        if "tests" in path.parts:
            continue
        tree = ast.parse(path.read_text())
        tops = set()
        for node in ast.walk(tree):
            if isinstance(node, ast.Import):
                tops |= {a.name.split(".")[0] for a in node.names}
            elif isinstance(node, ast.ImportFrom) and node.module:
                tops.add(node.module.split(".")[0])
        assert not tops & {"jax", "jaxlib", "flax", "gcm_tpu"}, path
        if "reference" in path.parts:
            assert "gcm_tpu_torch" not in tops, path
            assert tops <= {"torch", "math", "__future__", "portbench"}, path


@pytest.mark.card
@pytest.mark.parametrize("name", CELLS)
def test_each_cell_runs_correct_on_the_card(card, name):
    out = subprocess.run(
        [sys.executable, "portbench/run.py", "--workload", name, "--seed",
         "2147483659", "--seconds", "3", "--trace", "0"],
        cwd=REPO, capture_output=True, text=True, timeout=1200)
    assert out.returncode == 0, out.stderr[-3000:]
    r = json.loads(out.stdout.strip().splitlines()[-1])
    assert r["correct"] is True and r["device"]["platform"] == "gpu", r
