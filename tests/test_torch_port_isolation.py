"""The port stands alone: gcm_tpu_torch and chip_smoke.py import neither JAX
nor the JAX package, and the port's entry points run on the CUDA card by
default, raising instead of falling back to the CPU when there is none."""

import re
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest
import torch

import gcm_tpu_torch as g

torch.set_num_threads(1)

ROOT = Path(__file__).resolve().parent.parent


def test_import_leaves_jax_out():
    code = ("import sys, gcm_tpu_torch, gcm_tpu_torch.ops._build, "
            "gcm_tpu_torch.weights; "
            "bad = sorted(m for m in sys.modules if m == 'jax' "
            "or m.startswith(('jax.', 'jaxlib')) or m == 'gcm_tpu' "
            "or m.startswith('gcm_tpu.')); print(bad)")
    out = subprocess.run([sys.executable, "-c", code], cwd=ROOT,
                         capture_output=True, text=True, check=True,
                         timeout=120)
    assert out.stdout.strip() == "[]"


def test_sources_reference_no_jax():
    files = sorted((ROOT / "gcm_tpu_torch").rglob("*.py")) + [
        ROOT / "chip_smoke.py"]
    assert len(files) > 10
    hits = []
    for path in files:
        for line in path.read_text().splitlines():
            if re.search(r"^\s*(import jax|from jax)", line) or re.search(
                    r"\bgcm_tpu\.", line):
                hits.append(f"{path.relative_to(ROOT)}: {line.strip()}")
    # mentions of the JAX package's files in docstrings and comments name
    # them by path (gcm_tpu/...), never as a module (gcm_tpu.x)
    assert not hits, hits


def _cpu_model():
    return g.readme_dense_gcm(graph_size=16, device="cpu")


@pytest.mark.parametrize("entry", [
    lambda: g.readme_dense_gcm(),
    lambda: g.Linear(4, 4),
    lambda: g.DenseGraphConv(4, 4),
    lambda: g.DenseGCM(g.DenseGNN([g.DenseGraphConv(4, 4, device="cpu")])),
    lambda: g.SessionServer(_cpu_model(), capacity=2, obs_dim=8),
    lambda: g.resolve_device(None),
], ids=["readme_dense_gcm", "Linear", "DenseGraphConv", "DenseGCM",
        "SessionServer", "resolve_device"])
def test_entry_points_default_to_cuda(entry):
    if torch.cuda.is_available():
        pytest.skip("a CUDA card is present: device=None resolves to it")
    with pytest.raises(RuntimeError, match="device='cpu'"):
        entry()


def test_cpu_server_runs_when_asked():
    srv = g.SessionServer(_cpu_model(), capacity=2, obs_dim=8, device="cpu")
    out = srv.step({"a": np.ones(8, np.float32)})
    assert out["a"].shape == (32,) and np.isfinite(out["a"]).all()
