"""CPU tests of the benchmark: `python -m pytest portbench/tests -q`.

Tests that need the card carry the `card` marker and skip, with a reason,
where the `card` fixture finds none; on the card: `python -m pytest
portbench/tests -q -m card`.
"""

import sys
from pathlib import Path

import pytest

REPO = Path(__file__).resolve().parents[2]
sys.path.insert(0, str(REPO))

# Each cell cut to a size a CPU test holds: a few graphs of a few nodes.
TINY_TRAFFIC = {"batch": 8, "steps": 12, "pool": 3}
TINY_GRAPH = 12


def pytest_configure(config):
    config.addinivalue_line(
        "markers", "card: needs an NVIDIA card (skips without one)")


@pytest.fixture
def card():
    import torch

    if not torch.cuda.is_available():
        pytest.skip("no CUDA card here: the benchmark runs only on the card")
    return torch.device("cuda:0")


def shrink(cell, wl, cfg):
    tr = wl["traffic"]
    for k, v in TINY_TRAFFIC.items():
        if k in tr:
            tr[k] = v
    if "taus" in tr:
        tr["taus"] = {"min": 3, "max": TINY_GRAPH}
    if "episode" in tr:  # dense episodes outlast the graph: it wraps
        big = 2 * TINY_GRAPH if cfg["core"] == "dense" else TINY_GRAPH
        tr["episode"] = {"min": 3, "max": big}
    cfg["preset_kwargs"]["graph_size"] = TINY_GRAPH
    wl["check"].update(row_block=3, envs=4)
    return cell, wl, cfg


@pytest.fixture
def tiny(monkeypatch):
    """harness.run on the CPU with every cell cut to a tiny size."""
    from portbench import harness

    real = harness.cell_files
    monkeypatch.setattr(harness, "cell_files",
                        lambda bench, name: shrink(*real(bench, name)))
    return harness
