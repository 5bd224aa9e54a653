"""The benchmark's files: every cell of BENCHMARK.json resolves by name to
its workload, configuration, driver and metric files, the file keeps to the
benchmark's contract, and a configuration, a cell and a metric can be added
as new files and entries alone."""

import json
import re
import shutil
import subprocess
import sys
import textwrap

from conftest import REPO

from portbench import harness

NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.\-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.\-]{1,16}$")


def test_every_cell_resolves_and_keeps_to_the_contract():
    bench = harness.benchmark()
    assert set(bench) == {"command", "paths", "run_seconds", "configs",
                          "workloads", "end_to_end", "per_layer"}
    assert 1 <= bench["run_seconds"] <= 51
    names = [m["name"] for m in bench["end_to_end"] + bench["per_layer"]]
    assert len(names) == len(set(names))
    cells = {w["name"] for w in bench["workloads"]}
    for c in bench["configs"]:
        assert set(c) == {"name", "source", "file", "reduced", "why"}
        assert NAME.match(c["name"])
        cfg = json.loads((REPO / c["file"]).read_text())
        assert cfg["name"] == c["name"] and cfg["reduced"] == c["reduced"]
        assert any(w["config"] == c["name"] for w in bench["workloads"])
    for w in bench["workloads"]:
        assert set(w) == {"name", "config", "traffic", "chips", "why"}
        assert NAME.match(w["name"]) and NAME.match(w["traffic"])
        assert len(w["why"]) <= 200 and w["chips"] == 1
        cell, wl, cfg = harness.cell_files(bench, w["name"])
        assert (REPO / "portbench" / "drivers" / f"{wl['driver']}.py").exists()
        assert set(wl["limits"]) and cfg["core"] in ("dense", "sparse")
        e2e = harness.cell_metrics(bench, w["name"], traced=False)
        assert "setup_s" in {m["name"] for m in e2e} and len(e2e) >= 2
        assert harness.cell_metrics(bench, w["name"], traced=True)
    for m in bench["end_to_end"]:
        assert m["source"] in ("host_clock", "device_trace")
        assert 0.01 <= m["bound"] <= 0.25
    for m in bench["end_to_end"] + bench["per_layer"]:
        assert NAME.match(m["name"]) and UNIT.match(m["unit"])
        assert m["better"] in ("lower", "higher")
        assert set(m.get("workloads", cells)) <= cells
        assert harness.metric_reader(m["name"]).read  # metrics/<name>.py
    for m in bench["per_layer"]:
        moves = next(e for e in bench["end_to_end"] if e["name"] == m["moves"])
        assert set(m["workloads"]) <= set(moves.get("workloads", cells))
    assert len(json.dumps(bench)) < 64 * 1024


def test_a_config_a_cell_and_a_metric_are_added_as_files(tmp_path):
    """A copy of the benchmark gains a configuration, a cell and a metric
    by new files and entries only, and runs the new cell."""
    shutil.copytree(REPO / "portbench", tmp_path / "portbench",
                    ignore=shutil.ignore_patterns("__pycache__", "tests"))
    bench = harness.benchmark()
    pb = tmp_path / "portbench"
    cfg = json.loads((pb / "configs" / "readme_dense.json").read_text())
    cfg.update(name="readme_dense_g16", reduced=["graph_size"])
    cfg["preset_kwargs"]["graph_size"] = 16
    (pb / "configs" / "readme_dense_g16.json").write_text(json.dumps(cfg))
    wl = json.loads((pb / "workloads" / "dense-train-b4096-t128.json")
                    .read_text())
    wl.update(config="readme_dense_g16", traffic_mix="train-b4-t16")
    wl["traffic"].update(batch=4, steps=16, pool=3)
    wl["check"]["row_block"] = 2
    (pb / "workloads" / "dense-train-tiny.json").write_text(json.dumps(wl))
    (pb / "metrics" / "train_steps.py").write_text(textwrap.dedent('''
        """train_steps: the steps the window completed."""


        def read(view):
            return view.window["count"]["units"]
        '''))
    bench["configs"].append({"name": "readme_dense_g16", "source": "x",
                             "file": "portbench/configs/readme_dense_g16.json",
                             "reduced": ["graph_size"], "why": "a test"})
    bench["workloads"].append({"name": "dense-train-tiny",
                               "config": "readme_dense_g16",
                               "traffic": "train-b4-t16", "chips": 1,
                               "why": "a test"})
    for m in bench["end_to_end"]:
        if m["name"] == "train_timesteps_per_s":
            m["workloads"].append("dense-train-tiny")
    bench["end_to_end"].append({"name": "train_steps", "unit": "steps",
                                "better": "higher", "bound": 0.1,
                                "source": "host_clock",
                                "workloads": ["dense-train-tiny"]})
    (tmp_path / "BENCHMARK.json").write_text(json.dumps(bench))
    code = textwrap.dedent(f"""
        import json, sys, time
        sys.path.insert(0, {str(tmp_path)!r})
        sys.path.insert(1, {str(REPO)!r})
        from portbench import harness
        assert harness.HERE.parent.as_posix() == {tmp_path.as_posix()!r}
        r = harness.run("dense-train-tiny", 5, 0.5, False,
                        time.perf_counter(), device="cpu")
        print(json.dumps(r))
        """)
    out = subprocess.run([sys.executable, "-c", code], capture_output=True,
                         text=True, timeout=300)
    assert out.returncode == 0, out.stderr[-3000:]
    result = json.loads(out.stdout.strip().splitlines()[-1])
    assert result["correct"] is True
    assert set(result["metrics"]) == {"train_timesteps_per_s", "setup_s",
                                      "train_steps"}
    assert result["metrics"]["train_steps"]["value"] >= 1
