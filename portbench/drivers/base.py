"""What every driver shares: the device, spans for the traced window and
the counters of the work done."""

from __future__ import annotations

import contextlib
import copy
import time

import torch

from portbench import program, yardstick


class Driver:
    def __init__(self, ctx):
        self.ctx = ctx
        self.config = ctx.config
        self.traffic = ctx.workload["traffic"]
        self.device = torch.device(ctx.device)
        self.tracing = False
        self.count = {"units": 0, "timesteps": 0, "env_steps": 0,
                      "model_ops": 0, "work": {}}
        self.phases = []  # (what set-up finished, perf_counter)

    def build(self) -> None:
        """The configuration's sizes, the benchmark's weights from the seed
        and the program's model holding them."""
        kw = self.config["preset_kwargs"]
        self.N, self.H, self.obs = kw["graph_size"], kw["hidden"], \
            kw["obs_size"]
        self.hops, self.layers = kw["hops"], self.config["layers"]
        self.widths = [self.H] * (self.layers + 1)
        self.sparse = self.config["core"] == "sparse"
        self.weights = program.draw_weights(
            self.config, self.ctx.seeds["weights"], self.device)
        self.model = program.build(self.config, self.weights, self.device)
        self.mark("model")

    def mark(self, what: str) -> None:
        """Notes the end of a phase of set-up, for its breakdown."""
        self.sync()
        self.phases.append((what, time.perf_counter()))

    def span(self, name: str):
        """A profiler span around a call into the program, while traced."""
        if self.tracing:
            return torch.profiler.record_function(f"portbench.{name}")
        return contextlib.nullcontext()

    def sync(self) -> None:
        if self.device.type == "cuda":
            torch.cuda.synchronize(self.device)

    def counters(self) -> dict:
        return copy.deepcopy(self.count)

    def add_work(self, kernel: str, ops: float, nbytes: float,
                 calls: int = 1) -> None:
        """`calls` calls of the work a kernel row stands for, each of `ops`
        operations and `nbytes` bytes."""
        w = self.count["work"].setdefault(
            kernel, {"ops": 0.0, "bytes": 0.0, "bound_s": 0.0,
                     "bound_by": {"ops": 0, "bytes": 0}})
        t, by = yardstick.bound_s(ops, nbytes)
        w["ops"] += calls * ops
        w["bytes"] += calls * nbytes
        w["bound_s"] += calls * t
        w["bound_by"][by] += calls

    def free(self) -> None:
        """Drop the program's state and empty the allocator's cache before
        the reference runs."""
        import gc

        gc.collect()
        if self.device.type == "cuda":
            torch.cuda.empty_cache()
