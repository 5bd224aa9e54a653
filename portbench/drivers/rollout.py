"""Acting through the memory for a vectorised environment: B environments
stepped in lockstep in a closed loop, one tick at a time, under
`torch.inference_mode`. A tick hands over the observations (a host pool
made from the seed, copied from pinned memory), runs the core's step
(`DenseGCM.forward`, or `SparseGCM.forward` on a window of one) and copies
the beliefs to the host; then the environments whose episode ended are
reset with `reset_where`. Episode lengths are uniform in the workload's
range. A unit is one tick; its latency runs from the hand-over to the
beliefs on the host.

The check follows `check.envs` environments drawn from the seed through
every tick of the run, set-up's ticks included: the reference replays their
observations and resets, and their beliefs at every tick and their memory
after the last are compared.
"""

from __future__ import annotations

import time

import numpy as np
import torch

from portbench import compare, traffic, yardstick
from portbench.drivers import base
from portbench.reference import gcm


class Driver(base.Driver):
    def setup(self):
        from gcm_tpu_torch.core.graph_state import reset_where

        tr, dev = self.traffic, self.device
        self.build()
        self.B = B = tr["batch"]
        self.reset_where = reset_where
        rng = np.random.default_rng(self.ctx.seeds["host"])
        pin = dev.type == "cuda"
        self.pool = traffic.host_obs_pool(tr, self.obs, rng)
        self.episodes = traffic.Episodes(tr["episode"], B, rng)
        envs = self.ctx.workload["check"]["envs"]
        self.sample = np.sort(np.random.default_rng(
            self.ctx.seeds["sample"]).choice(B, envs, replace=False))
        self.sample_dev = torch.from_numpy(self.sample).to(dev)
        self.host_belief = torch.empty((B, self.H), pin_memory=pin)
        self.done_host = torch.empty((B,), dtype=torch.bool, pin_memory=pin)
        if pin:
            self.pool = self.pool.pin_memory()
        with torch.inference_mode():
            self.state = self.model.initial_state(B, self.obs)
            self.taus = torch.ones((B,), dtype=torch.int32, device=dev)
        self.pre_ops = yardstick.linear_ops(B * self.N, self.obs, self.H)
        gnn = yardstick.dense_gnn_ops(B, self.N, self.widths)
        self.tick_ops = self.pre_ops + gnn
        self.tick_work = (gnn, yardstick.dense_gnn_bytes(B, self.N,
                                                         self.widths))
        self.tick = 0
        self.latency = []
        self.beliefs, self.dones = [], []
        self.mark("inputs")
        for k in range(self.ctx.workload["check"]["warm_ticks"]):
            self.unit()
            self.mark(f"tick {k + 1}")
        self.latency.clear()

    def unit(self):
        dev = self.device
        x_host = self.pool[self.tick % self.pool.shape[0]]
        t0 = time.perf_counter()
        with torch.inference_mode():
            with self.span("h2d"):
                x = x_host.to(dev, non_blocking=True)
            with self.span("step"):
                if self.sparse:
                    out, self.state = self.model(x[:, None], self.taus,
                                                 self.state)
                    belief = out[:, 0]
                else:
                    belief, self.state = self.model(x, self.state)
            with self.span("d2h"):
                self.host_belief.copy_(belief, non_blocking=True)
                if dev.type == "cuda":
                    torch.cuda.current_stream(dev).synchronize()
            self.latency.append(time.perf_counter() - t0)
            with self.span("bookkeeping"):
                self._count()
                self.beliefs.append(self.host_belief.numpy()[self.sample])
                done = self.episodes.advance()
                self.dones.append(done[self.sample])
                self.done_host.numpy()[:] = done
            with self.span("reset"):
                self.state = self.reset_where(
                    self.state, self.done_host.to(dev, non_blocking=True))
        self.tick += 1

    def _count(self) -> None:
        """The tick's work (yardstick.py): the dense step's is the same every
        tick; the sparse one's follows the nodes each episode holds, this
        tick's included."""
        c = self.count
        c["units"] += 1
        c["env_steps"] += self.B
        if not self.sparse:
            c["model_ops"] += self.tick_ops
            self.add_work("fused_dense_gnn", *self.tick_work)
            return
        n = np.minimum(self.episodes.pos + 1, self.N)
        edges, rows = yardstick.temporal_totals(n, self.hops)
        c["model_ops"] += self.pre_ops + yardstick.sparse_gnn_ops(
            self.B, self.N, edges, self.widths)
        self.add_work("spmm_edge_list", 2 * edges * self.H,
                      yardstick.spmm_bytes(self.B, self.N, self.H, edges,
                                           rows), self.layers)

    def failed(self) -> int:
        """Ticks whose sampled beliefs are not finite."""
        return int(sum(not np.isfinite(b).all() for b in self.beliefs))

    def check(self, extra=()) -> dict:
        got = {"beliefs": np.stack(self.beliefs),
               "state": [t[self.sample_dev].cpu().numpy()
                         for t in self.state if t.numel()]}
        del self.model, self.state
        self.free()
        want = self.reference("fp32")
        out = {"program": compare.rollout_numbers(got, want)}
        if "control" in extra:
            out["control"] = compare.rollout_numbers(
                self.reference("tf32"), want)
        return out

    def reference(self, precision: str) -> dict:
        """The sampled environments replayed through every tick."""
        dev, K = self.device, len(self.sample)
        obs = self.pool[:, torch.from_numpy(self.sample)].to(dev)
        if self.sparse:
            step, reset = gcm.sparse_tick, gcm.sparse_reset
            state = gcm.sparse_state(K, self.N, self.obs,
                                     self.config["preset_kwargs"]
                                     ["max_edges"], dev)
        else:
            step, reset = gcm.dense_step, gcm.dense_reset
            state = gcm.dense_state(K, self.N, self.obs, dev)
        dones = torch.from_numpy(np.stack(self.dones)).to(dev)
        beliefs = []
        with torch.no_grad():
            for k in range(len(self.dones)):
                b, state = step(state, obs[k % obs.shape[0]], self.weights,
                                self.hops, self.layers, precision)
                beliefs.append(b)
                state = reset(state, dones[k])
            beliefs = torch.stack(beliefs).cpu().numpy()
        return {"beliefs": beliefs,
                "state": [t.cpu().numpy() for t in state]}
