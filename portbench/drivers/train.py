"""Supervised training through the program's train steps
(`gcm_tpu_torch.train`): `make_dense_supervised_step` over a trajectory
xs [B,T,obs] for a dense core, `make_sparse_supervised_step` over one
window with valid lengths taus [B] for a sparse core; Adam; MSE against
targets [B,T,hidden]. Every step starts from a fresh memory. A unit is one
step, on the next batch of a pool made on the device from the seed.

Set-up builds the one step object the window uses and drives it through
its first `check.steps` steps on different batches; their readings (the
losses, the first gradient as Adam holds it, the parameters' change) are
what the reference, run after the window, is compared with.
"""

from __future__ import annotations

import torch

from portbench import compare, program, traffic, yardstick
from portbench.drivers import base
from portbench.reference import adam, gcm


def _norm(t) -> torch.Tensor:
    return torch.linalg.vector_norm(t.detach().double())


class Driver(base.Driver):
    def setup(self):
        from gcm_tpu_torch.train.train_step import (
            make_dense_supervised_step, make_sparse_supervised_step)

        tr, dev = self.traffic, self.device
        self.build()
        self.opt = torch.optim.Adam(self.model.parameters(), lr=tr["lr"])
        make = (make_sparse_supervised_step if self.sparse
                else make_dense_supervised_step)
        self.step = make(self.model, self.opt)
        self.xs, self.targets, self.taus = traffic.train_pool(
            tr, self.obs, self.H, self.ctx.seeds["inputs"], dev)
        self.work = [self._work(i) for i in range(tr["pool"])]
        self.mark("inputs")
        self.n = 0
        self.losses = []

        checked = self.ctx.workload["check"]["steps"]
        names = program.roles(self.config)
        params = dict(self.model.named_parameters())
        beta1 = self.opt.param_groups[0]["betas"][0]
        grad = None
        for k in range(checked):
            self.unit()
            self.mark(f"step {k + 1}")
            if k == 0:  # the first gradient, from Adam's first moment
                grad = {names[n]: _norm(self.opt.state[p].get(
                    "exp_avg", torch.zeros_like(p)) / (1 - beta1))
                    for n, p in params.items()}
        change = {names[n]: _norm(p - self.weights[names[n]])
                  for n, p in params.items()}
        self.readings = {
            "loss": [float(v) for v in self.losses[:checked]],
            "grad": {k: float(v) for k, v in grad.items()},
            "change": {k: float(v) for k, v in change.items()}}
        self.checked = checked

    def _work(self, i: int) -> dict:
        """Timesteps, model operations and kernel work of a step on pool
        batch i (yardstick.py)."""
        B, T, N, H = self.traffic["batch"], self.traffic["steps"], self.N, \
            self.H
        widths = self.widths
        pre = yardstick.linear_ops(B * N, self.obs, H)
        if not self.sparse:
            gnn = yardstick.dense_gnn_ops(B, N, widths)
            return {"timesteps": B * T, "model_ops": 3 * T * (pre + gnn),
                    "kernels": [
                        ("fused_dense_gnn", gnn,
                         yardstick.dense_gnn_bytes(B, N, widths), T),
                        ("fused_dense_gnn_bwd", 2 * gnn,
                         yardstick.dense_gnn_bwd_bytes(B, N, widths), T)]}
        n = torch.clamp(self.taus[i], max=N).tolist()
        edges = sum(yardstick.temporal_edges(v, self.hops) for v in n)
        rows = sum(yardstick.temporal_sources(v, self.hops) for v in n)
        gnn = yardstick.sparse_gnn_ops(B, N, edges, widths)
        # each layer's aggregation forward, and its transpose for dx
        return {"timesteps": int(self.taus[i].sum()),
                "model_ops": 3 * (pre + gnn),
                "kernels": [("spmm_edge_list", 2 * edges * H,
                             yardstick.spmm_bytes(B, N, H, edges, rows),
                             2 * self.layers)]}

    def unit(self):
        i = self.n % self.traffic["pool"]
        args = (self.xs[i], self.targets[i])
        if self.sparse:
            args += (self.taus[i],)
        with self.span("train_step"):
            loss = self.step(*args)
        self.losses.append(loss)
        self.n += 1
        w = self.work[i]
        self.count["units"] += 1
        self.count["timesteps"] += w["timesteps"]
        self.count["model_ops"] += w["model_ops"]
        for kernel, ops, nbytes, calls in w["kernels"]:
            self.add_work(kernel, ops, nbytes, calls)
        return loss

    def failed(self) -> int:
        """Steps of the window whose loss is not finite."""
        window = self.losses[self.checked:]
        if not window:
            return 0
        return int((~torch.isfinite(torch.stack(window))).sum())

    def check(self, extra=()) -> dict:
        del self.model, self.opt, self.step
        self.losses = self.losses[:self.checked]
        self.free()
        want = self.reference("fp32")
        out = {"program": compare.train_numbers(self.readings, want)}
        if "control" in extra:
            out["control"] = compare.train_numbers(self.reference("tf32"),
                                                   want)
        if "half_batch" in extra:
            half = self.traffic["batch"] // 2
            out["half_batch"] = compare.train_numbers(
                self.reference("fp32", rows=half), want)
        return out

    def reference(self, precision: str, rows: int | None = None) -> dict:
        """The reference's readings over the checked steps' batches, in
        blocks of rows; `rows` < batch leaves the rest of the batch out and
        takes the mean over the rows kept (a planted fault)."""
        tr = self.traffic
        rows = rows or tr["batch"]
        block = self.ctx.workload["check"]["row_block"]
        scale = rows * tr["steps"] * self.H
        opt = adam.Adam({k: v.clone() for k, v in self.weights.items()},
                        lr=tr["lr"])
        losses, first = [], None
        for k in range(self.checked):
            grads = {r: torch.zeros_like(v) for r, v in opt.params.items()}
            total = torch.zeros((), dtype=torch.float64, device=self.device)
            for r0 in range(0, rows, block):
                r1 = min(r0 + block, rows)
                p = {r: v.detach().requires_grad_()
                     for r, v in opt.params.items()}
                with torch.enable_grad():
                    out = self._trajectory(k, r0, r1, p, precision)
                    loss = ((out - self.targets[k, r0:r1]) ** 2).sum() / scale
                    g = torch.autograd.grad(loss, list(p.values()))
                for r, gi in zip(p, g):
                    grads[r] += gi
                total += loss.detach().double()
            if k == 0:
                first = {r: float(_norm(g)) for r, g in grads.items()}
            opt.step(grads)
            losses.append(float(total))
        change = {r: float(_norm(opt.params[r] - self.weights[r]))
                  for r in opt.params}
        return {"loss": losses, "grad": first, "change": change}

    def _trajectory(self, k, r0, r1, p, precision):
        xs = self.xs[k, r0:r1]
        if self.sparse:
            return gcm.sparse_window(xs, self.taus[k, r0:r1], p, self.N,
                                     self.hops, self.layers, precision)
        return gcm.dense_trajectory(xs, p, self.N, self.hops, self.layers,
                                    precision)
