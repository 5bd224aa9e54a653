"""Sharding rules for the port's modules and states (counterpart of
gcm_tpu/parallel/sharding.py), and the dp x tp wrapper that trains under
them.

Parameters (tp): the JAX rule, walked over the JAX parameter tree
(`weights.jax_param_tree`, dict keys sorted as JAX flattens them): the
Linear kernels alternate column-parallel (the output dimension split) and
row-parallel (the input dimension split), depth-first; biases and every
other parameter are replicated. The port's Linear stores its kernel
[in, out] as JAX does, so the split dimension is JAX's: column-parallel
splits dim 1, row-parallel dim 0. A kernel whose dimension does not divide
by tp stays whole (GSPMD would pad it).

States (dp): every leaf is batch-leading and split over dp, except scalars
and size-0 placeholders.

`TensorParallel(model, mesh)` holds this rank's shard of each tp-split
kernel as its own parameter (so an optimizer over its parameters keeps
Adam's moments in the same shard) and the replicated rest as they are.
Each call gathers the shards into whole kernels (`comm.all_gather`, whose
backward keeps this rank's block of the gradient: the tp ranks of one dp
group run the same batch, so a reduce-scatter would count it tp times)
and runs the model with them, as GSPMD must gather around a pallas_call it
cannot split: the fused dense kernels take whole weights. The call also
copies the whole kernels' values into the model's own Parameters (no
gradient), so that a recompute in the backward that reads the model's
attributes after the call (a checkpointed step under remat) computes
with the forward's weights; the gradient still reaches the shards through
the forward's graph. After the backward, `sync_grads` averages every
gradient over dp, as GSPMD's all-reduce of the batch-split mean does; the
train steps call it. A batch-wide mean inside the model (EuclideanEdge's)
runs over the whole dp batch: the wrapper binds the model's selectors to
the dp group (mesh.py::bind_batch).
"""

from __future__ import annotations

import functools

import torch
from torch import nn

from gcm_tpu_torch.parallel import comm
from gcm_tpu_torch.parallel.mesh import (axis_group, axis_rank, axis_size,
                                         bind_batch)
from gcm_tpu_torch.utils.functional import call_with


def _walk(tree, path=()):
    """(path, leaf) of a jax_param_tree in JAX's flattening order."""
    if isinstance(tree, dict):
        for k in sorted(tree):
            yield from _walk(tree[k], path + (k,))
    elif isinstance(tree, list):
        for i, sub in enumerate(tree):
            yield from _walk(sub, path + (i,))
    else:
        yield path, tree


def param_specs(module, tp: int | None = None) -> dict:
    """{parameter name: the dimension split over tp, or None}. With tp
    given, a dimension that does not divide by it is not split."""
    from gcm_tpu_torch.weights import jax_param_tree

    names = {id(p): n for n, p in module.named_parameters()}
    specs = dict.fromkeys(names.values())
    alt = 0
    for path, leaf in _walk(jax_param_tree(module)):
        if path and path[-1] == "kernel":
            dim = None
            if leaf.dim() == 2:
                dim = 1 if alt % 2 == 0 else 0
            elif leaf.dim() == 1 and alt % 2 == 0:
                dim = 0
            alt += 1
            if dim is not None and tp is not None and leaf.shape[dim] % tp:
                dim = None
            specs[names[id(leaf)]] = dim
    return specs


def state_specs(state) -> tuple:
    """Per leaf of a state NamedTuple: 0 (the batch dim, split over dp)
    or None (scalars, size-0 placeholders)."""
    return tuple(None if (t.dim() == 0 or t.shape[0] == 0) else 0
                 for t in state)


def shard_pytree(mesh, tree, specs, axis: str = "dp"):
    """This rank's block of each leaf of a state NamedTuple along its
    spec's dimension over `axis` (None: the leaf whole)."""
    d, r = axis_size(mesh, axis), axis_rank(mesh, axis)
    out = []
    for t, dim in zip(tree, specs):
        if dim is not None:
            nb = t.shape[dim] // d
            t = t.narrow(dim, r * nb, nb)
        out.append(t)
    return type(tree)(*out)


class TensorParallel(nn.Module):
    """model under a (dp, tp) mesh: see the module docstring. Its
    `scan`, `window` (None where the model has none) and `__call__` run
    the model's with whole weights; `initial_state` and the window gates
    are the model's. The caller hands each rank its dp block of the batch
    (`mesh.shard_tensor` with `batch_sharding`)."""

    def __init__(self, model, mesh, dp_axis: str = "dp", tp_axis: str = "tp"):
        super().__init__()
        self.model = model
        self.dp_group = axis_group(mesh, dp_axis)
        self.tp_group = axis_group(mesh, tp_axis)
        tp, r = axis_size(mesh, tp_axis), axis_rank(mesh, tp_axis)
        self.dp = axis_size(mesh, dp_axis)
        self.specs = param_specs(model, tp) if tp > 1 else \
            dict.fromkeys(n for n, _ in model.named_parameters())
        self.shards = nn.ParameterDict()
        for name, p in model.named_parameters():
            dim = self.specs[name]
            if dim is not None:
                nb = p.shape[dim] // tp
                p = nn.Parameter(p.detach().narrow(dim, r * nb, nb).clone())
            self.shards[name.replace(".", "/")] = p
        bind_batch(model, self.dp_group)

    def whole_params(self) -> dict:
        """{model parameter name: the whole tensor}, gathered over tp."""
        out = {}
        for name, dim in self.specs.items():
            p = self.shards[name.replace(".", "/")]
            out[name] = p if dim is None else comm.all_gather(
                p, self.tp_group, dim, grad="slice")
        return out

    def _run(self, method, *args, **kw):
        whole = self.whole_params()
        own = dict(self.model.named_parameters())
        with torch.no_grad():
            for name, dim in self.specs.items():
                if dim is not None:
                    own[name].copy_(whole[name])
        return call_with(self.model, whole, method, *args, **kw)

    def forward(self, *args, **kw):
        return self._run("forward", *args, **kw)

    def scan(self, *args, **kw):
        return self._run("scan", *args, **kw)

    @property
    def window(self):
        if getattr(self.model, "window", None) is None:
            return None
        return functools.partial(self._run, "window")

    @property
    def direction(self):
        return getattr(self.model, "direction", "forward")

    def window_profitable(self, *args, **kw) -> bool:
        gate = getattr(self.model, "window_profitable", None)
        return True if gate is None else gate(*args, **kw)

    def window_applicable(self, *args, **kw) -> bool:
        gate = getattr(self.model, "window_applicable", None)
        return True if gate is None else gate(*args, **kw)

    def initial_state(self, *args, **kw):
        return self.model.initial_state(*args, **kw)

    def sync_grads(self) -> None:
        """Average every parameter's gradient over dp (one all-reduce)."""
        if self.dp > 1:
            comm.all_reduce_many([p.grad for p in self.shards.values()],
                                 self.dp_group, mean=True)

    def reduce_loss(self, loss: torch.Tensor) -> torch.Tensor:
        """The global batch's mean loss from this rank's block mean."""
        if self.dp == 1:
            return loss
        return comm.all_reduce_(loss.detach().clone(), self.dp_group) / self.dp

    @torch.no_grad()
    def gathered_state_dict(self) -> dict:
        """{model parameter name: the whole tensor} (no gradient)."""
        return {n: t.detach() for n, t in self.whole_params().items()}
