"""Runtime guards and observability helpers (counterpart of
gcm_tpu/utils/debug.py): the reference's NaN guard and causality assert,
per-parameter gradient norms, and a profiler trace.

`nan_guard` and `assert_causal_edges` read values, so on the card they
wait for the device: they are opt-in, for debugging, and no path of the
port calls them.
"""

from __future__ import annotations

import contextlib
import os

import torch

NAN_MESSAGE = "Got NaN in returned memory, try using tanh activation"


def _float_leaves(tree):
    if isinstance(tree, torch.Tensor):
        if tree.is_floating_point():
            yield tree
    elif isinstance(tree, dict):
        for v in tree.values():
            yield from _float_leaves(v)
    elif isinstance(tree, (list, tuple)):
        for v in tree:
            yield from _float_leaves(v)


def nan_guard(fn):
    """Wrap `fn` so that a NaN or an infinity in any floating-point tensor
    of its output (tensors, tuples, lists, dicts, NamedTuple states)
    raises FloatingPointError with the reference's message (its isfinite
    assert on the belief). Synchronises with the device on every call."""

    def guarded(*args, **kwargs):
        out = fn(*args, **kwargs)
        for leaf in _float_leaves(out):
            if not bool(torch.isfinite(leaf).all()):
                raise FloatingPointError(NAN_MESSAGE)
        return out

    return guarded


def assert_causal_edges(edges: torch.Tensor) -> torch.Tensor:
    """edges [B, 2, E] (row 0 sink, row 1 source, -1 unused) -> a bool
    scalar tensor, True iff every valid edge has source < sink (the
    reference's "Causality violated" assert). No host wait."""
    valid = (edges[:, 0, :] >= 0) & (edges[:, 1, :] >= 0)
    return torch.where(valid, edges[:, 1, :] < edges[:, 0, :], True).all()


def grad_norms(module, prefix: str = "grad_norm") -> dict:
    """Per-parameter L2 norms of the gradients in `.grad`, as a flat
    {f"{prefix}/{path}": scalar tensor} keyed by each parameter's path in
    the JAX parameter tree (e.g. "grad_norm/core/gnn/0/lin_rel/kernel"),
    so that a logger sees the JAX package's names. A parameter with no
    gradient counts 0. The norms stay on the device."""
    # imported here: weights.py knows every module's layout, the RL
    # trainers (which import this) included
    from gcm_tpu_torch.weights import jax_paths

    named = dict(module.named_parameters())
    out = {}
    for name, path in jax_paths(module).items():
        g = named[name].grad
        out[f"{prefix}/{path}"] = (torch.zeros((), device=named[name].device)
                                   if g is None
                                   else torch.sqrt(torch.sum(torch.square(g))))
    return out


@contextlib.contextmanager
def trace(log_dir: str):
    """A torch.profiler window (the host, and the card where there is
    one) whose Chrome trace is written to `log_dir`/trace.json on exit;
    yields the profiler, whose key_averages() the caller may read."""
    activities = [torch.profiler.ProfilerActivity.CPU]
    if torch.cuda.is_available():
        activities.append(torch.profiler.ProfilerActivity.CUDA)
    os.makedirs(log_dir, exist_ok=True)
    with torch.profiler.profile(activities=activities) as prof:
        yield prof
    prof.export_chrome_trace(os.path.join(log_dir, "trace.json"))
