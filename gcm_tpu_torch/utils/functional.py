"""A module's call with its parameters swapped for other tensors
(torch.func.functional_call), for a method or for any callable that uses
the module.

The data-parallel and tensor-parallel wrappers run a model with tensors
that are not its own Parameters (tp's gathered whole kernels, the sharded
core's entered parameters), and the reversible scans replay a step in the
backward with the parameters the forward saw.
"""

from __future__ import annotations

from torch import nn
from torch.func import functional_call


class _Method(nn.Module):
    def __init__(self, model, method):
        super().__init__()
        self.model = model
        self.method = method

    def forward(self, *args, **kw):
        fn = (getattr(self.model, self.method)
              if isinstance(self.method, str) else self.method)
        return fn(*args, **kw)


def call_with(model, params: dict, method, *args, **kw):
    """model.<method>(*args, **kw), or method(*args, **kw) for a callable
    that uses model, with model's parameters replaced by params {name:
    tensor} for the call."""
    return functional_call(_Method(model, method),
                           {"model." + n: t for n, t in params.items()},
                           args, kw)
