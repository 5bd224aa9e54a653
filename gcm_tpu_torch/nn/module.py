"""Linear and MLP (counterpart of gcm_tpu/nn/module.py).

`Linear` keeps the JAX package's layout, y = x @ kernel + bias with `kernel`
stored [in, out], so JAX parameters load without a transpose and the graph
conv kernels take the weights as they are stored. Its initialisation is
torch.nn.Linear's (kaiming-uniform with a = sqrt(5) for the kernel, uniform
in +-1/sqrt(in) for the bias), drawn on the CPU from the given
torch.Generator so that the same seed gives the same weights on every
device.
"""

from __future__ import annotations

import math

import torch
from torch import nn

from gcm_tpu_torch.device import resolve_device


def _uniform(shape, bound, generator) -> torch.Tensor:
    return torch.empty(shape).uniform_(-bound, bound, generator=generator)


class Linear(nn.Module):
    def __init__(self, in_dim: int, out_dim: int, use_bias: bool = True, *,
                 device=None, generator: torch.Generator | None = None):
        super().__init__()
        device = resolve_device(device)
        self.in_dim = in_dim
        self.out_dim = out_dim
        # kaiming_uniform(a=sqrt(5)): gain * sqrt(3 / fan_in) = 1/sqrt(fan_in)
        bound = 1.0 / math.sqrt(in_dim) if in_dim > 0 else 0.0
        self.kernel = nn.Parameter(
            _uniform((in_dim, out_dim), bound, generator).to(device))
        self.bias = (nn.Parameter(_uniform((out_dim,), bound, generator)
                                  .to(device)) if use_bias else None)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        y = x @ self.kernel
        return y if self.bias is None else y + self.bias


class MLP(nn.Module):
    """Sequential of modules and plain activation callables (torch.tanh,
    torch.relu, ...), each applied to the running value in order."""

    def __init__(self, layers):
        super().__init__()
        self.layers = list(layers)
        self.blocks = nn.ModuleList(
            [m for m in self.layers if isinstance(m, nn.Module)])

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        for layer in self.layers:
            x = layer(x)
        return x
