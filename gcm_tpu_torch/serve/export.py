"""Serving export: one step of a memory core as bytes (counterpart of
gcm_tpu/serve/export.py, with torch.export in place of jax.export).

`export_step(model, example_obs, example_state)` traces
`model(obs, state) -> (belief, state)` with torch.export, the parameters
held in the program, and serialises it; `load_step(blob)` gives it back as
a callable `step(obs, state) -> (belief, state)` that needs no model-
building code, only `import gcm_tpu_torch`, which registers the kernels'
torch.library ops. The state crosses as its tensors in field order (a
NamedTuple is rebuilt from the state handed to the loaded step), so its
int counters (`num_nodes`, `t`) stay inputs of the program: nothing is
specialised on their values, only on the shapes of the example.

The served step's kernels are torch.library ops (`gcm::fused_dense_gnn`,
`gcm::fused_dense_graph_conv`, `gcm::sddmm_threshold_row` and
`gcm::sddmm_threshold_row_current`), each with a fake for tracing, so the
exported program launches the same kernels as the eager step, on the
device it was exported on. A step that reaches any other kernel (the
sparse core's SpMMs) raises while it is exported, naming the kernel.
"""

from __future__ import annotations

import io

import torch
from torch import nn


class _Step(nn.Module):
    """model(obs, state) with the state flattened to its fields, the form
    torch.export saves without registering the state's type."""

    def __init__(self, model, state_type):
        super().__init__()
        self.model = model
        self.state_type = state_type

    def forward(self, obs, *fields):
        belief, state = self.model(obs, self.state_type(*fields))
        return (belief, *state)


def export_step(model, example_obs, example_state):
    """Trace and serialise one step of `model` at the example's shapes.
    Returns (blob, exported): the bytes and the in-process
    torch.export.ExportedProgram (without its example inputs, which the
    blob leaves out)."""
    with torch.no_grad():
        exported = torch.export.export(
            _Step(model, type(example_state)),
            (example_obs, *example_state))
    # the example state would travel in the blob (16.8 MB of adjacency at
    # capacity 256, N = 128); the program needs only its shapes
    exported.example_inputs = None
    buf = io.BytesIO()
    torch.export.save(exported, buf)
    return buf.getvalue(), exported


def load_step(blob: bytes):
    """The callable step(obs, state) -> (belief, state) of an exported
    blob, run without gradients."""
    program = torch.export.load(io.BytesIO(blob)).module()

    def step(obs, state):
        with torch.no_grad():
            belief, *fields = program(obs, *state)
        return belief, type(state)(*fields)

    return step
