"""Supervised training steps (counterpart of gcm_tpu/train/train_step.py).

Each factory takes a model and a torch optimizer over its parameters
(`torch.optim.Adam` takes the place of optax.adam) and returns a step that
computes JAX's loss, the mean squared error of the beliefs against the
targets from `model.initial_state`, backpropagates it and applies one
optimizer step. PyTorch's idiom for JAX's (params, opt_state) threading:
the step updates the model's parameters in place and leaves their gradients
in `.grad` until the next step; it returns the loss, detached.

On the card the gradients go through the port's autograd Functions, whose
backwards are CUDA kernels: the dense stack's (csrc/dense_gnn_bwd.cu),
spmm_edge_list on flipped edges and, where edge weights carry a gradient,
the edge weight-gradient (csrc/edge_grad.cu).
"""

from __future__ import annotations

import torch


def _apply(opt, loss_fn):
    opt.zero_grad(set_to_none=True)
    loss = loss_fn()
    loss.backward()
    opt.step()
    return loss.detach()


def make_dense_supervised_step(model, opt):
    """Regression-style step over a scanned trajectory: predict targets
    from beliefs. Returns step(xs [B,T,obs], targets [B,T,H]) -> loss."""

    def step(xs, targets):
        def loss_fn():
            state = model.initial_state(xs.shape[0], xs.shape[-1],
                                        dtype=xs.dtype)
            outs, _ = model.scan(xs, state)
            return torch.mean((outs - targets) ** 2)

        return _apply(opt, loss_fn)

    return step


def make_window_supervised_step(model, opt, **window_kwargs):
    """Step through a core's scan-free whole-trajectory forward
    (`BandedRingGCM` / `BandedScoredGCM` / `CliqueGCM` / `RingDenseGCM`
    `.window`): no per-step loop in the forward or the backward.
    window_kwargs (e.g. impl="proj" for CliqueGCM) go to `window`.
    Returns step(xs [B,T,obs], targets [B,T,H], dones=None) -> loss."""

    def step(xs, targets, dones=None):
        def loss_fn():
            state = model.initial_state(xs.shape[0], xs.shape[-1],
                                        dtype=xs.dtype)
            outs, _ = model.window(xs, state, dones=dones, **window_kwargs)
            return torch.mean((outs - targets) ** 2)

        return _apply(opt, loss_fn)

    return step


def make_trajectory_supervised_step(model, opt, unroll=None, remat=False):
    """Step that picks, once, at construction, the core's scan-free
    `window` where its card-measured training gate says so
    (`window_profitable(mode="train")`) and `window_applicable` holds, and
    else its scan with the caller's unroll / remat. The step's
    `use_window` attribute says which. Returns step(xs [B,T,obs],
    targets [B,T,H]) -> loss."""
    use_window = (callable(getattr(model, "window", None))
                  and getattr(model, "direction", "forward") == "forward")
    if use_window and hasattr(model, "window_profitable"):
        use_window = model.window_profitable(mode="train")
    if use_window and hasattr(model, "window_applicable"):
        use_window = model.window_applicable(dones=None)

    def step(xs, targets):
        def loss_fn():
            state = model.initial_state(xs.shape[0], xs.shape[-1],
                                        dtype=xs.dtype)
            if use_window:
                outs, _ = model.window(xs, state)
            else:
                outs, _ = model.scan(xs, state, unroll=unroll, remat=remat)
            return torch.mean((outs - targets) ** 2)

        return _apply(opt, loss_fn)

    step.use_window = use_window
    return step


def make_sparse_supervised_step(model, opt):
    """Whole-rollout step through SparseGCM (time-batched training).
    Returns step(xs [B,T,obs], targets [B,T,H], taus [B]) -> loss."""

    def step(xs, targets, taus):
        def loss_fn():
            state = model.initial_state(xs.shape[0], xs.shape[-1],
                                        dtype=xs.dtype)
            outs, _ = model(xs, taus, state)
            return torch.mean((outs - targets) ** 2)

        return _apply(opt, loss_fn)

    return step
