"""A training loop that checkpoints and resumes (counterpart of
gcm_tpu/train/resilient.py).

`train_resilient` runs a trainer of the port's A2C / PPO protocol (a
`policy` module, an optimizer `opt`, and `update(generator, B)` that
changes both in place) for a number of updates, checkpointing every
`checkpoint_every` through train/checkpoint.py: the policy's and the
optimizer's state_dicts, the update counter and the generator's state.
On a (re)start it restores the latest checkpoint in its directory and
continues from the recorded counter, so a crash costs at most
`checkpoint_every` updates, and a resumed run gives bitwise the
parameters of an uninterrupted one.
"""

from __future__ import annotations

import torch

from gcm_tpu_torch.device import resolve_device
from gcm_tpu_torch.train.checkpoint import make_manager, restore, save


def train_resilient(trainer, directory: str, updates: int, B: int = 16,
                    generator: torch.Generator | None = None,
                    checkpoint_every: int = 50, on_update=None):
    """Run `updates` updates in all, checkpointing every
    `checkpoint_every` and after the last; resume from the latest
    checkpoint in `directory` if there is one. `generator` draws every
    rollout (by default a generator seeded 0 on the CUDA card, which
    raises where there is none); its state is checkpointed and restored
    with the rest. Returns (the policy's parameters as {name: tensor},
    history), history the return metric (else the loss) of each update run
    since the (re)start; `on_update(step, metrics)` is called after each."""
    if generator is None:
        generator = torch.Generator(resolve_device(None)).manual_seed(0)
    policy, opt = trainer.policy, trainer.opt
    mgr = make_manager(directory)
    start = 0
    if mgr.latest_step() is not None:
        tree = restore(mgr)
        policy.load_state_dict(tree["policy"])
        opt.load_state_dict(tree["opt"])
        generator.set_state(tree["generator"])
        start = int(tree["step"])
    history = []
    for step in range(start, updates):
        metrics = trainer.update(generator, B)
        history.append(float(metrics.get("return", metrics["loss"])))
        if on_update is not None:
            on_update(step, metrics)
        if (step + 1) % checkpoint_every == 0 or step + 1 == updates:
            save(mgr, step + 1, {"policy": policy.state_dict(),
                                 "opt": opt.state_dict(), "step": step + 1,
                                 "generator": generator.get_state()})
    return {n: p.detach() for n, p in policy.named_parameters()}, history
