"""Checkpoint and resume of (parameters, optimizer state, memory state)
trees (counterpart of gcm_tpu/train/checkpoint.py), on torch.save /
torch.load.

A tree is nested dicts, lists and tuples of tensors and plain values
(ints, floats, bools, strings, None), such as a module's and an
optimizer's `state_dict()`. A NamedTuple state is written as its dict
(`_asdict()`), so that the file loads under `torch.load(weights_only=
True)`, which never unpickles an object; `restore` with a template gives
the NamedTuples back. Each step is one file, `step_<n>.pt`, written to a
temporary name and moved into place with `os.replace`, so a crash leaves
either the whole step or none of it. Zero-size tensors (the memory
states' unused weights placeholder) save and load as they are.
"""

from __future__ import annotations

import os
import re
from dataclasses import dataclass

import torch

_STEP_FILE = re.compile(r"^step_(\d+)\.pt$")


@dataclass
class CheckpointManager:
    """The steps saved under `directory`, at most `max_to_keep` of them
    (the oldest removed first)."""

    directory: str
    max_to_keep: int = 3

    def path(self, step: int) -> str:
        return os.path.join(self.directory, f"step_{step}.pt")

    def all_steps(self) -> list[int]:
        if not os.path.isdir(self.directory):
            return []
        return sorted(int(m.group(1)) for m in map(
            _STEP_FILE.match, os.listdir(self.directory)) if m)

    def latest_step(self) -> int | None:
        steps = self.all_steps()
        return steps[-1] if steps else None


def make_manager(directory: str, max_to_keep: int = 3) -> CheckpointManager:
    return CheckpointManager(os.path.abspath(directory), max_to_keep)


def _plain(tree):
    """NamedTuples as dicts, recursively; tensors and plain values as
    they are."""
    if isinstance(tree, tuple) and hasattr(tree, "_asdict"):
        return {k: _plain(v) for k, v in tree._asdict().items()}
    if isinstance(tree, dict):
        return {k: _plain(v) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return type(tree)(_plain(v) for v in tree)
    return tree


def _like(template, got):
    """`got` (loaded on the CPU) in the structure of `template`: its
    NamedTuples rebuilt, each tensor on its template leaf's device."""
    if isinstance(template, tuple) and hasattr(template, "_asdict"):
        return type(template)(**{k: _like(v, got[k]) for k, v in
                                 template._asdict().items()})
    if isinstance(template, dict):
        return {k: _like(v, got[k]) for k, v in template.items()}
    if isinstance(template, (list, tuple)):
        if len(template) != len(got):
            raise ValueError(f"the checkpoint holds {len(got)} entries "
                             f"where the template has {len(template)}")
        return type(template)(_like(t, g) for t, g in zip(template, got))
    if isinstance(template, torch.Tensor):
        if tuple(got.shape) != tuple(template.shape):
            raise ValueError(f"checkpoint tensor of shape "
                             f"{tuple(got.shape)} where the template has "
                             f"{tuple(template.shape)}")
        return got.to(device=template.device, dtype=template.dtype)
    return got


def save(manager: CheckpointManager, step: int, tree) -> None:
    """Write `tree` as step `step`, atomically, then drop the oldest steps
    beyond max_to_keep."""
    os.makedirs(manager.directory, exist_ok=True)
    final = manager.path(step)
    tmp = f"{final}.tmp-{os.getpid()}"
    try:
        torch.save(_plain(tree), tmp)
        os.replace(tmp, final)
    finally:
        if os.path.exists(tmp):
            os.remove(tmp)
    for old in manager.all_steps()[:-manager.max_to_keep or None]:
        os.remove(manager.path(old))


def restore(manager: CheckpointManager, step: int | None = None,
            template=None):
    """The tree saved as `step` (the latest when None), loaded with
    weights_only=True. Without a template: dicts, lists and tensors on the
    CPU. With one: the template's structure, NamedTuples included, each
    tensor on its template leaf's device and in its dtype."""
    if step is None:
        step = manager.latest_step()
        if step is None:
            raise FileNotFoundError(f"no checkpoint in {manager.directory}")
    got = torch.load(manager.path(step), map_location="cpu",
                     weights_only=True)
    return got if template is None else _like(template, got)
