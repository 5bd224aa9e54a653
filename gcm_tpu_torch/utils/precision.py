"""Mixed-precision helpers (counterpart of gcm_tpu/utils/precision.py).

`cast_tree` casts the floating-point tensors of a tree (parameters,
states) to another dtype and leaves int and bool tensors (node counters,
edge indices, masks) as they are. Whether a narrower dtype speeds up a
core of the port on the card has not been measured; the JAX package's
guidance was measured on a TPU and does not carry over. Keep optimizer
state and loss accumulation in float32 either way: the cast is for
inference copies.
"""

from __future__ import annotations

import torch


def cast_tree(tree, dtype=torch.bfloat16):
    """The tree (tensors in dicts, lists, tuples and NamedTuples) with
    every floating-point tensor cast to `dtype`."""
    if isinstance(tree, torch.Tensor):
        return tree.to(dtype) if tree.is_floating_point() else tree
    if isinstance(tree, tuple) and hasattr(tree, "_fields"):
        return type(tree)(*(cast_tree(v, dtype) for v in tree))
    if isinstance(tree, dict):
        return {k: cast_tree(v, dtype) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return type(tree)(cast_tree(v, dtype) for v in tree)
    return tree


def _named_leaves(tree, path=""):
    """(name, tensor) of a module's parameters or of a tree's tensors, a
    tree's names as JAX's keystr writes them (['gnn'][0]...)."""
    if isinstance(tree, torch.nn.Module):
        yield from tree.named_parameters()
    elif isinstance(tree, torch.Tensor):
        yield path, tree
    elif isinstance(tree, dict):
        for k, v in tree.items():
            yield from _named_leaves(v, f"{path}[{k!r}]")
    elif isinstance(tree, (list, tuple)):
        for i, v in enumerate(tree):
            yield from _named_leaves(v, f"{path}[{i}]")


def param_count(params) -> int:
    """The number of scalars in a module's parameters or a tree's
    tensors."""
    return sum(t.numel() for _, t in _named_leaves(params))


def summarize(params, prefix: str = "") -> str:
    """A table of each parameter's (or leaf's) name, shape, dtype and
    size, then the total."""
    lines = [f"{prefix + name:<60} {str(tuple(t.shape)):<16} "
             f"{str(t.dtype).replace('torch.', ''):<10} {t.numel():>10,}"
             for name, t in _named_leaves(params)]
    lines.append(f"{'TOTAL':<60} {'':<16} {'':<10} "
                 f"{param_count(params):>10,}")
    return "\n".join(lines)
