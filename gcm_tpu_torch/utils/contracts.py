"""Opt-in shape contracts for the public entry points (counterpart of
gcm_tpu/utils/contracts.py, which checks jaxtyping annotations; the
reference pins its shapes with torchtyping and typeguard).

An entry point annotates its tensors with axis names, `x: Float["B F"]`
(`Annotated[torch.Tensor, ...]`: a dtype kind, float, int or bool, and one
name per dimension), and `@checked` enforces them when contracts are on:
the rank, the dtype kind, and the same size for each axis name across the
call's arguments (taus [B] must match x's B). `X | None` accepts None.
Other annotations (states, ints) are not checked.

Contracts are off unless `contracts.TYPECHECK` is set or the process
starts with GCM_TYPECHECK=1; when off, a checked call goes straight to
the function. A violation raises TypeError naming the contract.
"""

from __future__ import annotations

import functools
import inspect
import os
import typing
from typing import Annotated

import torch

TYPECHECK = os.environ.get("GCM_TYPECHECK") == "1"

_KIND_TEST = {
    "float": torch.Tensor.is_floating_point,
    "int": lambda t: not t.is_floating_point() and not t.is_complex()
    and t.dtype != torch.bool,
    "bool": lambda t: t.dtype == torch.bool,
}


class Axes:
    """A tensor annotation's dtype kind and axis names."""

    def __init__(self, kind: str, dims: str):
        self.kind, self.names = kind, tuple(dims.split())

    def __repr__(self):
        return f"{self.kind.capitalize()}[{' '.join(self.names)}]"


class _Kind:
    def __init__(self, kind: str):
        self.kind = kind

    def __getitem__(self, dims: str):
        return Annotated[torch.Tensor, Axes(self.kind, dims)]


Float, Int, Bool = _Kind("float"), _Kind("int"), _Kind("bool")


def _contract(ann):
    """(Axes, whether None is allowed) of an annotation, else (None, _)."""
    members = typing.get_args(ann) if typing.get_origin(ann) in (
        typing.Union, getattr(__import__("types"), "UnionType", ())) \
        else (ann,)
    for m in members:
        for meta in getattr(m, "__metadata__", ()):
            if isinstance(meta, Axes):
                return meta, type(None) in members
    return None, False


@functools.cache
def _contracts_of(fn):
    hints = typing.get_type_hints(fn, include_extras=True)
    out = {}
    for name, ann in hints.items():
        axes, optional = _contract(ann)
        if axes is not None:
            out[name] = (axes, optional)
    return inspect.signature(fn), out


def check_call(fn, args, kwargs) -> None:
    """Raise TypeError where the call's annotated tensors break their
    contracts."""
    sig, contracts = _contracts_of(fn)
    bound = sig.bind(*args, **kwargs)
    sizes: dict[str, tuple[int, str]] = {}
    for name, (axes, optional) in contracts.items():
        if name not in bound.arguments:
            continue
        val = bound.arguments[name]
        if val is None and optional:
            continue
        got = (f"shape={tuple(val.shape)} dtype={val.dtype}"
               if isinstance(val, torch.Tensor) else repr(type(val)))
        ok = (isinstance(val, torch.Tensor) and val.dim() == len(axes.names)
              and _KIND_TEST[axes.kind](val))
        clash = None
        if ok:
            for ax, n in zip(axes.names, val.shape):
                if sizes.setdefault(ax, (n, name))[0] != n:
                    clash = (f"; axis {ax} is {sizes[ax][0]} in "
                             f"'{sizes[ax][1]}'")
                    break
        if not ok or clash:
            raise TypeError(
                f"{fn.__qualname__}: parameter '{name}' violates shape "
                f"contract {axes!r}; got {got}{clash or ''}")


def checked(fn):
    """Enforce fn's axis-named tensor annotations when contracts are on
    (TYPECHECK); otherwise call fn directly."""

    @functools.wraps(fn)
    def wrapper(*args, **kwargs):
        if TYPECHECK:
            check_call(fn, args, kwargs)
        return fn(*args, **kwargs)

    return wrapper
