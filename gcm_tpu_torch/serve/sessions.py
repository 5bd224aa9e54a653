"""Batched streaming inference with per-session recurrent graph memory
(counterpart of gcm_tpu/serve/sessions.py).

`SessionServer` keeps a fixed `capacity`-row state pool on the device:

- requests are (session_id, obs) pairs; an unknown id gets a free row with
  freshly zeroed memory (evicting the least recently used idle session when
  the pool is full),
- one masked step advances exactly the rows with a request this tick; the
  other rows' state is kept as it was,
- `end_session` frees a row at once.

The pool never changes shape, so every tick costs the same whatever the
number of live sessions.

With `mesh=` the pool's rows are split over the mesh axis `axis` (one
rank a block of capacity / d rows), so the live sessions' memory grows
with the number of cards: every rank runs the same bookkeeping on the
same requests, steps its own rows and one all_gather of the stepped rows
gives every rank the same reply. Sessions interact only through a
batch-wide mean (EuclideanEdge's, over the whole pool), which gathers the
pool's current nodes: the server binds the model's (or the policy's)
selectors to the mesh axis when it is built (parallel/mesh.py::
bind_batch); otherwise the step needs no collective. `snapshot`
gathers the whole pool, and `restore` takes this rank's rows of one, so
snapshots cross between mesh and unsharded servers.
"""

from __future__ import annotations

import itertools

import numpy as np
import torch

from gcm_tpu_torch.core.graph_state import reset_where
from gcm_tpu_torch.device import resolve_device
from gcm_tpu_torch.parallel.comm import all_gather_data
from gcm_tpu_torch.parallel.mesh import (axis_group, axis_rank, axis_size,
                                         bind_batch)


def _tree_map(fn, tree):
    """Apply fn to every tensor leaf of a tensor, tuple (incl. NamedTuple),
    list or dict."""
    if isinstance(tree, torch.Tensor):
        return fn(tree)
    if isinstance(tree, dict):
        return {k: _tree_map(fn, v) for k, v in tree.items()}
    if isinstance(tree, tuple) and hasattr(tree, "_fields"):
        return type(tree)(*(_tree_map(fn, v) for v in tree))
    if isinstance(tree, (tuple, list)):
        return type(tree)(_tree_map(fn, v) for v in tree)
    return fn(tree)


class SessionServer:
    def __init__(self, model, capacity: int, obs_dim: int,
                 dtype=torch.float32, step_fn=None, initial_state=None,
                 mesh=None, axis: str = "dp", *, device=None):
        """`model(obs, state) -> (belief, state)` backs the server;
        alternatively pass step_fn(obs, state) -> (belief, state) with a
        matching capacity-sized `initial_state` and model=None (see
        `from_step`). Runs on `device` (default: the CUDA card). mesh: a
        DeviceMesh whose axis `axis` splits the pool's rows (its size must
        divide capacity; see the module docstring); a step_fn's model is
        bound to the axis by its builder (`from_policy` does it)."""
        self.device = resolve_device(device)
        self.model = model
        self.capacity = capacity
        self.obs_dim = obs_dim
        self._group = None
        self._rows = slice(0, capacity)
        if mesh is not None:
            d = axis_size(mesh, axis)
            if capacity % d:
                raise ValueError(f"mesh axis '{axis}' of size {d} must "
                                 f"divide capacity {capacity}")
            r, nb = axis_rank(mesh, axis), capacity // d
            self._group = axis_group(mesh, axis)
            self._rows = slice(r * nb, (r + 1) * nb)
            if model is not None:
                bind_batch(model, self._group)
        self._pool = self._rows.stop - self._rows.start
        if initial_state is not None:
            self.state = _tree_map(lambda t: self._own_rows(t).to(
                self.device), initial_state)
        else:
            self.state = model.initial_state(self._pool, obs_dim, dtype=dtype)
        self._model_step = step_fn if step_fn is not None else model
        self._row_of: dict = {}          # session_id -> row
        self._free = list(range(capacity - 1, -1, -1))  # pop() -> row 0 first
        self._clock = itertools.count()
        self._last_used: dict = {}       # session_id -> clock tick
        self._counters = {"ticks": 0, "requests": 0, "allocations": 0,
                          "evictions": 0}

    @classmethod
    def from_policy(cls, policy, capacity: int, mesh=None, axis: str = "dp",
                    *, device=None):
        """Serve a whole actor-critic policy (rl/wrappers.py): each tick
        returns {"logits": [A], "value": scalar} per session. The policy
        must not use the previous action (requests carry none). Runs on
        `device`, by default the policy's."""
        if policy.cfg.get("use_prev_action", False):
            raise ValueError(
                "serving tracks no per-session action history; build the "
                "policy with use_prev_action=False")
        if mesh is not None:
            bind_batch(policy, axis_group(mesh, axis))

        def step_fn(obs, state):
            logits, value, state = policy.step(obs, state)
            return {"logits": logits, "value": value}, state

        return cls(None, capacity, policy.obs_dim, step_fn=step_fn,
                   initial_state=policy.initial_state(capacity), mesh=mesh,
                   axis=axis,
                   device=policy.device if device is None else device)

    @classmethod
    def from_step(cls, step_fn, initial_state, obs_dim: int, *, device=None):
        """A server around a bare step callable and the matching
        capacity-sized initial state; no model object needed."""
        capacity = initial_state[0].shape[0]
        return cls(None, capacity, obs_dim, step_fn=step_fn,
                   initial_state=initial_state, device=device)

    def _own_rows(self, t):
        """This rank's rows of a capacity-leading tensor (all of them
        without a mesh); other tensors whole."""
        if t.dim() == 0 or t.shape[0] != self.capacity:
            return t
        return t[self._rows]

    def _all_rows(self, t):
        """The whole pool's rows from every rank's (a mesh server)."""
        if self._group is None or t.dim() == 0 or t.shape[0] != self._pool:
            return t
        return all_gather_data(t, self._group, 0)

    @torch.no_grad()
    def _step(self, obs, active):
        obs, active = obs[self._rows], active[self._rows]
        beliefs, new_state = self._model_step(obs, self.state)

        def merge(n, o):
            # leaves without a per-session leading axis (the size-0
            # placeholder weights) pass through unchanged, as in reset_where
            if n.dim() == 0 or n.shape[0] != self._pool:
                return n
            m = active.reshape((-1,) + (1,) * (n.dim() - 1))
            return torch.where(m, n, o)

        self.state = type(new_state)(
            *(merge(n, o) for n, o in zip(new_state, self.state)))
        return _tree_map(self._all_rows, beliefs)

    # -- row management ------------------------------------------------------
    def _allocate(self, sid):
        """Assign a free row, evicting the least recently used session when
        full. The caller wipes the row: step() resets all of a tick's new
        rows in one masked call."""
        if not self._free:
            # requesters are recency-bumped before allocation, so a session
            # in the current batch is never the victim
            victim = min((s for s in self._last_used if s in self._row_of),
                         key=self._last_used.get)
            self.end_session(victim)
            self._counters["evictions"] += 1
        row = self._free.pop()
        self._row_of[sid] = row
        self._counters["allocations"] += 1
        return row

    def end_session(self, sid) -> None:
        """Free a session's row (its memory is wiped on reuse)."""
        row = self._row_of.pop(sid, None)
        self._last_used.pop(sid, None)
        if row is not None:
            self._free.append(row)

    @property
    def num_active(self) -> int:
        return len(self._row_of)

    @property
    def stats(self) -> dict:
        """Lifetime counters and pool occupancy; `evictions` rising means
        sessions lose their memory before their streams end."""
        return {**self._counters, "active": len(self._row_of),
                "capacity": self.capacity}

    # -- failover ------------------------------------------------------------
    def snapshot(self) -> dict:
        """Server state as host arrays plus the session bookkeeping; a
        server built the same way continues every session bit-exactly after
        `restore`."""
        return {
            "state": _tree_map(lambda t: self._all_rows(t).cpu().numpy(),
                               self.state),
            "row_of": dict(self._row_of),
            "last_used": dict(self._last_used),
            "free": list(self._free),
            "clock": next(self._clock),  # consumes one tick; monotonic
        }

    def restore(self, snap: dict) -> None:
        """Adopt a snapshot() of another server built the same way, with
        or without a mesh."""
        state = _tree_map(lambda a: self._own_rows(
            torch.as_tensor(a, device=self.device)), snap["state"])
        if type(state) is not type(self.state) or any(
                a.shape != b.shape for a, b in zip(state, self.state)):
            raise ValueError("snapshot state does not match this server's "
                             "model")
        self.state = state
        self._row_of = dict(snap["row_of"])
        self._last_used = dict(snap["last_used"])
        self._free = list(snap["free"])
        self._clock = itertools.count(snap["clock"])

    # -- inference -----------------------------------------------------------
    def step(self, requests: dict) -> dict:
        """requests: {session_id: obs [obs_dim] array-like}. Steps every
        requesting session's memory one tick in one batched device step and
        returns {session_id: belief as numpy}. Other sessions are
        untouched."""
        if not requests:
            return {}
        if len(requests) > self.capacity:
            raise ValueError(
                f"{len(requests)} requests > capacity {self.capacity}")
        # bump recency for every requester first, so that a session in this
        # very batch can never be the eviction victim of another's allocation
        for sid in requests:
            self._last_used[sid] = next(self._clock)
        self._counters["ticks"] += 1
        self._counters["requests"] += len(requests)
        rows, new_rows = [], []
        for sid in requests:
            row = self._row_of.get(sid)
            if row is None:
                row = self._allocate(sid)
                new_rows.append(row)
            rows.append(row)
        if new_rows:
            # fresh memory for every newly allocated row, in one masked call
            mask = np.zeros((self.capacity,), bool)
            mask[new_rows] = True
            self.state = reset_where(self.state, torch.as_tensor(
                mask[self._rows], device=self.device))

        obs = np.zeros((self.capacity, self.obs_dim), np.float32)
        active = np.zeros((self.capacity,), bool)
        for sid, row in zip(requests, rows):
            obs[row] = np.asarray(requests[sid], np.float32)
            active[row] = True
        out = self._step(torch.as_tensor(obs, device=self.device),
                         torch.as_tensor(active, device=self.device))
        out = _tree_map(lambda t: t.cpu().numpy(), out)
        return {sid: _tree_map(lambda a: a[row], out)
                for sid, row in zip(requests, rows)}
