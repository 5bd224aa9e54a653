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
"""

from __future__ import annotations

import itertools

import numpy as np
import torch

from gcm_tpu_torch.core.graph_state import reset_where
from gcm_tpu_torch.device import resolve_device


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
                 dtype=torch.float32, step_fn=None, initial_state=None, *,
                 device=None):
        """`model(obs, state) -> (belief, state)` backs the server;
        alternatively pass step_fn(obs, state) -> (belief, state) with a
        matching capacity-sized `initial_state` and model=None (see
        `from_step`). Runs on `device` (default: the CUDA card)."""
        self.device = resolve_device(device)
        self.model = model
        self.capacity = capacity
        self.obs_dim = obs_dim
        if initial_state is not None:
            self.state = _tree_map(lambda t: t.to(self.device), initial_state)
        else:
            self.state = model.initial_state(capacity, obs_dim, dtype=dtype)
        self._model_step = step_fn if step_fn is not None else model
        self._row_of: dict = {}          # session_id -> row
        self._free = list(range(capacity - 1, -1, -1))  # pop() -> row 0 first
        self._clock = itertools.count()
        self._last_used: dict = {}       # session_id -> clock tick
        self._counters = {"ticks": 0, "requests": 0, "allocations": 0,
                          "evictions": 0}

    @classmethod
    def from_policy(cls, policy, capacity: int, *, device=None):
        """Serve a whole actor-critic policy (rl/wrappers.py): each tick
        returns {"logits": [A], "value": scalar} per session. The policy
        must not use the previous action (requests carry none). Runs on
        `device`, by default the policy's."""
        if policy.cfg.get("use_prev_action", False):
            raise ValueError(
                "serving tracks no per-session action history; build the "
                "policy with use_prev_action=False")

        def step_fn(obs, state):
            logits, value, state = policy.step(obs, state)
            return {"logits": logits, "value": value}, state

        return cls(None, capacity, policy.obs_dim, step_fn=step_fn,
                   initial_state=policy.initial_state(capacity),
                   device=policy.device if device is None else device)

    @classmethod
    def from_step(cls, step_fn, initial_state, obs_dim: int, *, device=None):
        """A server around a bare step callable and the matching
        capacity-sized initial state; no model object needed."""
        capacity = initial_state[0].shape[0]
        return cls(None, capacity, obs_dim, step_fn=step_fn,
                   initial_state=initial_state, device=device)

    @torch.no_grad()
    def _step(self, obs, active):
        beliefs, new_state = self._model_step(obs, self.state)

        def merge(n, o):
            # leaves without a per-session leading axis (the size-0
            # placeholder weights) pass through unchanged, as in reset_where
            if n.dim() == 0 or n.shape[0] != self.capacity:
                return n
            m = active.reshape((-1,) + (1,) * (n.dim() - 1))
            return torch.where(m, n, o)

        self.state = type(new_state)(
            *(merge(n, o) for n, o in zip(new_state, self.state)))
        return beliefs

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
            "state": _tree_map(lambda t: t.cpu().numpy(), self.state),
            "row_of": dict(self._row_of),
            "last_used": dict(self._last_used),
            "free": list(self._free),
            "clock": next(self._clock),  # consumes one tick; monotonic
        }

    def restore(self, snap: dict) -> None:
        """Adopt a snapshot() of another server built the same way."""
        state = _tree_map(lambda a: torch.as_tensor(a, device=self.device),
                          snap["state"])
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
            self.state = reset_where(self.state,
                                     torch.as_tensor(mask, device=self.device))

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
