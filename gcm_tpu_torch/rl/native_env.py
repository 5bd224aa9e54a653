"""Native (C++) vectorised CartPole pool for the host-stepped RL path
(counterpart of gcm_tpu/rl/native_env.py).

`rl/external.py::HostEnvPool` steps one Python object per env; this pool
is the same batched interface backed by one C call a tick
(`csrc/host_buffer.cpp::ep_step`), whose dynamics replicate the port's
`rl/env.py::CartPoleEnv` in float32 (Gym's Euler integration, auto-reset,
the masked-velocity mode). A host object, as in JAX: numpy in and out.
Accepted wherever a `HostEnvPool` is (`collect_host_episodes`).
"""

from __future__ import annotations

import ctypes

import numpy as np

from gcm_tpu_torch.data.host_buffer import _load, _ptr


class NativeCartPolePool:
    num_actions = 2

    def __init__(self, n: int, horizon: int = 64,
                 masked_velocity: bool = False, reward_scale: float = 1.0,
                 seed: int = 0):
        self._lib = _load()
        self._h = self._lib.ep_create(n, horizon, int(masked_velocity),
                                      float(reward_scale), seed)
        self.n = n
        self.horizon = horizon
        self.obs_dim = int(self._lib.ep_obs_dim(self._h))
        self._obs = np.empty((n, self.obs_dim), np.float32)
        self._rew = np.empty((n,), np.float32)
        self._done = np.empty((n,), np.uint8)

    def __len__(self):
        return self.n

    def __del__(self):
        if getattr(self, "_h", None):
            self._lib.ep_destroy(self._h)
            self._h = None

    def reset(self) -> np.ndarray:
        self._lib.ep_reset(self._h, _ptr(self._obs, ctypes.c_float))
        return self._obs.copy()

    def set_state(self, x, x_dot, theta, theta_dot) -> None:
        """Overwrite the physical state (episode clocks to 0): a hook for
        holding the dynamics to another env from the same states."""
        arrs = [np.ascontiguousarray(a, np.float32)
                for a in (x, x_dot, theta, theta_dot)]
        if any(a.shape != (self.n,) for a in arrs):
            raise ValueError(f"each state array must be [{self.n}]")
        self._lib.ep_set_state(self._h,
                               *[_ptr(a, ctypes.c_float) for a in arrs])

    def step(self, actions: np.ndarray):
        """One batch tick: (obs [n, obs_dim], rewards [n], dones [n] bool).
        A finished env resets and returns the next episode's first
        observation, as `HostEnvPool` does."""
        acts = np.ascontiguousarray(actions, np.int32)
        if acts.shape != (self.n,):
            raise ValueError(f"actions must be [{self.n}], got {acts.shape}")
        self._lib.ep_step(self._h, _ptr(acts, ctypes.c_int32),
                          _ptr(self._obs, ctypes.c_float),
                          _ptr(self._rew, ctypes.c_float),
                          _ptr(self._done, ctypes.c_uint8))
        return self._obs.copy(), self._rew.copy(), self._done.astype(bool)
