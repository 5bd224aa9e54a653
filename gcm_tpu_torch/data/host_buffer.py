"""ctypes bindings of the host trajectory store (counterpart of
gcm_tpu/data/host_buffer.py): `HostReplayBuffer`, an episode ring buffer
with zero-padded fixed-shape batch sampling, and `pack_edges_host`, the
ragged edge-list packer.

The C++ is the port's own copy, `csrc/host_buffer.cpp`, built with g++ at
first use into `_build/` (`ops/_build.py::load_host`); the JAX package's
`native/libgcm_host.so` is never loaded. Same code, same seed: a sample is
bitwise the JAX package's for the same episodes. Host objects: numpy in,
numpy out, no device.
"""

from __future__ import annotations

import ctypes
import functools

import numpy as np

from gcm_tpu_torch.ops._build import load_host


@functools.cache
def _load() -> ctypes.CDLL:
    lib = load_host("host_buffer")
    lib.rb_create.restype = ctypes.c_void_p
    lib.rb_create.argtypes = [ctypes.c_size_t, ctypes.c_int]
    lib.rb_destroy.restype = None
    lib.rb_destroy.argtypes = [ctypes.c_void_p]
    lib.rb_append_episode.restype = ctypes.c_int64
    lib.rb_append_episode.argtypes = [
        ctypes.c_void_p, ctypes.POINTER(ctypes.c_float),
        ctypes.POINTER(ctypes.c_int32), ctypes.POINTER(ctypes.c_float),
        ctypes.c_int32,
    ]
    lib.rb_num_episodes.restype = ctypes.c_int32
    lib.rb_num_episodes.argtypes = [ctypes.c_void_p]
    lib.rb_total_steps.restype = ctypes.c_int64
    lib.rb_total_steps.argtypes = [ctypes.c_void_p]
    lib.rb_sample_batch.restype = None
    lib.rb_sample_batch.argtypes = [
        ctypes.c_void_p, ctypes.c_int32, ctypes.c_int32, ctypes.c_uint64,
        ctypes.POINTER(ctypes.c_float), ctypes.POINTER(ctypes.c_int32),
        ctypes.POINTER(ctypes.c_float), ctypes.POINTER(ctypes.c_int32),
    ]
    lib.ep_create.restype = ctypes.c_void_p
    lib.ep_create.argtypes = [ctypes.c_int32, ctypes.c_int32,
                              ctypes.c_int32, ctypes.c_float,
                              ctypes.c_uint64]
    lib.ep_destroy.restype = None
    lib.ep_destroy.argtypes = [ctypes.c_void_p]
    lib.ep_obs_dim.restype = ctypes.c_int32
    lib.ep_obs_dim.argtypes = [ctypes.c_void_p]
    lib.ep_reset.restype = None
    lib.ep_reset.argtypes = [ctypes.c_void_p,
                             ctypes.POINTER(ctypes.c_float)]
    lib.ep_set_state.restype = None
    lib.ep_set_state.argtypes = [ctypes.c_void_p] + \
        [ctypes.POINTER(ctypes.c_float)] * 4
    lib.ep_step.restype = None
    lib.ep_step.argtypes = [
        ctypes.c_void_p, ctypes.POINTER(ctypes.c_int32),
        ctypes.POINTER(ctypes.c_float), ctypes.POINTER(ctypes.c_float),
        ctypes.POINTER(ctypes.c_uint8),
    ]
    lib.pack_edges.restype = ctypes.c_int32
    lib.pack_edges.argtypes = [
        ctypes.POINTER(ctypes.c_int64), ctypes.POINTER(ctypes.c_int64),
        ctypes.POINTER(ctypes.c_int64), ctypes.c_int32, ctypes.c_int32,
        ctypes.c_int32, ctypes.POINTER(ctypes.c_int64),
    ]
    return lib


def _ptr(a: np.ndarray, ctype):
    return a.ctypes.data_as(ctypes.POINTER(ctype))


class HostReplayBuffer:
    """Episode ring buffer with zero-padded fixed-shape batch sampling: the
    host data path feeding SparseGCM's and NavGCM's time-batched training
    ([B, T_max, F] + taus). Appending past `capacity_steps` evicts the
    oldest episodes (at least one episode always stays)."""

    def __init__(self, capacity_steps: int, obs_dim: int):
        self._lib = _load()
        self.obs_dim = obs_dim
        self._h = ctypes.c_void_p(self._lib.rb_create(capacity_steps,
                                                      obs_dim))

    def __del__(self):
        if getattr(self, "_h", None):
            self._lib.rb_destroy(self._h)
            self._h = None

    def append(self, obs: np.ndarray, actions: np.ndarray,
               rewards: np.ndarray) -> int:
        """Append one episode (obs [T, obs_dim], actions [T], rewards [T]);
        returns the running count of appended episodes."""
        obs = np.ascontiguousarray(obs, np.float32)
        actions = np.ascontiguousarray(actions, np.int32)
        rewards = np.ascontiguousarray(rewards, np.float32)
        T = obs.shape[0]
        if obs.shape != (T, self.obs_dim) or actions.shape != (T,) \
                or rewards.shape != (T,):
            raise ValueError(f"episode shapes {obs.shape}, {actions.shape}, "
                             f"{rewards.shape} do not fit obs_dim "
                             f"{self.obs_dim}")
        return self._lib.rb_append_episode(
            self._h, _ptr(obs, ctypes.c_float), _ptr(actions, ctypes.c_int32),
            _ptr(rewards, ctypes.c_float), T)

    @property
    def num_episodes(self) -> int:
        return self._lib.rb_num_episodes(self._h)

    @property
    def total_steps(self) -> int:
        return self._lib.rb_total_steps(self._h)

    def sample(self, B: int, T_max: int, seed: int = 0):
        """B episodes drawn uniformly with replacement (mt19937_64 from
        `seed`), each cut to its first T_max steps and zero-padded: (obs
        [B, T_max, obs_dim], actions [B, T_max] int32, rewards [B, T_max],
        taus [B] int32). An empty buffer gives zeros."""
        obs = np.empty((B, T_max, self.obs_dim), np.float32)
        acts = np.empty((B, T_max), np.int32)
        rews = np.empty((B, T_max), np.float32)
        taus = np.empty((B,), np.int32)
        self._lib.rb_sample_batch(
            self._h, B, T_max, seed, _ptr(obs, ctypes.c_float),
            _ptr(acts, ctypes.c_int32), _ptr(rews, ctypes.c_float),
            _ptr(taus, ctypes.c_int32))
        return obs, acts, rews, taus


def pack_edges_host(sinks, sources, lengths, max_edges: int,
                    edge_fill: int = -1):
    """Ragged -> fixed edge-list packing in C++ (the loop of
    utils/packing.py::pack_hidden). sinks, sources: concatenated int64
    arrays; lengths: each batch element's edge count. Returns ([B, 2,
    max_edges] int64, the number of elements whose edges overflowed and
    were cut)."""
    lib = _load()
    sinks = np.ascontiguousarray(sinks, np.int64)
    sources = np.ascontiguousarray(sources, np.int64)
    lengths = np.ascontiguousarray(lengths, np.int64)
    if sinks.shape != sources.shape or int(lengths.sum()) > sinks.shape[0]:
        raise ValueError("sinks and sources must hold sum(lengths) edges")
    B = lengths.shape[0]
    out = np.empty((B, 2, max_edges), np.int64)
    overflowed = lib.pack_edges(
        _ptr(sinks, ctypes.c_int64), _ptr(sources, ctypes.c_int64),
        _ptr(lengths, ctypes.c_int64), B, max_edges, edge_fill,
        _ptr(out, ctypes.c_int64))
    return out, int(overflowed)
