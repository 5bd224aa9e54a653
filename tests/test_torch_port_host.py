"""The port's host-stepped RL path (gcm_tpu_torch/data/host_buffer.py,
rl/native_env.py, rl/external.py, data/prefetch.py) against the JAX
package's, on the CPU.

- HostReplayBuffer (the port's own build of csrc/host_buffer.cpp) and
  pack_edges_host against the JAX package's (native/): the same episodes
  give the same counts, eviction and samples bit for bit, for several
  seeds, an empty buffer and overflowing edge lists.
- NativeCartPolePool: bitwise against JAX's pool from the same seed (the
  same C++), and, from the same states under the same actions, against the
  port's CartPoleEnv (rewards and dones equal, observations within 1e-6 /
  1e-5 relative, until each env's first end).
- episode_batch_to_device against JAX's: returns within 1e-6, previous
  actions, taus and validity exactly.
- collect_host_episodes with greedy=True on a host T-maze pool and the
  native CartPole pool under the sparse policy: the same episode count,
  mean return and buffer contents (samples bitwise) as JAX's; sampled
  collection: action frequencies within 4.5 standard errors of the
  policy's softmax.
- make_offline_a2c_update: gradients against JAX's (captured from its
  jitted update) at 1e-5 and one step of clip_by_global_norm + Adam
  against optax's at 1e-5, with the ZERO_GRAD rule.
- prefetch_to_device on the CPU: content and order, an empty iterator, an
  exception raised in the consumer, and the thread stopped when the
  consumer stops early. No timing is asserted.
"""

import os
import sys
import threading

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from gcm_tpu.data.host_buffer import HostReplayBuffer as JaxBuffer
from gcm_tpu.data.host_buffer import pack_edges_host as jax_pack_edges
from gcm_tpu.edges.sparse_temporal import TemporalEdge as JaxTemporalEdge
from gcm_tpu.rl import external as jext
from gcm_tpu.rl.native_env import NativeCartPolePool as JaxPool
from gcm_tpu.rl.wrappers import SparseGCMActorCritic as JaxSparsePolicy
from gcm_tpu_torch import (CartPoleEnv, HostEnvPool, HostReplayBuffer,
                           NativeCartPolePool, SparseGCMActorCritic,
                           TemporalEdge, collect_host_episodes,
                           episode_batch_to_device, load_jax_params,
                           make_offline_a2c_update, named_from_jax,
                           pack_edges_host, prefetch_to_device)
from gcm_tpu_torch.core.graph_state import dense_initial_state
from gcm_tpu_torch.ops import _build
from gcm_tpu_torch.rl.env import CartPoleState

sys.path.insert(0, os.path.join(os.path.dirname(__file__), os.pardir,
                                "examples"))
from train_external_env import PyTMaze  # noqa: E402

torch.set_num_threads(1)

ATOL = 1e-5
ZERO_GRAD = 1e-7  # a gradient that is zero up to float32 rounding


def t(a):
    return torch.from_numpy(np.array(a))


def numpy_tree(tree):
    return jax.tree_util.tree_map(np.asarray, tree)


def close(got, want, atol=ATOL, msg=""):
    got = got.detach().numpy() if torch.is_tensor(got) else np.asarray(got)
    np.testing.assert_allclose(got, np.asarray(want), atol=atol, rtol=0,
                               err_msg=msg)


def same_samples(a, b, seeds=(0, 1, 7), B=8, T=6):
    for seed in seeds:
        for x, y in zip(a.sample(B, T, seed), b.sample(B, T, seed)):
            assert x.dtype == y.dtype and np.array_equal(x, y), seed


# -- the buffer and the pool --------------------------------------------------

def test_host_library_is_the_ports_own_build():
    lib = _build.load_host("host_buffer")
    assert _build.BUILD_DIR in _build._host_target("host_buffer").parents
    assert os.path.basename(lib._name).startswith("host_buffer-")
    assert "native" not in lib._name


def test_replay_buffer_and_pack_edges_match_jax_bitwise():
    """The same episodes: counts, eviction at capacity (one episode always
    stays) and samples equal bit for bit; pack_edges_host equal, overflow
    counted."""
    rng = np.random.default_rng(0)
    for capacity in (10_000, 30, 3):
        ours, theirs = HostReplayBuffer(capacity, 3), JaxBuffer(capacity, 3)
        assert np.array_equal(ours.sample(2, 4)[0], theirs.sample(2, 4)[0])
        for i in range(12):
            T = int(rng.integers(1, 9))
            ep = (rng.standard_normal((T, 3)).astype(np.float32),
                  rng.integers(0, 3, T).astype(np.int32),
                  rng.standard_normal(T).astype(np.float32))
            assert ours.append(*ep) == theirs.append(*ep) == i + 1
            assert (ours.num_episodes, ours.total_steps) == (
                theirs.num_episodes, theirs.total_steps)
        assert ours.total_steps <= max(capacity, 8)
        same_samples(ours, theirs)
    with pytest.raises(ValueError, match="obs_dim"):
        ours.append(np.zeros((2, 4)), np.zeros(2), np.zeros(2))

    lengths = np.array([2, 0, 5, 3], np.int64)
    sinks = rng.integers(0, 9, lengths.sum()).astype(np.int64)
    sources = rng.integers(0, 9, lengths.sum()).astype(np.int64)
    for max_edges in (6, 4):
        got, n = pack_edges_host(sinks, sources, lengths, max_edges)
        want, jn = jax_pack_edges(sinks, sources, lengths, max_edges)
        assert np.array_equal(got, want) and n == jn
    assert n == 1


def test_native_cartpole_pool_matches_jax_pool_and_port_env():
    """Bitwise JAX's pool from the same seed (resets included); from the
    same states under the same actions, the port's CartPoleEnv's rewards
    and dones, and its observations within 1e-6 absolute / 1e-5 relative,
    until each env's first end."""
    B, horizon = 6, 12
    rng = np.random.default_rng(0)
    acts = rng.integers(0, 2, (40, B))
    for masked in (False, True):
        ours = NativeCartPolePool(B, horizon, masked, 0.5, seed=3)
        theirs = JaxPool(B, horizon, masked, 0.5, seed=3)
        assert ours.obs_dim == theirs.obs_dim == (2 if masked else 4)
        assert np.array_equal(ours.reset(), theirs.reset())
        for a in acts:
            for x, y in zip(ours.step(a), theirs.step(a)):
                assert np.array_equal(x, y)

    env = CartPoleEnv(horizon=horizon, reward_scale=0.5, device="cpu")
    pool = NativeCartPolePool(B, horizon, reward_scale=0.5, seed=1)
    v = rng.uniform(-0.05, 0.05, (4, B)).astype(np.float32)
    v[2, 0] = 0.2  # falls within a few steps
    pool.set_state(*v)
    state = CartPoleState(*(t(a) for a in v),
                          torch.zeros(B, dtype=torch.int32))
    g = torch.Generator().manual_seed(0)
    alive = np.ones(B, bool)
    for a in acts[: horizon + 2]:
        obs, rew, done, state = env.step(state, t(a), g)
        nobs, nrew, ndone = pool.step(a)
        np.testing.assert_array_equal(nrew[alive], rew.numpy()[alive])
        np.testing.assert_array_equal(ndone[alive], done.numpy()[alive])
        run = alive & ~ndone
        np.testing.assert_allclose(nobs[run], obs.numpy()[run], rtol=1e-5,
                                   atol=1e-6)
        alive = run
    assert not alive.any()
    with pytest.raises(ValueError, match="actions"):
        pool.step(np.zeros(B + 1))


def test_episode_batch_to_device_matches_jax():
    rng = np.random.default_rng(1)
    B, T = 5, 7
    taus = np.array([7, 3, 1, 0, 5], np.int32)
    valid = np.arange(T)[None] < taus[:, None]
    obs = rng.standard_normal((B, T, 3)).astype(np.float32) * valid[..., None]
    acts = (rng.integers(0, 3, (B, T)) * valid).astype(np.int32)
    rews = (rng.standard_normal((B, T)) * valid).astype(np.float32)
    got = episode_batch_to_device(obs, acts, rews, taus, 0.9, device="cpu")
    want = jext.episode_batch_to_device(obs, acts, rews, taus, 0.9)
    assert set(got) == set(want)
    for k in ("obs", "actions", "prev_actions", "taus", "valid"):
        np.testing.assert_array_equal(got[k].numpy(), np.asarray(want[k]),
                                      err_msg=k)
    close(got["returns"], want["returns"], atol=1e-6)
    b = episode_batch_to_device(np.zeros((1, 4, 2), np.float32),
                                np.zeros((1, 4), np.int32),
                                np.float32([[1, 1, 1, 0]]), np.int32([3]),
                                0.5, device="cpu")
    np.testing.assert_allclose(b["returns"].numpy(), [[1.75, 1.5, 1.0, 0.0]])


# -- collection and the update ------------------------------------------------

def sparse_policy_pair(obs_dim, n_act, T_max, width=8):
    cfg = dict(graph_size=T_max + 1, gnn_input_size=width,
               gnn_output_size=width, max_edges=4 * T_max,
               use_prev_action=True)
    jpol = JaxSparsePolicy(obs_dim, n_act, n_act,
                           edge_selectors=JaxTemporalEdge([1]), **cfg)
    pol = SparseGCMActorCritic(obs_dim, n_act, n_act,
                               edge_selectors=TemporalEdge([1]),
                               device="cpu", **cfg)
    params = jpol.init(jax.random.PRNGKey(0))
    load_jax_params(pol, numpy_tree(params))
    return jpol, params, pol


def tmaze_pool(seed=0, n=4, corridor=2):
    return HostEnvPool([PyTMaze(corridor, np.random.default_rng(seed + i))
                        for i in range(n)])


POOLS = {  # the pool, JAX's twin, T_max and the collection's ticks
    "tmaze": lambda: (tmaze_pool(), tmaze_pool(), 6, 24),
    "native_cartpole": lambda: (
        NativeCartPolePool(4, horizon=8, reward_scale=0.1, seed=5),
        JaxPool(4, horizon=8, reward_scale=0.1, seed=5), 8, 30),
}


@pytest.fixture(scope="module")
def jax_collections():
    """JAX's greedy collection on each pool of POOLS under the sparse
    policy, run once a module and shared by the items that compare against
    it: {kind: (pool, T_max, steps, JAX policy, its params, JAX's buffer,
    JAX's (episodes, mean return))}."""
    out = {}
    for kind, make in POOLS.items():
        pool, jpool, T_max, steps = make()
        jpol, params, _ = sparse_policy_pair(pool.obs_dim, pool.num_actions,
                                             T_max)
        jbuf = JaxBuffer(10_000, pool.obs_dim)
        want = jext.collect_host_episodes(jpool, jpol, params, jbuf, steps,
                                          jax.random.PRNGKey(0), greedy=True)
        out[kind] = (pool, T_max, steps, jpol, params, jbuf, want)
    return out


@pytest.mark.parametrize("pool_kind", list(POOLS))
def test_greedy_collection_matches_jax(pool_kind, jax_collections):
    """Greedy collection under the sparse policy from the same weights and
    pools: the same episodes appended, mean return and buffer samples."""
    pool, T_max, steps, _, _, jbuf, want = jax_collections[pool_kind]
    _, _, pol = sparse_policy_pair(pool.obs_dim, pool.num_actions, T_max)
    buf = HostReplayBuffer(10_000, pool.obs_dim)
    got = collect_host_episodes(pool, pol, buf, steps, greedy=True)
    assert got[0] == want[0] > 0
    close(got[1], want[1], atol=1e-6)
    assert (buf.num_episodes, buf.total_steps) == (jbuf.num_episodes,
                                                   jbuf.total_steps)
    same_samples(buf, jbuf, T=T_max)


class FixedLogits(torch.nn.Module):
    """A policy stub whose logits are a fixed row for every env."""

    def __init__(self, row):
        super().__init__()
        self.row = torch.nn.Parameter(torch.tensor(row))

    def initial_state(self, B):
        return dense_initial_state(B, 2, 1)

    def step(self, obs, state, prev_action=None):
        B = obs.shape[0]
        return self.row.expand(B, -1), torch.zeros(B), state


def test_sampled_collection_follows_the_softmax():
    """Sampled collection's 2,400 actions (as the pool received them) within
    4.5 standard errors of softmax(logits); greedy=False needs a
    generator."""
    row = [0.5, -1.0, 1.5]
    seen = []

    class Recording(HostEnvPool):
        def step(self, actions):
            seen.append(np.array(actions))
            return super().step(actions)

    pool = Recording(tmaze_pool(n=16).envs)
    buf = HostReplayBuffer(100_000, pool.obs_dim)
    pol = FixedLogits(row)
    n_eps, _ = collect_host_episodes(pool, pol, buf, 150,
                                     torch.Generator().manual_seed(1))
    assert n_eps == buf.num_episodes > 0
    draws = np.concatenate(seen)
    n = draws.size
    assert n == 2_400
    freq = np.bincount(draws, minlength=3) / n
    p = torch.softmax(torch.tensor(row), -1).numpy()
    assert np.all(np.abs(freq - p) <= 4.5 * np.sqrt(p * (1 - p) / n)), \
        (freq, p)
    with pytest.raises(ValueError, match="torch.Generator"):
        collect_host_episodes(pool, pol, buf, 1)


def capture_grads():
    """An optax transform that passes the updates on unchanged and keeps
    them as its state: put first in a chain, it reads JAX's gradients out
    of the jitted update that also takes the chain's step."""
    return optax.GradientTransformation(
        lambda p: jax.tree_util.tree_map(jnp.zeros_like, p),
        lambda u, s, p=None: (u, u))


def test_offline_a2c_update_matches_optax(jax_collections):
    """A batch from JAX's T-maze buffer: the loss, its metrics and
    every gradient against JAX's (read by capture_grads), and one step
    clipped at 0.05 + Adam(3e-3) against optax.chain(clip_by_global_norm,
    adam), both from one jitted JAX update."""
    pool, T_max, _, jpol, params, jbuf, _ = jax_collections["tmaze"]
    _, _, pol = sparse_policy_pair(pool.obs_dim, pool.num_actions, T_max)
    batch = {k: np.asarray(v) for k, v in jext.episode_batch_to_device(
        *jbuf.sample(8, T_max, seed=2), gamma=0.9).items()}
    tb = {k: t(v) for k, v in batch.items()}

    chain = optax.chain(capture_grads(), optax.clip_by_global_norm(0.05),
                        optax.adam(3e-3))
    new_params, state, jm = jext.make_offline_a2c_update(jpol, chain)(
        params, chain.init(params), batch)
    grads = state[0]
    pm = make_offline_a2c_update(
        pol, torch.optim.SGD(pol.parameters(), lr=0.0))(tb)
    for k in ("loss", "pg", "v", "entropy"):
        close(pm[k], jm[k], msg=k)
    want = named_from_jax(pol, numpy_tree(grads))
    for name, p in pol.named_parameters():
        close(p.grad, want[name], msg=f"grad {name}")
    assert float(optax.global_norm(grads)) > 0.05, "the clip does not bite"

    make_offline_a2c_update(pol, torch.optim.Adam(pol.parameters(), lr=3e-3),
                            max_grad_norm=0.05)(tb)
    want_p = named_from_jax(pol, numpy_tree(new_params))
    for name, p in pol.named_parameters():
        if float(want[name].abs().max()) < ZERO_GRAD:
            assert float(p.grad.abs().max()) < ZERO_GRAD, name
            continue
        close(p, want_p[name], msg=f"{name} after the step")


# -- prefetch -----------------------------------------------------------------

def test_prefetch_on_the_cpu():
    batches = [{"x": np.full((3, 2), i, np.float32), "i": np.int32(i),
                "pair": (np.arange(i), torch.ones(2) * i)} for i in range(7)]
    out = list(prefetch_to_device(iter(batches), size=3, device="cpu"))
    assert len(out) == 7
    for i, b in enumerate(out):
        assert torch.is_tensor(b["x"]) and b["x"].device.type == "cpu"
        np.testing.assert_array_equal(b["x"].numpy(), batches[i]["x"])
        assert int(b["i"]) == i and isinstance(b["pair"], tuple)
        np.testing.assert_array_equal(b["pair"][0].numpy(), np.arange(i))
        assert torch.equal(b["pair"][1], torch.ones(2) * i)
    assert list(prefetch_to_device(iter([]), device="cpu")) == []

    def boom():
        yield np.zeros(2)
        raise ValueError("boom")

    it = prefetch_to_device(boom(), size=2, device="cpu")
    next(it)
    with pytest.raises(ValueError, match="boom"):
        next(it)
    with pytest.raises(ValueError, match="depth"):
        prefetch_to_device(iter([]), size=0, device="cpu")

    # a consumer that stops early stops the thread
    before = threading.active_count()
    it = prefetch_to_device((np.zeros(1) for _ in range(10 ** 6)), size=2,
                            device="cpu")
    next(it)
    it.close()
    assert threading.active_count() == before
