"""The port's fast-core actor-critics (gcm_tpu_torch/rl/wrappers.py:
GCMActorCritic with core="banded", "clique", "banded_scored" and "auto")
against the JAX package's, on the CPU.

The JAX policy's weights go into the port's (`load_jax_params`); the
trajectories are JAX's. For each fast core, on a T-maze whose episodes end
mid-rollout (graph 5, previous actions):
- the step's logits and values over a trajectory, with resets, against
  JAX's whole-trajectory call (1e-5);
- the whole-trajectory call through the core's window (the port's gate
  takes it) and, with a generator (JAX: a key), through its scan, against
  JAX's (1e-5);
- A2C's loss and every gradient on a JAX-collected trajectory against
  jax.value_and_grad (1e-5 absolute, 1e-4 relative), the replay taking the
  window.
Then core="auto"'s answers on the JAX test's configurations
(tests/test_rl.py::TestAutoCore), JAX's structural answers (each family's
fast core won on the card); the ValueErrors where JAX asserts; and
train_remat_for's reverse branch against JAX's with the reverse constants
set.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import gcm_tpu.config as jax_config
from gcm_tpu.edges.chain import EdgeChain as JaxEdgeChain
from gcm_tpu.edges.dense import DenseEdge as JaxDenseEdge
from gcm_tpu.edges.distance import EuclideanEdge as JaxEuclideanEdge
from gcm_tpu.edges.temporal import TemporalBackedge as JaxTemporalBackedge
from gcm_tpu.nn.dense_conv import DenseGNN as JaxDenseGNN
from gcm_tpu.nn.dense_conv import DenseGraphConv as JaxDenseGraphConv
from gcm_tpu.rl import env as jenv
from gcm_tpu.rl.a2c import A2C as JaxA2C
from gcm_tpu.rl.wrappers import GCMActorCritic as JaxGCMActorCritic
from gcm_tpu.rl.wrappers import train_remat_for as jax_train_remat_for
from gcm_tpu_torch import (A2C, DenseEdge, DenseGNN, DenseGraphConv,
                           EdgeChain, EuclideanEdge, GCMActorCritic,
                           TemporalBackedge, TMazeEnv, load_jax_params,
                           named_from_jax, reset_where)
from gcm_tpu_torch.ops.cuda import fused_gnn
from gcm_tpu_torch.rl import wrappers
from gcm_tpu_torch.rl.wrappers import train_remat_for

torch.set_num_threads(1)

ATOL, RTOL = 1e-5, 1e-4
B, T, G = 4, 8, 5


@pytest.fixture(autouse=True)
def one_step_a_loop_iteration(monkeypatch):
    """JAX's scans unrolled once: unrolling changes how XLA compiles the
    loop (and how long it takes), not what it computes."""
    for knob in ("SCAN_UNROLL", "DENSE_SCAN_UNROLL", "RING_SCAN_UNROLL"):
        monkeypatch.setattr(jax_config, knob, 1)


def t(a):
    return torch.from_numpy(np.array(a))


def numpy_tree(tree):
    return jax.tree_util.tree_map(np.asarray, tree)


def assert_close(got, want, msg, atol=ATOL, rtol=RTOL):
    got = got.detach().numpy() if torch.is_tensor(got) else np.asarray(got)
    np.testing.assert_allclose(got, np.asarray(want), atol=atol, rtol=rtol,
                               err_msg=msg)


SELECTORS = {
    "banded": (lambda: JaxTemporalBackedge([1, 2]),
               lambda: TemporalBackedge([1, 2])),
    "clique": (JaxDenseEdge, DenseEdge),
    "banded_scored": (
        lambda: JaxEdgeChain([JaxTemporalBackedge([1]),
                              JaxEuclideanEdge(1.0, window=3)]),
        lambda: EdgeChain([TemporalBackedge([1]),
                           EuclideanEdge(1.0, window=3)])),
}


def policy_pair(core):
    jsel, sel = SELECTORS[core]
    cfg = dict(core=core, graph_size=G, gnn_input_size=8, gnn_output_size=8,
               use_prev_action=True)
    jv = jenv.TMazeEnv(3)
    jpol = JaxGCMActorCritic(jv.obs_dim, jv.num_actions, jv.num_actions,
                             edge_selectors=jsel(), **cfg)
    pol = GCMActorCritic(jv.obs_dim, jv.num_actions, jv.num_actions,
                         edge_selectors=sel(), device="cpu", **cfg)
    params = jpol.init(jax.random.PRNGKey(0))
    load_jax_params(pol, numpy_tree(params))
    return jv, jpol, params, pol


@pytest.mark.parametrize("core", list(SELECTORS))
def test_fast_policy_matches_jax(core):
    """Step, window replay, scan replay and A2C's loss and gradients
    against JAX's policy with the same weights."""
    jv, jpol, params, pol = policy_pair(core)
    assert type(pol.core).__name__ == type(jpol.core).__name__
    jtr = JaxA2C(jv, jpol, rollout_len=T)
    traj = numpy_tree(jax.jit(jtr.collect, static_argnums=2)(
        params, jax.random.PRNGKey(3), B))
    assert traj["dones"][:, :-1].any(), "no episode ended mid-rollout"
    obs, prev, dones = traj["obs"], traj["prev_actions"], traj["dones"]
    st = jpol.initial_state(B)
    jl, jv_, _ = jax.jit(lambda p: jpol(p, obs, st, prev_actions=prev,
                                        dones=dones, train=True))(params)
    sl, sv, _ = jax.jit(lambda p, k: jpol(p, obs, st, prev_actions=prev,
                                          dones=dones, key=k))(
        params, jax.random.PRNGKey(1))
    with torch.no_grad():
        assert pol.uses_window(t(dones), train=True)
        wl, wv, _ = pol(t(obs), pol.initial_state(B), prev_actions=t(prev),
                        dones=t(dones), train=True)
        gen = torch.Generator().manual_seed(0)
        assert not pol.uses_window(t(dones), train=True, generator=gen)
        pl, pv, _ = pol(t(obs), pol.initial_state(B), prev_actions=t(prev),
                        dones=t(dones), generator=gen)
        state = pol.initial_state(B)
        steps = []
        for s in range(T):
            lo, va, state = pol.step(t(obs[:, s]), state, t(prev[:, s]))
            steps.append((lo, va))
            state = reset_where(state, t(dones[:, s]))
    for label, (lo, va), (wl_, wv_) in (
            ("window", (wl, wv), (jl, jv_)), ("scan", (pl, pv), (sl, sv)),
            ("step", tuple(torch.stack(x, 1) for x in zip(*steps)),
             (jl, jv_))):
        assert_close(lo, wl_, f"{core} {label}: logits")
        assert_close(va, wv_, f"{core} {label}: values")

    (loss, metrics), grads = jax.jit(jax.value_and_grad(
        jtr.loss, has_aux=True))(params, traj)
    tr = A2C(TMazeEnv(3, device="cpu"), pol, rollout_len=T)
    before = fused_gnn.fused_dense_gnn.launches
    total, pm = tr.loss({k: t(v) for k, v in traj.items()})
    total.backward()
    assert fused_gnn.fused_dense_gnn.launches == before
    assert_close(total, loss, f"{core}: loss")
    want = named_from_jax(pol, numpy_tree(grads))
    for name, p in pol.named_parameters():
        g = p.grad if p.grad is not None else torch.zeros_like(p)
        assert_close(g, want[name], f"{core}: grad {name}")


AUTO_CASES = [
    # (selector config, JAX's structural answer), tests/test_rl.py's
    (lambda m: dict(edge_selectors=m.TemporalBackedge([1, 2])), "banded"),
    (lambda m: dict(edge_selectors=m.TemporalBackedge([1], learned=True)),
     "dense"),
    (lambda m: dict(edge_selectors=m.DenseEdge()), "clique"),
    (lambda m: dict(edge_selectors=m.EuclideanEdge(1.0, window=8),
                    graph_size=512), "dense"),
    (lambda m: dict(edge_selectors=m.EuclideanEdge(1.0, window=8),
                    graph_size=512, usage="trajectory_train"),
     "banded_scored"),
    (lambda m: dict(edge_selectors=m.EdgeChain([
        m.TemporalBackedge([1]), m.EuclideanEdge(1.0, window=8)]),
        graph_size=512, usage="trajectory_train"), "banded_scored"),
    (lambda m: dict(edge_selectors=m.EdgeChain([
        m.TemporalBackedge([1]), m.EuclideanEdge(1.0, window=8)]),
        graph_size=512), "dense"),
    (lambda m: dict(edge_selectors=m.EuclideanEdge(1.0)), "dense"),
    (lambda m: dict(edge_selectors=m.TemporalBackedge([1]), pooled=True),
     "dense"),
    (lambda m: dict(edge_selectors=m.TemporalBackedge([1]), gnn=m.DenseGNN(
        [m.DenseGraphConv(16, 16, aggr="mean"), m.tanh])), "banded"),
    (lambda m: dict(edge_selectors=m.TemporalBackedge([1]), gnn=m.DenseGNN(
        [m.DenseGraphConv(16, 16, aggr="max"), m.tanh])), "dense"),
]


class _Jax:
    TemporalBackedge, DenseEdge = JaxTemporalBackedge, JaxDenseEdge
    EuclideanEdge, EdgeChain = JaxEuclideanEdge, JaxEdgeChain
    DenseGNN, DenseGraphConv, tanh = JaxDenseGNN, JaxDenseGraphConv, jnp.tanh


class _Port:
    DenseEdge, EuclideanEdge, EdgeChain = DenseEdge, EuclideanEdge, EdgeChain
    tanh = torch.tanh

    @staticmethod
    def TemporalBackedge(hops, **kw):
        return TemporalBackedge(hops, device="cpu", **kw)

    @staticmethod
    def DenseGNN(layers):
        return DenseGNN(layers)

    @staticmethod
    def DenseGraphConv(i, o, aggr):
        return DenseGraphConv(i, o, aggr=aggr, device="cpu")


def test_auto_rule_refusals_and_train_remat(monkeypatch):
    """core="auto" on JAX's test configurations: the port's answer is
    JAX's structural one (each family's fast core won on the card); a fast
    core given a selector or option it does not
    implement raises ValueError where JAX asserts; train_remat_for's
    reverse branch as JAX's."""
    base = dict(gnn_input_size=16, gnn_output_size=16, use_prev_action=True,
                graph_size=9)
    for make, structural in AUTO_CASES:
        jpol = JaxGCMActorCritic(4, 3, 3, core="auto",
                                 **{**base, **make(_Jax)})
        pol = GCMActorCritic(4, 3, 3, core="auto", device="cpu",
                             **{**base, **make(_Port)})
        assert jpol.cfg["core"] == pol.cfg["core"] == structural, (
            structural, pol.cfg["core"])
    refused = [
        (dict(core="banded", edge_selectors="learned"), "deterministic"),
        (dict(core="clique", edge_selectors="temporal"), "DenseEdge"),
        (dict(core="banded_scored", edge_selectors="dense"), "Distance"),
        (dict(core="banded", edge_selectors="temporal", pooled=True),
         "plain"),
        (dict(core="clique", edge_selectors="dense", edge_weights=True),
         "plain"),
    ]
    sels = {"learned": lambda m: m.TemporalBackedge([1], learned=True),
            "temporal": lambda m: m.TemporalBackedge([1]),
            "dense": lambda m: m.DenseEdge()}
    for cfg, match in refused:
        kw = dict(base, **cfg)
        name = kw.pop("edge_selectors")
        with pytest.raises(AssertionError):
            JaxGCMActorCritic(4, 3, 3, edge_selectors=sels[name](_Jax), **kw)
        with pytest.raises(ValueError, match=match):
            GCMActorCritic(4, 3, 3, edge_selectors=sels[name](_Port),
                           device="cpu", **kw)
    # the reverse branch, with both frameworks' constants set
    monkeypatch.setattr(jax_config, "RING_REVERSE_BWD", True)
    monkeypatch.setattr(jax_config, "DENSE_REVERSE_BWD", True)
    monkeypatch.setattr(wrappers, "RING_REVERSE_BWD", True)
    monkeypatch.setattr(wrappers, "DENSE_REVERSE_BWD", True)
    dones = np.zeros((2, 8), bool)
    for core in ("ring", "dense", "banded"):
        jpol = JaxGCMActorCritic(4, 3, 3, core=core,
                                 edge_selectors=JaxTemporalBackedge([1]),
                                 **base)
        pol = GCMActorCritic(4, 3, 3, core=core, device="cpu",
                             edge_selectors=TemporalBackedge([1]), **base)
        for d in (None, dones):
            assert train_remat_for(pol.core, 8, dones=d) == \
                jax_train_remat_for(jpol.core, 8, dones=d), (core, d)
