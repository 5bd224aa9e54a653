"""The port's RL stack (gcm_tpu_torch/rl, utils/debug.py and
SessionServer.from_policy) against the JAX package's, on the CPU.

torch.Generator and jax.random draw different streams, so parity runs on
the same inputs: JAX collects the trajectory and both losses take it as
numpy; PPO's `learn` takes JAX's permutations; env dynamics are compared
teacher-forced, from the same states under the same actions. The port's
samplers and env draws are held to their laws instead.

- Categorical and DiagGaussian log_prob / entropy against JAX at 1e-6; the
  Categorical's frequencies over 20,000 draws within 4.5 standard errors
  of softmax(logits); DiagGaussian's sample mean and std likewise.
- TMaze, CartPole (masked velocity, reward scale), Recall and
  ContinuousRecall stepped from JAX's states under the same actions:
  rewards, dones and the deterministic parts of states and observations
  equal (CartPole's dynamics within 1e-6); the draws' ranges and laws.
- The wrappers: config validation, mesh= building the node-sharded core,
  step == __call__, previous-action one-hots and positional encodings
  ('add' and 'cat' on the ring, 'relative' on the dense core) against
  JAX's policies at 1e-5.
- discounted_returns and gae against JAX at 1e-6.
- A2C's loss, metrics and every gradient against jax.value_and_grad of
  JAX's loss on a JAX-collected trajectory, for the ring (graph size 5,
  off the dense kernels' 16-row grid, episodes ending mid-rollout), dense
  and sparse policies (the dense one with a frozen user preprocessor,
  which takes no gradient); the grad norms under JAX's tree paths; one Adam
  step against optax.adam, and with max_grad_norm against
  optax.chain(clip_by_global_norm, adam).
- PPO's learn with JAX's permutations against JAX's jitted update, every
  parameter after all epochs x minibatches Adam steps.
- replay_dones=False: the same loss where no episode ends early, and a
  refusal where one does.
- SessionServer.from_policy against JAX's: logits and values at 1e-5.

Tolerance: 1e-5 absolute + 1e-4 relative for losses and gradients
(float32, different summation orders), 1e-4 absolute for parameters after
several Adam steps.
"""

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

import gcm_tpu.config as jax_config
from gcm_tpu.edges.sparse_temporal import TemporalEdge as JaxTemporalEdge
from gcm_tpu.edges.temporal import TemporalBackedge as JaxTemporalBackedge
from gcm_tpu.nn.module import MLP as JaxMLP
from gcm_tpu.nn.module import Linear as JaxLinear
from gcm_tpu.rl import distributions as jdist
from gcm_tpu.rl import env as jenv
from gcm_tpu.rl.a2c import A2C as JaxA2C
from gcm_tpu.rl.a2c import discounted_returns as jax_discounted_returns
from gcm_tpu.rl.ppo import PPO as JaxPPO
from gcm_tpu.rl.ppo import gae as jax_gae
from gcm_tpu.rl.wrappers import GCMActorCritic as JaxGCMActorCritic
from gcm_tpu.rl.wrappers import (
    SparseGCMActorCritic as JaxSparseGCMActorCritic)
from gcm_tpu.serve.sessions import SessionServer as JaxSessionServer
from gcm_tpu.utils.debug import grad_norms as jax_grad_norms
from gcm_tpu_torch import (A2C, MLP, PPO, CartPoleEnv, Categorical,
                           ContinuousRecallEnv, DiagGaussian, GCMActorCritic,
                           Linear, RecallEnv, SessionServer,
                           SparseGCMActorCritic, TemporalBackedge,
                           TemporalEdge, TMazeEnv, discounted_returns, gae,
                           load_jax_params, named_from_jax, reset_where)
from gcm_tpu_torch.parallel.distributed import world_of_one
from gcm_tpu_torch.parallel.mesh import make_mesh
from gcm_tpu_torch.parallel.sharded_sparse import ShardedSparseGCM
from gcm_tpu_torch.rl import env as tenv

torch.set_num_threads(1)

ATOL, RTOL = 1e-5, 1e-4
ATOL_PARAMS = 1e-4
ZERO_GRAD = 1e-7  # a gradient that is zero up to float32 rounding
LR = 3e-3


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


def assert_close(got, want, atol=ATOL, rtol=RTOL, msg=""):
    got = got.detach().numpy() if torch.is_tensor(got) else np.asarray(got)
    np.testing.assert_allclose(got, np.asarray(want), atol=atol, rtol=rtol,
                               err_msg=msg)


# -- distributions ------------------------------------------------------------

def test_distributions_match_jax_and_their_laws():
    rng = np.random.default_rng(0)
    logits = rng.standard_normal((5, 7, 3)).astype(np.float32)
    actions = rng.integers(0, 3, (5, 7)).astype(np.int32)
    cat, jcat = Categorical(), jdist.Categorical()
    assert_close(cat.log_prob(t(logits), t(actions)),
                 jcat.log_prob(logits, actions), atol=1e-6)
    assert_close(cat.entropy(t(logits)), jcat.entropy(logits), atol=1e-6)
    gl = rng.standard_normal((5, 7, 4)).astype(np.float32) * 3
    ga = rng.standard_normal((5, 7, 2)).astype(np.float32)
    gauss, jgauss = DiagGaussian(2), jdist.DiagGaussian(2)
    assert_close(gauss.log_prob(t(gl), t(ga)), jgauss.log_prob(gl, ga),
                 atol=1e-5)
    assert_close(gauss.entropy(t(gl)), jgauss.entropy(gl), atol=1e-6)
    with pytest.raises(ValueError, match="2 \\* act_dim"):
        gauss.entropy(t(logits))
    done = t(np.array([True, False, True]))
    assert cat.neutral_action(3).tolist() == [0, 0, 0]
    assert cat.reset_prev(t(np.array([2, 1, 1])), done).tolist() == [0, 1, 0]
    assert gauss.reset_prev(torch.ones(3, 2), done)[:, 0].tolist() == \
        [0.0, 1.0, 0.0]

    # the laws of the samplers, n = 20,000 draws
    n = 20_000
    g = torch.Generator().manual_seed(1)
    row = torch.tensor([0.5, -1.0, 1.5, 0.0])
    draws = cat.sample(g, row.expand(n, 4))
    freq = np.bincount(draws.numpy(), minlength=4) / n
    p = torch.softmax(row, -1).numpy()
    assert np.all(np.abs(freq - p) <= 4.5 * np.sqrt(p * (1 - p) / n)), \
        (freq, p)
    mean, log_std = np.float32([0.3, -2.0]), np.float32([-1.0, 0.5])
    z = gauss.sample(g, t(np.tile(np.concatenate([mean, log_std]),
                                  (n, 1)))).numpy()
    std = np.exp(log_std)
    assert np.all(np.abs(z.mean(0) - mean) <= 4.5 * std / np.sqrt(n))
    assert np.all(np.abs(z.std(0) / std - 1) <= 4.5 / np.sqrt(2 * n))


# -- environments -------------------------------------------------------------

def port_state(env, jstate):
    """The JAX env state as the port's state tuple."""
    cls = {tenv.TMazeEnv: tenv.TMazeState, tenv.CartPoleEnv:
           tenv.CartPoleState, tenv.RecallEnv: tenv.RecallEnvState,
           tenv.ContinuousRecallEnv: tenv.ContinuousRecallState}[type(env)]
    return cls(*(t(a) for a in jstate))


def test_envs_teacher_forced_against_jax():
    """From JAX's states under the same actions: rewards, dones and the
    deterministic parts of the next state and observation equal (CartPole's
    dynamics within 1e-6); what is drawn anew only within its range."""
    B, steps = 64, 40
    g = torch.Generator().manual_seed(0)
    rng = np.random.default_rng(0)
    cases = [
        (jenv.TMazeEnv(3), TMazeEnv(3, device="cpu"), 3),
        (jenv.CartPoleEnv(horizon=30, masked_velocity=True,
                          reward_scale=0.05),
         CartPoleEnv(horizon=30, masked_velocity=True, reward_scale=0.05,
                     device="cpu"), 2),
        (jenv.CartPoleEnv(horizon=30), CartPoleEnv(horizon=30, device="cpu"),
         2),
        (jenv.RecallEnv(3, 5, 2), RecallEnv(3, 5, 2, device="cpu"), 3),
        (jenv.ContinuousRecallEnv(5, 2), ContinuousRecallEnv(5, 2,
                                                             device="cpu"),
         None),
    ]
    for jv, pv, n_act in cases:
        name = type(pv).__name__
        assert (pv.obs_dim, pv.horizon) == (jv.obs_dim, jv.horizon)
        _, jstate = jv.reset(jax.random.PRNGKey(1), B)
        obs, state = pv.reset(g, B)
        assert obs.shape == (B, jv.obs_dim) and obs.dtype == torch.float32
        jstep = jax.jit(jv.step)
        saw_done = False
        for i in range(steps):
            if n_act is None:
                a = rng.uniform(-1, 1, (B, 1)).astype(np.float32)
            else:
                a = rng.integers(0, n_act, B).astype(np.int32)
            jobs, jr, jd, jnext = jstep(jstate, a, jax.random.PRNGKey(i))
            obs, r, d, nxt = pv.step(port_state(pv, jstate), t(a), g)
            jd = np.asarray(jd)
            ended = t(jd)
            np.testing.assert_array_equal(d.numpy(), jd, err_msg=name)
            assert_close(r, jr, atol=1e-6, rtol=0, msg=name)
            keep = ~jd
            for field, got, want in zip(jnext._fields, nxt, jnext):
                got, want = got.numpy(), np.asarray(want)
                assert got.dtype == want.dtype, (name, field)
                np.testing.assert_allclose(got[keep], want[keep], atol=1e-6,
                                           err_msg=f"{name}.{field}")
            if name == "CartPoleEnv":
                fresh = torch.stack([a[ended] for a in nxt[:4]])
                assert bool((fresh.abs() <= 0.05).all())
                assert not nxt.t[ended].any()
                np.testing.assert_allclose(obs.numpy()[keep],
                                           np.asarray(jobs)[keep], atol=1e-6)
            elif name == "TMazeEnv":
                assert set(nxt.goal[ended].tolist()) <= {0, 1}
                np.testing.assert_array_equal(
                    obs.numpy()[:, 2:], np.asarray(jobs)[:, 2:])
            else:  # the cue / target, then the noise, then the query flag
                k = jv.obs_dim - jv.noise_dim - 1
                np.testing.assert_array_equal(obs.numpy()[keep][:, :k],
                                              np.asarray(jobs)[keep][:, :k])
                np.testing.assert_array_equal(obs.numpy()[:, -1],
                                              np.asarray(jobs)[:, -1])
            saw_done |= jd.any()
            jstate = jnext
        assert saw_done, name
    # the draws' laws: Recall's observation noise is N(0, 0.1^2)
    noise = torch.cat([RecallEnv(3, 5, 200, device="cpu").reset(g, 100)[0]
                       [:, 3:-1] for _ in range(5)])
    assert abs(float(noise.std()) - 0.1) < 0.002
    assert abs(float(noise.mean())) < 0.002


# -- the wrappers -------------------------------------------------------------

def policy_pair(core="ring", env=None, sparse=False, frozen=False, **cfg):
    """JAX's policy, its params, and the port's with the same weights;
    frozen adds a user preprocessor (Linear + tanh) with
    preprocessor_frozen."""
    env = env or jenv.RecallEnv(num_symbols=2, horizon=4, noise_dim=2)
    base = dict(graph_size=env.horizon + 1, gnn_input_size=16,
                gnn_output_size=16)
    jextra, extra = {}, {}
    if frozen:
        jextra = dict(preprocessor=JaxMLP([JaxLinear(16, 16), jnp.tanh]),
                      preprocessor_frozen=True)
        extra = dict(preprocessor=MLP([Linear(16, 16, device="cpu"),
                                       torch.tanh]),
                     preprocessor_frozen=True)
    if sparse:
        base.update(max_edges=64)
        jsel, sel = JaxTemporalEdge([1]), TemporalEdge([1])
    else:
        base["core"] = core
        jsel, sel = JaxTemporalBackedge([1, 2]), TemporalBackedge([1, 2])
    base.update(cfg)
    jcls, cls = ((JaxSparseGCMActorCritic, SparseGCMActorCritic) if sparse
                 else (JaxGCMActorCritic, GCMActorCritic))
    jpol = jcls(env.obs_dim, env.num_actions, env.num_actions,
                edge_selectors=jsel, **base, **jextra)
    pol = cls(env.obs_dim, env.num_actions, env.num_actions,
              edge_selectors=sel, device="cpu", **base, **extra)
    params = jpol.init(jax.random.PRNGKey(0))
    load_jax_params(pol, numpy_tree(params))
    return jpol, params, pol


def test_wrapper_config_validation_and_refusals():
    """Unknown config keys raise in both frameworks; a fast core given a
    selector it does not implement raises ValueError, as JAX asserts, and
    core="auto" resolves a temporal selector to "banded";
    mesh= builds the node-sharded core (plain selectors only); slot_k is
    derived from the selector."""
    with pytest.raises(ValueError, match="Invalid config key"):
        GCMActorCritic(4, 2, 2, device="cpu", bogus_key=1)
    with pytest.raises(AssertionError):
        JaxGCMActorCritic(4, 2, 2, bogus_key=1)
    for core, match in (("clique", "DenseEdge"), ("banded_scored",
                                                  "Distance")):
        with pytest.raises(ValueError, match=match):
            GCMActorCritic(4, 2, 2, core=core, device="cpu",
                           edge_selectors=TemporalBackedge([1]))
    pol = GCMActorCritic(4, 2, 2, core="auto", device="cpu",
                         edge_selectors=TemporalBackedge([1]))
    assert pol.cfg["core"] == "banded"
    with world_of_one("cpu"):  # mesh= builds the node-sharded core
        mesh = make_mesh(device_type="cpu")
        pol = SparseGCMActorCritic(4, 2, 2, mesh=mesh, device="cpu",
                                   graph_size=16, max_edges=64,
                                   edge_selectors=TemporalEdge([1]))
        assert isinstance(pol.core, ShardedSparseGCM)
        with pytest.raises(ValueError, match="plain selector"):
            SparseGCMActorCritic(4, 2, 2, mesh=mesh, device="cpu",
                                 max_hops=2, edge_selectors=TemporalEdge([1]))
    with pytest.raises(ValueError, match="dense core only"):
        GCMActorCritic(4, 2, 2, positional_encoding="relative",
                       device="cpu")
    pol = SparseGCMActorCritic(4, 2, 2, device="cpu", aggregation="slots",
                               graph_size=128,
                               edge_selectors=TemporalEdge([1, 2]))
    assert pol.core.slot_k == 2


@pytest.mark.parametrize("core, cfg", [
    ("ring", dict(use_prev_action=True)),
    ("dense", dict(use_prev_action=True)),
    ("ring", dict(positional_encoding="add")),
    ("ring", dict(positional_encoding="cat")),
    ("dense", dict(positional_encoding="relative")),
    ("sparse", dict(use_prev_action=True, graph_size=16)),
], ids=["ring_prev_action", "dense_prev_action", "ring_pe_add",
        "ring_pe_cat", "dense_pe_relative", "sparse_prev_action"])
def test_policy_matches_jax(core, cfg):
    """The policy's logits and values against JAX's over a trajectory that
    wraps the graph, with previous actions and dones; step == __call__."""
    B, T = 3, 11
    rng = np.random.default_rng(0)
    sparse = core == "sparse"
    jpol, params, pol = policy_pair(core, sparse=sparse, **cfg)
    T = 5 if sparse else T
    obs = rng.standard_normal((B, T, jpol.obs_dim)).astype(np.float32)
    prev = rng.integers(0, 2, (B, T)).astype(np.int32)
    dones = rng.random((B, T)) < 0.1
    kw = dict(prev_actions=prev, dones=dones)
    jl, jv, _ = jax.jit(lambda p: jpol(p, obs, jpol.initial_state(B),
                                       **kw))(params)
    with torch.no_grad():
        pl, pv, _ = pol(t(obs), pol.initial_state(B), prev_actions=t(prev),
                        dones=t(dones))
        assert_close(pl, jl)
        assert_close(pv, jv)
        if sparse:
            return
        state = pol.initial_state(B)
        for s in range(T):
            sl, sv, state = pol.step(t(obs[:, s]), state, t(prev[:, s]))
            assert_close(sl, jl[:, s], msg=f"step {s}")
            assert_close(sv, jv[:, s], msg=f"step {s}")
            state = reset_where(state, t(dones[:, s]))


def test_returns_and_gae_match_jax():
    rng = np.random.default_rng(0)
    r = rng.standard_normal((4, 9)).astype(np.float32)
    d = rng.random((4, 9)) < 0.3
    v = rng.standard_normal((4, 9)).astype(np.float32)
    assert_close(discounted_returns(t(r), t(d), 0.9),
                 jax_discounted_returns(r, d, 0.9), atol=1e-6)
    adv, ret = gae(t(r), t(v), t(d), 0.99, 0.95)
    jadv, jret = jax_gae(r, v, d, 0.99, 0.95)
    assert_close(adv, jadv, atol=1e-6)
    assert_close(ret, jret, atol=1e-6)


# -- the trainers -------------------------------------------------------------

def jax_collect(trainer, params, key, B):
    traj = jax.jit(trainer.collect, static_argnums=2)(params, key, B)
    return numpy_tree(traj)


def port_traj(traj):
    return {k: t(v) for k, v in traj.items()}


def compare_update(pol, params, grads, new_params, msg, clipped=False):
    """The port's gradients (in .grad; unless clipped) and parameters after
    its step against JAX's; a parameter whose gradient is zero up to
    rounding must be such a zero on both sides, and its update is not
    compared (Adam turns rounding noise into its sign)."""
    want_grads = named_from_jax(pol, numpy_tree(grads))
    want_params = named_from_jax(pol, numpy_tree(new_params))
    for name, p in pol.named_parameters():
        if not clipped:
            assert_close(p.grad, want_grads[name], msg=f"{msg}: grad {name}")
        if float(want_grads[name].abs().max()) < ZERO_GRAD:
            assert float(p.grad.abs().max()) < ZERO_GRAD, name
            continue
        assert_close(p, want_params[name], atol=ATOL_PARAMS, rtol=0,
                     msg=f"{msg}: {name} after the step")


@pytest.mark.parametrize("core", ["ring", "dense", "sparse"])
def test_a2c_loss_grads_and_step_match_jax(core):
    """A JAX-collected trajectory through both losses: the loss, its
    metrics, every gradient and their norms under JAX's tree paths, then
    one Adam step against optax's; on the ring, also a step clipped by
    max_grad_norm against optax.chain(clip_by_global_norm, adam)."""
    sparse = core == "sparse"
    if sparse:  # one TemporalEdge window a step; no episode crosses B rows
        jv, pv = (jenv.RecallEnv(2, 4, 2),
                  RecallEnv(2, 4, 2, device="cpu"))
        cfg = dict(use_prev_action=True, graph_size=8)
    else:  # episodes end mid-rollout; graph 5 is off the 16-row grid
        jv, pv = jenv.TMazeEnv(3), TMazeEnv(3, device="cpu")
        cfg = dict(use_prev_action=True, graph_size=5)
    jpol, params, pol = policy_pair(core, env=jv, sparse=sparse,
                                    frozen=core == "dense", **cfg)
    B, T = 6, 8
    jtr = JaxA2C(jv, jpol, lr=LR, rollout_len=T)
    traj = jax_collect(jtr, params, jax.random.PRNGKey(3), B)
    if not sparse:
        assert traj["dones"][:, :-1].any(), "no episode ended mid-rollout"
    (loss, metrics), grads = jax.jit(jax.value_and_grad(
        jtr.loss, has_aux=True))(params, traj)

    tr = A2C(pv, pol, lr=LR, rollout_len=T, log_grad_norms=True)
    total, pm = tr.loss(port_traj(traj))
    assert_close(total, loss, msg=f"{core}: loss")
    for k in ("pg", "v", "entropy", "return"):
        assert_close(pm[k], metrics[k], msg=f"{core}: {k}")
    norms = tr.apply(total)
    want_norms = jax_grad_norms(grads)
    assert set(norms) == set(want_norms), (sorted(norms), sorted(want_norms))
    for k, v in want_norms.items():
        assert_close(norms[k], v, msg=k)
    opt = optax.adam(LR)
    updates, _ = opt.update(grads, opt.init(params), params)
    compare_update(pol, params, grads, optax.apply_updates(params, updates),
                   f"{core} adam")
    if core == "dense":  # the frozen user preprocessor takes no gradient
        frozen = [p for n, p in pol.named_parameters()
                  if n.startswith("core.preprocessor.blocks.1")]
        assert len(frozen) == 2 and not any(bool(p.grad.any())
                                            for p in frozen)
    if core != "ring":
        return
    _, _, pol2 = policy_pair(core, env=jv, **cfg)
    tr2 = A2C(pv, pol2, lr=LR, rollout_len=T, max_grad_norm=0.05)
    tr2.apply(tr2.loss(port_traj(traj))[0])
    gnorm = float(optax.global_norm(grads))
    assert gnorm > 0.05, "the clip does not bite"
    chain = optax.chain(optax.clip_by_global_norm(0.05), optax.adam(LR))
    updates, _ = chain.update(grads, chain.init(params), params)
    compare_update(pol2, params, grads, optax.apply_updates(params, updates),
                   "ring clipped", clipped=True)


def test_ppo_learn_matches_jax_update():
    """PPO's learn on JAX's trajectory with JAX's per-epoch permutations:
    the parameters after epochs x minibatches = 4 Adam steps against JAX's
    jitted update from the same key."""
    jv, pv = jenv.RecallEnv(2, 4, 2), RecallEnv(2, 4, 2, device="cpu")
    jpol, params, pol = policy_pair("ring", env=jv, use_prev_action=True)
    B = 4
    kw = dict(lr=LR, epochs=2, num_minibatches=2)
    jtr = JaxPPO(jv, jpol, **kw)
    key = jax.random.PRNGKey(5)
    new_params, _, metrics = jtr.update(params, jtr.opt.init(params), key, B)
    k_collect, k_perm = jax.random.split(key)
    traj = jax_collect(jtr, params, k_collect, B)
    perms = [t(jax.random.permutation(k, B))
             for k in jax.random.split(k_perm, jtr.epochs)]
    tr = PPO(pv, pol, **kw)
    got = tr.learn(port_traj(traj), perms)
    assert_close(got["loss"], metrics["loss"], msg="mean loss")
    assert_close(got["return"], metrics["return"], msg="return")
    want = named_from_jax(pol, numpy_tree(new_params))
    for name, p in pol.named_parameters():
        assert_close(p, want[name], atol=ATOL_PARAMS, rtol=0, msg=name)


def test_replay_dones_false_is_checked():
    """replay_dones=False gives the same loss where episodes end only at
    the rollout's last step, and raises where one ends before it (the
    precondition JAX leaves unchecked)."""
    jv, pv = jenv.RecallEnv(2, 4, 2), RecallEnv(2, 4, 2, device="cpu")
    jpol, params, pol = policy_pair("ring", env=jv)
    traj = port_traj(jax_collect(JaxA2C(jv, jpol), params,
                                 jax.random.PRNGKey(0), 4))
    with torch.no_grad():
        a = A2C(pv, pol).loss(traj)[0]
        b = A2C(pv, pol, replay_dones=False).loss(traj)[0]
    assert_close(b, a.numpy(), atol=1e-6)
    traj["dones"][0, 1] = True
    with pytest.raises(ValueError, match="replay_dones=False"):
        A2C(pv, pol, replay_dones=False).loss(traj)
    with world_of_one("cpu"):  # dp_mesh= builds; a world of one is dp 1
        tr = A2C(pv, pol, dp_mesh=make_mesh(device_type="cpu"))
        assert tr.dp == 1
        traj["dones"][0, 1] = False
        with torch.no_grad():
            assert_close(tr.loss(tr._own(traj))[0], a.numpy(), atol=1e-6)


def test_from_policy_matches_jax_server():
    """SessionServer.from_policy against JAX's over ticks with arrivals and
    an ended session: logits and values at 1e-5; both refuse a policy that
    uses the previous action."""
    jpol, params, pol = policy_pair("ring")
    srv = SessionServer.from_policy(pol, capacity=4)
    jsrv = JaxSessionServer.from_policy(jpol, params, capacity=4)
    rng = np.random.default_rng(0)
    for tick in range(9):
        sids = [s for s in ("a", "b", "c", "d", "e") if rng.random() < 0.7]
        if tick == 4:
            srv.end_session("a")
            jsrv.end_session("a")
        reqs = {s: rng.standard_normal(jpol.obs_dim).astype(np.float32)
                for s in sids[:4]}
        got, want = srv.step(reqs), jsrv.step(reqs)
        for s in reqs:
            assert_close(got[s]["logits"], want[s]["logits"], msg=s)
            assert_close(got[s]["value"], want[s]["value"], msg=s)
    jp, _, p = policy_pair("ring", use_prev_action=True)
    with pytest.raises(ValueError, match="use_prev_action"):
        SessionServer.from_policy(p, capacity=2)
    with pytest.raises(AssertionError):
        JaxSessionServer.from_policy(jp, params, capacity=2)
