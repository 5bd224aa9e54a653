"""The port's navigation memory (gcm_tpu_torch/models/nav_gcm.py,
nn/nav_conv.py, rl/nav.py) against the JAX package's, on the CPU.

The same seeded numpy inputs and the same weights (JAX's params loaded with
`load_jax_params`) go through both; the JAX side runs jitted.

- NavRelPosConv and NavPoseGNN: outputs at 1e-5, translation invariance.
- NavGCM in causal (radius and kNN, ragged taus, chained windows, a
  pose GNN), full (non-causal) and pool modes: outputs and states at 1e-5,
  the adjacency masks exactly JAX's on seeded continuous positions, and
  every parameter's gradient against jax.grad at 1e-5.
- NavGCMIncremental against JAX's incremental core (outputs, states and
  caches at 1e-5) and against the port's NavGCM(causal=True) at 1e-5 over
  chained ragged windows (a window of tau 0 included), dense and pose
  GNNs, radius and kNN.
- nav_core's dispatch and structural fallbacks.
- PointGoalNav bitwise against JAX's under the same actions and seeds.
- NavActorCritic: collect (the incremental core, tick by tick) == replay
  (the full core, one call) at 1e-5, both against JAX's policy at 1e-5.
- make_nav_a2c_update: the gradients against JAX's (captured from its
  jitted update) and one step of clip_by_global_norm(0.5) + Adam against
  optax's at 1e-5 (parameters after the step at 1e-5, with the ZERO_GRAD
  rule of tests/test_torch_port_training.py).
- Lattice poses (PointGoalNav trajectories: turning in place repeats a
  pose): an adjacency entry may differ from JAX's only where the float64
  distance lies within 1e-5 of the radius or of the k-th distance; the
  GNN is then held to JAX teacher-forced, on JAX's adjacency.
"""

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

import gcm_tpu as jg
from gcm_tpu.models.nav_gcm import NavDenseGNN as JNavDenseGNN
from gcm_tpu.models.nav_gcm import NavGCM as JNavGCM
from gcm_tpu.models.nav_gcm import NavGCMIncremental as JNavGCMIncremental
from gcm_tpu.nn.dense_conv import DenseGraphConv as JDenseGraphConv
from gcm_tpu.nn.nav_conv import NavPoseGNN as JNavPoseGNN
from gcm_tpu.nn.nav_conv import NavRelPosConv as JNavRelPosConv
from gcm_tpu.rl.nav import NavActorCritic as JNavActorCritic
from gcm_tpu.rl.nav import PointGoalNav as JPointGoalNav
from gcm_tpu.rl.nav import make_nav_a2c_update as jax_make_nav_a2c_update
from gcm_tpu_torch import (DenseGraphConv, NavActorCritic, NavDenseGNN,
                           NavGCM, NavGCMIncremental, NavPoseGNN,
                           NavRelPosConv, PointGoalNav, load_jax_params,
                           make_nav_a2c_update, named_from_jax,
                           nav_inc_state_to_numpy, nav_state_to_numpy)
from gcm_tpu_torch.models import nav_gcm
from gcm_tpu_torch.models.nav_gcm import pair_distance

torch.set_num_threads(1)

ATOL = 1e-5
ZERO_GRAD = 1e-7  # a gradient that is zero up to float32 rounding
MARGIN = 1e-5     # an adjacency entry this close to its cut may flip


def t(a):
    return torch.from_numpy(np.array(a))


def numpy_tree(tree):
    return jax.tree_util.tree_map(np.asarray, tree)


def close(got, want, atol=ATOL, msg=""):
    got = got.detach().numpy() if torch.is_tensor(got) else np.asarray(got)
    np.testing.assert_allclose(got, np.asarray(want), atol=atol, rtol=0,
                               err_msg=msg)


def gnn_pair(kind, in_dim, widths=(4, 4), aggr="add"):
    """(JAX gnn, port gnn) of the same layers: 'dense' (NavDenseGNN of
    DenseGraphConv + tanh, pose concatenated) or 'pose' (NavPoseGNN of
    NavRelPosConv + tanh)."""
    jl, tl, d = [], [], in_dim
    for w in widths:
        if kind == "dense":
            jl += [JDenseGraphConv(d + 3 if not jl else d, w, aggr=aggr),
                   jnp.tanh]
            tl += [DenseGraphConv(d + 3 if not tl else d, w, aggr=aggr,
                                  device="cpu"), torch.tanh]
        else:
            jl += [JNavRelPosConv(d, w), jnp.tanh]
            tl += [NavRelPosConv(d, w, device="cpu"), torch.tanh]
        d = w
    if kind == "dense":
        return JNavDenseGNN(jl), NavDenseGNN(tl)
    return JNavPoseGNN(jl), NavPoseGNN(tl)


def core_pair(kind="dense", incremental=False, feat=2, V=16, **kw):
    """(JAX core, its params, port core with those weights)."""
    jgnn, tgnn = gnn_pair(kind, feat, aggr=kw.pop("aggr", "add"))
    if incremental:
        jc = JNavGCMIncremental(jgnn, max_verts=V, **kw)
        tc = NavGCMIncremental(tgnn, max_verts=V, device="cpu", **kw)
    else:
        jc = JNavGCM(jgnn, max_verts=V, **kw)
        tc = NavGCM(tgnn, max_verts=V, device="cpu", **kw)
    params = jc.init(jax.random.PRNGKey(0))
    load_jax_params(tc, numpy_tree(params))
    return jc, params, tc


def windows(seed, B, taus_seq, feat=2, scale=2.0):
    """Seeded continuous inputs, one (x, pos, rot, taus) a window."""
    rng = np.random.default_rng(seed)
    out = []
    for taus in taus_seq:
        taus = np.asarray(taus, np.int32)
        w = max(int(taus.max()), 1)
        out.append((rng.standard_normal((B, w, feat)).astype(np.float32),
                    (rng.standard_normal((B, w, 2)) * scale).astype(
                        np.float32),
                    rng.standard_normal((B, w, 1)).astype(np.float32), taus))
    return out


def run_chain(core, params, state, wins, jax_side):
    """Outputs of each window and the last state."""
    outs = []
    if jax_side:
        call = jax.jit(core.__call__)
        for x, pos, rot, taus in wins:
            o, state = call(params, x, pos, rot, taus, state)
            outs.append(np.asarray(o))
        return outs, state
    for x, pos, rot, taus in wins:
        o, state = core(t(x), t(pos), t(rot), t(taus), state)
        outs.append(o)
    return outs, state


# -- the conv -----------------------------------------------------------------

def test_nav_conv_and_pose_gnn_match_jax():
    """NavRelPosConv alone and a NavPoseGNN stack against JAX's at 1e-5;
    a uniform shift of every position changes nothing, moving one node
    does."""
    rng = np.random.default_rng(0)
    B, V = 2, 7
    x = rng.standard_normal((B, V, 3)).astype(np.float32)
    pos = rng.standard_normal((B, V, 2)).astype(np.float32)
    rot = rng.standard_normal((B, V, 1)).astype(np.float32)
    adj = rng.random((B, V, V)) < 0.5
    jconv, conv = JNavRelPosConv(3, 5, hidden=6), NavRelPosConv(
        3, 5, hidden=6, device="cpu")
    p = jconv.init(jax.random.PRNGKey(1))
    load_jax_params(conv, numpy_tree(p))
    want = jconv(p, x, adj, pos, rot)
    got = conv(t(x), t(adj), t(pos), t(rot))
    close(got, want, msg="NavRelPosConv")
    jgnn, gnn = gnn_pair("pose", 3)
    p = jgnn.init(jax.random.PRNGKey(2))
    load_jax_params(gnn, numpy_tree(p))
    with torch.no_grad():
        got = gnn(t(x), t(adj), t(pos), t(rot))
        close(got, jgnn(p, x, adj, pos, rot, None, None, None),
              msg="NavPoseGNN")
        close(gnn(t(x), t(adj), t(pos) + 7.0, t(rot)), got.numpy())
        moved = pos.copy()
        moved[0, 2] += 1.0
        assert not np.allclose(gnn(t(x), t(adj), t(moved), t(rot)).numpy(),
                               got.numpy(), atol=1e-3)


# -- NavGCM -------------------------------------------------------------------

NAV_CASES = {
    "causal_radius": dict(kind="dense", edge_method="radius", k=3, r=2.5,
                          taus=[[3, 4], [4, 0], [1, 4]]),
    "causal_knn": dict(kind="dense", edge_method="knn", k=2,
                       taus=[[4, 4], [4, 4], [4, 4]]),
    "causal_pose_gnn": dict(kind="pose", edge_method="radius", k=3, r=2.5,
                            taus=[[3, 4], [4, 2]]),
    "full_radius": dict(kind="dense", edge_method="radius", k=3, r=2.5,
                        causal=False, taus=[[3, 5], [4, 2]]),
    "full_knn": dict(kind="dense", edge_method="knn", k=2, causal=False,
                     taus=[[5, 5]]),
    "pool": dict(kind="dense", edge_method="radius", k=16, r=3.0, pool=True,
                 taus=[[3, 4], [4, 4]]),
    "mean_aggr": dict(kind="dense", edge_method="radius", k=3, r=2.5,
                      aggr="mean", taus=[[4, 3]]),
}


@pytest.mark.parametrize("case", list(NAV_CASES))
def test_nav_gcm_matches_jax(case):
    """Chained windows: outputs and states at 1e-5, the adjacency of the
    last state exactly JAX's, and every parameter's gradient (through the
    last window, from the carried state) against jax.grad at 1e-5."""
    cfg = dict(NAV_CASES[case])
    kind, taus_seq = cfg.pop("kind"), cfg.pop("taus")
    B = 2
    jc, params, tc = core_pair(kind, **cfg)
    wins = windows(1, B, taus_seq)
    jouts, jstate = run_chain(jc, params, jc.initial_state(B, 2), wins[:-1],
                              True)
    with torch.no_grad():
        touts, tstate = run_chain(tc, None, tc.initial_state(B, 2),
                                  wins[:-1], False)
    for i, (a, b) in enumerate(zip(touts, jouts)):
        close(a, b, msg=f"{case} window {i}")

    # the adjacency over the state's nodes, exactly JAX's
    pos = np.asarray(jstate.pos)
    valid = np.arange(16)[None] < np.asarray(jstate.t)[:, None]
    want_adj = np.asarray(jc._edges(jnp.asarray(pos), jnp.asarray(valid)))
    got_adj = tc._edges(pair_distance(t(pos), t(pos)), t(valid))
    np.testing.assert_array_equal(got_adj.numpy(), want_adj, err_msg=case)

    # the last window under gradients
    x, p, r, taus = wins[-1]

    def jloss(prm):
        o, s = jc(prm, x, p, r, taus, jstate)
        return jnp.sum(o ** 2), (o, s)

    (_, (jo, js)), jgrads = jax.jit(jax.value_and_grad(
        jloss, has_aux=True))(params)
    o, s = tc(t(x), t(p), t(r), t(taus), tstate)
    close(o, jo, msg=f"{case} last window")
    for field, a, b in zip(js._fields, nav_state_to_numpy(s), js):
        close(a, b, msg=f"{case} state.{field}")
    torch.sum(o ** 2).backward()
    want = named_from_jax(tc, numpy_tree(jgrads))
    assert want
    for name, prm in tc.named_parameters():
        close(prm.grad, want[name], msg=f"{case} grad {name}")


@pytest.mark.parametrize("kind, edge_method, k", [
    ("dense", "radius", 3), ("dense", "knn", 2), ("pose", "radius", 3)],
    ids=["dense_radius", "dense_knn", "pose_radius"])
def test_incremental_matches_jax_and_full_core(kind, edge_method, k):
    """NavGCMIncremental over chained ragged windows (one of tau 0 for an
    element): outputs and states (caches included) against JAX's
    incremental core at 1e-5, outputs and x/pos/rot/t against the port's
    NavGCM(causal=True) at 1e-5."""
    B = 2
    cfg = dict(edge_method=edge_method, k=k, r=2.5)
    jc, params, tc = core_pair(kind, incremental=True, **cfg)
    _, _, full = core_pair(kind, **cfg)
    wins = windows(7, B, [[3, 4], [4, 0], [1, 4], [4, 3]])
    jouts, jstate = run_chain(jc, params, jc.initial_state(B, 2), wins, True)
    with torch.no_grad():
        touts, tstate = run_chain(tc, None, tc.initial_state(B, 2), wins,
                                  False)
        fouts, fstate = run_chain(full, None, full.initial_state(B, 2), wins,
                                  False)
    for i, (a, b, f) in enumerate(zip(touts, jouts, fouts)):
        close(a, b, msg=f"window {i} vs JAX")
        close(a, f.numpy(), msg=f"window {i} vs the full core")
    got = nav_inc_state_to_numpy(tstate)
    for a, b in zip(got.caches, jstate.caches):
        close(a, b, msg="caches")
    for field in ("x", "pos", "rot", "t"):
        close(getattr(got, field), getattr(jstate, field), msg=field)
        close(getattr(got, field), getattr(fstate, field).numpy(), msg=field)


def test_incremental_gradients_match_jax():
    """The incremental core's parameter gradients against jax.grad."""
    B = 2
    jc, params, tc = core_pair("dense", incremental=True, k=3, r=2.5)
    (x, p, r, taus), = windows(3, B, [[4, 4]])

    def jloss(prm):
        return jnp.sum(jc(prm, x, p, r, taus, jc.initial_state(B, 2))[0]
                       ** 2)

    jgrads = jax.jit(jax.grad(jloss))(params)
    o, _ = tc(t(x), t(p), t(r), t(taus), tc.initial_state(B, 2))
    torch.sum(o ** 2).backward()
    want = named_from_jax(tc, numpy_tree(jgrads))
    for name, prm in tc.named_parameters():
        close(prm.grad, want[name], msg=name)


def test_nav_core_dispatch(monkeypatch):
    """nav_core: the incremental core from NAV_INCREMENTAL_MIN_V on, NavGCM
    below it and wherever the incremental core cannot run (non-causal,
    pooled, a GNN it cannot cache); its constructor refuses such a GNN."""
    monkeypatch.setattr(nav_gcm, "NAV_INCREMENTAL_MIN_V", 64)
    _, gnn = gnn_pair("dense", 1)
    core = nav_gcm.nav_core(gnn, max_verts=64, device="cpu")
    assert isinstance(core, NavGCMIncremental)
    assert type(nav_gcm.nav_core(gnn, max_verts=48, device="cpu")) is NavGCM
    for kw in (dict(causal=False), dict(pool=True)):
        c = nav_gcm.nav_core(gnn, max_verts=64, device="cpu", **kw)
        assert type(c) is NavGCM
    assert nav_gcm.nav_core(gnn, max_verts=64, pool=True, device="cpu").pool

    class Opaque(torch.nn.Module):
        layers = None

    assert type(nav_gcm.nav_core(Opaque(), max_verts=64,
                                 device="cpu")) is NavGCM
    conv_only = NavDenseGNN([torch.nn.Linear(4, 4)])
    assert not NavGCMIncremental.supports(conv_only)
    with pytest.raises(TypeError, match="NavDenseGNN or NavPoseGNN"):
        NavGCMIncremental(conv_only, device="cpu")
    with pytest.raises(ValueError, match="edge_method"):
        NavGCM(gnn, edge_method="ball", device="cpu")
    # the JAX package's dispatch takes the same structural fallbacks
    jgnn, _ = gnn_pair("dense", 1)
    V = jg.config.NAV_INCREMENTAL_MIN_V
    assert isinstance(jg.nav_core(jgnn, max_verts=V), JNavGCMIncremental)
    assert not isinstance(jg.nav_core(jgnn, max_verts=V, pool=True),
                          JNavGCMIncremental)


# -- the task and the policy --------------------------------------------------

def test_point_goal_nav_matches_jax_bitwise():
    """The same seeds and actions: every observation, reward and done of
    the port's PointGoalNav equal to JAX's bit for bit."""
    rng = np.random.default_rng(0)
    for seed in range(3):
        je = JPointGoalNav(horizon=12, rng=np.random.default_rng(seed))
        pe = PointGoalNav(horizon=12, rng=np.random.default_rng(seed))
        np.testing.assert_array_equal(pe.reset(), je.reset())
        for _ in range(40):
            a = int(rng.integers(0, 3))
            (po, pr, pd), (jo, jr, jd) = pe.step(a), je.step(a)
            np.testing.assert_array_equal(po, jo)
            assert (pr, pd) == (jr, jd)
            if pd:
                np.testing.assert_array_equal(pe.reset(), je.reset())


def policy_pair(V=16, hidden=8, k=4):
    jpol = JNavActorCritic(5, 3, max_verts=V, hidden=hidden, k=k, r=2.5)
    pol = NavActorCritic(5, 3, max_verts=V, hidden=hidden, k=k, r=2.5,
                         device="cpu")
    params = jpol.init(jax.random.PRNGKey(0))
    load_jax_params(pol, numpy_tree(params))
    return jpol, params, pol


def jax_episodes(jpol, params, B, T, seed):
    """B PointGoalNav episodes of T steps collected greedily by JAX's
    policy (tick by tick), with its logits: (obs [B, T, 5], prev actions
    [B, T], logits [B, T, 3])."""
    envs = [JPointGoalNav(horizon=T + 4, rng=np.random.default_rng(seed + i))
            for i in range(B)]
    obs = np.stack([e.reset() for e in envs])
    mem = jpol.initial_state(B)
    prev = np.zeros(B, np.int32)
    step = jax.jit(jpol.step)
    o_seq, p_seq, l_seq = [], [], []
    for _ in range(T):
        logits, _, mem = step(params, obs, mem, prev_action=prev)
        act = np.asarray(jnp.argmax(logits, -1)).astype(np.int32)
        o_seq.append(obs)
        p_seq.append(prev)
        l_seq.append(np.asarray(logits))
        obs = np.stack([e.step(int(a))[0] for e, a in zip(envs, act)])
        prev = act
    return (np.stack(o_seq, 1), np.stack(p_seq, 1), np.stack(l_seq, 1))


def test_nav_actor_critic_step_equals_replay_and_jax():
    """Collect (the incremental core, tick by tick) == replay (NavGCM, one
    call) at 1e-5, each against JAX's policy at 1e-5, ragged taus in the
    replay."""
    jpol, params, pol = policy_pair()
    B, T = 3, 8
    obs, prev, jlogits = jax_episodes(jpol, params, B, T, seed=3)
    taus = np.array([8, 5, 7], np.int32)
    jl, jv, _ = jax.jit(lambda p: jpol(p, obs, None, prev_actions=prev,
                                       taus=taus))(params)
    with torch.no_grad():
        state = pol.initial_state(B)
        steps = []
        for s in range(T):
            lg, _, state = pol.step(t(obs[:, s]), state, t(prev[:, s]))
            steps.append(lg)
        steps = torch.stack(steps, 1)
        close(steps, jlogits, msg="collect vs JAX")
        rl, rv, _ = pol(t(obs), None, prev_actions=t(prev), taus=t(taus))
    valid = np.arange(T)[None] < taus[:, None]
    close(rl, jl, msg="replay vs JAX")
    close(rv, jv, msg="values vs JAX")
    close(rl.numpy()[valid], steps.numpy()[valid], msg="collect vs replay")


def capture_grads():
    """An optax transform that passes the updates on unchanged and keeps
    them as its state: put first in a chain, it reads JAX's gradients out
    of the jitted update that also takes the chain's step."""
    return optax.GradientTransformation(
        lambda p: jax.tree_util.tree_map(jnp.zeros_like, p),
        lambda u, s, p=None: (u, u))


def nav_batch(seed, B=4, T=6):
    rng = np.random.default_rng(seed)
    obs = rng.standard_normal((B, T, 5)).astype(np.float32) * 2
    taus = np.array([6, 4, 6, 2], np.int32)[:B]
    valid = np.arange(T)[None] < taus[:, None]
    acts = rng.integers(0, 3, (B, T)).astype(np.int32) * valid
    prev = np.concatenate([np.zeros((B, 1), np.int32), acts[:, :-1]],
                          1) * valid
    return {"obs": obs * valid[..., None], "actions": acts,
            "prev_actions": prev.astype(np.int32),
            "returns": (rng.standard_normal((B, T)) * valid).astype(
                np.float32), "taus": taus, "valid": valid}


def check_update(pol, params, jupdate_for, port_update_for, batch):
    """The loss, its metrics and the port's gradients against JAX's (read
    by capture_grads), and one step clipped at 0.5 + Adam(5e-4) against
    optax.chain(clip_by_global_norm(0.5), adam(5e-4)): one jitted JAX
    update gives both."""
    tb = {k: t(v) for k, v in batch.items()}
    chain = optax.chain(capture_grads(), optax.clip_by_global_norm(0.5),
                        optax.adam(5e-4))
    new_params, state, jm = jupdate_for(chain)(params, chain.init(params),
                                               batch)
    grads = state[0]
    pm = port_update_for(pol, torch.optim.SGD(pol.parameters(), lr=0.0),
                         None)(tb)
    for k in ("loss", "pg", "v", "entropy"):
        close(pm[k], jm[k], msg=k)
    want = named_from_jax(pol, numpy_tree(grads))
    for name, p in pol.named_parameters():
        close(p.grad, want[name], msg=f"grad {name}")
    assert float(optax.global_norm(grads)) > 0.5, "the clip does not bite"

    adam = torch.optim.Adam(pol.parameters(), lr=5e-4)
    port_update_for(pol, adam, 0.5)(tb)
    want_p = named_from_jax(pol, numpy_tree(new_params))
    for name, p in pol.named_parameters():
        if float(want[name].abs().max()) < ZERO_GRAD:
            assert float(p.grad.abs().max()) < ZERO_GRAD, name
            continue
        close(p, want_p[name], msg=f"{name} after the step")


def test_nav_a2c_update_matches_optax():
    jpol, params, pol = policy_pair()
    check_update(
        pol, params,
        lambda opt: jax_make_nav_a2c_update(jpol, opt, entropy_coef=0.03),
        lambda p, opt, clip: make_nav_a2c_update(p, opt, entropy_coef=0.03,
                                                 max_grad_norm=clip),
        nav_batch(0))


def test_lattice_poses_flip_only_under_the_margin():
    """PointGoalNav odometry (a lattice of 45-degree headings; turning in
    place repeats a pose): the full core's adjacency against JAX's, radius
    and kNN (k = 8 caps both); a differing entry must lie within MARGIN of
    its cut in float64 (the radius or the k-th candidate distance). These
    trajectories do flip entries at tied k-th distances. The GNN's
    features are then held to JAX's teacher-forced, on JAX's adjacency, at
    1e-5."""
    B, T, V, r, k = 16, 24, 26, 2.5, 8
    rng = np.random.default_rng(5)
    pos = np.zeros((B, V, 2), np.float32)
    for b in range(B):
        env = PointGoalNav(horizon=100, rng=np.random.default_rng(b))
        env.reset()
        for s in range(T):
            pos[b, s] = env.pos
            env.step(int(rng.choice(3, p=[0.35, 0.15, 0.5])))
    valid = np.arange(V)[None] < T
    valid = np.broadcast_to(valid, (B, V))
    d64 = np.linalg.norm(pos[:, :, None].astype(np.float64)
                         - pos[:, None].astype(np.float64), axis=-1)
    cand = valid[:, :, None] & valid[:, None, :] & (
        np.arange(V)[None, :] < np.arange(V)[:, None])
    x = rng.standard_normal((B, V, 2)).astype(np.float32)
    rot = rng.standard_normal((B, V, 1)).astype(np.float32)
    flips = 0
    for edge_method in ("radius", "knn"):
        jc, params, tc = core_pair("dense", V=V, edge_method=edge_method,
                                   k=k, r=r)
        want = np.asarray(jc._edges(jnp.asarray(pos), jnp.asarray(valid)))
        got = tc._edges(pair_distance(t(pos), t(pos)), t(valid)).numpy()
        within = cand & (d64 <= r) if edge_method == "radius" else cand
        kth = np.sort(np.where(within, d64, np.inf), -1)[..., k - 1:k]
        margin = np.abs(d64 - kth)
        if edge_method == "radius":
            margin = np.minimum(margin, np.abs(d64 - r))
        differ = got != want
        assert (margin[differ] < MARGIN).all(), (edge_method,
                                                 margin[differ])
        flips += int(differ.sum())
        feats = jc.gnn(params["gnn"], x, jnp.asarray(want), pos, rot, valid,
                       None, None)
        with torch.no_grad():
            tf = tc.gnn(t(x), t(want), t(pos), t(rot))
        close(tf, feats, msg=f"{edge_method} teacher-forced")
    assert flips > 0, "no tie flipped: the case tests nothing"
