"""Navigation RL over NavGCM (counterpart of gcm_tpu/rl/nav.py).

- `PointGoalNav`: a host point-goal task in numpy (the port's own copy of
  the JAX package's): the goal vector shows only at t = 0, so the policy
  must remember it while odometry (pos, rot) streams in.
- `NavActorCritic`: actor-critic heads over a nav memory core. Collection
  steps through `NavGCMIncremental` (tau = 1 rows a tick, no dense kernel);
  training replays whole episodes through `NavGCM` in one time-batched
  call (the one-layer kernel a conv, its backward the stack backward's).
  The two give the same beliefs, so collect-time and replay-time beliefs
  match.
- `make_nav_a2c_update`: the A2C step of rl/external.py's workflow over
  the whole-window nav core (pose rides in the observation's tail
  channels through the buffer).
"""

from __future__ import annotations

import numpy as np
import torch
from torch import nn

from gcm_tpu_torch.device import resolve_device
from gcm_tpu_torch.models.nav_gcm import (NavDenseGNN, NavGCM,
                                          NavGCMIncremental)
from gcm_tpu_torch.nn.dense_conv import DenseGraphConv
from gcm_tpu_torch.nn.module import Linear
from gcm_tpu_torch.rl.external import a2c_update


class PointGoalNav:
    """Host point-goal navigation with memory: obs = [goal_dx, goal_dy,
    pos_x, pos_y, heading]; the goal channels are non-zero ONLY on the first
    step of the episode. Actions: 0 turn left, 1 turn right, 2 forward.
    Reward: potential-based (distance decrease), +1 bonus on reaching the
    goal. Episode ends on goal or horizon."""

    def __init__(self, horizon: int = 24, goal_radius: float = 3.0,
                 step_size: float = 1.0, reach: float = 1.0, rng=None):
        self.horizon = horizon
        self.goal_radius = goal_radius
        self.step_size = step_size
        self.reach = reach
        self.obs_dim = 5  # goal(2) + pos(2) + rot(1)
        self.num_actions = 3
        self.rng = rng or np.random.default_rng(0)

    def _obs(self, show_goal: bool) -> np.ndarray:
        goal = self.goal - self.pos if show_goal else np.zeros(2)
        return np.concatenate(
            [goal, self.pos, [self.theta]]).astype(np.float32)

    def reset(self) -> np.ndarray:
        self.pos = np.zeros(2, np.float64)
        self.theta = 0.0
        ang = self.rng.uniform(0, 2 * np.pi)
        self.goal = self.goal_radius * np.array([np.cos(ang), np.sin(ang)])
        self.t = 0
        return self._obs(show_goal=True)

    def step(self, action: int):
        if action == 0:
            self.theta += np.pi / 4
        elif action == 1:
            self.theta -= np.pi / 4
        else:
            self.pos = self.pos + self.step_size * np.array(
                [np.cos(self.theta), np.sin(self.theta)])
        prev_d = np.linalg.norm(self.goal - (
            self.pos - (self.step_size * np.array(
                [np.cos(self.theta), np.sin(self.theta)])
                if action == 2 else 0.0)))
        d = np.linalg.norm(self.goal - self.pos)
        self.t += 1
        reached = d < self.reach
        done = reached or self.t >= self.horizon
        rew = (prev_d - d) + (1.0 if reached else 0.0)
        return self._obs(show_goal=False), float(rew), bool(done)


class NavActorCritic(nn.Module):
    """Actor-critic over a NavGCM memory core. Observations carry the pose
    in their TAIL pose_dim channels (pos the first pos_dim of them, rot the
    rest); the head channels (and the previous action's one-hot) are the
    node features, the pose concatenated back by NavDenseGNN."""

    def __init__(self, obs_dim: int, num_actions: int, pose_dim: int = 3,
                 pos_dim: int = 2, hidden: int = 16, max_verts: int = 32,
                 edge_method: str = "radius", k: int | None = 8,
                 r: float = 2.5, use_prev_action: bool = True, *,
                 device=None, generator: torch.Generator | None = None):
        super().__init__()
        self.device = resolve_device(device)
        self.obs_dim = obs_dim
        self.num_actions = num_actions
        self.pose_dim = pose_dim
        self.pos_dim = pos_dim
        self.use_prev_action = use_prev_action
        self.feat_dim = obs_dim - pose_dim + (
            num_actions if use_prev_action else 0)
        kw = dict(device=self.device, generator=generator)
        gnn = NavDenseGNN([
            DenseGraphConv(self.feat_dim + pose_dim, hidden, **kw),
            torch.tanh,
            DenseGraphConv(hidden, hidden, **kw), torch.tanh,
        ])
        cores = dict(max_verts=max_verts, edge_method=edge_method, k=k, r=r,
                     device=self.device)
        self.core_train = NavGCM(gnn, causal=True, **cores)
        self.core_step = NavGCMIncremental(gnn, **cores)
        self.logit_branch = Linear(hidden, num_actions, init=("normc", 0.01),
                                   **kw)
        self.value_branch = Linear(hidden, 1, init=("normc", 0.01), **kw)

    def initial_state(self, B: int, dtype=torch.float32):
        """Collection-time state (the incremental core's)."""
        return self.core_step.initial_state(
            B, self.feat_dim, pos_dim=self.pos_dim,
            rot_dim=self.pose_dim - self.pos_dim, dtype=dtype)

    def _split(self, obs, prev_actions):
        """obs [..., obs_dim] -> (node features, pos, rot)."""
        feat = obs[..., : self.obs_dim - self.pose_dim]
        pose = obs[..., self.obs_dim - self.pose_dim:]
        if self.use_prev_action:
            onehot = nn.functional.one_hot(prev_actions.long(),
                                           self.num_actions)
            feat = torch.cat([feat, onehot.to(obs.dtype)], dim=-1)
        return feat, pose[..., : self.pos_dim], pose[..., self.pos_dim:]

    def _heads(self, belief):
        return self.logit_branch(belief), self.value_branch(belief)[..., 0]

    def step(self, obs, state, prev_action=None):
        """One tick through the incremental core: obs [B, obs_dim] ->
        (logits [B, A], value [B], state)."""
        B = obs.shape[0]
        if prev_action is None:
            prev_action = torch.zeros((B,), dtype=torch.int64,
                                      device=obs.device)
        feat, pos, rot = self._split(obs[:, None, :], prev_action[:, None])
        taus = torch.ones((B,), dtype=torch.int32, device=obs.device)
        belief, state = self.core_step(feat, pos, rot, taus, state)
        return (*self._heads(belief[:, 0]), state)

    def forward(self, obs_seq, state=None, prev_actions=None, taus=None):
        """Whole episodes in one time-batched NavGCM call: obs_seq [B, T,
        obs_dim] -> (logits [B, T, A], values [B, T], state). `state` must
        be a fresh NavState (episodes replay from empty memory); None
        makes one."""
        B, T, _ = obs_seq.shape
        dev = obs_seq.device
        if taus is None:
            taus = torch.full((B,), T, dtype=torch.int32, device=dev)
        if prev_actions is None:
            prev_actions = torch.zeros((B, T), dtype=torch.int64, device=dev)
        if state is None:
            state = self.core_train.initial_state(
                B, self.feat_dim, pos_dim=self.pos_dim,
                rot_dim=self.pose_dim - self.pos_dim)
        feat, pos, rot = self._split(obs_seq, prev_actions)
        beliefs, state = self.core_train(feat, pos, rot, taus, state)
        return (*self._heads(beliefs), state)


def make_nav_a2c_update(policy: NavActorCritic, optimizer,
                        value_coef: float = 0.5, entropy_coef: float = 0.01,
                        max_grad_norm: float | None = None):
    """update(batch) -> metrics: one A2C step over buffer-sampled padded
    episodes through the whole-window nav core from empty memory (the nav
    counterpart of rl/external.py::make_offline_a2c_update)."""
    return a2c_update(policy, optimizer, lambda B: None, value_coef,
                      entropy_coef, max_grad_norm)
