"""Vectorised environments on the device (counterpart of gcm_tpu/rl/env.py):
every env steps a batch of B episodes as tensors on `device` (default the
CUDA card), and every random draw comes from an explicit torch.Generator
(made on the generator's device and moved to the env's).

Interface: reset(generator, B) -> (obs [B, obs_dim], state);
step(state, action, generator) -> (obs, reward [B], done [B] bool, state).
An env resets an ended episode itself, inside `step`.
"""

from __future__ import annotations

import math
from typing import NamedTuple

import torch

from gcm_tpu_torch.device import resolve_device


def _randint(generator, high, shape, device):
    return torch.randint(0, high, shape, generator=generator,
                         device=generator.device,
                         dtype=torch.int32).to(device)


def _uniform(generator, low, high, shape, device):
    u = torch.rand(shape, generator=generator, device=generator.device)
    return (low + (high - low) * u).to(device)


def _normal(generator, shape, device):
    return torch.randn(shape, generator=generator,
                       device=generator.device).to(device)


class TMazeState(NamedTuple):
    goal: torch.Tensor  # [B] int32: 0 = left, 1 = right
    pos: torch.Tensor   # [B] int32 position along the corridor


class TMazeEnv:
    """The T-maze memory POMDP (Bakker 2001): the goal side shows only at
    the corridor's start; at the junction the agent must turn the
    remembered way. Reward 4 for the right turn, -0.1 for the wrong one or
    a bump. Actions: 0 forward, 1 left, 2 right. Obs: [goal_left,
    goal_right, in_corridor, at_junction]."""

    def __init__(self, corridor_length: int = 6, *, device=None):
        self.device = resolve_device(device)
        self.corridor_length = corridor_length
        self.horizon = corridor_length + 1
        self.obs_dim = 4
        self.num_actions = 3

    def reset(self, generator: torch.Generator, B: int):
        state = TMazeState(
            goal=_randint(generator, 2, (B,), self.device),
            pos=torch.zeros((B,), dtype=torch.int32, device=self.device))
        return self._obs(state), state

    def _obs(self, state):
        at_start = state.pos == 0
        at_junction = state.pos >= self.corridor_length
        return torch.stack([
            (at_start & (state.goal == 0)).float(),
            (at_start & (state.goal == 1)).float(),
            (~at_junction).float(), at_junction.float()], dim=-1)

    def step(self, state: TMazeState, action, generator: torch.Generator):
        at_junction = state.pos >= self.corridor_length
        forward = action == 0
        turn = torch.where(action == 1, 0, torch.where(action == 2, 1, -1))
        correct = at_junction & (turn == state.goal)
        wrong_turn = at_junction & (turn >= 0) & (turn != state.goal)
        reward = torch.where(
            correct, 4.0, torch.where(
                wrong_turn, -0.1,
                torch.where(forward & ~at_junction, 0.0, -0.1)))
        done = (at_junction & (turn >= 0)) | (state.pos >= self.horizon)
        pos = torch.where(done, 0, torch.where(forward & ~at_junction,
                                               state.pos + 1, state.pos))
        goal = torch.where(done, _randint(generator, 2, state.goal.shape,
                                          self.device), state.goal)
        new_state = TMazeState(goal=goal.to(torch.int32),
                               pos=pos.to(torch.int32))
        return self._obs(new_state), reward, done, new_state


class CartPoleState(NamedTuple):
    x: torch.Tensor          # [B] cart position
    x_dot: torch.Tensor      # [B] cart velocity
    theta: torch.Tensor      # [B] pole angle (rad)
    theta_dot: torch.Tensor  # [B] pole angular velocity
    t: torch.Tensor          # [B] int32 steps since the episode began


class CartPoleEnv:
    """CartPole with Gym's classic dynamics (Euler, tau 0.02, +-10 N),
    reward 1 a step times `reward_scale`, an end at |x| > 2.4, |theta| >
    12 degrees or `horizon` steps, and a fresh state (uniform +-0.05) after
    an end. masked_velocity=True observes only [x, theta]: the memory must
    supply the velocities. The JAX package's docstring documents A2C at
    B=64, horizon 64, reward_scale 0.05 with a graph_size 16 policy on
    hops [1, 2]."""

    GRAVITY = 9.8
    MASS_CART = 1.0
    MASS_POLE = 0.1
    LENGTH = 0.5  # half the pole's length
    FORCE_MAG = 10.0
    TAU = 0.02
    X_LIMIT = 2.4
    THETA_LIMIT = 12 * 2 * math.pi / 360

    def __init__(self, horizon: int = 64, masked_velocity: bool = False,
                 reward_scale: float = 1.0, *, device=None):
        self.device = resolve_device(device)
        self.horizon = horizon
        self.masked_velocity = masked_velocity
        self.reward_scale = reward_scale
        self.obs_dim = 2 if masked_velocity else 4
        self.num_actions = 2

    def _init_state(self, generator, B):
        v = _uniform(generator, -0.05, 0.05, (4, B), self.device)
        return CartPoleState(x=v[0], x_dot=v[1], theta=v[2], theta_dot=v[3],
                             t=torch.zeros((B,), dtype=torch.int32,
                                           device=self.device))

    def reset(self, generator: torch.Generator, B: int):
        state = self._init_state(generator, B)
        return self._obs(state), state

    def _obs(self, s: CartPoleState):
        if self.masked_velocity:
            return torch.stack([s.x, s.theta], dim=-1)
        return torch.stack([s.x, s.x_dot, s.theta, s.theta_dot], dim=-1)

    def step(self, s: CartPoleState, action, generator: torch.Generator):
        force = torch.where(action == 1, self.FORCE_MAG, -self.FORCE_MAG)
        costh, sinth = torch.cos(s.theta), torch.sin(s.theta)
        total_mass = self.MASS_CART + self.MASS_POLE
        pml = self.MASS_POLE * self.LENGTH
        temp = (force + pml * s.theta_dot ** 2 * sinth) / total_mass
        theta_acc = (self.GRAVITY * sinth - costh * temp) / (
            self.LENGTH * (4.0 / 3.0 - self.MASS_POLE * costh ** 2
                           / total_mass))
        x_acc = temp - pml * theta_acc * costh / total_mass
        x = s.x + self.TAU * s.x_dot
        x_dot = s.x_dot + self.TAU * x_acc
        theta = s.theta + self.TAU * s.theta_dot
        theta_dot = s.theta_dot + self.TAU * theta_acc
        t = s.t + 1
        fell = (torch.abs(x) > self.X_LIMIT) \
            | (torch.abs(theta) > self.THETA_LIMIT)
        done = fell | (t >= self.horizon)
        reward = torch.full_like(x, self.reward_scale)
        fresh = self._init_state(generator, x.shape[0])
        new_state = CartPoleState(*(
            torch.where(done, init, new) for new, init in zip(
                (x, x_dot, theta, theta_dot, t), fresh)))
        return self._obs(new_state), reward, done, new_state


class RecallEnvState(NamedTuple):
    cue: torch.Tensor  # [B] int32
    t: torch.Tensor    # [B] int32


class RecallEnv:
    """A cue symbol shows at t = 0, later observations are noise, and the
    last step of `horizon` rewards 1 for the action equal to the cue. Obs:
    [one-hot cue (t = 0 only) | noise | query flag]. A memoryless policy
    scores 1 / num_symbols."""

    def __init__(self, num_symbols: int = 4, horizon: int = 8,
                 noise_dim: int = 4, *, device=None):
        self.device = resolve_device(device)
        self.num_symbols = num_symbols
        self.horizon = horizon
        self.noise_dim = noise_dim
        self.obs_dim = num_symbols + noise_dim + 1
        self.num_actions = num_symbols

    def reset(self, generator: torch.Generator, B: int):
        state = RecallEnvState(
            cue=_randint(generator, self.num_symbols, (B,), self.device),
            t=torch.zeros((B,), dtype=torch.int32, device=self.device))
        return self._obs(state, generator), state

    def _obs(self, state, generator):
        B = state.cue.shape[0]
        show = (state.t == 0)[:, None]
        cue_oh = torch.nn.functional.one_hot(
            state.cue.long(), self.num_symbols).float() * show
        noise = _normal(generator, (B, self.noise_dim), self.device) * 0.1
        query = (state.t == self.horizon - 1)[:, None].float()
        return torch.cat([cue_oh, noise, query], dim=-1)

    def step(self, state: RecallEnvState, action, generator: torch.Generator):
        is_last = state.t == self.horizon - 1
        reward = torch.where(is_last & (action == state.cue), 1.0, 0.0)
        done = is_last
        new_state = RecallEnvState(
            cue=torch.where(done, _randint(generator, self.num_symbols,
                                           state.cue.shape, self.device),
                            state.cue),
            t=torch.where(done, 0, state.t + 1).to(torch.int32))
        return self._obs(new_state, generator), reward, done, new_state


class ContinuousRecallState(NamedTuple):
    target: torch.Tensor  # [B] float32 in [-1, 1]
    t: torch.Tensor       # [B] int32


class ContinuousRecallEnv:
    """RecallEnv's continuous twin (for DiagGaussian): t = 0 shows a target
    in [-1, 1], the last step rewards 1 - (action - target)^2 for a [B, 1]
    action. A memoryless policy's best is 2/3."""

    act_dim = 1

    def __init__(self, horizon: int = 8, noise_dim: int = 4, *, device=None):
        self.device = resolve_device(device)
        self.horizon = horizon
        self.noise_dim = noise_dim
        self.obs_dim = 1 + noise_dim + 1  # target | noise | query flag

    def reset(self, generator: torch.Generator, B: int):
        state = ContinuousRecallState(
            target=_uniform(generator, -1.0, 1.0, (B,), self.device),
            t=torch.zeros((B,), dtype=torch.int32, device=self.device))
        return self._obs(state, generator), state

    def _obs(self, state, generator):
        B = state.target.shape[0]
        show = (state.t == 0).float()[:, None]
        noise = _normal(generator, (B, self.noise_dim), self.device) * 0.1
        query = (state.t == self.horizon - 1)[:, None].float()
        return torch.cat([state.target[:, None] * show, noise, query], dim=-1)

    def step(self, state: ContinuousRecallState, action,
             generator: torch.Generator):
        is_last = state.t == self.horizon - 1
        reward = torch.where(is_last,
                             1.0 - (action[:, 0] - state.target) ** 2, 0.0)
        done = is_last
        new_state = ContinuousRecallState(
            target=torch.where(done, _uniform(generator, -1.0, 1.0,
                                              state.target.shape,
                                              self.device), state.target),
            t=torch.where(done, 0, state.t + 1).to(torch.int32))
        return self._obs(new_state, generator), reward, done, new_state
