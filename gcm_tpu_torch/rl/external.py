"""External-environment adapter: host-stepped envs, a policy on the card
(counterpart of gcm_tpu/rl/external.py).

The loop splits at the host / device boundary:

- the ENV steps on the host: any Python object with the gym-style protocol
  below (numpy, no torch needed), batched by `HostEnvPool`, or the native
  `rl/native_env.py::NativeCartPolePool`;
- the POLICY steps on its device, one `policy.step` a tick, its recurrent
  graph memory kept there between ticks and reset per env at episode ends;
- finished episodes stream into the native `HostReplayBuffer`
  (data/host_buffer.py);
- training samples fixed-shape padded windows ([B, T_max, F] + taus) from
  the buffer and replays them through the policy's whole-window call: on
  the sparse policy, SparseGCM's single time-batched call.

A tick copies the actions to the host once (the env needs them) and the
next observations and dones to the device; nothing else leaves the card.
`make_offline_a2c_update` takes a torch optimizer over the policy's
parameters in place of optax's (params, opt_state) and changes the
parameters in place; `max_grad_norm` clips as optax.clip_by_global_norm.
"""

from __future__ import annotations

from typing import Protocol, Sequence

import numpy as np
import torch

from gcm_tpu_torch.core.graph_state import reset_where
from gcm_tpu_torch.device import resolve_device
from gcm_tpu_torch.rl.a2c import clip_by_global_norm
from gcm_tpu_torch.rl.distributions import Categorical


class PythonEnv(Protocol):
    """Minimal gym-style host environment protocol."""

    obs_dim: int
    num_actions: int

    def reset(self) -> np.ndarray: ...           # -> obs [obs_dim]

    def step(self, action: int):                 # -> (obs, reward, done)
        ...


class HostEnvPool:
    """Vectorises a set of host Python envs behind a batched interface.
    Auto-resets finished envs (the reset obs starts the next episode)."""

    def __init__(self, envs: Sequence[PythonEnv]):
        if not envs:
            raise ValueError("HostEnvPool needs at least one env")
        self.envs = list(envs)
        self.obs_dim = envs[0].obs_dim
        self.num_actions = envs[0].num_actions

    def __len__(self):
        return len(self.envs)

    def reset(self) -> np.ndarray:
        return np.stack([e.reset() for e in self.envs]).astype(np.float32)

    def step(self, actions: np.ndarray):
        obs = np.empty((len(self.envs), self.obs_dim), np.float32)
        rew = np.empty((len(self.envs),), np.float32)
        done = np.empty((len(self.envs),), bool)
        for i, (e, a) in enumerate(zip(self.envs, actions)):
            o, r, d = e.step(int(a))
            if d:
                o = e.reset()
            obs[i], rew[i], done[i] = o, r, d
        return obs, rew, done


@torch.no_grad()
def collect_host_episodes(pool, policy, buffer, steps: int,
                          generator: torch.Generator | None = None,
                          greedy: bool = False):
    """Run the policy on its device against the host env pool for `steps`
    ticks, appending every FINISHED episode to `buffer`
    (HostReplayBuffer). Actions are drawn from `generator` (argmax of the
    logits where greedy); an ended episode's memory is reset and its
    previous action set to 0. Returns (episodes appended, mean episode
    return, 0.0 if none ended)."""
    if not greedy and generator is None:
        raise ValueError("sampled collection needs a torch.Generator")
    dev = next(policy.parameters()).device
    dist = Categorical()
    B = len(pool)
    obs = pool.reset()
    mem = policy.initial_state(B)
    prev = torch.zeros((B,), dtype=torch.int64, device=dev)
    partial = [([], [], []) for _ in range(B)]
    returns = []
    for _ in range(steps):
        logits, _, mem = policy.step(torch.as_tensor(obs, device=dev), mem,
                                     prev_action=prev)
        act_dev = (torch.argmax(logits, dim=-1) if greedy
                   else dist.sample(generator, logits))
        act = act_dev.cpu().numpy()  # the tick's one copy to the host
        nobs, rew, done = pool.step(act)
        for i in range(B):
            ep_obs, ep_act, ep_rew = partial[i]
            ep_obs.append(obs[i])
            ep_act.append(act[i])
            ep_rew.append(rew[i])
            if done[i]:
                buffer.append(np.stack(ep_obs), np.asarray(ep_act, np.int32),
                              np.asarray(ep_rew, np.float32))
                returns.append(float(np.sum(ep_rew)))
                partial[i] = ([], [], [])
        d = torch.as_tensor(done, device=dev)
        mem = reset_where(mem, d)
        prev = torch.where(d, 0, act_dev)
        obs = nobs
    return len(returns), (float(np.mean(returns)) if returns else 0.0)


def episode_batch_to_device(obs, acts, rews, taus, gamma: float,
                            device=None) -> dict:
    """A HostReplayBuffer sample (padded episodes; numpy or tensors) as the
    training batch on `device` (default the card): previous actions shifted
    within the episode, per-step validity and discounted returns within the
    valid prefix (a reverse loop over T, 0 in the padding)."""
    dev = resolve_device(device)
    obs, acts, rews, taus = (torch.as_tensor(a, device=dev)
                             for a in (obs, acts, rews, taus))
    B, T = acts.shape
    valid = torch.arange(T, device=dev)[None, :] < taus[:, None]
    prev = torch.cat([torch.zeros((B, 1), dtype=acts.dtype, device=dev),
                      acts[:, :-1]], dim=1) * valid
    rews = torch.where(valid, rews, 0.0)
    carry = torch.zeros((B,), dtype=rews.dtype, device=dev)
    rets = [None] * T
    for t in reversed(range(T)):
        carry = torch.where(valid[:, t], rews[:, t] + gamma * carry, 0.0)
        rets[t] = carry
    return {"obs": obs, "actions": acts, "prev_actions": prev,
            "returns": torch.stack(rets, dim=1), "taus": taus,
            "valid": valid}


def masked_a2c_loss(logits, values, batch, value_coef: float,
                    entropy_coef: float):
    """The A2C loss over the valid steps of a padded batch: (total, {"pg",
    "v", "entropy"}), each mean over the valid steps."""
    v = batch["valid"]
    nv = torch.clamp_min(v.sum(), 1)
    adv = (batch["returns"] - values).detach()
    logp = torch.log_softmax(logits, dim=-1)
    alogp = torch.gather(logp, -1, batch["actions"].long()[..., None])[..., 0]
    pg = -torch.sum(torch.where(v, alogp * adv, 0.0)) / nv
    vl = torch.sum(torch.where(v, (batch["returns"] - values) ** 2,
                               0.0)) / nv
    ent = -torch.sum(torch.where(v, torch.sum(torch.exp(logp) * logp, -1),
                                 0.0)) / nv
    return pg + value_coef * vl - entropy_coef * ent, {
        "pg": pg.detach(), "v": vl.detach(), "entropy": ent.detach()}


def a2c_update(policy, optimizer, fresh_state, value_coef: float,
               entropy_coef: float, max_grad_norm: float | None):
    """update(batch) -> metrics: one A2C step over a padded episode batch
    through the policy's whole-window call from fresh_state(B), masked to
    the valid steps, on `optimizer`'s parameters (max_grad_norm clips as
    optax.clip_by_global_norm); the metrics stay tensors on the
    device."""
    params = [p for g in optimizer.param_groups for p in g["params"]]

    def update(batch) -> dict:
        logits, values, _ = policy(batch["obs"],
                                   fresh_state(batch["obs"].shape[0]),
                                   prev_actions=batch["prev_actions"],
                                   taus=batch["taus"])
        total, metrics = masked_a2c_loss(logits, values, batch, value_coef,
                                         entropy_coef)
        optimizer.zero_grad(set_to_none=True)
        total.backward()
        # a parameter the loss does not reach steps on a zero gradient, as
        # optax updates every leaf
        for p in params:
            if p.grad is None:
                p.grad = torch.zeros_like(p)
        if max_grad_norm is not None:
            clip_by_global_norm([p.grad for p in params], max_grad_norm)
        optimizer.step()
        metrics["loss"] = total.detach()
        return metrics

    return update


def make_offline_a2c_update(policy, optimizer, value_coef: float = 0.5,
                            entropy_coef: float = 0.01,
                            max_grad_norm: float | None = None):
    """update(batch) -> metrics: one A2C step over a buffer-sampled episode
    batch (episode_batch_to_device) through the policy's single
    whole-window call from its initial state, masked to the valid steps.
    `optimizer` holds the policy's parameters."""
    return a2c_update(policy, optimizer, policy.initial_state, value_coef,
                      entropy_coef, max_grad_norm)
