"""A2C over the actor-critic policies, on the card (counterpart of
gcm_tpu/rl/a2c.py): rollout collection under the recurrent memory policy,
discounted returns, the advantage actor-critic loss with an entropy bonus,
and an optimizer step.

PyTorch's idiom for JAX's (params, opt_state) threading: the trainer owns
the policy's optimizer and `update` changes the policy's parameters in
place. Collection is an eager loop over `rollout_len` steps under
torch.no_grad (JAX jits it as one lax.scan), every draw (the env's, the
actions') from the torch.Generator handed to it. The replay for the loss is
the policy's whole-trajectory call, whose gradients go through the port's
kernels' autograd Functions: on the ring and dense cores fused_dense_gnn
forward and fused_dense_gnn_bwd backward, on the sparse core
spmm_edge_list.

max_grad_norm clips as optax.clip_by_global_norm does (g kept below the
norm, else (g / norm) * max_norm), not as clip_grad_norm_ (g * max_norm /
(norm + 1e-6)), so that a clipped update is JAX's.
"""

from __future__ import annotations

import torch

from gcm_tpu_torch.core.graph_state import reset_where
from gcm_tpu_torch.rl.distributions import Categorical
from gcm_tpu_torch.rl.wrappers import PARALLELISM, train_remat_for
from gcm_tpu_torch.utils.debug import grad_norms


def discounted_returns(rewards, dones, gamma: float):
    """rewards, dones [B, T] -> returns [B, T], restarting at dones."""
    carry = torch.zeros_like(rewards[:, 0])
    d = dones.to(rewards.dtype)
    out = [None] * rewards.shape[1]
    for t in reversed(range(rewards.shape[1])):
        carry = rewards[:, t] + gamma * carry * (1.0 - d[:, t])
        out[t] = carry
    return torch.stack(out, dim=1)


def clip_by_global_norm(grads, max_norm: float):
    """optax.clip_by_global_norm on a list of tensors, in place: kept where
    the global L2 norm is below max_norm, else (g / norm) * max_norm. No
    host wait."""
    norm = torch.sqrt(sum(torch.sum(g * g) for g in grads))
    keep = norm < max_norm
    for g in grads:
        g.copy_(torch.where(keep, g, (g / norm) * max_norm))


class A2C:
    """opt: a factory, opt(parameters) -> torch optimizer, in place of
    optax's GradientTransformation (default torch.optim.Adam(lr)).
    replay_dones=False replays without the episode ends: only valid where
    no episode ends before a rollout's last step (fixed-horizon envs with
    rollout_len == env.horizon); the replay checks that and raises
    otherwise."""

    def __init__(self, env, policy, gamma: float = 0.99, lr: float = 3e-3,
                 value_coef: float = 0.5, entropy_coef: float = 0.01,
                 rollout_len: int | None = None,
                 log_grad_norms: bool = False, dp_mesh=None,
                 dp_axis: str = "dp", opt=None,
                 max_grad_norm: float | None = None, dist=None,
                 replay_dones: bool = True):
        if dp_mesh is not None:
            raise NotImplementedError(f"dp_mesh= (data-parallel training) "
                                      f"waits for {PARALLELISM}")
        del dp_axis
        self.env = env
        self.policy = policy
        self.dist = dist if dist is not None else Categorical()
        if not isinstance(self.dist, Categorical) and getattr(
                policy, "cfg", {}).get("use_prev_action", False):
            raise ValueError("use_prev_action embeds discrete actions "
                             "one-hot; disable it for continuous "
                             "distributions")
        self.gamma = gamma
        self.value_coef = value_coef
        self.entropy_coef = entropy_coef
        self.rollout_len = rollout_len or env.horizon
        self.params = list(policy.parameters())
        self.opt = (opt if opt is not None else
                    (lambda ps: torch.optim.Adam(ps, lr=lr)))(self.params)
        self.max_grad_norm = max_grad_norm
        self.log_grad_norms = log_grad_norms
        self.replay_dones = replay_dones

    # -- rollout (no gradients) ----------------------------------------------
    @torch.no_grad()
    def collect(self, generator: torch.Generator, B: int) -> dict:
        """Roll the policy for rollout_len steps from fresh episodes; the
        memory of an ended episode is wiped and its previous action reset.
        Returns {"obs", "actions", "rewards", "dones", "prev_actions"},
        each [B, T, ...]."""
        obs, env_state = self.env.reset(generator, B)
        mem = self.policy.initial_state(B)
        prev = self.dist.neutral_action(B, obs.device)
        steps = []
        for _ in range(self.rollout_len):
            logits, _, mem = self.policy.step(obs, mem, prev_action=prev)
            action = self.dist.sample(generator, logits)
            nobs, reward, done, env_state = self.env.step(env_state, action,
                                                          generator)
            steps.append((obs, action, reward, done, prev))
            mem = reset_where(mem, done)
            prev = self.dist.reset_prev(action, done)
            obs = nobs
        keys = ("obs", "actions", "rewards", "dones", "prev_actions")
        return {k: torch.stack(v, dim=1) for k, v in zip(keys, zip(*steps))}

    # -- update ------------------------------------------------------------
    def replay(self, traj):
        """The policy's whole-trajectory call over a collected trajectory
        from the initial state, with the episode ends unless replay_dones
        is False: (logits, values)."""
        obs = traj["obs"]
        B, T = obs.shape[0], obs.shape[1]
        replay_d = traj["dones"] if self.replay_dones else None
        if replay_d is None and bool(traj["dones"][:, :-1].any()):
            raise ValueError(
                "replay_dones=False replays without episode ends, but an "
                "episode ended before the rollout's last step: the replay "
                "would not see what collection saw")
        logits, values, _ = self.policy(
            obs, self.policy.initial_state(B),
            prev_actions=traj["prev_actions"], dones=replay_d,
            remat=train_remat_for(getattr(self.policy, "core", None), T))
        return logits, values

    def loss(self, traj):
        """(total loss, {"pg", "v", "entropy", "return"})."""
        logits, values = self.replay(traj)
        returns = discounted_returns(traj["rewards"], traj["dones"],
                                     self.gamma)
        adv = (returns - values).detach()
        pg_loss = -torch.mean(self.dist.log_prob(logits, traj["actions"])
                              * adv)
        v_loss = torch.mean((returns - values) ** 2)
        entropy = torch.mean(self.dist.entropy(logits))
        total = pg_loss + self.value_coef * v_loss \
            - self.entropy_coef * entropy
        return total, {"pg": pg_loss.detach(), "v": v_loss.detach(),
                       "entropy": entropy.detach(),
                       "return": torch.mean(torch.sum(traj["rewards"],
                                                      dim=1))}

    def apply(self, loss) -> dict:
        """Backpropagate `loss`, clip, and take one optimizer step. A
        parameter the loss does not reach gets a zero gradient, as optax
        updates every leaf. Returns the unclipped grad norms if logged."""
        self.opt.zero_grad(set_to_none=True)
        loss.backward()
        for p in self.params:
            if p.grad is None:
                p.grad = torch.zeros_like(p)
        # the norms before clipping, as JAX logs them
        norms = grad_norms(self.policy) if self.log_grad_norms else {}
        if self.max_grad_norm is not None:
            clip_by_global_norm([p.grad for p in self.params],
                                self.max_grad_norm)
        self.opt.step()
        return norms

    def update(self, generator: torch.Generator, B: int) -> dict:
        """Collect one rollout and take one step on its loss; the metrics
        stay tensors on the device."""
        traj = self.collect(generator, B)
        total, metrics = self.loss(traj)
        metrics.update(self.apply(total))
        metrics["loss"] = total.detach()
        return metrics

    def train(self, generator: torch.Generator, updates: int, B: int = 16,
              log_every: int = 0):
        """`updates` updates; returns the mean episode return of each."""
        history = []
        for i in range(updates):
            metrics = self.update(generator, B)
            history.append(float(metrics["return"]))
            if log_every and i % log_every == 0:
                print(f"update {i}: return={history[-1]:.3f} "
                      f"loss={float(metrics['loss']):.3f}")
        return history
