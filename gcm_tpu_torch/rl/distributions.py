"""Action distributions of the RL trainers (counterpart of
gcm_tpu/rl/distributions.py).

The policy emits `num_outputs` logits and the distribution turns them into
actions; A2C and PPO take a `dist=` (default Categorical). Contract, with
logits [..., num_outputs]:

- sample(generator, logits) -> actions, drawn from the torch.Generator
  (on the generator's device, moved to the logits');
- log_prob(logits, actions) -> [...] and entropy(logits) -> [...];
- neutral_action(B, device) -> the "no previous action" the rollout starts
  from, and reset_prev(actions, done) puts it back at episode ends.

torch.Generator and jax.random draw different streams, so a sample is held
to its law, not to JAX's draws.
"""

from __future__ import annotations

import math

import torch


def _uniform(shape, generator, device, dtype=torch.float32):
    u = torch.rand(shape, generator=generator, device=generator.device,
                   dtype=dtype)
    return u.to(device)


class Categorical:
    """Discrete actions from a softmax over the logits."""

    def sample(self, generator: torch.Generator, logits):
        """Gumbel-max: argmax(logits + Gumbel noise), as jax.random.
        categorical draws (int64 actions)."""
        u = _uniform(logits.shape, generator, logits.device, logits.dtype)
        u = torch.clamp_min(u, torch.finfo(logits.dtype).tiny)
        return torch.argmax(logits - torch.log(-torch.log(u)), dim=-1)

    def log_prob(self, logits, actions):
        logp = torch.log_softmax(logits, dim=-1)
        return torch.gather(logp, -1, actions.long()[..., None])[..., 0]

    def entropy(self, logits):
        logp = torch.log_softmax(logits, dim=-1)
        return -torch.sum(torch.exp(logp) * logp, dim=-1)

    def neutral_action(self, B: int, device=None):
        return torch.zeros((B,), dtype=torch.int64, device=device)

    def reset_prev(self, actions, done):
        return torch.where(done, 0, actions)


class DiagGaussian:
    """Continuous actions: logits [..., 2 * act_dim] = [mean | log_std]
    (rllib's layout), log_std clamped to [min_log_std, max_log_std] (a
    hard clip: no gradient outside)."""

    def __init__(self, act_dim: int, min_log_std: float = -5.0,
                 max_log_std: float = 2.0):
        self.act_dim = act_dim
        self.min_log_std = min_log_std
        self.max_log_std = max_log_std

    def _split(self, logits):
        if logits.shape[-1] != 2 * self.act_dim:
            raise ValueError(f"DiagGaussian needs num_outputs == 2 * act_dim "
                             f"({2 * self.act_dim}), got {logits.shape[-1]}")
        mean = logits[..., :self.act_dim]
        log_std = torch.clamp(logits[..., self.act_dim:], self.min_log_std,
                              self.max_log_std)
        return mean, log_std

    def sample(self, generator: torch.Generator, logits):
        mean, log_std = self._split(logits)
        z = torch.randn(mean.shape, generator=generator,
                        device=generator.device, dtype=mean.dtype)
        return mean + torch.exp(log_std) * z.to(mean.device)

    def log_prob(self, logits, actions):
        mean, log_std = self._split(logits)
        z = (actions - mean) * torch.exp(-log_std)
        per_dim = -0.5 * z ** 2 - log_std - 0.5 * math.log(2.0 * math.pi)
        return torch.sum(per_dim, dim=-1)

    def entropy(self, logits):
        _, log_std = self._split(logits)
        return torch.sum(log_std + 0.5 * math.log(2.0 * math.pi * math.e),
                         dim=-1)

    def neutral_action(self, B: int, device=None):
        return torch.zeros((B, self.act_dim), dtype=torch.float32,
                           device=device)

    def reset_prev(self, actions, done):
        return torch.where(done[..., None], 0.0, actions)
