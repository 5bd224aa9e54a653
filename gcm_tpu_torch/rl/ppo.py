"""PPO with GAE over the actor-critic policies, on the card (counterpart of
gcm_tpu/rl/ppo.py): the clipped surrogate objective, generalized advantage
estimation, and `epochs` passes of `num_minibatches` minibatches over the
batch axis per rollout, each replaying the recurrent memory from the
initial state.

`update` = `collect` + `learn(traj, perms)`, where perms are the epochs'
batch permutations, drawn from the update's generator; a caller may hand
`learn` permutations of its own (JAX's, in the CPU parity test).

Under dp_mesh (see A2C) every rank holds the whole trajectory; the old
log-probs and values are computed on the rank's rows and all-gathered,
and each minibatch (consecutive slices of the permutation over the whole
batch, as without dp) is split over dp: a rank replays its block of the
minibatch's rows, normalising the advantages by the whole minibatch's
mean and std, and the gradients are averaged over dp.
"""

from __future__ import annotations

import torch

from gcm_tpu_torch.parallel.comm import all_gather_data
from gcm_tpu_torch.rl.a2c import A2C


def gae(rewards, values, dones, gamma: float, lam: float):
    """rewards, values, dones [B, T], value 0 after the window ->
    (advantages, returns)."""
    nonterm = 1.0 - dones.to(rewards.dtype)
    next_values = torch.cat([values[:, 1:], torch.zeros_like(values[:, :1])],
                            dim=1)
    deltas = rewards + gamma * next_values * nonterm - values
    carry = torch.zeros_like(rewards[:, 0])
    adv = [None] * rewards.shape[1]
    for t in reversed(range(rewards.shape[1])):
        carry = deltas[:, t] + gamma * lam * nonterm[:, t] * carry
        adv[t] = carry
    adv = torch.stack(adv, dim=1)
    return adv, adv + values


class PPO(A2C):
    def __init__(self, env, policy, gamma: float = 0.99, lam: float = 0.95,
                 lr: float = 3e-3, clip_eps: float = 0.2,
                 value_coef: float = 0.5, entropy_coef: float = 0.01,
                 epochs: int = 4, num_minibatches: int = 2,
                 rollout_len: int | None = None,
                 log_grad_norms: bool = False, dp_mesh=None,
                 dp_axis: str = "dp", opt=None,
                 max_grad_norm: float | None = None, dist=None,
                 replay_dones: bool = True):
        super().__init__(env, policy, gamma=gamma, lr=lr,
                         value_coef=value_coef, entropy_coef=entropy_coef,
                         rollout_len=rollout_len,
                         log_grad_norms=log_grad_norms, dp_mesh=dp_mesh,
                         dp_axis=dp_axis, opt=opt,
                         max_grad_norm=max_grad_norm, dist=dist,
                         replay_dones=replay_dones)
        self.lam = lam
        self.clip_eps = clip_eps
        self.epochs = epochs
        self.num_minibatches = num_minibatches

    def _evaluate(self, traj_mb):
        logits, values = self.replay(traj_mb)
        return (self.dist.log_prob(logits, traj_mb["actions"]), values,
                self.dist.entropy(logits))

    def ppo_loss(self, traj_mb, adv_all=None):
        """adv_all: the whole minibatch's advantages, whose mean and std
        normalise these rows' (default: these rows are the minibatch)."""
        logp, values, entropy = self._evaluate(traj_mb)
        ratio = torch.exp(logp - traj_mb["logp_old"])
        adv = traj_mb["adv"]
        if adv_all is None:
            adv_all = adv
        adv = (adv - adv_all.mean()) / (adv_all.std(unbiased=False) + 1e-8)
        clipped = torch.clamp(ratio, 1 - self.clip_eps, 1 + self.clip_eps)
        pg_loss = -torch.mean(torch.minimum(ratio * adv, clipped * adv))
        v_loss = torch.mean((traj_mb["returns"] - values) ** 2)
        ent = torch.mean(entropy)
        total = pg_loss + self.value_coef * v_loss - self.entropy_coef * ent
        return total, {"pg": pg_loss.detach(), "v": v_loss.detach(),
                       "entropy": ent.detach()}

    def learn(self, traj: dict, perms) -> dict:
        """The epochs over a collected trajectory: the old log-probs,
        values and GAE from the current policy, then for each epoch's
        permutation (perms[e], a [B] index tensor) num_minibatches steps on
        consecutive slices of it. Returns the mean loss, the mean episode
        return and, if logged, the last minibatch's grad norms."""
        B = traj["obs"].shape[0]
        with torch.no_grad():
            logp_old, values, _ = self._evaluate(self._own(traj))
            if self.dp > 1:
                logp_old = all_gather_data(logp_old, self.dp_group, 0)
                values = all_gather_data(values, self.dp_group, 0)
            adv, returns = gae(traj["rewards"], values, traj["dones"],
                               self.gamma, self.lam)
        traj = {**traj, "logp_old": logp_old, "adv": adv, "returns": returns}
        mb = B // self.num_minibatches
        losses, norms = [], {}
        for e in range(self.epochs):
            perm = torch.as_tensor(perms[e], device=traj["obs"].device)
            for i in range(self.num_minibatches):
                idx = perm[i * mb:(i + 1) * mb].long()
                own = idx[self._rows(mb)]
                total, _ = self.ppo_loss({k: v[own] for k, v in traj.items()},
                                         adv_all=traj["adv"][idx])
                norms = self.apply(total)
                losses.append(total.detach())
        loss = torch.stack(losses).mean()
        self._dp_mean([loss])
        return {"loss": loss,
                "return": torch.mean(torch.sum(traj["rewards"], dim=1)),
                **norms}

    def update(self, generator: torch.Generator, B: int) -> dict:
        traj = self.collect(generator, B)
        perms = [torch.randperm(B, generator=generator,
                                device=generator.device)
                 for _ in range(self.epochs)]
        return self.learn(traj, perms)
