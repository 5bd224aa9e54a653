"""The general traffic generator: everything a run feeds the program comes
from its seed and the parameters of the cell's workload file.

Every seed gives the same sizes in another order: ragged lengths are a
fixed multiset, spread evenly over their range and permuted by the seed, so
runs with different seeds do the same amount of work.
"""

from __future__ import annotations

import numpy as np
import torch

STREAMS = ("weights", "inputs", "host", "sample")


def sub_seeds(seed: int) -> dict:
    """Independent 63-bit seeds, one for each stream of a run."""
    if seed < 0:
        raise ValueError(f"--seed must be a whole number >= 0, got {seed}")
    children = np.random.SeedSequence(seed).spawn(len(STREAMS))
    return {name: int(c.generate_state(1, np.uint64)[0] >> np.uint64(1))
            for name, c in zip(STREAMS, children)}


def device_generator(seed: int, device) -> torch.Generator:
    g = torch.Generator(device=device)
    g.manual_seed(seed)
    return g


def spread(lo: int, hi: int, n: int) -> np.ndarray:
    """n whole numbers spread evenly over lo..hi (inclusive)."""
    return lo + (np.arange(n, dtype=np.int64) * (hi - lo + 1)) // n


def lengths(spec, n: int, rng: np.random.Generator) -> np.ndarray:
    """The fixed multiset spread(spec['min'], spec['max'], n), permuted."""
    return rng.permutation(spread(int(spec["min"]), int(spec["max"]), n))


def train_pool(traffic: dict, obs: int, hidden: int, seed: int, device):
    """`pool` batches of one training step each, made on the device:
    xs [P,B,T,obs] standard normal, targets [P,B,T,hidden] uniform in
    (-1, 1) and, where traffic has "taus", valid lengths [P,B] (xs zero
    past them)."""
    P, B, T = traffic["pool"], traffic["batch"], traffic["steps"]
    g = device_generator(seed, device)
    xs = torch.randn((P, B, T, obs), generator=g, device=device)
    targets = torch.rand((P, B, T, hidden), generator=g, device=device)
    targets = targets * 2 - 1
    taus = None
    if "taus" in traffic:
        rng = np.random.default_rng(seed)
        taus = torch.from_numpy(np.stack(
            [lengths(traffic["taus"], B, rng) for _ in range(P)])
            .astype(np.int32)).to(device)
        steps = torch.arange(T, device=device)
        xs = torch.where(steps[None, None, :, None] < taus[..., None, None],
                         xs, 0.0)
    return xs, targets, taus


class Episodes:
    """Episode lengths of B environments stepped in lockstep: the first B
    from the fixed multiset, each next one uniform in min..max; `advance`
    moves every environment one step and returns where an episode ended."""

    def __init__(self, spec: dict, B: int, rng: np.random.Generator):
        self.lo, self.hi = int(spec["min"]), int(spec["max"])
        self.rng = rng
        self.remaining = lengths(spec, B, rng).astype(np.int32)
        self.pos = np.zeros(B, dtype=np.int32)  # steps into the episode

    def advance(self) -> np.ndarray:
        self.remaining -= 1
        self.pos += 1
        done = self.remaining == 0
        ended = np.flatnonzero(done)
        if ended.size:
            self.remaining[ended] = self.rng.integers(self.lo, self.hi + 1,
                                                      ended.size)
            self.pos[ended] = 0
        return done


def host_obs_pool(traffic: dict, obs: int, rng: np.random.Generator):
    """[pool, B, obs] standard normal observations on the host."""
    return torch.from_numpy(rng.standard_normal(
        (traffic["pool"], traffic["batch"], obs), dtype=np.float32))
