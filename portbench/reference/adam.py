"""Adam (Kingma and Ba, arXiv 1412.6980) written out, as torch.optim.Adam's
defaults compute it: bias-corrected moments, eps added to the corrected
root."""

from __future__ import annotations

import math

import torch


class Adam:
    def __init__(self, params: dict, lr=1e-3, betas=(0.9, 0.999), eps=1e-8):
        self.params = params
        self.lr, self.betas, self.eps = lr, betas, eps
        self.m = {k: torch.zeros_like(v) for k, v in params.items()}
        self.v = {k: torch.zeros_like(v) for k, v in params.items()}
        self.t = 0

    def step(self, grads: dict) -> None:
        self.t += 1
        b1, b2 = self.betas
        c1 = 1 - b1 ** self.t
        c2 = math.sqrt(1 - b2 ** self.t)
        for k, p in self.params.items():
            g = grads[k]
            self.m[k] = b1 * self.m[k] + (1 - b1) * g
            self.v[k] = b2 * self.v[k] + (1 - b2) * g * g
            denom = self.v[k].sqrt() / c2 + self.eps
            self.params[k] = p - (self.lr / c1) * self.m[k] / denom
