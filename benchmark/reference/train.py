"""Adam and the plateau schedule of the templates, plainly: Adam with L2
weight decay added to the gradient, beta2 0.999, eps 1e-8 outside the square
root and bias-corrected moments; ReduceLROnPlateau (mode min, relative
threshold) stepped with each update's last microbatch loss."""

from __future__ import annotations

import torch


class Adam:
    def __init__(self, params, cfg, beta2=0.999, eps=1e-8):
        self.params, self.count = params, 0
        self.b1, self.b2, self.eps = cfg.get("beta1", 0.9), beta2, eps
        self.wd = cfg.get("weight_decay", 0.0)
        self.mu = [torch.zeros_like(p) for p in params]
        self.nu = [torch.zeros_like(p) for p in params]

    @torch.no_grad()
    def update(self, grads, lr):
        self.count += 1
        for p, g, mu, nu in zip(self.params, grads, self.mu, self.nu):
            g = g + self.wd * p if self.wd else g
            mu.mul_(self.b1).add_((1 - self.b1) * g)
            nu.mul_(self.b2).add_((1 - self.b2) * g * g)
            mu_hat = mu / (1 - self.b1 ** self.count)
            nu_hat = nu / (1 - self.b2 ** self.count)
            p.sub_(lr * mu_hat / (nu_hat.sqrt() + self.eps))


class Plateau:
    def __init__(self, lr, cfg):
        self.lr, self.cfg = lr, cfg
        self.best, self.bad, self.cooldown = float("inf"), 0, 0

    def step(self, metric):
        c = self.cfg
        if metric < self.best * (1 - c["threshold"]):
            self.best, self.bad = metric, 0
        else:
            self.bad += 1
        if self.cooldown > 0:
            self.cooldown -= 1
            self.bad = 0
        if self.bad > c["patience"]:
            self.lr = max(self.lr * c["factor"], c["min_lr"])
            self.cooldown, self.bad = c["cooldown"], 0
