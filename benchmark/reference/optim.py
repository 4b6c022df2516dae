"""The training recipe in plain float32: global-norm clipping at 1.0, then
AdamW (betas 0.9 / 0.999, eps 1e-8, weight decay 0.01) at a linear-warmup
+ cosine learning rate, as the reference trainer and optax's
``chain(clip_by_global_norm, adamw)`` step it.  ``pe_gaussian`` is a frozen
buffer: no update, no decay."""

from __future__ import annotations

import math

import numpy as np
import torch

FROZEN_LEAVES = ("pe_gaussian",)


def leaves(tree, prefix: str = ""):
    """``(path, leaf)`` of a nested dict / list tree."""
    if isinstance(tree, dict):
        for k, v in tree.items():
            yield from leaves(v, f"{prefix}/{k}" if prefix else str(k))
    elif isinstance(tree, (list, tuple)):
        for i, v in enumerate(tree):
            yield from leaves(v, f"{prefix}/{i}" if prefix else str(i))
    else:
        yield prefix, tree


def trained(path: str) -> bool:
    return not any(n in path.split("/") for n in FROZEN_LEAVES)


def lr_at(opt: dict, count: int) -> float:
    """The learning rate after ``count`` applied updates."""
    warmup = max(1, int(opt["warmup_ratio"] * opt["total_steps"]))
    decay = max(1, opt["total_steps"] - warmup)
    start = opt["lr"] * opt["warmup_start_factor"]
    if count < warmup:
        return (start - opt["lr"]) * (1.0 - count / warmup) + opt["lr"]
    t = min(count - warmup, decay) / decay
    return opt["lr"] * 0.5 * (1.0 + math.cos(math.pi * t))


class AdamW:
    """State over the trained leaves of a tree of float32 tensors."""

    def __init__(self, opt: dict, params):
        self.opt = opt
        self.count = 0
        self.mu = {p: torch.zeros_like(t) for p, t in leaves(params)
                   if trained(p)}
        self.nu = {p: torch.zeros_like(t) for p, t in leaves(params)
                   if trained(p)}

    def step(self, grads: dict, params) -> dict:
        """Apply one update in place; returns the clipped gradients the
        moments took."""
        o = self.opt
        b1, b2 = o["betas"]
        norm = torch.stack([g.square().sum() for g in grads.values()]).sum() \
            .sqrt()
        lr = lr_at(o, self.count)
        t = self.count + 1
        bc1, bc2 = (1.0 - float(np.float32(b) ** t) for b in (b1, b2))
        taken = {}
        with torch.no_grad():
            for path, p in leaves(params):
                if not trained(path):
                    continue
                g = grads[path]
                if norm >= o["max_grad_norm"]:
                    g = g / norm * o["max_grad_norm"]
                taken[path] = g
                m, v = self.mu[path], self.nu[path]
                m.mul_(b1).add_(g, alpha=1.0 - b1)
                v.mul_(b2).addcmul_(g, g, value=1.0 - b2)
                p.sub_(lr * ((m / bc1) / ((v / bc2).sqrt() + o["eps"])
                             + o["weight_decay"] * p))
        self.count = t
        return taken
