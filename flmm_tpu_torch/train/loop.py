"""Training loop (flmm_tpu/train/loop.py): AdamW with a linear-warmup +
cosine schedule and global-norm clipping over the trainable tree, and a
functional train step.

The reference recipe: AdamW lr 1e-4, betas (0.9, 0.999), weight decay 0.01,
gradient clipping at global norm 1.0, linear warmup from ``lr * 1e-5`` over
3% of training, then cosine to 0.  The optimizer follows optax's
``chain(clip_by_global_norm, adamw)`` step for step, so the port's states
can be held against the JAX package's: the schedule is read at the count of
updates applied so far, and AdamW applies ``p -= lr * (m_hat / (sqrt(v_hat)
+ eps) + wd * p)``.  SAM's ``pe_gaussian`` is a frozen buffer in the
reference: it is neither updated nor weight-decayed.

Parameters and moments are updated in place (no second copy of the
trainable tree); the functions still return the state they were given.
"""

from __future__ import annotations

import dataclasses
import math
from typing import Any, Callable, NamedTuple

import numpy as np
import torch

FROZEN_LEAVES = ("pe_gaussian",)


@dataclasses.dataclass(frozen=True)
class OptimConfig:
    lr: float = 1e-4
    betas: tuple = (0.9, 0.999)
    weight_decay: float = 0.01
    max_grad_norm: float = 1.0
    warmup_ratio: float = 0.03
    total_steps: int = 10000
    warmup_start_factor: float = 1e-5
    eps: float = 1e-8


def make_schedule(cfg: OptimConfig) -> Callable[[int], float]:
    """Learning rate after ``count`` applied updates: linear from
    ``lr * warmup_start_factor`` to ``lr`` over ``max(1, int(warmup_ratio *
    total_steps))`` updates, then cosine to 0 (optax's join of
    linear_schedule and cosine_decay_schedule)."""
    warmup = max(1, int(cfg.warmup_ratio * cfg.total_steps))
    decay = max(1, cfg.total_steps - warmup)
    start = cfg.lr * cfg.warmup_start_factor

    def schedule(count: int) -> float:
        if count < warmup:
            frac = 1.0 - count / warmup
            return (start - cfg.lr) * frac + cfg.lr
        t = min(count - warmup, decay) / decay
        return cfg.lr * 0.5 * (1.0 + math.cos(math.pi * t))

    return schedule


def tree_leaves(tree, prefix: str = ""):
    """``(path, leaf)`` pairs of a nested dict / list tree, paths like
    ``sam/prompt/pe_gaussian``."""
    if isinstance(tree, dict):
        for k, v in tree.items():
            yield from tree_leaves(v, f"{prefix}/{k}" if prefix else str(k))
    elif isinstance(tree, (list, tuple)):
        for i, v in enumerate(tree):
            yield from tree_leaves(v, f"{prefix}/{i}" if prefix else str(i))
    else:
        yield prefix, tree


def is_trained(path: str) -> bool:
    """False for the leaves the optimizer leaves alone (frozen buffers)."""
    return not any(name in path.split("/") for name in FROZEN_LEAVES)


def global_norm(grads: dict) -> torch.Tensor:
    """The f32 L2 norm over every gradient (None counts as zero)."""
    sq = [g.float().square().sum() for g in grads.values() if g is not None]
    return torch.stack(sq).sum().sqrt()


class Optimizer(NamedTuple):
    """``init(params) -> state``; ``update(grads, state, params) -> state``,
    which applies the update to ``params`` in place.  ``grads`` maps each
    leaf path of ``params`` to its gradient or None."""
    init: Callable[[Any], dict]
    update: Callable[[dict, dict, Any], dict]


def make_optimizer(cfg: OptimConfig) -> Optimizer:
    """Global-norm clipping over every gradient, then AdamW on the trained
    leaves (optax ``make_optimizer``)."""
    schedule = make_schedule(cfg)
    b1, b2 = cfg.betas

    def init(params) -> dict:
        leaves = [(p, t) for p, t in tree_leaves(params) if is_trained(p)]
        return {"count": 0,
                "mu": {p: torch.zeros_like(t, dtype=torch.float32)
                       for p, t in leaves},
                "nu": {p: torch.zeros_like(t, dtype=torch.float32)
                       for p, t in leaves}}

    def update(grads: dict, state: dict, params) -> dict:
        norm = global_norm(grads)
        # optax scales by max_norm / norm only when norm >= max_norm
        keep = norm < cfg.max_grad_norm
        t = state["count"] + 1
        lr = schedule(state["count"])
        # bias corrections with the betas in f32, as optax computes them
        # (1 - 0.999 ** t differs by 1.3e-5 in f32 and f64 at t = 1)
        bc1, bc2 = (1.0 - float(np.float32(b) ** t) for b in (b1, b2))
        with torch.no_grad():
            for path, p in tree_leaves(params):
                if not is_trained(path):
                    continue
                g = grads.get(path)
                g = (torch.zeros_like(p, dtype=torch.float32) if g is None
                     else torch.where(keep, g, g / norm * cfg.max_grad_norm))
                m, v = state["mu"][path], state["nu"][path]
                m.mul_(b1).add_(g, alpha=1.0 - b1)
                v.mul_(b2).addcmul_(g, g, value=1.0 - b2)
                step = (m / bc1) / ((v / bc2).sqrt() + cfg.eps)
                p.sub_(lr * (step + cfg.weight_decay * p.float()))
        state["count"] = t
        return state

    return Optimizer(init, update)


def init_state(trainable, opt: Optimizer) -> dict:
    """``{'step', 'params', 'opt_state'}`` over the trainable tree, whose
    trained leaves are made to require grad (the frozen buffers do not)."""
    for path, p in tree_leaves(trainable):
        p.requires_grad_(is_trained(path))
    return {"step": 0, "params": trainable, "opt_state": opt.init(trainable)}


def gradients(loss: torch.Tensor, trainable) -> dict:
    """``d loss / d leaf`` keyed by the trainable leaf paths (None where a
    leaf takes no gradient)."""
    leaves = list(tree_leaves(trainable))
    wrt = [(p, t) for p, t in leaves if t.requires_grad]
    got = torch.autograd.grad(loss, [t for _, t in wrt], allow_unused=True)
    grads = dict.fromkeys(p for p, _ in leaves)
    grads.update({p: g for (p, _), g in zip(wrt, got)})
    return grads


def value_and_grad(loss_fn: Callable, frozen, trainable, batch):
    """``((loss, metrics), grads)`` of ``loss_fn({'frozen', 'trainable'},
    batch)``, grads as :func:`gradients` gives them."""
    loss, metrics = loss_fn({"frozen": frozen, "trainable": trainable},
                            batch)
    grads = gradients(loss, trainable)
    return (loss.detach(), {k: v.detach() for k, v in metrics.items()}), grads


def make_train_step(loss_fn: Callable, opt: Optimizer) -> Callable:
    """``step(state, frozen, batch) -> (state, metrics)`` (optax
    ``make_train_step``): the metrics, ``grad_norm`` among them, are those
    of the incoming batch before the update; ``loss_fn(params, batch) ->
    (loss, metrics)``."""

    def step(state: dict, frozen, batch) -> tuple[dict, dict]:
        (_, metrics), grads = value_and_grad(loss_fn, frozen,
                                             state["params"], batch)
        state["opt_state"] = opt.update(grads, state["opt_state"],
                                        state["params"])
        state["step"] += 1
        metrics["grad_norm"] = global_norm(grads)
        return state, metrics

    return step
