"""Faults planted under the timed path, for the tests and the calibration of
the check's limits: the check has to come out not correct on each."""

from __future__ import annotations

import contextlib

import torch


class _Stepped:
    """A trainer whose ``step`` is replaced, the rest passed through."""

    def __init__(self, tr, step):
        self._tr = tr
        self.step = step

    def __getattr__(self, name):
        return getattr(self._tr, name)


def half_batch(tr):
    """Every training step sees the first half of its batch's rows only: the
    loss is the mean over the rest."""
    step = tr.step

    def halved(batch: dict) -> dict:
        n = batch["input_ids"].shape[0] // 2
        return step({k: ({kk: vv[:n] for kk, vv in v.items()}
                         if isinstance(v, dict) else v[:n])
                     for k, v in batch.items()})

    return _Stepped(tr, halved)


def unchanged_state(tr):
    """Every training step runs the forward and the backward and leaves the
    state as it found it (no update)."""
    from flmm_tpu_torch import registry
    from flmm_tpu_torch.train import loop

    loss_fn = registry.get_model(tr.family).loss_fn

    def idle(batch: dict) -> dict:
        (_, metrics), grads = loop.value_and_grad(
            lambda p, b: loss_fn(p, tr.cfg, b), tr.frozen,
            tr.state["params"], batch)
        metrics["grad_norm"] = loop.global_norm(grads)
        return metrics

    return _Stepped(tr, idle)


def stale_params(tr):
    """Every training step updates the optimizer's moments and leaves the
    parameters as it found them: an update that is never written."""
    from flmm_tpu_torch.train import loop

    step = tr.step

    def kept(batch: dict) -> dict:
        before = [(t, t.detach().clone())
                  for _, t in loop.tree_leaves(tr.state["params"])]
        metrics = step(batch)
        with torch.no_grad():
            for t, old in before:
                t.copy_(old)
        return metrics

    return _Stepped(tr, kept)


@contextlib.contextmanager
def halved_box():
    """Every box the SAM refiner makes comes out halved about its centre: a
    box altered where it is produced, and the SAM prompt made from it."""
    from flmm_tpu_torch.models.mask_head import refiner

    orig = refiner.mask_to_box

    def halved(mask):
        box = orig(mask)
        quarter = (box[..., 2:] - box[..., :2]) / 4
        return torch.cat([box[..., :2] + quarter, box[..., 2:] - quarter],
                         dim=-1)

    refiner.mask_to_box = halved
    try:
        yield
    finally:
        refiner.mask_to_box = orig


@contextlib.contextmanager
def altered_answer():
    """The SAM refiner's first mask of every image comes out negated: an
    answer altered where it is produced."""
    from flmm_tpu_torch.models.mask_head import refiner

    orig = refiner.refine

    def refine(*args, **kwargs):
        out = dict(orig(*args, **kwargs))
        logits = out["low_res_logits"].clone()
        logits[0] = -logits[0]
        out["low_res_logits"] = logits
        return out

    refiner.refine = refine
    try:
        yield
    finally:
        refiner.refine = orig


TRAIN_FAULTS = {"half_batch": half_batch, "unchanged_state": unchanged_state,
                "stale_params": stale_params}
SERVE_FAULTS = {"altered_answer": altered_answer, "halved_box": halved_box}
