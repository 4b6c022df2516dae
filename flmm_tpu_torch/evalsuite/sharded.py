"""Data-parallel evaluation (flmm_tpu/evalsuite/sharded.py on
``torch.distributed``).

* :func:`run_eval_sharded` -- the metric-exact path: every data rank builds
  the same global batch and runs the forward on its own rows; the low-res
  SAM logits are gathered over the ``"data"`` axis in rank order, so the
  host scorer (evalsuite.runner's per-sample pipeline at the original GT
  resolution) sees what one process would, and the results equal the host
  path's on the same data, for the RefCOCO and the PNG accumulators.
  Every rank computes them.
* :func:`make_sharded_eval_step` / :func:`batch_iou_terms` -- scalar terms
  in the fixed SAM prompt frame, summed over the data axis: no logits move
  between ranks, and the scores are an approximation (the SAM frame's
  resolution, not the original one).
"""

from __future__ import annotations

import torch

from flmm_tpu_torch.parallel import mesh as mesh_lib


def batch_iou_terms(sam_logits: torch.Tensor, gt_sam, sam_weight,
                    mask_valid) -> dict:
    """Per-batch IoU sums in the SAM frame.

    Args:
      sam_logits: ``(B, M, P, P)``; gt_sam binary likewise.
      sam_weight: ``(B, P, P)``; mask_valid ``(B, M)``.

    Returns f32 scalars: the intersection and union sums, the per-mask IoU
    sum, the count of masks above 0.5 IoU and the valid count -- addable
    across batches and ranks.
    """
    w = sam_weight.float()[:, None]
    pred = (torch.sigmoid(sam_logits.float()) > 0.5).float() * w
    gt = gt_sam.float() * w
    mv = mask_valid.float()
    inter = (pred * gt).sum(dim=(2, 3)) * mv
    union = (pred + gt - pred * gt).sum(dim=(2, 3)) * mv
    iou = inter / union.clamp_min(1e-12)
    return {
        "intersection": inter.sum(),
        "union": union.sum(),
        "iou_sum": (iou * mv).sum(),
        "acc50_sum": ((iou > 0.5).float() * mv).sum(),
        "count": mv.sum(),
    }


def _data_axis(mesh) -> mesh_lib.Axis:
    if mesh.get_coordinate() is None:
        raise ValueError("this rank is outside the mesh")
    return mesh_lib.axis_of(mesh, "data")


def make_sharded_eval_step(model_forward, mesh):
    """``(params, batch) -> metric term scalars`` over the global batch:
    this rank's rows through ``model_forward(params, rows)``, the terms
    summed over the data axis (every rank holds the sums)."""
    axis = _data_axis(mesh)

    def step(params, batch):
        rows = mesh_lib.shard_rows(batch, axis)
        with torch.no_grad():
            out = model_forward(params, rows)
        terms = batch_iou_terms(out["sam_logits"], rows["gt_sam"],
                                rows["sam_weight"], rows["mask_valid"])
        flat = torch.stack(list(terms.values()))
        mesh_lib.all_reduce(flat, axis.group)
        return dict(zip(terms, flat))

    return step


def finalize(terms: dict) -> dict:
    return {
        "cIoU": 100.0 * float(terms["intersection"])
        / max(float(terms["union"]), 1e-12),
        "mIoU": 100.0 * float(terms["iou_sum"])
        / max(float(terms["count"]), 1.0),
        "aAcc@0.5": 100.0 * float(terms["acc50_sum"])
        / max(float(terms["count"]), 1.0),
        "n": int(terms["count"]),
    }


def make_sharded_predict(model_forward, params, mesh, device):
    """``numpy batch (without infos) -> (B, M, P, P)`` SAM low-res logits:
    this rank's rows through the forward on ``device``, gathered over the
    data axis in rank order.  Drop-in for evalsuite.runner's
    ``predict_fn``."""
    from flmm_tpu_torch.convert.from_jax import from_jax

    axis = _data_axis(mesh)

    def predict(batch):
        rows = from_jax(mesh_lib.shard_rows(batch, axis), device)
        with torch.no_grad():
            logits = model_forward(params, rows)["sam_logits"]
        return mesh_lib.all_gather_cat(logits, 0, axis)

    return predict


def run_eval_sharded(samples, params, model_forward, spec, batch_size: int,
                     mesh, batch_builder=None, accumulator_factory=None,
                     score_fn=None, device="cpu") -> dict:
    """The data-parallel eval loop, metric-exact (reference
    multiprocess_eval_refcoco.py:136-175): defaults to the RefCOCO
    accumulator; pass ``PNGAccumulator`` / ``png_score`` for PNG (the
    per-split thing / stuff / plural metrics kept)."""
    from flmm_tpu_torch.evalsuite.runner import RefSegAccumulator, \
        refcoco_score, run_eval

    acc = run_eval(samples,
                   make_sharded_predict(model_forward, params, mesh, device),
                   spec, batch_size,
                   accumulator_factory or RefSegAccumulator,
                   score_fn or refcoco_score, batch_builder=batch_builder)
    return acc.results()
