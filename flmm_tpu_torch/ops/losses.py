"""Segmentation losses with the reference's mmdet semantics
(flmm_tpu/ops/losses.py): per-pixel sigmoid BCE and naive Dice (eps 1.0),
plus the accuracy and IoU metrics.  Every term takes an optional pixel-weight
map, so losses over a fixed padded frame see only valid pixels.  All
reductions are in float32."""

from __future__ import annotations

import torch


def bce_terms(logits: torch.Tensor, targets: torch.Tensor) -> torch.Tensor:
    """Elementwise BCE with logits in f32, ``max(x, 0) - x t + log1p(e^-|x|)``."""
    lf, tf = logits.float(), targets.float()
    return lf.clamp_min(0.0) - lf * tf + torch.log1p(torch.exp(-lf.abs()))


def sigmoid_bce(logits, targets, weights=None) -> torch.Tensor:
    """Mean BCE with logits over the (weighted) elements (mmdet
    CrossEntropyLoss(use_sigmoid=True) with avg_factor = valid count)."""
    per = bce_terms(logits, targets)
    if weights is None:
        return per.mean()
    w = weights.float()
    return (per * w).sum() / w.sum().clamp_min(1.0)


def _rows(x: torch.Tensor, weights, shape) -> torch.Tensor:
    """``x`` times the broadcast weights, flattened to one row per mask."""
    if weights is not None:
        x = x * torch.broadcast_to(weights.float(), shape)
    return x.reshape(shape[0], -1)


def naive_dice(logits, targets, weights=None, mask_valid=None,
               eps: float = 1.0) -> torch.Tensor:
    """mmdet naive Dice loss, one term per mask ``(M, ...)``, averaged over
    the valid masks (``mask_valid`` ``(M,)`` bool) or all of them."""
    p = _rows(torch.sigmoid(logits.float()), weights, logits.shape)
    t = _rows(targets.float(), weights, logits.shape)
    num = 2.0 * (p * t).sum(-1)
    den = p.sum(-1) + t.sum(-1)
    loss = 1.0 - (num + eps) / (den + eps)
    if mask_valid is None:
        return loss.mean()
    mv = mask_valid.float()
    return (loss * mv).sum() / mv.sum().clamp_min(1.0)


def mask_accuracy(logits, targets, weights=None) -> torch.Tensor:
    """Fraction of (valid) pixels where ``sigmoid(logits) > 0.5`` equals the
    target."""
    pred = (torch.sigmoid(logits.float()) > 0.5).float()
    eq = (pred == targets.float()).float()
    if weights is None:
        return eq.mean()
    w = torch.broadcast_to(weights.float(), logits.shape)
    return (eq * w).sum() / w.sum().clamp_min(1.0)


def mask_iou(pred, target, weights=None, eps: float = 1e-12) -> torch.Tensor:
    """Per-mask IoU ``(M,)`` of binary maps ``(M, ...)`` (reference
    flmm/utils.py:7 compute_mask_IoU)."""
    p = _rows(pred.float(), weights, pred.shape)
    t = _rows(target.float(), weights, pred.shape)
    inter = (p * t).sum(-1)
    union = (p + t - p * t).sum(-1)
    return inter / (union + eps)
