"""Shared machinery of the frozen-LMM grounding models
(flmm_tpu/models/frozen/base.py): the loss computation.

Parameter convention: ``params = {'frozen': {...}, 'trainable': {...}}``;
only the trainable tree is differentiated, optimised and checkpointed.
"""

from __future__ import annotations

import torch

from flmm_tpu_torch.ops import losses as L


def grounding_losses(coarse_logits, gt_coarse, coarse_weight, sam_logits,
                     gt_sam, sam_weight, mask_valid) -> dict:
    """BCE + naive Dice for both heads plus accuracy / aIoU metrics, as the
    reference computes them (frozen_llava.py:71-85,167-217).

    BCE and accuracy are per-sample pixel means (over that sample's valid
    pixels) weighted by the sample's mask count over the total mask count --
    not a flat mean when samples have different valid sizes.  Dice and aIoU
    are per mask, averaged over the valid masks.

    Args:
      coarse_logits, gt_coarse: ``(B, M, Hc, Wc)``; coarse_weight
        ``(B, Hc, Wc)`` valid-pixel map.
      sam_logits, gt_sam: ``(B, M, P, P)``; sam_weight ``(B, P, P)``.
      mask_valid: ``(B, M)`` bool.

    Returns the scalar terms ``loss_mask``, ``loss_dice``, ``accuracy``,
    ``aiou``, the same with a ``sam_`` prefix, and their ``loss``.
    """
    B, M = mask_valid.shape
    mv = mask_valid.float()
    m_s = mv.sum(1)
    m_norm = m_s.sum().clamp_min(1.0)

    def per_sample_mean(per, w):
        num = (per * w).sum(dim=(1, 2, 3))
        den = w.sum(dim=(1, 2, 3)).clamp_min(1.0)
        return ((num / den) * m_s).sum() / m_norm

    def head(logits, gt, pix_w):
        w = torch.broadcast_to(pix_w[:, None].float() * mv[:, :, None, None],
                               logits.shape)
        flat_logits = logits.reshape(B * M, -1)
        flat_gt = gt.reshape(B * M, -1)
        flat_w = w.reshape(B * M, -1)
        gf = gt.float()
        pred = (torch.sigmoid(logits.float()) > 0.5).float()
        acc = (pred == gf).float()
        iou = L.mask_iou(pred.reshape(B * M, -1) * flat_w,
                         flat_gt.float() * flat_w)
        return {
            "loss_mask": per_sample_mean(L.bce_terms(logits, gt), w),
            "loss_dice": L.naive_dice(flat_logits, flat_gt, flat_w,
                                      mask_valid.reshape(-1)),
            "accuracy": per_sample_mean(acc, w),
            "aiou": (iou * mv.reshape(-1)).sum() / mv.sum().clamp_min(1.0),
        }

    out = head(coarse_logits, gt_coarse, coarse_weight)
    out.update({f"sam_{k}": v for k, v in head(sam_logits, gt_sam,
                                                sam_weight).items()})
    out["loss"] = (out["loss_mask"] + out["loss_dice"]
                   + out["sam_loss_mask"] + out["sam_loss_dice"])
    return out
