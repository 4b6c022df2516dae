"""Eval metrics (flmm_tpu/evalsuite/metrics.py), numpy on the host.

* RefCOCO referring segmentation: cIoU = sum(intersections) /
  sum(unions), mIoU = the mean per-expression IoU.
* PNG: AA (the average accuracy over a dense sweep of IoU thresholds, in
  an O(N) closed form: the mean IoU up to the sweep's discretisation),
  aAcc@0.5 and pixel accuracy, with thing / stuff and singular / plural
  splits.
"""

from __future__ import annotations

import dataclasses

import numpy as np


def mask_iou_np(pred: np.ndarray, gt: np.ndarray
                ) -> tuple[float, float, float]:
    """(intersection, union, IoU) of two binary masks."""
    p = pred.astype(np.float64).reshape(-1)
    t = gt.astype(np.float64).reshape(-1)
    inter = float((p * t).sum())
    union = float((p + t - p * t).sum())
    return inter, union, inter / (union + 1e-12)


def average_accuracy(ious: np.ndarray, n_thresholds: int = 100000) -> float:
    """The sum of accuracy over the IoU thresholds ``i / n``, i = 0 .. n-2,
    over ``n`` (the mean IoU up to discretisation), in the O(N) closed form
    of the dense sweep; it may differ from the sweep by <= 1e-5 per sample
    where float rounding of ``i / n`` flips an ``iou >= threshold``
    comparison."""
    if len(ious) == 0:
        return 0.0
    ious = np.asarray(ious, np.float64)
    # acc(t) = mean(iou >= t) summed over thresholds i/n, i = 0..n-2 (the
    # last grid point is left out).  A sample with given iou
    # satisfies iou >= i/n for i <= floor(iou*n), i.e. floor(iou*n)+1 grid
    # points, clipped to the n-1 thresholds actually summed -- O(N)
    # instead of the (n_thresholds, N) boolean outer product.
    counts = np.minimum(np.floor(ious * n_thresholds) + 1, n_thresholds - 1)
    return float(counts.sum() / len(ious) / n_thresholds)


@dataclasses.dataclass
class RefSegAccumulator:
    inter: float = 0.0
    union: float = 0.0
    ious: list = dataclasses.field(default_factory=list)

    def add(self, pred: np.ndarray, gt: np.ndarray) -> None:
        i, u, iou = mask_iou_np(pred, gt)
        self.inter += i
        self.union += u
        self.ious.append(iou)

    def merge(self, other: "RefSegAccumulator") -> None:
        self.inter += other.inter
        self.union += other.union
        self.ious += other.ious

    def results(self) -> dict:
        n = max(1, len(self.ious))
        return {
            "cIoU": 100.0 * self.inter / max(self.union, 1e-12),
            "mIoU": 100.0 * float(np.mean(self.ious)) if self.ious else 0.0,
            "n": n,
        }


@dataclasses.dataclass
class PNGAccumulator:
    ious: list = dataclasses.field(default_factory=list)
    isthing: list = dataclasses.field(default_factory=list)
    plural: list = dataclasses.field(default_factory=list)
    pixel_accs: list = dataclasses.field(default_factory=list)

    def add(self, pred: np.ndarray, gt: np.ndarray, info: dict) -> None:
        _, _, iou = mask_iou_np(pred, gt)
        self.ious.append(iou)
        self.isthing.append(bool(info["isthing"]))
        self.plural.append(bool(info["plural"]))
        self.pixel_accs.append(float((pred == gt).mean()))

    def merge(self, other: "PNGAccumulator") -> None:
        for k in ("ious", "isthing", "plural", "pixel_accs"):
            getattr(self, k).extend(getattr(other, k))

    def results(self) -> dict:
        ious = np.asarray(self.ious)
        thing = np.asarray(self.isthing, bool)
        plural = np.asarray(self.plural, bool)
        return {
            "AA": average_accuracy(ious),
            "AA_singulars": average_accuracy(ious[~plural]),
            "AA_plurals": average_accuracy(ious[plural]),
            "AA_things": average_accuracy(ious[thing]),
            "AA_stuff": average_accuracy(ious[~thing]),
            "aAcc@0.5": float((ious > 0.5).mean()) if len(ious) else 0.0,
            "pixel_acc": float(np.mean(self.pixel_accs)) if self.pixel_accs
            else 0.0,
            "n": len(self.ious),
        }
