"""Automatic mask generation (flmm_tpu/models/sam/amg.py; reference
segment_anything/automatic_mask_generator.py): prompt SAM with a regular
point grid, keep masks by predicted IoU and stability score, deduplicate
with box NMS and return one record per mask.

The whole grid decodes in one mask-decoder call on the device: 32 x 32
points at SAM-1024 peak at 30.09 GB above the embedding on an NVIDIA H100
80GB HBM3 at 700 W (chip_smoke.py phase 34).  The kept low-res logits are
brought to the image's size as ``SamPredictor.predict`` does (the valid SAM
region cropped, resized bilinearly), and the stability score, the
threshold, the boxes, areas and RLEs are taken there, as the reference
does.  flmm_tpu takes them
on the decoder's 256 x 256 low-res frame, padding included
(flmm_tpu/models/sam/amg.py:117-158), so its records are not in the image's
frame; the port does not copy that.  The grid, the stability score, the RLE,
the NMS and the box are numpy on the host, as in flmm_tpu.
"""

from __future__ import annotations

import numpy as np
import torch

from flmm_tpu_torch.models.mask_head.refiner import SamRefinerConfig
from flmm_tpu_torch.models.sam import mask_decoder as sam_decoder
from flmm_tpu_torch.models.sam import prompt_encoder as sam_prompt
from flmm_tpu_torch.models.sam.predictor import encode_image, \
    low_res_to_masks


def build_point_grid(n_per_side: int) -> np.ndarray:
    """Normalised [0,1] point grid (reference utils/amg.py)."""
    offset = 1 / (2 * n_per_side)
    pts = np.linspace(offset, 1 - offset, n_per_side)
    gx, gy = np.meshgrid(pts, pts)
    return np.stack([gx.reshape(-1), gy.reshape(-1)], axis=-1)


def stability_score(logits: np.ndarray, mask_threshold: float = 0.0,
                    offset: float = 1.0) -> np.ndarray:
    """IoU between masks at threshold +- offset (reference utils/amg.py)."""
    hi = (logits > mask_threshold + offset).reshape(logits.shape[0], -1)
    lo = (logits > mask_threshold - offset).reshape(logits.shape[0], -1)
    return hi.sum(-1) / np.maximum(lo.sum(-1), 1)


def mask_to_rle(mask: np.ndarray) -> dict:
    """Binary mask -> uncompressed column-major COCO RLE."""
    h, w = mask.shape
    flat = np.asarray(mask, np.uint8).T.reshape(-1)
    change = np.nonzero(np.diff(flat))[0] + 1
    idx = np.concatenate([[0], change, [len(flat)]])
    counts = np.diff(idx).tolist()
    if flat[0] == 1:
        counts = [0] + counts
    return {"size": [h, w], "counts": counts}


def box_nms(boxes: np.ndarray, scores: np.ndarray, thresh: float) -> list:
    """Greedy IoU NMS (torchvision.batched_nms replacement)."""
    order = np.argsort(-scores)
    keep = []
    while len(order):
        i = order[0]
        keep.append(int(i))
        if len(order) == 1:
            break
        rest = order[1:]
        xx0 = np.maximum(boxes[i, 0], boxes[rest, 0])
        yy0 = np.maximum(boxes[i, 1], boxes[rest, 1])
        xx1 = np.minimum(boxes[i, 2], boxes[rest, 2])
        yy1 = np.minimum(boxes[i, 3], boxes[rest, 3])
        inter = np.maximum(0, xx1 - xx0) * np.maximum(0, yy1 - yy0)
        a = (boxes[i, 2] - boxes[i, 0]) * (boxes[i, 3] - boxes[i, 1])
        b = (boxes[rest, 2] - boxes[rest, 0]) * (boxes[rest, 3] - boxes[rest, 1])
        iou = inter / np.maximum(a + b - inter, 1e-9)
        order = rest[iou <= thresh]
    return keep


def mask_box(mask: np.ndarray) -> np.ndarray:
    ys, xs = np.where(mask)
    if len(ys) == 0:
        return np.zeros(4, np.float32)
    return np.array([xs.min(), ys.min(), xs.max() + 1, ys.max() + 1],
                    np.float32)


class AutomaticMaskGenerator:
    def __init__(self, params: dict, cfg: SamRefinerConfig,
                 points_per_side: int = 32, pred_iou_thresh: float = 0.88,
                 stability_score_thresh: float = 0.95,
                 box_nms_thresh: float = 0.7, device="cuda"):
        """``params``: the {'encoder', 'prompt', 'decoder'} trees on
        ``device``."""
        self.params = params
        self.cfg = cfg
        self.grid = build_point_grid(points_per_side)
        self.pred_iou_thresh = pred_iou_thresh
        self.stability_score_thresh = stability_score_thresh
        self.box_nms_thresh = box_nms_thresh
        self.device = torch.device(device)

    @torch.no_grad()
    def decode(self, embed: torch.Tensor, points: torch.Tensor) -> tuple:
        """``(N, 1, 2)`` points in SAM-frame pixels, one positive point a
        prompt -> the multimask outputs: logits ``(N, 3, P, P)`` and IoU
        predictions ``(N, 3)``."""
        cfg, p = self.cfg, self.params["prompt"]
        labels = torch.ones(points.shape[:2], dtype=torch.int32,
                            device=points.device)
        sparse = sam_prompt.embed_points(p, cfg.prompt, points, labels,
                                         pad=True)
        dense = sam_prompt.no_mask_dense(p, cfg.prompt, points.shape[0])
        masks, iou = sam_decoder.forward(
            self.params["decoder"], cfg.decoder, embed,
            sam_prompt.dense_pe(p, cfg.prompt), sparse, dense)
        return masks[:, 1:], iou[:, 1:]

    def grid_points(self, input_size: tuple[int, int]) -> torch.Tensor:
        """The point grid in the SAM frame of an image of ``input_size``,
        ``(N, 1, 2)`` f32 on the device."""
        nh, nw = input_size
        pts = self.grid * np.array([nw, nh], np.float32)
        return torch.as_tensor(pts[:, None, :], dtype=torch.float32,
                               device=self.device)

    def postprocess(self, low_res: torch.Tensor, ious: torch.Tensor,
                    input_size: tuple[int, int],
                    original_size: tuple[int, int]) -> list[dict]:
        """Decoded ``(K, P, P)`` logits and ``(K,)`` IoU predictions -> the
        records, each mask at ``original_size``."""
        ious_np = ious.float().cpu().numpy()
        keep = ious_np > self.pred_iou_thresh
        if not keep.any():
            return []
        logits = low_res_to_masks(
            low_res[torch.as_tensor(keep, device=low_res.device)].float(),
            input_size, original_size, self.cfg)
        hi = (logits > 1.0).flatten(1).sum(-1).cpu().numpy()
        lo = (logits > -1.0).flatten(1).sum(-1).cpu().numpy()
        stab = hi / np.maximum(lo, 1)
        keep2 = stab > self.stability_score_thresh
        if not keep2.any():
            return []
        ious_np = ious_np[keep][keep2]
        binary = (logits[torch.as_tensor(keep2, device=logits.device)]
                  > 0.0).cpu().numpy()
        boxes = np.stack([mask_box(m) for m in binary])
        nonempty = boxes[:, 2] > boxes[:, 0]
        binary, boxes, ious_np = (binary[nonempty], boxes[nonempty],
                                  ious_np[nonempty])
        if len(binary) == 0:
            return []
        return [{"segmentation": mask_to_rle(binary[i]),
                 "bbox": boxes[i].tolist(),
                 "predicted_iou": float(ious_np[i]),
                 "area": int(binary[i].sum())}
                for i in box_nms(boxes, ious_np, self.box_nms_thresh)]

    def generate(self, image: np.ndarray) -> list[dict]:
        """Records of an ``(H, W, 3)`` uint8 image: ``segmentation`` (RLE
        at ``(H, W)``), ``bbox`` xyxy, ``predicted_iou`` and ``area``."""
        embed, input_size = encode_image(self.params, self.cfg, image,
                                         self.device)
        masks, ious = self.decode(embed, self.grid_points(input_size))
        return self.postprocess(masks.flatten(0, 1), ious.reshape(-1),
                                input_size, tuple(image.shape[:2]))
