"""Host-side image geometry: padding metas and static-shape crop params
(flmm_tpu/data/geometry.py, carried over unchanged: numpy only).

Reproduces the coordinate conventions of the reference processors exactly:

* LMM frame: aspect-preserving resize of the long edge to the processor
  size, centred pad to square, meta = {padding, image_shape, padded_shape}
  (reference flmm/datasets/llava_processors.py:195-213,
  deepseek_vl/models/image_processing_vlm.py resize/expand2square).
* Coarse-grid crop: the reference's int unpad math
  (frozen_deepseek_vl.py:150-158).
* SAM frame: ResizeLongestSide to 1024 + corner pad
  (segment_anything/utils/transforms.py:16, modeling/sam.py:168-178).
"""

from __future__ import annotations

import numpy as np


def lmm_meta(orig_h: int, orig_w: int, size: int) -> dict:
    """Meta for resize-long-edge-to-``size`` + centred square pad."""
    if orig_h > orig_w:
        h, w = size, max(1, int(orig_w * size / orig_h))
    else:
        h, w = max(1, int(orig_h * size / orig_w)), size
    pad_h, pad_w = size - h, size - w
    before_h, before_w = pad_h // 2, pad_w // 2
    return {
        "padding": {
            "before_height": before_h, "after_height": pad_h - before_h,
            "before_width": before_w, "after_width": pad_w - before_w,
        },
        "image_shape": {"height": h, "width": w},
        "padded_shape": {"height": size, "width": size},
    }


def coarse_crop(meta: dict, coarse_hw: tuple[int, int]) -> dict:
    """Reference unpad math scaled to the coarse mask grid."""
    hc, wc = coarse_hw
    p_h = meta["padded_shape"]["height"]
    p_w = meta["padded_shape"]["width"]
    crop_y = int(meta["padding"]["before_height"] * hc / p_h)
    crop_x = int(meta["padding"]["before_width"] * wc / p_w)
    crop_h = int(meta["image_shape"]["height"] * hc / p_h + 0.5)
    crop_w = int(meta["image_shape"]["width"] * wc / p_w + 0.5)
    return {
        "crop_y": float(crop_y), "crop_x": float(crop_x),
        "crop_h": float(crop_h), "crop_w": float(crop_w),
    }


def sam_input_size(orig_h: int, orig_w: int, long_side: int = 1024) -> tuple:
    """ResizeLongestSide target (reference transforms.py get_preprocess_shape)."""
    scale = long_side / max(orig_h, orig_w)
    return (int(orig_h * scale + 0.5), int(orig_w * scale + 0.5))


def batch_geom(metas: list[dict], coarse_hw, sam_hw_list) -> dict:
    """Stack per-sample geometry into the (B,) arrays the model consumes."""
    out = {k: [] for k in ("crop_y", "crop_x", "crop_h", "crop_w",
                           "sam_h", "sam_w")}
    for meta, (nh, nw) in zip(metas, sam_hw_list):
        cc = coarse_crop(meta, coarse_hw)
        for k, v in cc.items():
            out[k].append(v)
        out["sam_h"].append(float(nh))
        out["sam_w"].append(float(nw))
    return {k: np.asarray(v, np.float32) for k, v in out.items()}


def coarse_weight(meta: dict, coarse_hw: tuple[int, int]) -> np.ndarray:
    """Valid-pixel map of the coarse grid (1 inside the unpadded region)."""
    cc = coarse_crop(meta, coarse_hw)
    w = np.zeros(coarse_hw, np.float32)
    y0, x0 = int(cc["crop_y"]), int(cc["crop_x"])
    w[y0:y0 + int(cc["crop_h"]), x0:x0 + int(cc["crop_w"])] = 1.0
    return w


def sam_weight(sam_hw: tuple[int, int], frame: int = 256,
               long_side: int = 1024) -> np.ndarray:
    """Valid-pixel map of the SAM low-res frame."""
    nh, nw = sam_hw
    w = np.zeros((frame, frame), np.float32)
    w[: max(1, int(round(nh * frame / long_side))),
      : max(1, int(round(nw * frame / long_side)))] = 1.0
    return w
