"""COCO panoptic segment decoding (flmm_tpu/data/panoptic.py): segment ids
are R + 256 G + 256^2 B in the panoptic PNGs (panopticapi.utils.rgb2id);
the PNG is read without PIL (data/image_io.py)."""

from __future__ import annotations

import numpy as np

from flmm_tpu_torch import runtime
from flmm_tpu_torch.data.image_io import open_image


def rgb2id(color: np.ndarray) -> np.ndarray:
    if color.dtype == np.uint8 and color.ndim >= 1 and color.shape[-1] == 3:
        return runtime.rgb2id(color).astype(np.uint32)
    color = color.astype(np.uint32)
    return color[..., 0] + 256 * color[..., 1] + 256 * 256 * color[..., 2]


def id2rgb(ids: np.ndarray) -> np.ndarray:
    ids = ids.astype(np.uint32)
    return np.stack(
        [ids % 256, (ids // 256) % 256, (ids // 65536) % 256], axis=-1
    ).astype(np.uint8)


def load_segment_map(path: str) -> np.ndarray:
    return rgb2id(open_image(path))


def segment_union_mask(segm_map: np.ndarray,
                       segment_ids: list[int]) -> np.ndarray:
    """Union of the given segment ids as a binary uint8 mask."""
    return runtime.segment_union(segm_map.astype(np.int32),
                                 [int(s) for s in segment_ids])
