"""MGM's video path (flmm_tpu/data/video.py): uniform frame sampling and the
tensor branch of the reference's ``VideoFramesProcessor`` (mgm/model/
processor/video_processor.py:11-110): one bicubic shortest-edge resize of
the whole ``(T, H, W, 3)`` stack (cast to f32 first, so the rescale comes
after the bicubic), a centre crop, rescale by 1/255 and mean / std
normalisation.  Frames come from a directory of images, decoded without
PIL (``data.image_io``), or from the caller.
"""

from __future__ import annotations

import pathlib
from typing import Callable, Sequence

import numpy as np
import torch

from flmm_tpu_torch.data.processors import CLIP_MEAN, CLIP_STD
from flmm_tpu_torch.ops.resize import resize_bicubic

FRAME_SUFFIXES = (".jpg", ".jpeg", ".png", ".bmp", ".webp")


def _resize_output_size(h: int, w: int, shortest_edge: int) -> tuple:
    """HF ``get_resize_output_image_size(default_to_square=False)``."""
    short, long = (h, w) if h <= w else (w, h)
    new_long = int(shortest_edge * long / short)
    return (shortest_edge, new_long) if h <= w else (new_long, shortest_edge)


def preprocess_video_frames(
    frames: np.ndarray,
    shortest_edge: int = 336,
    crop_size: int = 336,
    rescale_factor: float = 1.0 / 255.0,
    mean: Sequence[float] = CLIP_MEAN,
    std: Sequence[float] = CLIP_STD,
    do_resize: bool = True,
    do_center_crop: bool = True,
    do_rescale: bool = True,
    do_normalize: bool = True,
) -> np.ndarray:
    """``(T, H, W, 3)`` frames (any numeric dtype) -> ``(T, 3, crop, crop)``
    f32, the reference's layout.  The crop takes ``crop_size`` on both axes
    (the reference names the axes the other way round, which square crops
    make moot)."""
    x = np.asarray(frames, np.float32)
    if x.ndim != 4 or x.shape[-1] != 3:
        raise ValueError(f"frames are (T, H, W, 3), got {x.shape}")
    if do_resize:
        oh, ow = _resize_output_size(x.shape[1], x.shape[2], shortest_edge)
        x = resize_bicubic(torch.from_numpy(x).permute(0, 3, 1, 2),
                           (oh, ow)).permute(0, 2, 3, 1).numpy()
    if do_center_crop:
        cy = (x.shape[1] - crop_size) // 2
        cx = (x.shape[2] - crop_size) // 2
        x = x[:, cy:cy + crop_size, cx:cx + crop_size]
    if do_rescale:
        x = x * rescale_factor
    if do_normalize:
        x = (x - np.asarray(mean, np.float32)) / np.asarray(std, np.float32)
    return np.ascontiguousarray(x.transpose(0, 3, 1, 2))


def sample_indices(n_total: int, n_frames: int) -> list[int]:
    """``n_frames`` indices spread uniformly over ``n_total`` frames (all of
    them when there are no more)."""
    if n_total <= n_frames:
        return list(range(n_total))
    pos = np.linspace(0, n_total - 1, n_frames)
    return [int(round(p)) for p in pos]


def load_frames_from_dir(path: str, n_frames: int = 8) -> list[np.ndarray]:
    """``n_frames`` frames, sampled uniformly from the image files of a
    directory in name order, as ``(H, W, 3)`` uint8 arrays."""
    from flmm_tpu_torch.data.image_io import open_image

    files = sorted(p for p in pathlib.Path(path).iterdir()
                   if p.suffix.lower() in FRAME_SUFFIXES)
    return [open_image(str(files[i]))
            for i in sample_indices(len(files), n_frames)]


def process_video(frames: Sequence[np.ndarray],
                  preprocess: Callable[[np.ndarray], dict],
                  n_frames: int = 8) -> dict:
    """Sample and preprocess frames: stacked ``pixel_values``, each frame's
    ``meta`` and the ``frame_indices`` taken."""
    idx = sample_indices(len(frames), n_frames)
    outs = [preprocess(frames[i]) for i in idx]
    return {"pixel_values": np.stack([o["pixel_values"] for o in outs]),
            "metas": [o.get("meta") for o in outs],
            "frame_indices": idx}
