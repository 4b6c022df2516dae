"""Host image processors (flmm_tpu/data/processors.py) over ``(H, W, 3)``
uint8 numpy arrays: the LMM square-pad preprocess and SAM's
ResizeLongestSide preprocess, with the same outputs and padding metas.

The JAX package resizes with PIL's ``Image.resize``.  The port reads no PIL
(the machine with the card has none), so :func:`resample` is a numpy twin
of PIL's 8-bit resampler (``libImaging/Resample.c``): the same filter
coefficients, normalised per output pixel, rounded to 22 fraction bits, a
horizontal then a vertical pass with rounding and a clip to uint8 after
each, in int32 as PIL sums.  It gives PIL's pixels bit for bit.
"""

from __future__ import annotations

import dataclasses

import numpy as np

CLIP_MEAN = (0.48145466, 0.4578275, 0.40821073)
CLIP_STD = (0.26862954, 0.26130258, 0.27577711)
SAM_MEAN = (123.675, 116.28, 103.53)
SAM_STD = (58.395, 57.12, 57.375)

PRECISION_BITS = 22  # PIL's fixed point for 8-bit images: 32 - 8 - 2


def _bilinear(x: np.ndarray) -> np.ndarray:
    x = np.abs(x)
    return np.where(x < 1.0, 1.0 - x, 0.0)


def _bicubic(x: np.ndarray) -> np.ndarray:
    """Keys' cubic with a = -0.5, in PIL's order of operations."""
    a = -0.5
    x = np.abs(x)
    near = ((a + 2.0) * x - (a + 3.0)) * x * x + 1
    far = (((x - 5) * x + 8) * x - 4) * a
    return np.where(x < 1.0, near, np.where(x < 2.0, far, 0.0))


# resample name -> (filter, support); "bicubic" is Image.BICUBIC
FILTERS = {"bilinear": (_bilinear, 1.0), "bicubic": (_bicubic, 2.0)}


def resample_taps(in_size: int, out_size: int, name: str) -> tuple:
    """One axis of PIL's ``precompute_coeffs`` and
    ``normalize_coeffs_8bpc``: ``(index, coeff)``, both ``(out_size,
    ksize)``, the input pixel of each tap and its int32 coefficient in units
    of 2**-22 (0 on taps beyond the filter's bounds)."""
    fn, support = FILTERS[name]
    scale = in_size / out_size
    filterscale = max(scale, 1.0)
    support = support * filterscale
    ksize = int(np.ceil(support)) * 2 + 1
    center = (np.arange(out_size) + 0.5) * scale
    xmin = np.maximum(np.trunc(center - support + 0.5), 0).astype(np.int64)
    xmax = np.minimum(np.trunc(center + support + 0.5),
                      in_size).astype(np.int64) - xmin
    taps = np.arange(ksize)
    live = taps[None, :] < xmax[:, None]
    w = fn((taps[None, :] + xmin[:, None] - center[:, None] + 0.5)
           * (1.0 / filterscale))
    w = np.where(live, w, 0.0)
    ww = np.zeros(out_size)
    for j in range(ksize):  # PIL's order of summation
        ww = ww + w[:, j]
    w = w / np.where(ww == 0.0, 1.0, ww)[:, None]
    coeff = np.trunc(w * (1 << PRECISION_BITS) + np.where(w < 0, -0.5, 0.5))
    index = np.minimum(xmin[:, None] + taps[None, :], in_size - 1)
    return index, np.where(live, coeff, 0).astype(np.int32)


def _pass(image: np.ndarray, axis: int, out_size: int, name: str
          ) -> np.ndarray:
    """One pass along ``axis`` (0 rows, 1 columns) of an ``(H, W, C)``
    uint8 image: the fixed-point sum over the taps, PIL's rounding offset,
    shift and clip to uint8.  It runs over the leading axis of a contiguous
    copy (the transpose for the columns), so that a tap gathers whole rows
    into one reused buffer."""
    index, coeff = resample_taps(image.shape[axis], out_size, name)
    x = np.ascontiguousarray(np.moveaxis(image, axis, 0))
    src = x.reshape(x.shape[0], -1).astype(np.int32)
    acc = np.full((out_size, src.shape[1]), 1 << (PRECISION_BITS - 1),
                  np.int32)
    tap = np.empty_like(acc)
    for j in range(index.shape[1]):
        np.take(src, index[:, j], axis=0, out=tap)
        tap *= coeff[:, j, None]
        acc += tap
    acc >>= PRECISION_BITS
    out = np.clip(acc, 0, 255).astype(np.uint8)
    return np.moveaxis(out.reshape((out_size,) + x.shape[1:]), 0, axis)


def resample(image: np.ndarray, out_hw: tuple, name: str = "bicubic"
             ) -> np.ndarray:
    """``(H, W, C)`` uint8 -> ``(oh, ow, C)`` uint8, as PIL's
    ``Image.resize((ow, oh), filter)`` resamples an 8-bit image: the
    horizontal pass, then the vertical one, each only where its size
    changes."""
    if image.dtype != np.uint8 or image.ndim != 3:
        raise ValueError(f"resample takes (H, W, C) uint8, got "
                         f"{image.dtype} {image.shape}")
    if name not in FILTERS:
        raise ValueError(f"resample {name!r}: one of {sorted(FILTERS)}")
    oh, ow = out_hw
    out = image
    if ow != image.shape[1]:
        out = _pass(out, 1, ow, name)
    if oh != image.shape[0]:
        out = _pass(out, 0, oh, name)
    return out


@dataclasses.dataclass(frozen=True)
class ProcessorConfig:
    size: int = 384
    mean: tuple = CLIP_MEAN
    std: tuple = CLIP_STD
    # 'deepseek': floor(h/max*size) with min clamp; 'llava': int(w*size/h);
    # 'hpt15': fit the target box
    size_rule: str = "deepseek"
    min_size: int = 14
    resample: str = "bicubic"  # or "bilinear"


def _target_hw(cfg: ProcessorConfig, w: int, h: int) -> tuple[int, int]:
    if cfg.size_rule == "deepseek":
        m = max(w, h)
        return (
            max(int(h / m * cfg.size), cfg.min_size),
            max(int(w / m * cfg.size), cfg.min_size),
        )
    if cfg.size_rule == "llava":
        if h > w:
            return cfg.size, int(w * cfg.size / h)
        return int(h * cfg.size / w), cfg.size
    if cfg.size_rule == "hpt15":
        # scale by the smaller of the (target/current) ratios so the result
        # fits the target box, int() truncation on the free dim; the pad
        # that follows is the square pad below
        if cfg.size / h < cfg.size / w:
            return cfg.size, int(w * cfg.size / h)
        return int(h * cfg.size / w), cfg.size
    raise ValueError(cfg.size_rule)


def _rgb(image: np.ndarray) -> np.ndarray:
    if image.dtype != np.uint8 or image.ndim != 3 or image.shape[2] != 3:
        raise ValueError(f"an image is an (H, W, 3) uint8 array, got "
                         f"{image.dtype} {image.shape}")
    return image


def square_pad_preprocess(image: np.ndarray, cfg: ProcessorConfig) -> dict:
    """``(H, W, 3)`` uint8 -> normalised ``(size, size, 3)`` f32 + padding
    meta: resize the long edge to ``size``, centre on a square of the mean
    colour, rescale and normalise."""
    h, w, _ = _rgb(image).shape
    th, tw = _target_hw(cfg, w, h)
    resized = resample(image, (th, tw), cfg.resample)
    canvas = np.empty((cfg.size, cfg.size, 3), np.uint8)
    canvas[:] = [int(x * 255) for x in cfg.mean]
    pad_h, pad_w = cfg.size - th, cfg.size - tw
    before_h, before_w = pad_h // 2, pad_w // 2
    canvas[before_h:before_h + th, before_w:before_w + tw] = resized
    arr = canvas.astype(np.float32) / 255.0
    arr = (arr - np.asarray(cfg.mean, np.float32)) / np.asarray(cfg.std,
                                                               np.float32)
    meta = {
        "padding": {
            "before_height": before_h, "after_height": pad_h - before_h,
            "before_width": before_w, "after_width": pad_w - before_w,
        },
        "image_shape": {"height": th, "width": tw},
        "padded_shape": {"height": cfg.size, "width": cfg.size},
    }
    return {"pixel_values": arr, "meta": meta, "image_size": (h, w)}


def sam_preprocess(image: np.ndarray, long_side: int = 1024) -> dict:
    """``(H, W, 3)`` uint8 -> SAM-normalised corner-padded ``(long, long,
    3)`` f32: bilinear resize of the long edge to ``long_side``."""
    h, w, _ = _rgb(image).shape
    scale = long_side / max(h, w)
    nh, nw = int(h * scale + 0.5), int(w * scale + 0.5)
    arr = resample(image, (nh, nw), "bilinear").astype(np.float32)
    arr = (arr - np.asarray(SAM_MEAN, np.float32)) / np.asarray(SAM_STD,
                                                                np.float32)
    out = np.zeros((long_side, long_side, 3), np.float32)
    out[:nh, :nw] = arr
    return {"sam_pixel_values": out, "sam_input_size": (nh, nw)}
