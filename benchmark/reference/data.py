"""The host batch builders the reference recomputes from the raw samples:
the PIL-exact resampler, the square-pad and SAM preprocesses, the geometry
metas, the static batch of the contiguous-image-block families and
LLaVA-NeXT's anyres batch, in numpy.  A frozen copy of the program's
builders, so that the reference derives every input itself."""

from __future__ import annotations

import dataclasses
import math

import numpy as np


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


import numpy as np



@dataclasses.dataclass(frozen=True)
class BatchSpec:
    seq_len: int = 704
    max_masks: int = 8
    text_per_mask: int = 16
    coarse_hw: tuple = (64, 64)
    sam_size: int = 1024
    prompt_size: int = 256
    pad_token_id: int = 0
    processor: ProcessorConfig = dataclasses.field(
        default_factory=ProcessorConfig)
    # hybrid towers: also a high-res square-padded tensor at this size (the
    # low-res tensor stays at processor.size)
    hires_size: int | None = None
    # pad the prompt so the image block starts at a multiple of this (128
    # for the flash-capture decoder kernel); masked pads and explicit
    # position ids keep RoPE as for the unpadded sequence
    align_image_block: int | None = None
    # the model config's static img_start, checked against each sample's
    # (aligned) value so that the image embeddings never land elsewhere
    expected_img_start: int | None = None


def _nearest_resize(mask: np.ndarray, out_hw: tuple[int, int]) -> np.ndarray:
    h, w = mask.shape
    oh, ow = out_hw
    rows = np.floor(np.arange(oh) * (h / oh)).astype(np.int64)
    cols = np.floor(np.arange(ow) * (w / ow)).astype(np.int64)
    return mask[rows][:, cols]


def embed_gt_coarse(mask: np.ndarray, meta: dict,
                    coarse_hw: tuple[int, int]) -> np.ndarray:
    """GT mask (original resolution) -> binary map in the coarse padded
    frame: resized to the meta's image shape, placed into the padded canvas,
    then nearest-resized to the coarse grid."""
    ih = meta["image_shape"]["height"]
    iw = meta["image_shape"]["width"]
    ph = meta["padded_shape"]["height"]
    pw = meta["padded_shape"]["width"]
    bh = meta["padding"]["before_height"]
    bw = meta["padding"]["before_width"]
    canvas = np.zeros((ph, pw), np.float32)
    canvas[bh:bh + ih, bw:bw + iw] = _nearest_resize(
        mask.astype(np.float32), (ih, iw))
    return _nearest_resize(canvas, coarse_hw)


def embed_gt_sam(mask: np.ndarray, sam_hw: tuple[int, int], prompt_size: int,
                 sam_size: int = 1024) -> np.ndarray:
    """GT mask (original resolution) -> binary map in the low-res SAM
    frame."""
    nh, nw = sam_hw
    rh = max(1, int(round(nh * prompt_size / sam_size)))
    rw = max(1, int(round(nw * prompt_size / sam_size)))
    out = np.zeros((prompt_size, prompt_size), np.float32)
    out[:rh, :rw] = _nearest_resize(mask.astype(np.float32), (rh, rw))
    return out


def build_batch(samples: list[dict], spec: BatchSpec) -> dict:
    """Samples -> one static batch of numpy arrays, plus ``infos`` (file
    name, original size, number of valid masks and mask infos per
    sample)."""
    B = len(samples)
    S, M, T = spec.seq_len, spec.max_masks, spec.text_per_mask
    P = spec.prompt_size
    Hc, Wc = spec.coarse_hw

    input_ids = np.full((B, S), spec.pad_token_id, np.int32)
    attn_mask = np.zeros((B, S), bool)
    mask_ids = np.full((B, S), -1, np.int32)
    mask_valid = np.zeros((B, M), bool)
    text_idx = np.zeros((B, M, T), np.int32)
    text_valid = np.zeros((B, M, T), bool)
    pixels = np.zeros((B, spec.processor.size, spec.processor.size, 3),
                      np.float32)
    hires = (np.zeros((B, spec.hires_size, spec.hires_size, 3), np.float32)
             if spec.hires_size else None)
    sam_pixels = np.zeros((B, spec.sam_size, spec.sam_size, 3), np.float32)
    gt_coarse = np.zeros((B, M, Hc, Wc), np.float32)
    gt_sam = np.zeros((B, M, P, P), np.float32)
    cweight = np.zeros((B, Hc, Wc), np.float32)
    sweight = np.zeros((B, P, P), np.float32)
    metas, sam_hws, infos = [], [], []

    align_pad = 0
    if spec.align_image_block and samples:
        a = spec.align_image_block
        align_pad = (a - samples[0]["img_start"] % a) % a

    for b, s in enumerate(samples):
        if spec.expected_img_start is not None:
            got = s["img_start"] + align_pad
            if got != spec.expected_img_start:
                raise ValueError(
                    f"sample img_start {s['img_start']} (+align {align_pad})"
                    f" = {got} != config img_start "
                    f"{spec.expected_img_start}: the prompt layout and the "
                    "model config disagree")
        full_ids = s["input_ids"]
        full_mids = s["mask_ids"]
        span_shift = 0
        if align_pad:
            st = s["img_start"]
            full_ids = np.concatenate([
                full_ids[:st],
                np.full((align_pad,), spec.pad_token_id, np.int32),
                full_ids[st:],
            ])
            full_mids = np.concatenate([
                full_mids[:st], np.full((align_pad,), -1, np.int32),
                full_mids[st:],
            ])
            span_shift = align_pad
        ids = full_ids[:S]
        n = len(ids)
        input_ids[b, :n] = ids
        attn_mask[b, :n] = True
        if align_pad:
            st = s["img_start"]
            attn_mask[b, st:st + align_pad] = False
        mids = full_mids[:S]
        mids = np.where(mids >= M, -1, mids)
        mask_ids[b, :len(mids)] = mids

        proc = square_pad_preprocess(s["image"], spec.processor)
        sam = sam_preprocess(s["image"], spec.sam_size)
        pixels[b] = proc["pixel_values"]
        if hires is not None:
            hires[b] = square_pad_preprocess(s["image"], dataclasses.replace(
                spec.processor, size=spec.hires_size))["pixel_values"]
        sam_pixels[b] = sam["sam_pixel_values"]
        meta, sam_hw = proc["meta"], sam["sam_input_size"]
        metas.append(meta)
        sam_hws.append(sam_hw)
        cweight[b] = coarse_weight(meta, (Hc, Wc))
        sweight[b] = sam_weight(sam_hw, frame=P,
                                         long_side=spec.sam_size)

        masks = s["masks"][:M]
        for m, (mask, span) in enumerate(zip(masks, s["spans"][:M])):
            lo, hi = span[0] + span_shift, span[1] + span_shift
            hi = min(hi, n)
            if hi <= lo:
                continue
            mask_valid[b, m] = True
            k = min(hi - lo, T)
            text_idx[b, m, :k] = np.arange(lo, lo + k)
            text_valid[b, m, :k] = True
            gt_coarse[b, m] = embed_gt_coarse(mask, meta, (Hc, Wc))
            gt_sam[b, m] = embed_gt_sam(mask, sam_hw, P, spec.sam_size)
        infos.append({
            "file_name": s.get("file_name"),
            "orig_size": s["masks"].shape[-2:],
            "num_masks": int(mask_valid[b].sum()),
            "mask_infos": s.get("mask_infos"),
        })

    position_ids = np.maximum(np.cumsum(attn_mask, axis=1) - 1, 0).astype(
        np.int32)
    out = {
        "input_ids": input_ids,
        "attn_mask": attn_mask,
        "position_ids": position_ids,
        "mask_ids": mask_ids,
        "mask_valid": mask_valid,
        "text_idx": text_idx,
        "text_valid": text_valid,
        "pixel_values": pixels,
        "sam_pixel_values": sam_pixels,
        "geom": batch_geom(metas, (Hc, Wc), sam_hws),
        "gt_coarse": gt_coarse,
        "coarse_weight": cweight,
        "gt_sam": gt_sam,
        "sam_weight": sweight,
        "infos": infos,
    }
    if hires is not None:
        out["hires_pixel_values"] = hires
    return out


import numpy as np


DEFAULT_PINPOINTS = ((336, 672), (672, 336), (672, 672), (1008, 336),
                     (336, 1008))


def select_best_resolution(orig_hw: tuple, pinpoints) -> tuple:
    """HF select_best_resolution: max effective resolution, min waste."""
    oh, ow = orig_hw
    best, best_fit, min_waste = None, 0, float("inf")
    for th, tw in pinpoints:
        scale = min(tw / ow, th / oh)
        dw, dh = int(ow * scale), int(oh * scale)
        effective = min(dw * dh, ow * oh)
        waste = th * tw - effective
        if effective > best_fit or (effective == best_fit and waste < min_waste):
            best, best_fit, min_waste = (th, tw), effective, waste
    return best


def _patch_output_size(oh, ow, th, tw) -> tuple:
    if tw / ow < th / oh:
        return min(math.ceil(oh * tw / ow), th), tw
    return th, min(math.ceil(ow * th / oh), tw)


def unpad_feature_hw(orig_hw: tuple, canvas_hw: tuple) -> tuple[int, int, int, int]:
    """Feature-space unpad math (upstream ``unpad_image``): returns
    (fh, fw, pad_r, pad_c) -- the retained extent and its offset in the
    padded canvas."""
    oh, ow = orig_hw
    ch, cw = canvas_hw
    if ow / oh > cw / ch:
        new_h = int(oh * (cw / ow))
        pad = (ch - new_h) // 2
        return ch - 2 * pad, cw, pad, 0
    new_w = int(ow * (ch / oh))
    pad = (cw - new_w) // 2
    return ch, cw - 2 * pad, 0, pad


@dataclasses.dataclass(frozen=True)
class AnyresSpec:
    tile_size: int = 336
    patch_size: int = 14
    pinpoints: tuple = DEFAULT_PINPOINTS
    mean: tuple = CLIP_MEAN
    std: tuple = CLIP_STD

    @property
    def grid(self) -> int:
        return self.tile_size // self.patch_size  # 24

    @property
    def max_tiles(self) -> int:
        g = self.tile_size
        return max((th // g) * (tw // g) for th, tw in self.pinpoints)

    @property
    def max_fine_hw(self) -> tuple:
        g, gr = self.tile_size, self.grid
        fh = max((th // g) * gr for th, tw in self.pinpoints)
        fw = max((tw // g) * gr for th, tw in self.pinpoints)
        return fh, fw

    @property
    def n_img_max(self) -> int:
        g, gr = self.tile_size, self.grid
        n_fine = max(
            ((th // g) * gr) * ((tw // g) * gr + 1) for th, tw in self.pinpoints
        )
        return gr * gr + n_fine


def anyres_geometry(orig_hw: tuple, spec: AnyresSpec) -> dict:
    """The size-only part of ``anyres_process``: the tile grid of the best
    pinpoint and the unpadded fine extent with its offset."""
    th, tw = select_best_resolution(orig_hw, spec.pinpoints)
    ph, pw = th // spec.tile_size, tw // spec.tile_size
    fh, fw, pad_r, pad_c = unpad_feature_hw(
        orig_hw, (ph * spec.grid, pw * spec.grid))
    return {"grid": (ph, pw), "fine_hw": (fh, fw), "fine_pad": (pad_r, pad_c)}


def _normalize(image: np.ndarray, spec: AnyresSpec) -> np.ndarray:
    arr = image.astype(np.float32) / 255.0
    return (arr - np.asarray(spec.mean, np.float32)) / np.asarray(
        spec.std, np.float32)


def anyres_process(image: np.ndarray, spec: AnyresSpec) -> dict:
    """``(H, W, 3)`` uint8 image -> the normalised base view ``(g, g, 3)``
    and tiles ``(n, g, g, 3)``, the grid shape and the fine-frame geometry:
    a bicubic resize into the best pinpoint, centred on a black canvas, cut
    into tiles; the base view is the whole image resized to one tile."""
    if image.dtype != np.uint8 or image.ndim != 3 or image.shape[2] != 3:
        raise ValueError(f"an image is an (H, W, 3) uint8 array, got "
                         f"{image.dtype} {image.shape}")
    h, w, _ = image.shape
    th, tw = select_best_resolution((h, w), spec.pinpoints)
    nh, nw = _patch_output_size(h, w, th, tw)
    canvas = np.zeros((th, tw, 3), np.uint8)
    top, left = (th - nh) // 2, (tw - nw) // 2
    canvas[top:top + nh, left:left + nw] = resample(image, (nh, nw),
                                                    "bicubic")
    carr = _normalize(canvas, spec)
    g = spec.tile_size
    ph, pw = th // g, tw // g
    tiles = [carr[r * g:(r + 1) * g, c * g:(c + 1) * g]
             for r in range(ph) for c in range(pw)]
    base = _normalize(resample(image, (g, g), "bicubic"), spec)
    geo = anyres_geometry((h, w), spec)
    return {"base": base, "tiles": np.stack(tiles), "grid": geo["grid"],
            "fine_hw": geo["fine_hw"], "fine_pad": geo["fine_pad"],
            "orig_hw": (h, w)}


def block_layout(spec: AnyresSpec, grid: tuple, fine_hw: tuple,
                 fine_pad: tuple) -> dict:
    """Index maps for the padded image block over the per-sample feature
    source ``[base (g2) | tiles (T_max*g2) | newline | zero]``:
    block_index / block_valid ``(n_img_max,)`` and fine_gather / fine_valid
    ``(max_fh*max_fw,)`` (block-slot offsets for the fine-map re-assembly,
    0 where invalid)."""
    gr = spec.grid
    g2 = gr * gr
    ph, pw = grid
    fh, fw = fine_hw
    pad_r, pad_c = fine_pad
    n_max = spec.n_img_max
    newline_idx = g2 * (1 + spec.max_tiles)
    zero_idx = newline_idx + 1

    block_index = np.full((n_max,), zero_idx, np.int32)
    block_valid = np.zeros((n_max,), bool)
    block_index[:g2] = np.arange(g2)
    block_valid[:g2] = True
    n_fine = fh * (fw + 1)
    j = np.arange(n_fine)
    r = j // (fw + 1)
    c = j % (fw + 1)
    is_newline = c == fw
    rr = r + pad_r
    cc = c + pad_c
    tile = (rr // gr) * pw + (cc // gr)
    src = g2 + tile * g2 + (rr % gr) * gr + (cc % gr)
    block_index[g2:g2 + n_fine] = np.where(is_newline, newline_idx, src)
    block_valid[g2:g2 + n_fine] = True

    max_fh, max_fw = spec.max_fine_hw
    k = np.arange(max_fh * max_fw)
    kr = k // max_fw
    kc = k % max_fw
    fine_ok = (kr < fh) & (kc < fw)
    fine_gather = np.where(fine_ok, g2 + kr * (fw + 1) + kc, 0).astype(np.int32)
    return {
        "block_index": block_index,
        "block_valid": block_valid,
        "fine_gather": fine_gather,
        "fine_valid": fine_ok,
    }


def _empty_batch(B: int, spec: BatchSpec, anyres: AnyresSpec) -> dict:
    S, M, T = spec.seq_len, spec.max_masks, spec.text_per_mask
    P = spec.prompt_size
    Hc, Wc = spec.coarse_hw
    g = anyres.tile_size
    n_fine = anyres.max_fine_hw[0] * anyres.max_fine_hw[1]
    return {
        "input_ids": np.full((B, S), spec.pad_token_id, np.int32),
        "attn_mask": np.zeros((B, S), bool),
        "position_ids": np.zeros((B, S), np.int32),
        "mask_ids": np.full((B, S), -1, np.int32),
        "mask_valid": np.zeros((B, M), bool),
        "text_idx": np.zeros((B, M, T), np.int32),
        "text_valid": np.zeros((B, M, T), bool),
        "tiles": np.zeros((B, 1 + anyres.max_tiles, g, g, 3), np.float32),
        "tile_valid": np.zeros((B, 1 + anyres.max_tiles), bool),
        "block_index": np.zeros((B, anyres.n_img_max), np.int32),
        "block_valid": np.zeros((B, anyres.n_img_max), bool),
        "fine_gather": np.zeros((B, n_fine), np.int32),
        "fine_valid": np.zeros((B, n_fine), bool),
        "fine_hw": np.zeros((B, 2), np.float32),
        "sam_pixel_values": np.zeros((B, spec.sam_size, spec.sam_size, 3),
                                     np.float32),
        "gt_coarse": np.zeros((B, M, Hc, Wc), np.float32),
        "coarse_weight": np.zeros((B, Hc, Wc), np.float32),
        "gt_sam": np.zeros((B, M, P, P), np.float32),
        "sam_weight": np.zeros((B, P, P), np.float32),
    }


def _sample_rows(out: dict, b: int, s: dict, spec: BatchSpec,
                 anyres: AnyresSpec, geo: dict) -> tuple[int, int]:
    """Row ``b`` of the index maps and of everything the token streams give:
    input_ids, attn_mask with the image-block holes, position_ids skipping
    them, mask_ids.  Masked pads inserted before the image block make it
    ``spec.align_image_block``-aligned for the flash-capture kernel.
    Returns ``(span_shift, n)``: the pads inserted and the row's length."""
    layout = block_layout(anyres, geo["grid"], geo["fine_hw"],
                          geo["fine_pad"])
    for k in ("block_index", "block_valid", "fine_gather", "fine_valid"):
        out[k][b] = layout[k]
    out["fine_hw"][b] = geo["fine_hw"]

    S, M = spec.seq_len, spec.max_masks
    full_ids, full_mids = s["input_ids"], s["mask_ids"]
    img_start = s["img_start"]
    span_shift = 0
    if spec.align_image_block:
        a = spec.align_image_block
        pad_n = (a - img_start % a) % a
        if pad_n:
            full_ids = np.concatenate([
                full_ids[:img_start],
                np.full((pad_n,), spec.pad_token_id, np.int32),
                full_ids[img_start:]])
            full_mids = np.concatenate([
                full_mids[:img_start], np.full((pad_n,), -1, np.int32),
                full_mids[img_start:]])
            span_shift = pad_n
            img_start += pad_n
    if (spec.expected_img_start is not None
            and img_start != spec.expected_img_start):
        raise ValueError(f"sample img_start {img_start} != config "
                         f"img_start {spec.expected_img_start}; prompt "
                         "template/tokenizer drifted from the model config")
    ids = full_ids[:S]
    n = len(ids)
    out["input_ids"][b, :n] = ids
    valid = np.zeros((S,), bool)
    valid[:n] = True
    if span_shift:
        valid[img_start - span_shift:img_start] = False
    valid[img_start:img_start + anyres.n_img_max] = layout["block_valid"]
    out["attn_mask"][b] = valid
    out["position_ids"][b] = np.maximum(np.cumsum(valid) - 1, 0)
    mids = full_mids[:S]
    out["mask_ids"][b, :len(mids)] = np.where(mids >= M, -1, mids)
    return span_shift, n


def _text_row(out: dict, b: int, m: int, span, span_shift: int, n: int,
              text_per_mask: int) -> bool:
    """Mask ``m``'s text indices (its span shifted by the alignment pads,
    cut at the row's length); False where nothing of the span is left."""
    lo, hi = span[0] + span_shift, min(span[1] + span_shift, n)
    if hi <= lo:
        return False
    out["mask_valid"][b, m] = True
    kk = min(hi - lo, text_per_mask)
    out["text_idx"][b, m, :kk] = np.arange(lo, lo + kk)
    out["text_valid"][b, m, :kk] = True
    return True


def build_anyres_batch(samples: list[dict], spec: BatchSpec,
                       anyres: AnyresSpec) -> dict:
    """Samples with ``(H, W, 3)`` uint8 images -> one static LLaVA-NeXT
    batch: the standard schema (``spec.processor`` and ``spec.hires_size``
    are not read) with tiles ``(B, 1 + T_max, g, g, 3)`` (the base view,
    then the best pinpoint's tiles), tile_valid, block_index/block_valid,
    fine_gather/fine_valid, position_ids, fine_hw, the geometry and
    ``infos``."""
    B = len(samples)
    M, P = spec.max_masks, spec.prompt_size
    Hc, Wc = spec.coarse_hw
    out = _empty_batch(B, spec, anyres)
    metas, sam_hws, infos = [], [], []
    for b, s in enumerate(samples):
        proc = anyres_process(s["image"], anyres)
        n_tiles = proc["tiles"].shape[0]
        out["tiles"][b, 0] = proc["base"]
        out["tiles"][b, 1:1 + n_tiles] = proc["tiles"]
        out["tile_valid"][b, :1 + n_tiles] = True
        span_shift, n = _sample_rows(out, b, s, spec, anyres, proc)

        meta = lmm_meta(*proc["orig_hw"], anyres.tile_size)
        sam = sam_preprocess(s["image"], spec.sam_size)
        out["sam_pixel_values"][b] = sam["sam_pixel_values"]
        metas.append(meta)
        sam_hws.append(sam["sam_input_size"])
        out["coarse_weight"][b] = coarse_weight(meta, (Hc, Wc))
        out["sam_weight"][b] = sam_weight(
            sam["sam_input_size"], frame=P, long_side=spec.sam_size)

        for m, (mask, span) in enumerate(zip(s["masks"][:M],
                                             s["spans"][:M])):
            if _text_row(out, b, m, span, span_shift, n, spec.text_per_mask):
                out["gt_coarse"][b, m] = embed_gt_coarse(mask, meta,
                                                         (Hc, Wc))
                out["gt_sam"][b, m] = embed_gt_sam(
                    mask, sam["sam_input_size"], P, spec.sam_size)
        infos.append({
            "file_name": s.get("file_name"),
            "orig_size": s["masks"].shape[-2:],
            "num_masks": int(out["mask_valid"][b].sum()),
            "mask_infos": s.get("mask_infos"),
        })
    out["geom"] = batch_geom(metas, (Hc, Wc), sam_hws)
    out["infos"] = infos
    return out


