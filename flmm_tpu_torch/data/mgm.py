"""MGM host processing (flmm_tpu/data/mgm.py) over ``(H, W, 3)`` uint8
arrays: the centred square pad in the CLIP mean colour (reference flmm/
datasets/pad2square_processor.py), the aux image at ``aux_size``, the main
image at ``grid * crop_size`` sliced into the crop grid and, for HD, the
global image appended last (frozen_mgm.py:_process_image), and the batch
builder.  The three bicubic resizes are ``processors.resample``, PIL's
``Image.resize(..., BICUBIC)`` bit for bit, so a batch equals the JAX
package's.
"""

from __future__ import annotations

import dataclasses

import numpy as np

from flmm_tpu_torch.data import geometry
from flmm_tpu_torch.data.collate import BatchSpec, embed_gt_coarse, \
    embed_gt_sam
from flmm_tpu_torch.data.processors import CLIP_MEAN, CLIP_STD, _rgb, \
    resample, sam_preprocess


@dataclasses.dataclass(frozen=True)
class MGMProcessSpec:
    crop_size: int = 336
    aux_size: int = 768
    image_grid: int = 1
    image_global: bool = False
    mean: tuple = CLIP_MEAN
    std: tuple = CLIP_STD

    @property
    def num_crops(self) -> int:
        return self.image_grid ** 2 + (1 if self.image_global else 0)


def _normalize(image: np.ndarray, spec: MGMProcessSpec) -> np.ndarray:
    arr = image.astype(np.float32) / 255.0
    return (arr - np.asarray(spec.mean, np.float32)) / np.asarray(
        spec.std, np.float32)


def pad2square(image: np.ndarray, mean: tuple) -> tuple[np.ndarray, dict]:
    """The image centred on a square canvas of colour ``int(mean * 255)``,
    and its padding meta."""
    h, w, _ = _rgb(image).shape
    size = max(w, h)
    canvas = np.empty((size, size, 3), np.uint8)
    canvas[:] = [int(x * 255) for x in mean]
    before_w, before_h = (size - w) // 2, (size - h) // 2
    canvas[before_h:before_h + h, before_w:before_w + w] = image
    meta = {
        "padding": {
            "before_height": before_h, "after_height": size - h - before_h,
            "before_width": before_w, "after_width": size - w - before_w,
        },
        "image_shape": {"height": h, "width": w},
        "padded_shape": {"height": size, "width": size},
    }
    return canvas, meta


def mgm_process(image: np.ndarray, spec: MGMProcessSpec) -> dict:
    """``crops`` ``(n_crops, crop, crop, 3)`` (grid row-major, the global
    image last), ``aux`` ``(aux, aux, 3)``, both normalised f32, and the
    square pad's ``meta``."""
    square, meta = pad2square(image, spec.mean)
    aux = _normalize(resample(square, (spec.aux_size,) * 2), spec)
    g, cs = spec.image_grid, spec.crop_size
    main = _normalize(resample(square, (cs * g,) * 2), spec)
    crops = [main[r * cs:(r + 1) * cs, c * cs:(c + 1) * cs]
             for r in range(g) for c in range(g)]
    if spec.image_global:
        crops.append(_normalize(resample(square, (cs, cs)), spec))
    return {"crops": np.stack(crops), "aux": aux, "meta": meta}


def build_mgm_batch(samples: list[dict], spec: BatchSpec,
                    mgm: MGMProcessSpec) -> dict:
    """Samples -> one static MGM batch of numpy arrays: the standard
    batch's keys without ``position_ids`` (the image block stays where the
    prompt puts it), ``pixel_values`` ``(B, n_crops, crop, crop, 3)`` and
    ``aux_pixel_values``, plus ``infos``."""
    B = len(samples)
    S, M, T = spec.seq_len, spec.max_masks, spec.text_per_mask
    P = spec.prompt_size
    Hc, Wc = spec.coarse_hw
    cs = mgm.crop_size

    out = {
        "input_ids": np.full((B, S), spec.pad_token_id, np.int32),
        "attn_mask": np.zeros((B, S), bool),
        "mask_ids": np.full((B, S), -1, np.int32),
        "mask_valid": np.zeros((B, M), bool),
        "text_idx": np.zeros((B, M, T), np.int32),
        "text_valid": np.zeros((B, M, T), bool),
        "pixel_values": np.zeros((B, mgm.num_crops, cs, cs, 3), np.float32),
        "aux_pixel_values": np.zeros((B, mgm.aux_size, mgm.aux_size, 3),
                                     np.float32),
        "sam_pixel_values": np.zeros((B, spec.sam_size, spec.sam_size, 3),
                                     np.float32),
        "gt_coarse": np.zeros((B, M, Hc, Wc), np.float32),
        "coarse_weight": np.zeros((B, Hc, Wc), np.float32),
        "gt_sam": np.zeros((B, M, P, P), np.float32),
        "sam_weight": np.zeros((B, P, P), np.float32),
    }
    metas, sam_hws, infos = [], [], []
    for b, s in enumerate(samples):
        if (spec.expected_img_start is not None and "img_start" in s
                and s["img_start"] != spec.expected_img_start):
            raise ValueError(
                f"sample img_start {s['img_start']} != config img_start "
                f"{spec.expected_img_start}: the prompt layout and the model "
                "config disagree")
        ids = s["input_ids"][:S]
        n = len(ids)
        out["input_ids"][b, :n] = ids
        out["attn_mask"][b, :n] = True
        mids = s["mask_ids"][:S]
        out["mask_ids"][b, :len(mids)] = np.where(mids >= M, -1, mids)

        proc = mgm_process(s["image"], mgm)
        sam = sam_preprocess(s["image"], spec.sam_size)
        out["pixel_values"][b] = proc["crops"]
        out["aux_pixel_values"][b] = proc["aux"]
        out["sam_pixel_values"][b] = sam["sam_pixel_values"]
        meta, sam_hw = proc["meta"], sam["sam_input_size"]
        metas.append(meta)
        sam_hws.append(sam_hw)
        out["coarse_weight"][b] = geometry.coarse_weight(meta, (Hc, Wc))
        out["sam_weight"][b] = geometry.sam_weight(
            sam_hw, frame=P, long_side=spec.sam_size)

        for m, (mask, span) in enumerate(zip(s["masks"][:M],
                                             s["spans"][:M])):
            lo, hi = span
            hi = min(hi, n)
            if hi <= lo:
                continue
            out["mask_valid"][b, m] = True
            k = min(hi - lo, T)
            out["text_idx"][b, m, :k] = np.arange(lo, lo + k)
            out["text_valid"][b, m, :k] = True
            out["gt_coarse"][b, m] = embed_gt_coarse(mask, meta, (Hc, Wc))
            out["gt_sam"][b, m] = embed_gt_sam(mask, sam_hw, P,
                                               spec.sam_size)
        infos.append({
            "file_name": s.get("file_name"),
            "orig_size": s["masks"].shape[-2:],
            "num_masks": int(out["mask_valid"][b].sum()),
            "mask_infos": s.get("mask_infos"),
        })
    out["geom"] = geometry.batch_geom(metas, (Hc, Wc), sam_hws)
    out["infos"] = infos
    return out
