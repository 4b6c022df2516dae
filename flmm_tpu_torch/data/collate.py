"""Static-shape batch assembly (flmm_tpu/data/collate.py): samples of
variable sequence length and mask count, each with an ``(H, W, 3)`` uint8
image, become fixed ``(B, S)`` / ``(B, M, ...)`` numpy arrays with validity
masks, the ground truth embedded in the coarse and SAM frames, and the
per-sample geometry scalars the forward consumes.  Host code, numpy only;
the port's entry points move the arrays to the card.
"""

from __future__ import annotations

import dataclasses

import numpy as np

from flmm_tpu_torch.data import geometry
from flmm_tpu_torch.data.processors import (
    ProcessorConfig, sam_preprocess, square_pad_preprocess,
)


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
        cweight[b] = geometry.coarse_weight(meta, (Hc, Wc))
        sweight[b] = geometry.sam_weight(sam_hw, frame=P,
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
        "geom": geometry.batch_geom(metas, (Hc, Wc), sam_hws),
        "gt_coarse": gt_coarse,
        "coarse_weight": cweight,
        "gt_sam": gt_sam,
        "sam_weight": sweight,
        "infos": infos,
    }
    if hires is not None:
        out["hires_pixel_values"] = hires
    return out
