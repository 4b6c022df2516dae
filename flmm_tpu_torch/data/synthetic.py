"""Synthetic grounding batches (flmm_tpu/data/synthetic.py): the model's
exact batch schema, numpy only, identical to the JAX package's batches for
the same config and seed -- random content (:func:`synthetic_batch`) or the
derivable coloured-rectangles task (:func:`synthetic_grounding_batch`)."""

from __future__ import annotations

import numpy as np

from flmm_tpu_torch.data import geometry
from flmm_tpu_torch.models.mask_head.unet import output_hw


def synthetic_batch(cfg, batch_size: int = 2, seq_len: int | None = None,
                    max_masks: int = 3, text_tokens_per_mask: int = 4,
                    seed: int = 0, image_token_id: int = 5) -> dict:
    """A dict of numpy arrays: input_ids, attn_mask, mask_ids, mask_valid,
    text_idx, text_valid, pixel_values (NHWC), sam_pixel_values, geom and
    the loss targets gt_coarse, coarse_weight, gt_sam, sam_weight."""
    rng = np.random.default_rng(seed)
    B, M, T = batch_size, max_masks, text_tokens_per_mask
    n_img = cfg.num_img_tokens
    S = seq_len or (cfg.img_start + n_img + 32)
    lmm_size = cfg.input_size
    sam_size = cfg.sam.encoder.img_size
    Hc, Wc = output_hw(cfg.unet, (cfg.clip_shape, cfg.clip_shape))
    P = cfg.sam.prompt_size

    input_ids = rng.integers(10, cfg.llm.vocab_size, (B, S)).astype(np.int32)
    input_ids[:, cfg.img_start:cfg.img_start + n_img] = image_token_id
    attn_mask = np.ones((B, S), bool)
    attn_mask[:, S - 4:] = False  # trailing padding

    mask_ids = np.full((B, S), -1, np.int32)
    text_idx = np.zeros((B, M, T), np.int32)
    text_valid = np.zeros((B, M, T), bool)
    mask_valid = np.zeros((B, M), bool)
    caption_start = cfg.img_start + n_img + 2
    for b in range(B):
        pos = caption_start
        for m in range(int(rng.integers(1, M + 1))):
            n_t = int(rng.integers(1, T + 1))
            span = list(range(pos, min(pos + n_t, S - 5)))
            if not span:
                break
            mask_ids[b, span] = m
            text_idx[b, m, :len(span)] = span
            text_valid[b, m, :len(span)] = True
            mask_valid[b, m] = True
            pos += n_t + 1

    metas, sam_hws = [], []
    gt_coarse = np.zeros((B, M, Hc, Wc), np.float32)
    gt_sam = np.zeros((B, M, P, P), np.float32)
    cw = np.zeros((B, Hc, Wc), np.float32)
    sw = np.zeros((B, P, P), np.float32)
    for b in range(B):
        oh = int(rng.integers(60, 200))
        ow = int(rng.integers(60, 200))
        meta = geometry.lmm_meta(oh, ow, lmm_size)
        nh, nw = geometry.sam_input_size(oh, ow, sam_size)
        metas.append(meta)
        sam_hws.append((nh, nw))
        cw[b] = geometry.coarse_weight(meta, (Hc, Wc))
        sw[b] = geometry.sam_weight((nh, nw), frame=P, long_side=sam_size)
        for m in range(M):
            if not mask_valid[b, m]:
                continue
            y0, x0 = rng.integers(0, Hc // 2), rng.integers(0, Wc // 2)
            gt_coarse[b, m, y0:y0 + Hc // 3, x0:x0 + Wc // 3] = 1.0
            gt_coarse[b, m] *= cw[b]
            ys, xs = rng.integers(0, P // 2), rng.integers(0, P // 2)
            gt_sam[b, m, ys:ys + P // 3, xs:xs + P // 3] = 1.0
            gt_sam[b, m] *= sw[b]

    return {
        "input_ids": input_ids,
        "attn_mask": attn_mask,
        "mask_ids": mask_ids,
        "mask_valid": mask_valid,
        "text_idx": text_idx,
        "text_valid": text_valid,
        "pixel_values": rng.standard_normal(
            (B, lmm_size, lmm_size, 3)).astype(np.float32) * 0.3,
        "sam_pixel_values": rng.standard_normal(
            (B, sam_size, sam_size, 3)).astype(np.float32) * 0.3,
        "geom": geometry.batch_geom(metas, (Hc, Wc), sam_hws),
        "gt_coarse": gt_coarse,
        "coarse_weight": cw,
        "gt_sam": gt_sam,
        "sam_weight": sw,
    }


def synthetic_grounding_batch(cfg, batch_size: int = 4, seed: int = 0,
                              image_token_id: int = 5) -> dict:
    """A derivable grounding task: two coloured rectangles per image whose
    masks are a function of the pixels, one caption word per colour.
    Object 0 lies in the left half, object 1 in the right half, positions
    and sizes random per image; the caption word is the only thing that
    tells the two masks of an image apart, so the trainable heads must learn
    to ground through the frozen model."""
    rng = np.random.default_rng(seed)
    base = cfg.base if hasattr(cfg, "base") else cfg
    B, M = batch_size, 2
    n_img = base.num_img_tokens
    lmm_size = base.input_size
    sam_size = base.sam.encoder.img_size
    Hc, Wc = output_hw(base.unet, (base.clip_shape, base.clip_shape))
    P = base.sam.prompt_size
    colors = np.asarray([[1.2, -0.6, 0.4], [-0.8, 1.0, -0.3]], np.float32)
    word_ids = (23, 67)

    S = base.img_start + n_img + 2 + 3 * M + 2
    input_ids = np.full((B, S), 7, np.int32)
    input_ids[:, base.img_start:base.img_start + n_img] = image_token_id
    attn_mask = np.ones((B, S), bool)
    mask_ids = np.full((B, S), -1, np.int32)
    text_idx = np.zeros((B, M, 2), np.int32)
    text_valid = np.ones((B, M, 2), bool)
    mask_valid = np.ones((B, M), bool)
    cap0 = base.img_start + n_img + 2
    for m in range(M):
        span = (cap0 + 3 * m, cap0 + 3 * m + 1)
        input_ids[:, span[0]] = word_ids[m]
        input_ids[:, span[1]] = word_ids[m]
        mask_ids[:, span[0]:span[1] + 1] = m
        text_idx[:, m] = [span[0], span[1]]

    pixels = rng.normal(0.0, 0.05, (B, lmm_size, lmm_size, 3)).astype(
        np.float32)
    sam_px = rng.normal(0.0, 0.05, (B, sam_size, sam_size, 3)).astype(
        np.float32)
    gt_coarse = np.zeros((B, M, Hc, Wc), np.float32)
    gt_sam = np.zeros((B, M, P, P), np.float32)
    metas, sam_hws = [], []
    for b in range(B):
        metas.append(geometry.lmm_meta(256, 256, lmm_size))
        sam_hws.append(geometry.sam_input_size(256, 256, sam_size))
        for m in range(M):
            # a normalised rectangle inside the object's half
            h = rng.uniform(0.25, 0.45)
            w = rng.uniform(0.15, 0.35)
            y0 = rng.uniform(0.02, 0.96 - h)
            x0 = 0.5 * m + rng.uniform(0.02, 0.46 - w)
            for img, size in ((pixels[b], lmm_size), (sam_px[b], sam_size)):
                ya, yb = int(y0 * size), int((y0 + h) * size)
                xa, xb = int(x0 * size), int((x0 + w) * size)
                img[ya:yb, xa:xb] = colors[m] + rng.normal(
                    0.0, 0.05, (yb - ya, xb - xa, 3))
            gt_coarse[b, m, int(y0 * Hc):int((y0 + h) * Hc),
                      int(x0 * Wc):int((x0 + w) * Wc)] = 1.0
            gt_sam[b, m, int(y0 * P):int((y0 + h) * P),
                   int(x0 * P):int((x0 + w) * P)] = 1.0

    cw = np.stack([geometry.coarse_weight(m, (Hc, Wc)) for m in metas])
    sw = np.stack([geometry.sam_weight(hw, frame=P, long_side=sam_size)
                   for hw in sam_hws])
    return {
        "input_ids": input_ids,
        "attn_mask": attn_mask,
        "mask_ids": mask_ids,
        "mask_valid": mask_valid,
        "text_idx": text_idx,
        "text_valid": text_valid,
        "pixel_values": pixels,
        "sam_pixel_values": sam_px,
        "geom": geometry.batch_geom(metas, (Hc, Wc), sam_hws),
        "gt_coarse": gt_coarse * cw[:, None],
        "coarse_weight": cw,
        "gt_sam": gt_sam * sw[:, None],
        "sam_weight": sw,
    }
