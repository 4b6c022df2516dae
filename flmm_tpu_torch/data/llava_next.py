"""LLaVA-NeXT anyres geometry and static-shape batches, numpy only
(flmm_tpu/data/llava_next.py without PIL).

The anyres math is carried over unchanged: best-resolution selection,
the feature-space unpad, and the index maps of the padded image block
(``n_img_max = g2 + max_fh * (max_fw + 1)`` slots: base row-major, then the
fine rows each ending in a newline token, then masked pad slots).  The
batch builder follows ``build_anyres_batch`` (:192-320) exactly for
everything derived from the token streams and the image sizes -- the
128-alignment pad insertion, ``attn_mask`` with the image-block holes,
``position_ids = max(cumsum(valid) - 1, 0)``, the index maps, ``mask_ids``,
``text_idx`` and the geometry -- while the pixels (base view and tiles,
SAM input) and the loss targets are drawn from a seed, since nothing on the
serving path needs a resized photo.  ``infos`` is not built.
:func:`anyres_process` resizes a real ``(H, W, 3)`` uint8 image into the
base view and the tiles (the generation path's input), with
``processors.resample`` in place of PIL's bicubic resize.
"""

from __future__ import annotations

import dataclasses
import math

import numpy as np

from flmm_tpu_torch.data import geometry
from flmm_tpu_torch.data.processors import resample
from flmm_tpu_torch.registry import get_coarse_hw

DEFAULT_PINPOINTS = ((336, 672), (672, 336), (672, 672), (1008, 336),
                     (336, 1008))
# CLIP image normalisation (flmm_tpu/data/processors.py)
CLIP_MEAN = (0.48145466, 0.4578275, 0.40821073)
CLIP_STD = (0.26862954, 0.26130258, 0.27577711)
IMAGE_TOKEN_ID = 5  # the synthetic streams' image placeholder


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


@dataclasses.dataclass(frozen=True)
class BatchSpec:
    """The fields of flmm_tpu.data.collate.BatchSpec the anyres builder
    reads."""
    seq_len: int = 704
    max_masks: int = 8
    text_per_mask: int = 16
    coarse_hw: tuple = (64, 64)
    sam_size: int = 1024
    prompt_size: int = 256
    pad_token_id: int = 0
    align_image_block: int | None = None
    expected_img_start: int | None = None


def synthetic_anyres_samples(orig_hws, n_img_max: int, img_start: int = 35,
                             max_masks: int = 8, caption_tokens: int = 12,
                             vocab_size: int = 256,
                             seed: int = 0) -> list[dict]:
    """Token streams shaped like the data pipeline's: ``img_start`` prompt
    tokens, ``n_img_max`` image placeholders, then per mask one or two
    plain caption tokens and ``caption_tokens`` tokens of the phrase.  Each
    sample is a dict of input_ids, mask_ids, spans, img_start and
    orig_hw (the image size the geometry is derived from)."""
    rng = np.random.default_rng(seed)
    prompt = (rng.integers(10, vocab_size, img_start).tolist()
              + [IMAGE_TOKEN_ID] * n_img_max + [9, 9])
    samples = []
    for oh, ow in orig_hws:
        ids, mids, spans = list(prompt), [-1] * len(prompt), []
        for m in range(max_masks):
            filler = rng.integers(10, vocab_size, int(rng.integers(1, 3)))
            ids += filler.tolist()
            mids += [-1] * len(filler)
            spans.append((len(ids), len(ids) + caption_tokens))
            ids += rng.integers(10, vocab_size, caption_tokens).tolist()
            mids += [m] * caption_tokens
        samples.append({
            "input_ids": np.asarray(ids, np.int32),
            "mask_ids": np.asarray(mids, np.int32),
            "spans": spans, "img_start": img_start,
            "orig_hw": (int(oh), int(ow)),
        })
    return samples


def build_synthetic_anyres_batch(samples: list[dict], spec: BatchSpec,
                                 anyres: AnyresSpec, seed: int = 0) -> dict:
    """Static batch for the LLaVA-NeXT model with the schema of
    ``build_anyres_batch``: input_ids, attn_mask, position_ids, mask_ids,
    mask_valid, text_idx, text_valid, tiles ``(B, 1+T_max, g, g, 3)``,
    tile_valid, block_index/block_valid, fine_gather/fine_valid, fine_hw,
    sam_pixel_values, geom and the loss targets."""
    rng = np.random.default_rng(seed)
    B = len(samples)
    S, M, T = spec.seq_len, spec.max_masks, spec.text_per_mask
    P = spec.prompt_size
    Hc, Wc = spec.coarse_hw
    g = anyres.tile_size
    n_max = anyres.n_img_max
    n_fine = anyres.max_fine_hw[0] * anyres.max_fine_hw[1]

    out = {
        "input_ids": np.full((B, S), spec.pad_token_id, np.int32),
        "attn_mask": np.zeros((B, S), bool),
        "position_ids": np.zeros((B, S), np.int32),
        "mask_ids": np.full((B, S), -1, np.int32),
        "mask_valid": np.zeros((B, M), bool),
        "text_idx": np.zeros((B, M, T), np.int32),
        "text_valid": np.zeros((B, M, T), bool),
        "tiles": np.zeros((B, 1 + anyres.max_tiles, g, g, 3), np.float32),
        "tile_valid": np.zeros((B, 1 + anyres.max_tiles), bool),
        "block_index": np.zeros((B, n_max), np.int32),
        "block_valid": np.zeros((B, n_max), bool),
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
    metas, sam_hws = [], []

    for b, s in enumerate(samples):
        oh, ow = s["orig_hw"]
        geo = anyres_geometry((oh, ow), anyres)
        layout = block_layout(anyres, geo["grid"], geo["fine_hw"],
                              geo["fine_pad"])
        n_tiles = geo["grid"][0] * geo["grid"][1]
        out["tiles"][b, :1 + n_tiles] = rng.standard_normal(
            (1 + n_tiles, g, g, 3)).astype(np.float32) * 0.3
        out["tile_valid"][b, :1 + n_tiles] = True
        for k in ("block_index", "block_valid", "fine_gather", "fine_valid"):
            out[k][b] = layout[k]
        out["fine_hw"][b] = geo["fine_hw"]

        # masked pads before the image block make it 128-aligned for the
        # flash-capture kernel; position ids skip them
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
                             f"img_start {spec.expected_img_start}")
        ids = full_ids[:S]
        n = len(ids)
        out["input_ids"][b, :n] = ids
        valid = np.zeros((S,), bool)
        valid[:n] = True
        if span_shift:
            valid[img_start - span_shift:img_start] = False
        valid[img_start:img_start + n_max] = layout["block_valid"]
        out["attn_mask"][b] = valid
        out["position_ids"][b] = np.maximum(np.cumsum(valid) - 1, 0)
        mids = full_mids[:S]
        out["mask_ids"][b, :len(mids)] = np.where(mids >= M, -1, mids)

        meta = geometry.lmm_meta(oh, ow, g)
        nh, nw = geometry.sam_input_size(oh, ow, spec.sam_size)
        out["sam_pixel_values"][b, :nh, :nw] = rng.standard_normal(
            (nh, nw, 3)).astype(np.float32) * 0.3
        metas.append(meta)
        sam_hws.append((nh, nw))
        out["coarse_weight"][b] = geometry.coarse_weight(meta, (Hc, Wc))
        out["sam_weight"][b] = geometry.sam_weight(
            (nh, nw), frame=P, long_side=spec.sam_size)

        for m, span in enumerate(s["spans"][:M]):
            lo, hi = span[0] + span_shift, min(span[1] + span_shift, n)
            if hi <= lo:
                continue
            out["mask_valid"][b, m] = True
            kk = min(hi - lo, T)
            out["text_idx"][b, m, :kk] = np.arange(lo, lo + kk)
            out["text_valid"][b, m, :kk] = True
            y0, x0 = rng.integers(0, Hc // 2), rng.integers(0, Wc // 2)
            out["gt_coarse"][b, m, y0:y0 + Hc // 3, x0:x0 + Wc // 3] = 1.0
            out["gt_coarse"][b, m] *= out["coarse_weight"][b]
            ys, xs = rng.integers(0, P // 2), rng.integers(0, P // 2)
            out["gt_sam"][b, m, ys:ys + P // 3, xs:xs + P // 3] = 1.0
            out["gt_sam"][b, m] *= out["sam_weight"][b]

    out["geom"] = geometry.batch_geom(metas, (Hc, Wc), sam_hws)
    return out


def synthetic_anyres_batch(cfg, orig_hws, prompt_len: int = 35,
                           max_masks: int = 8, caption_tokens: int = 12,
                           seed: int = 0) -> dict:
    """One anyres batch for a LlavaNextConfig, an image of each size in
    ``orig_hws`` ``(h, w)``: the sequence is bench.py's rule (longest
    sample + 8, a multiple of 128 when the decoder takes the flash-capture
    path, whose 128-aligned image block must then start at
    ``cfg.base.img_start``)."""
    base = cfg.base
    anyres = cfg.anyres_spec()
    samples = synthetic_anyres_samples(
        orig_hws, anyres.n_img_max, img_start=prompt_len,
        max_masks=max_masks, caption_tokens=caption_tokens,
        vocab_size=base.llm.vocab_size, seed=seed)
    align = 128 if base.llm.use_flash_capture else None
    pad_n = (align - prompt_len % align) % align if align else 0
    S = max(len(s["input_ids"]) for s in samples) + pad_n + 8
    if align:
        S = -(-S // align) * align
    spec = BatchSpec(
        seq_len=S, max_masks=max_masks, text_per_mask=caption_tokens,
        coarse_hw=get_coarse_hw(cfg), sam_size=base.sam.encoder.img_size,
        prompt_size=base.sam.prompt_size, align_image_block=align,
        expected_img_start=base.img_start)
    return build_synthetic_anyres_batch(samples, spec, anyres, seed=seed)
