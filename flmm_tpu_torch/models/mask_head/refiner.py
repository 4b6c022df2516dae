"""SAM refiner: coarse U-Net logits -> refined SAM masks for one image
(flmm_tpu/models/mask_head/refiner.py::refine).

Per mask: a box prompt from the thresholded coarse mask, a dense prompt from
the coarse logits resampled into the SAM frame, and the text embeddings
appended to the sparse tokens; one batched mask-decoder call over the
image's masks.  All geometry is carried as per-image scalars through
:func:`affine_grid_sample`.  The grounding model loops over the batch.
"""

from __future__ import annotations

import dataclasses

import torch

from flmm_tpu_torch.models.sam import mask_decoder as sam_decoder
from flmm_tpu_torch.models.sam import prompt_encoder as sam_prompt
from flmm_tpu_torch.models.sam.image_encoder import SamEncoderConfig
from flmm_tpu_torch.models.sam.mask_decoder import MaskDecoderConfig
from flmm_tpu_torch.models.sam.prompt_encoder import PromptEncoderConfig
from flmm_tpu_torch.ops.losses import mask_iou
from flmm_tpu_torch.ops.masks import mask_to_box
from flmm_tpu_torch.ops.resize import affine_grid_sample


@dataclasses.dataclass(frozen=True)
class SamRefinerConfig:
    encoder: SamEncoderConfig = dataclasses.field(
        default_factory=SamEncoderConfig)
    prompt: PromptEncoderConfig = dataclasses.field(
        default_factory=PromptEncoderConfig)
    decoder: MaskDecoderConfig = dataclasses.field(
        default_factory=MaskDecoderConfig)
    use_text: bool = True
    use_mask: bool = True
    use_box: bool = True
    multimask_output: bool = False
    box_frame: int = 256
    prompt_size: int = 256


def refine(params: dict, cfg: SamRefinerConfig,
           image_embedding: torch.Tensor, coarse_logits: torch.Tensor,
           geom: dict, text_embeds: torch.Tensor | None = None,
           text_valid: torch.Tensor | None = None) -> dict:
    """Refine the coarse masks ``(M, Hc, Wc)`` of one image.

    Args:
      image_embedding: ``(S, S, D)`` frozen SAM encoder output.
      geom: 0-d tensors crop_y/crop_x/crop_h/crop_w (coarse grid) and
        sam_h/sam_w (valid extent in the SAM frame).
      text_embeds: ``(M, T, D)`` projected text tokens; text_valid
        ``(M, T)`` bool.

    Returns low_res_logits ``(M, P, P)`` f32, iou_pred ``(M,)``,
    prompt_masks ``(M, P, P)`` and boxes ``(M, 4)``.
    """
    M, Hc, Wc = coarse_logits.shape
    P = cfg.prompt_size
    dev = coarse_logits.device
    cy, cx, ch, cw, nh, nw = (geom[k].float() for k in (
        "crop_y", "crop_x", "crop_h", "crop_w", "sam_h", "sam_w"))
    src_lo = torch.stack([cy, cx])
    src_hi = torch.stack([cy + ch - 1.0, cx + cw - 1.0])

    # dense prompt: coarse crop -> (sam_h, sam_w) region of the SAM frame,
    # padded with min(-1, ROI min), at prompt resolution
    ys = torch.arange(Hc, device=dev)[:, None]
    xs = torch.arange(Wc, device=dev)[None, :]
    in_roi = (ys >= cy) & (ys <= src_hi[0]) & (xs >= cx) & (xs <= src_hi[1])
    roi_min = torch.where(in_roi, coarse_logits, torch.inf).amin()
    # the reference reads this pad value on the host: no gradient
    pad_value = torch.clamp(roi_min, max=-1.0).detach()
    ratio = float(cfg.encoder.img_size) / P
    scale = torch.stack([ratio * ch / nh, ratio * cw / nw])
    prompt_masks = affine_grid_sample(
        coarse_logits, scale, src_lo, (P, P), fill=pad_value,
        src_lo=src_lo, src_hi=src_hi, mode="fill")

    # box prompt from the thresholded coarse mask in a fixed frame
    bf = cfg.box_frame
    box_view = affine_grid_sample(
        coarse_logits, torch.stack([ch / bf, cw / bf]), src_lo, (bf, bf),
        src_lo=src_lo, src_hi=src_hi, mode="clamp")
    boxes = mask_to_box(torch.sigmoid(box_view) > 0.5)
    boxes = boxes * torch.stack([nw, nh, nw, nh]) / bf

    pcfg = cfg.prompt
    sparse_parts, valid_parts = [], []
    if cfg.use_box:
        sparse_parts.append(sam_prompt.embed_boxes(params["prompt"], pcfg,
                                                   boxes))
        valid_parts.append(torch.ones((M, 2), dtype=torch.bool, device=dev))
    if cfg.use_text and text_embeds is not None:
        sparse_parts.append(text_embeds.to(image_embedding.dtype))
        valid_parts.append(
            text_valid if text_valid is not None
            else torch.ones(text_embeds.shape[:2], dtype=torch.bool,
                            device=dev))
    dt = sparse_parts[0].dtype
    for p in sparse_parts[1:]:
        dt = torch.promote_types(dt, p.dtype)
    sparse = torch.cat([p.to(dt) for p in sparse_parts], dim=1)
    sparse_valid = torch.cat(valid_parts, dim=1)

    if cfg.use_mask:
        dense = sam_prompt.embed_masks(params["prompt"], pcfg,
                                       prompt_masks[..., None])
    else:
        dense = sam_prompt.no_mask_dense(params["prompt"], pcfg, M)
    image_pe = sam_prompt.dense_pe(params["prompt"], pcfg)
    masks, iou_pred = sam_decoder.forward(
        params["decoder"], cfg.decoder, image_embedding, image_pe, sparse,
        dense, sparse_valid=sparse_valid)
    if cfg.multimask_output:
        # of the three candidates, the one whose binarised mask best
        # overlaps the binarised coarse prompt (reference
        # mask_refiner.py:114-118); the first of equal IoUs
        cand = masks[:, 1:]
        target = (prompt_masks > 0.0).float()[:, None].expand_as(cand)
        ious = mask_iou((cand > 0).float().flatten(0, 1),
                        target.flatten(0, 1)).reshape(M, -1)
        best = ious.argmax(dim=1)
        rows = torch.arange(M, device=dev)
        low_res, iou_sel = cand[rows, best], iou_pred[rows, best + 1]
    else:
        low_res, iou_sel = masks[:, 0], iou_pred[:, 0]
    return {
        "low_res_logits": low_res.float(),
        "iou_pred": iou_sel,
        "prompt_masks": prompt_masks,
        "boxes": boxes,
    }
