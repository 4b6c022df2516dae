"""Frozen-LMM grounding model for contiguous-image-block families
(flmm_tpu/models/frozen/grounding.py): vision tower -> MLP aligner ->
frozen decoder with per-mask attention capture -> U-Net coarse head -> SAM
encoder + refiner -> losses (:func:`loss_fn`).  Not ported yet: the
DeepSeek-VL-7B hybrid tower.

Autograd: only the trainable tree carries gradients.  The frozen towers,
decoder and SAM encoder see no tensor that requires grad, so autograd
records nothing there and the kernels they launch need no backward; the
layer weights reach the loss through the decoder's hidden sum, U-Net,
``text_proj`` and the SAM prompt encoder and mask decoder through plain
ops."""

from __future__ import annotations

import dataclasses
import math
from typing import Any

import torch
import torch.nn.functional as F

from flmm_tpu_torch.models.frozen.base import grounding_losses
from flmm_tpu_torch.models.llm import decoder as llm
from flmm_tpu_torch.models.mask_head import refiner as sam_refiner
from flmm_tpu_torch.models.mask_head import unet
from flmm_tpu_torch.models.sam import image_encoder as sam_encoder
from flmm_tpu_torch.models.sam import mask_decoder as smd
from flmm_tpu_torch.models.sam import prompt_encoder as spe
from flmm_tpu_torch.models.vision import vit
from flmm_tpu_torch.ops import masks as mask_ops


@dataclasses.dataclass(frozen=True)
class GroundingConfig:
    llm: llm.DecoderConfig
    vision: vit.ViTConfig
    unet: unet.UNetConfig
    sam: sam_refiner.SamRefinerConfig
    projector_depth: int = 2
    img_start: int = 5
    num_img_tokens: int = 576
    clip_shape: int = 24
    merge: str = "mean"
    vision_select_layer: int = -1
    vision_drop_cls: bool = False
    image_input_size: int | None = None
    hybrid_high: Any = None
    dtype: torch.dtype = torch.bfloat16

    def __post_init__(self):
        if self.hybrid_high is not None:
            raise NotImplementedError("the hybrid SAM-B tower is not ported")

    @property
    def input_size(self) -> int:
        return self.image_input_size or self.vision.image_size

    @property
    def attn_channels(self) -> int:
        return self.llm.num_layers * self.llm.num_heads


def init_params(cfg: GroundingConfig, generator: torch.Generator,
                device) -> dict:
    """Random parameters with the JAX tree's keys, shapes and dtypes, built
    directly on ``device``."""
    d_llm, d_vis = cfg.llm.hidden_size, cfg.vision.hidden_size
    d_sam = cfg.sam.prompt.embed_dim

    def lin(i, o):
        return {"w": torch.randn((i, o), generator=generator, device=device)
                / math.sqrt(i),
                "b": torch.zeros((o,), device=device)}

    return {
        "frozen": {
            "llm": llm.init_params(cfg.llm, generator, device),
            "vision": vit.init_params(cfg.vision, generator, device),
            "projector": [lin(d_vis if i == 0 else d_llm, d_llm)
                          for i in range(cfg.projector_depth)],
            "sam_encoder": sam_encoder.init_params(cfg.sam.encoder,
                                                   generator, device),
        },
        "trainable": {
            "unet": unet.init_params(cfg.unet, generator, device),
            "text_proj": lin(d_llm, d_sam),
            "text_layer_weights": torch.ones((cfg.llm.num_layers,),
                                             device=device),
            "sam": {
                "prompt": spe.init_params(cfg.sam.prompt, generator, device),
                "decoder": smd.init_params(cfg.sam.decoder, generator,
                                           device),
            },
        },
    }


def _project(features: torch.Tensor, layers: list) -> torch.Tensor:
    """DeepSeek 'mlp_gelu' aligner (reference projector.py:39-45)."""
    x = features
    for i, p in enumerate(layers):
        if i > 0:
            x = F.gelu(x)
        x = x @ p["w"].to(x.dtype) + p["b"].to(x.dtype)
    return x


def forward(params: dict, cfg: GroundingConfig, batch: dict) -> dict:
    """Grounding forward for a static-shape batch (schema of
    flmm_tpu.models.frozen.grounding.forward, as tensors on one device).

    Returns coarse_logits ``(B, M, Hc, Wc)``, sam_logits ``(B, M, P, P)``,
    iou_pred ``(B, M)``, hidden ``(B, S, D)`` and boxes ``(B, M, 4)``.
    """
    fro, tra = params["frozen"], params["trainable"]
    B, S = batch["input_ids"].shape
    M = batch["mask_valid"].shape[1]
    n_img = cfg.num_img_tokens

    feats = vit.forward(fro["vision"], cfg.vision, batch["pixel_values"],
                        select_layer=cfg.vision_select_layer)
    if cfg.vision_drop_cls:
        feats = feats[:, 1:]
    img_embeds = _project(feats, fro["projector"]).to(cfg.dtype)

    embeds = llm.embed_tokens(fro["llm"], cfg.llm,
                              batch["input_ids"]).to(cfg.dtype)
    embeds[:, cfg.img_start:cfg.img_start + n_img] = img_embeds

    lw = torch.softmax(tra["text_layer_weights"], dim=0)
    if cfg.merge == "mean":
        mm = mask_ops.mean_merge_matrix(batch["mask_ids"], M)
    else:
        mm = mask_ops.segment_matrix(batch["mask_ids"], M)
    out = llm.forward_capture(
        fro["llm"], cfg.llm, embeds, batch["attn_mask"],
        img_start=cfg.img_start, n_img=n_img, merge_matrix=mm,
        merge=cfg.merge, layer_weights=lw,
        position_ids=batch.get("position_ids"))

    # per-mask attention images, channels layer-major
    L_, H_, g = cfg.llm.num_layers, cfg.llm.num_heads, cfg.clip_shape
    attn = out["attn"].permute(0, 3, 1, 2, 4).reshape(B * M, L_ * H_, g, g)
    return heads_forward(params, cfg, attn.permute(0, 2, 3, 1),
                         out["hidden"], batch)


def heads_forward(params: dict, cfg: GroundingConfig,
                  attn_nhwc: torch.Tensor, hidden: torch.Tensor,
                  batch: dict) -> dict:
    """Attention images ``(B*M, h, w, C)`` -> U-Net -> text prompts -> SAM."""
    fro, tra = params["frozen"], params["trainable"]
    B, M = batch["mask_valid"].shape

    coarse = unet.forward(tra["unet"], cfg.unet, attn_nhwc)
    Hc, Wc = coarse.shape[-2:]
    coarse = coarse.reshape(B, M, Hc, Wc).float()

    tp = tra["text_proj"]
    rows = torch.arange(B, device=hidden.device)[:, None, None]
    text = hidden[rows, batch["text_idx"]] @ tp["w"] + tp["b"]
    text = text * batch["text_valid"][..., None]

    img_emb = sam_encoder.forward(fro["sam_encoder"], cfg.sam.encoder,
                                  batch["sam_pixel_values"])
    geom = batch["geom"]
    refined = [sam_refiner.refine(
        tra["sam"], cfg.sam, img_emb[b], coarse[b],
        {k: geom[k][b] for k in ("crop_y", "crop_x", "crop_h", "crop_w",
                                 "sam_h", "sam_w")},
        text[b], batch["text_valid"][b]) for b in range(B)]

    return {
        "coarse_logits": coarse,
        "sam_logits": torch.stack([r["low_res_logits"] for r in refined]),
        "iou_pred": torch.stack([r["iou_pred"] for r in refined]),
        "hidden": hidden,
        "boxes": torch.stack([r["boxes"] for r in refined]),
    }


def loss_fn(params: dict, cfg: GroundingConfig, batch: dict) -> tuple:
    """``(loss, metrics)`` of the grounding forward on a batch with the loss
    targets gt_coarse, coarse_weight, gt_sam and sam_weight."""
    out = forward(params, cfg, batch)
    losses = grounding_losses(
        out["coarse_logits"], batch["gt_coarse"], batch["coarse_weight"],
        out["sam_logits"], batch["gt_sam"], batch["sam_weight"],
        batch["mask_valid"])
    return losses["loss"], losses
