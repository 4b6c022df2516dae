"""Frozen-LMM grounding model for contiguous-image-block families
(flmm_tpu/models/frozen/grounding.py): vision tower -> MLP aligner ->
frozen decoder with per-mask attention capture -> U-Net coarse head -> SAM
encoder + refiner -> losses (:func:`loss_fn`).  DeepSeek-VL-7B's hybrid
tower (``hybrid_high``) adds the SAM-B high-resolution branch
(models/vision/sam_tower.py), fused with the low-resolution tower by the
split projector (:func:`_project_hybrid`).

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

from flmm_tpu_torch import trace
from flmm_tpu_torch.models.frozen.base import grounding_losses
from flmm_tpu_torch.models.llm import decoder as llm
from flmm_tpu_torch.models.mask_head import refiner as sam_refiner
from flmm_tpu_torch.models.mask_head import unet
from flmm_tpu_torch.models.sam import image_encoder as sam_encoder
from flmm_tpu_torch.models.sam import mask_decoder as smd
from flmm_tpu_torch.models.sam import prompt_encoder as spe
from flmm_tpu_torch.models.vision import sam_tower, vit
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
    # DeepSeek-VL-7B: the SAM-B high-resolution tower's SamTowerConfig
    # beside cfg.vision (reference deepseek_vl/models/clip_encoder.py:
    # 126-203); None for single-tower families
    hybrid_high: Any = None
    dtype: torch.dtype = torch.bfloat16

    @property
    def input_size(self) -> int:
        return self.image_input_size or self.vision.image_size

    @property
    def attn_channels(self) -> int:
        return self.llm.num_layers * self.llm.num_heads


def _linear(i: int, o: int, generator: torch.Generator, device) -> dict:
    return {"w": torch.randn((i, o), generator=generator, device=device)
            / math.sqrt(i),
            "b": torch.zeros((o,), device=device)}


def init_frozen(cfg: GroundingConfig, generator: torch.Generator, device,
                skip=()) -> dict:
    """The random frozen tree of :func:`init_params` without the keys in
    ``skip``, which draw nothing from ``generator`` (a loader supplies
    them)."""
    d_llm, d_vis = cfg.llm.hidden_size, cfg.vision.hidden_size
    hybrid = cfg.hybrid_high

    def projector():
        if hybrid is None:
            return [_linear(d_vis if i == 0 else d_llm, d_llm, generator,
                            device) for i in range(cfg.projector_depth)]
        # low_high_hybrid_split_mlp_gelu (reference projector.py:47-56)
        return {"high_up": _linear(hybrid.out_channels, d_llm // 2,
                                   generator, device),
                "low_up": _linear(d_vis, d_llm // 2, generator, device),
                "layers": [_linear(d_llm, d_llm, generator, device)
                           for _ in range(cfg.projector_depth - 1)]}

    parts = {
        "llm": lambda: llm.init_params(cfg.llm, generator, device),
        "vision": lambda: vit.init_params(cfg.vision, generator, device),
        "projector": projector,
        "sam_encoder": lambda: sam_encoder.init_params(cfg.sam.encoder,
                                                       generator, device),
    }
    if hybrid is not None:
        parts["vision_high"] = lambda: sam_tower.init_params(
            hybrid, generator, device)
    return {k: make() for k, make in parts.items() if k not in skip}


def init_trainable(cfg: GroundingConfig, generator: torch.Generator,
                   device) -> dict:
    """The random trainable tree of :func:`init_params`."""
    return {
        "unet": unet.init_params(cfg.unet, generator, device),
        "text_proj": _linear(cfg.llm.hidden_size, cfg.sam.prompt.embed_dim,
                             generator, device),
        "text_layer_weights": torch.ones((cfg.llm.num_layers,),
                                         device=device),
        "sam": {
            "prompt": spe.init_params(cfg.sam.prompt, generator, device),
            "decoder": smd.init_params(cfg.sam.decoder, generator, device),
        },
    }


def init_params(cfg: GroundingConfig, generator: torch.Generator,
                device) -> dict:
    """Random parameters with the JAX tree's keys, shapes and dtypes, built
    directly on ``device``."""
    return {"frozen": init_frozen(cfg, generator, device),
            "trainable": init_trainable(cfg, generator, device)}


def quantize_frozen_llm(params: dict) -> dict:
    """The parameters with the frozen decoder's projections int8 (W8A8
    serving, :func:`llm.quantize_params`); ``params`` is left as it is."""
    return {**params, "frozen": {**params["frozen"], "llm":
                                 llm.quantize_params(params["frozen"]["llm"])}}


def quantize_frozen_sam(params: dict) -> dict:
    """The parameters with the frozen SAM image encoder's projections int8
    (W8A8, :func:`sam_encoder.quantize_params`); ``params`` is left as it
    is.  The encoder dispatches on the quantised keys: no config change."""
    return {**params, "frozen": {
        **params["frozen"],
        "sam_encoder": sam_encoder.quantize_params(
            params["frozen"]["sam_encoder"])}}


def _project(features: torch.Tensor, layers: list) -> torch.Tensor:
    """DeepSeek 'mlp_gelu' aligner (reference projector.py:39-45)."""
    x = features
    for i, p in enumerate(layers):
        if i > 0:
            x = F.gelu(x)
        x = x @ p["w"].to(x.dtype) + p["b"].to(x.dtype)
    return x


def _project_hybrid(high: torch.Tensor, low: torch.Tensor,
                    p: dict) -> torch.Tensor:
    """low_high_hybrid_split_mlp_gelu (reference projector.py:77-82): each
    tower's tokens up to half the LLM width, concatenated, then GELU +
    linear layers, each product in its operand's dtype."""
    def linear(x, q):
        return x @ q["w"].to(x.dtype) + q["b"].to(x.dtype)

    x = torch.cat([linear(high, p["high_up"]), linear(low, p["low_up"])],
                  dim=-1)
    for q in p["layers"]:
        x = linear(F.gelu(x), q)
    return x


def image_embeddings(fro: dict, cfg: GroundingConfig,
                     batch: dict) -> torch.Tensor:
    """The tower(s) and the aligner: ``(B, n_img, D)`` in ``cfg.dtype``."""
    feats = vit.forward(fro["vision"], cfg.vision, batch["pixel_values"],
                        select_layer=cfg.vision_select_layer)
    if cfg.vision_drop_cls:
        feats = feats[:, 1:]
    if cfg.hybrid_high is None:
        return _project(feats, fro["projector"]).to(cfg.dtype)
    high = sam_tower.forward(fro["vision_high"], cfg.hybrid_high,
                             batch["hires_pixel_values"])
    high = high.reshape(high.shape[0], -1, high.shape[-1])
    return _project_hybrid(high, feats, fro["projector"]).to(cfg.dtype)


@trace.spanned("forward")
def forward(params: dict, cfg: GroundingConfig, batch: dict) -> dict:
    """Grounding forward for a static-shape batch (schema of
    flmm_tpu.models.frozen.grounding.forward, as tensors on one device;
    ``hires_pixel_values`` for a hybrid tower).

    Returns coarse_logits ``(B, M, Hc, Wc)``, sam_logits ``(B, M, P, P)``,
    iou_pred ``(B, M)``, hidden ``(B, S, D)`` and boxes ``(B, M, 4)``.
    """
    img_embeds = image_embeddings(params["frozen"], cfg, batch)
    attn, hidden = decoder_capture(params, cfg, batch, img_embeds)
    return heads_forward(params, cfg, attn, hidden, batch)


def decoder_capture(params: dict, cfg: GroundingConfig, batch: dict,
                    img_embeds: torch.Tensor) -> tuple:
    """The image embeddings written into the token embeddings at
    ``img_start``, then the frozen decoder with the per-mask capture:
    ``(B*M, g, g, L*H)`` attention images (channels layer-major) and the
    ``(B, S, D)`` layer-weighted hidden states."""
    fro, tra = params["frozen"], params["trainable"]
    B = batch["input_ids"].shape[0]
    M = batch["mask_valid"].shape[1]
    n_img = cfg.num_img_tokens
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

    L_, H_, g = cfg.llm.num_layers, cfg.llm.num_heads, cfg.clip_shape
    attn = out["attn"].permute(0, 3, 1, 2, 4).reshape(B * M, L_ * H_, g, g)
    return attn.permute(0, 2, 3, 1), out["hidden"]


def heads_forward(params: dict, cfg: GroundingConfig,
                  attn_nhwc: torch.Tensor, hidden: torch.Tensor,
                  batch: dict, img_emb: torch.Tensor | None = None) -> dict:
    """Attention images ``(B*M, h, w, C)`` -> U-Net -> text prompts -> SAM.
    ``img_emb``: the SAM encoder's embedding of ``sam_pixel_values``, when
    the caller has it already.  Counts ``heads_slots`` (the U-Net's maps,
    B*M) and ``masks_valid`` for the tracer."""
    fro, tra = params["frozen"], params["trainable"]
    B, M = batch["mask_valid"].shape
    trace.count("heads_slots", B * M)
    trace.count("masks_valid", batch["mask_valid"])

    coarse = unet.forward(tra["unet"], cfg.unet, attn_nhwc)
    Hc, Wc = coarse.shape[-2:]
    coarse = coarse.reshape(B, M, Hc, Wc).float()

    tp = tra["text_proj"]
    rows = torch.arange(B, device=hidden.device)[:, None, None]
    text = hidden[rows, batch["text_idx"]] @ tp["w"] + tp["b"]
    text = text * batch["text_valid"][..., None]

    if img_emb is None:
        img_emb = sam_encoder.forward(fro["sam_encoder"], cfg.sam.encoder,
                                      batch["sam_pixel_values"])
    geom = batch["geom"]
    with trace.span("refine"):
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
