"""Frozen Mini-Gemini (MGM) grounding model (flmm_tpu/models/frozen/mgm.py).

Two towers: CLIP-ViT-L/336 over the crops and the ConvNeXt-L aux tower
(models/vision/convnext.py) over one high-resolution image.  The
patch-info mining ``unified_resampler`` lets each CLIP token attend to the
aux patches under it (reference mgm/model/mgm_arch.py:295-313); HD mode
runs an ``image_grid`` x ``image_grid`` crop grid plus a global image whose
tokens come first.  The decoder's per-mask capture over the image block is
stitched back into one ``(grid * 24)^2`` map, with the global map upsampled
beside it (reference frozen_mgm.py:171-202), and feeds the shared heads.

Dtypes follow the JAX tree: the tower and decoder in the config's dtype,
the resampler's ``_ln_lin`` projections in f32 (their params are f32), so
the mined tokens and the projector run in f32 and the image embeddings are
cast to the config's dtype at the end.
"""

from __future__ import annotations

import dataclasses
import math

import torch

from flmm_tpu_torch import trace
from flmm_tpu_torch.data.mgm import MGMProcessSpec
from flmm_tpu_torch.models.frozen import grounding
from flmm_tpu_torch.models.frozen.base import grounding_losses
from flmm_tpu_torch.models.frozen.grounding import GroundingConfig, _project
from flmm_tpu_torch.models.llm import decoder as llm
from flmm_tpu_torch.models.sam.common import layer_norm
from flmm_tpu_torch.models.vision import convnext, vit
from flmm_tpu_torch.ops import masks as mask_ops
from flmm_tpu_torch.ops.resize import resize_bilinear


@dataclasses.dataclass(frozen=True)
class MGMConfig:
    base: GroundingConfig
    aux: convnext.ConvNeXtConfig
    image_grid: int = 1
    image_global: bool = False

    @property
    def num_crops(self) -> int:
        return self.image_grid ** 2 + (1 if self.image_global else 0)

    @property
    def grid_tokens(self) -> int:
        return self.base.clip_shape ** 2  # tokens of one crop

    @property
    def map_hw(self) -> tuple:
        g = self.base.clip_shape * self.image_grid
        return (g, g)

    def process_spec(self) -> MGMProcessSpec:
        """The host processing of this config's crops and aux image."""
        return MGMProcessSpec(crop_size=self.base.input_size,
                              aux_size=self.aux.image_size,
                              image_grid=self.image_grid,
                              image_global=self.image_global)


def _ln_lin_params(i: int, o: int, generator: torch.Generator,
                   device) -> dict:
    return {"ln_w": torch.ones((i,), device=device),
            "ln_b": torch.zeros((i,), device=device),
            "w": torch.randn((i, o), generator=generator, device=device)
            / math.sqrt(i),
            "b": torch.zeros((o,), device=device)}


def init_frozen(cfg: MGMConfig, generator: torch.Generator, device,
                skip=()) -> dict:
    """:func:`grounding.init_frozen` with the aux tower and the three f32
    resampler projections, less ``skip``."""
    frozen = grounding.init_frozen(cfg.base, generator, device, skip)
    d_clip, d_aux = cfg.base.vision.hidden_size, cfg.aux.out_channels
    parts = {
        "aux_tower": lambda: convnext.init_params(cfg.aux, generator, device),
        "uni_query": lambda: _ln_lin_params(d_clip, d_clip, generator,
                                            device),
        "uni_aux": lambda: _ln_lin_params(d_aux, d_clip, generator, device),
        "uni_val": lambda: _ln_lin_params(d_aux, d_clip, generator, device),
    }
    frozen.update({k: make() for k, make in parts.items() if k not in skip})
    return frozen


def init_trainable(cfg: MGMConfig, generator: torch.Generator,
                   device) -> dict:
    return grounding.init_trainable(cfg.base, generator, device)


def init_params(cfg: MGMConfig, generator: torch.Generator, device) -> dict:
    """Random parameters with the JAX tree's keys, shapes and dtypes."""
    return {"frozen": init_frozen(cfg, generator, device),
            "trainable": init_trainable(cfg, generator, device)}


def _ln_lin(x: torch.Tensor, p: dict, eps: float = 1e-5) -> torch.Tensor:
    """LayerNorm then Linear, in f32 (the reference's nn.Sequential)."""
    return layer_norm(x.float(), p["ln_w"], p["ln_b"], eps) @ p["w"] + p["b"]


def unified_resampler(fro: dict, clip_feats: torch.Tensor,
                      aux_map: torch.Tensor, patch_num: int) -> torch.Tensor:
    """Patch-info mining: ``clip_feats`` ``(B, patch_num^2, D)`` each attend
    to the ``(A / patch_num)^2`` patches of ``aux_map`` ``(B, A, A, C)``
    under them; returns the ``(B, patch_num^2, D)`` mined features in
    f32."""
    B, n, D = clip_feats.shape
    A = aux_map.shape[1]
    ps = A // patch_num
    aux = aux_map.reshape(B, patch_num, ps, patch_num, ps, -1)
    aux = aux.permute(0, 1, 3, 2, 4, 5).reshape(B, n, ps * ps, -1)
    q = _ln_lin(clip_feats, fro["uni_query"])  # (B, n, D)
    k = _ln_lin(aux, fro["uni_aux"])  # (B, n, p2, D)
    v = _ln_lin(aux, fro["uni_val"])
    att = torch.einsum("bnd,bnpd->bnp", q, k) / math.sqrt(float(D))
    att = torch.softmax(torch.nan_to_num(att), dim=-1)
    return torch.einsum("bnp,bnpd->bnd", att, v)


def _resize_nhwc(x_nhwc: torch.Tensor, hw: tuple) -> torch.Tensor:
    """Bilinear resize of an NHWC map's spatial axes."""
    return resize_bilinear(x_nhwc.permute(0, 3, 1, 2), hw).permute(0, 2, 3, 1)


def tower_features(fro: dict, cfg: MGMConfig,
                   crops: torch.Tensor) -> torch.Tensor:
    """The CLIP tower over every crop in one batch: ``(B, n_crops, P, P,
    3)`` -> ``(B, n_crops, 576, D)`` at the select layer, class token
    dropped."""
    gcfg = cfg.base
    B, nc = crops.shape[:2]
    feats = vit.forward(fro["vision"], gcfg.vision,
                        crops.reshape(B * nc, *crops.shape[2:]),
                        select_layer=gcfg.vision_select_layer)
    if gcfg.vision_drop_cls:
        feats = feats[:, 1:]
    return feats.reshape(B, nc, gcfg.clip_shape ** 2, -1)


def encode_images(params: dict, cfg: MGMConfig, crops: torch.Tensor,
                  aux_pixels: torch.Tensor) -> torch.Tensor:
    """Crops ``(B, n_crops, P, P, 3)`` (the global image last) and aux
    pixels ``(B, Sa, Sa, 3)`` -> ``(B, n_crops * 576, D)`` image embeddings
    in the config's dtype, tokens ``[global | locals]`` when
    ``image_global`` (mgm_arch.py:284-287)."""
    fro = params["frozen"]
    feats = tower_features(fro, cfg, crops)
    aux_map = convnext.forward(fro["aux_tower"], cfg.aux, aux_pixels)
    return mine_and_project(fro, cfg, feats, aux_map)


def mine_and_project(fro: dict, cfg: MGMConfig, feats: torch.Tensor,
                     aux_map: torch.Tensor) -> torch.Tensor:
    """The tower's ``(B, n_crops, 576, D)`` features plus what each token
    mines from the aux map ``(B, A, A, C)`` (the global image's from the
    whole map resized by 1 / grid, each local crop's from its window),
    through the projector."""
    gcfg = cfg.base
    B = feats.shape[0]
    g, pn = cfg.image_grid, gcfg.clip_shape
    A = aux_map.shape[1]
    tokens = []
    if cfg.image_global:
        global_feats = feats[:, -1]
        gmap = _resize_nhwc(aux_map, (A // g, A // g))
        tokens.append(global_feats
                      + unified_resampler(fro, global_feats, gmap, pn))
        feats = feats[:, :-1]
    lf = feats.reshape(B * g * g, pn * pn, -1)
    if g > 1:  # the aux map sliced into one window per crop
        aux_map = aux_map.reshape(B, g, A // g, g, A // g, -1).permute(
            0, 1, 3, 2, 4, 5).reshape(B * g * g, A // g, A // g, -1)
    mined = unified_resampler(fro, lf, aux_map, pn)
    tokens.append((lf + mined).reshape(B, g * g * pn * pn, -1))
    tokens = torch.cat(tokens, dim=1) if len(tokens) > 1 else tokens[0]
    return _project(tokens, fro["projector"]).to(gcfg.dtype)


def assemble_attention(cfg: MGMConfig, attn: torch.Tensor) -> torch.Tensor:
    """Merged capture ``(B, L, H, M, n_img)`` -> ``(B*M, mh, mw, C)`` map
    images: HD crops tile into the ``(grid * pn)^2`` map, the global map is
    upsampled to it and comes first in channel order (``[global | hd]``, as
    the reference's ``torch.cat([global, hd])`` over the head axis)."""
    B, L, H, M, n = attn.shape
    pn, g = cfg.base.clip_shape, cfg.image_grid
    mh, mw = cfg.map_hw
    per = pn * pn
    a = attn.permute(0, 3, 1, 2, 4)  # (B, M, L, H, n)
    if g == 1:
        return a.reshape(B * M, L * H, pn, pn).permute(0, 2, 3, 1)
    glob = None
    if cfg.image_global:
        glob = a[..., :per].reshape(B * M, L * H, pn, pn)
        a = a[..., per:]
    hd = a.reshape(B * M, L * H, g, g, pn, pn).permute(
        0, 1, 2, 4, 3, 5).reshape(B * M, L * H, mh, mw)
    if glob is not None:
        hd = torch.cat([resize_bilinear(glob, (mh, mw)), hd], dim=1)
    return hd.permute(0, 2, 3, 1)


def capture(params: dict, cfg: MGMConfig, batch: dict,
            img_embeds: torch.Tensor | None = None) -> dict:
    """The frozen half of the forward: the image embeddings (computed here
    unless given) written at ``img_start``, then the decoder with the
    per-mask merged capture (``attn`` ``(B, L, H, M, n_img)``, ``hidden``,
    ``last_hidden``)."""
    fro, tra = params["frozen"], params["trainable"]
    gcfg = cfg.base
    M = batch["mask_valid"].shape[1]
    n_img = gcfg.num_img_tokens
    if img_embeds is None:
        img_embeds = encode_images(params, cfg, batch["pixel_values"],
                                   batch["aux_pixel_values"])
    embeds = llm.embed_tokens(fro["llm"], gcfg.llm,
                              batch["input_ids"]).to(gcfg.dtype)
    embeds[:, gcfg.img_start:gcfg.img_start + n_img] = img_embeds
    lw = torch.softmax(tra["text_layer_weights"], dim=0)
    if gcfg.merge == "mean":
        mm = mask_ops.mean_merge_matrix(batch["mask_ids"], M)
    else:
        mm = mask_ops.segment_matrix(batch["mask_ids"], M)
    return llm.forward_capture(
        fro["llm"], gcfg.llm, embeds, batch["attn_mask"],
        img_start=gcfg.img_start, n_img=n_img, merge_matrix=mm,
        merge=gcfg.merge, layer_weights=lw)


@trace.spanned("forward")
def forward(params: dict, cfg: MGMConfig, batch: dict) -> dict:
    """Grounding forward for an MGM batch (``pixel_values`` ``(B, n_crops,
    336, 336, 3)``, ``aux_pixel_values``; the rest as ``grounding.forward``);
    outputs as ``grounding.forward``."""
    out = capture(params, cfg, batch)
    maps = assemble_attention(cfg, out["attn"])
    return grounding.heads_forward(params, cfg.base, maps, out["hidden"],
                                   batch)


def loss_fn(params: dict, cfg: MGMConfig, batch: dict) -> tuple:
    """``(loss, metrics)`` of the MGM forward on a batch with the loss
    targets."""
    out = forward(params, cfg, batch)
    losses = grounding_losses(
        out["coarse_logits"], batch["gt_coarse"], batch["coarse_weight"],
        out["sam_logits"], batch["gt_sam"], batch["sam_weight"],
        batch["mask_valid"])
    return losses["loss"], losses
