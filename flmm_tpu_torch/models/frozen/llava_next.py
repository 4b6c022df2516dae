"""Frozen LLaVA-NeXT (anyres) grounding model
(flmm_tpu/models/frozen/llava_next.py), the serving forward.

The tower runs over the base view and every tile slot; the block gather
through ``[features | newline | zero]`` by ``block_index`` packs the
reference's variable-length anyres feature sequence into a padded image
block of ``n_img_max`` slots at ``img_start``, whose pad slots are masked
keys with pad-skipping position ids.  The decoder's merged capture over that
block is split into the coarse (24 x 24 base view) and the fine (unpadded,
variable extent) maps, each resampled by ``affine_grid_sample`` into the
square coarse frame, and the channels ``[coarse | fine]`` feed the shared
heads.
"""

from __future__ import annotations

import dataclasses

import torch

from flmm_tpu_torch.data.llava_next import AnyresSpec
from flmm_tpu_torch.models.frozen import grounding
from flmm_tpu_torch.models.frozen.grounding import GroundingConfig
from flmm_tpu_torch.models.llm import decoder as llm
from flmm_tpu_torch.models.vision import vit
from flmm_tpu_torch.ops import masks as mask_ops
from flmm_tpu_torch.ops.resize import affine_grid_sample


@dataclasses.dataclass(frozen=True)
class LlavaNextConfig:
    base: GroundingConfig  # llm/vision/unet/sam etc.
    max_tiles: int = 4
    max_fine_hw: tuple = (72, 72)
    n_img_max: int = 2928  # 576 + 48*49 for the 336-base pinpoints
    coarse_frame: tuple = (64, 64)  # square frame fed to the U-Net
    pinpoints: tuple = ((336, 672), (672, 336), (672, 672), (1008, 336),
                        (336, 1008))
    tile_size: int = 336

    def anyres_spec(self) -> AnyresSpec:
        return AnyresSpec(tile_size=self.tile_size,
                          patch_size=self.base.vision.patch_size,
                          pinpoints=self.pinpoints)

    @property
    def grid(self) -> int:
        return self.base.clip_shape


def init_params(cfg: LlavaNextConfig, generator: torch.Generator,
                device) -> dict:
    """The grounding tree plus the ``image_newline`` embedding."""
    params = grounding.init_params(cfg.base, generator, device)
    d = cfg.base.llm.hidden_size
    params["frozen"]["image_newline"] = (
        torch.randn((d,), generator=generator, device=device) * 0.02
    ).to(cfg.base.dtype)
    return params


def pack_embeds(params: dict, cfg: LlavaNextConfig, batch: dict):
    """Tower over base + tiles, block gather through the per-sample feature
    table, scatter into the padded image block at ``img_start``."""
    fro = params["frozen"]
    gcfg = cfg.base
    B = batch["input_ids"].shape[0]
    g2 = cfg.grid * cfg.grid

    tiles = batch["tiles"]  # (B, 1+T, gpx, gpx, 3)
    nt = tiles.shape[1]
    feats = vit.forward(fro["vision"], gcfg.vision,
                        tiles.reshape(B * nt, *tiles.shape[2:]),
                        select_layer=gcfg.vision_select_layer)
    if gcfg.vision_drop_cls:
        feats = feats[:, 1:]
    feats = grounding._project(feats, fro["projector"]).to(gcfg.dtype)
    d = feats.shape[-1]
    feats = feats.reshape(B, nt * g2, d)

    newline = fro["image_newline"].to(gcfg.dtype).expand(B, 1, d)
    table = torch.cat([feats, newline, feats.new_zeros((B, 1, d))], dim=1)
    index = batch["block_index"].long()[..., None].expand(-1, -1, d)
    block = torch.gather(table, 1, index)  # (B, n_max, d)
    block = block * batch["block_valid"][..., None].to(block.dtype)

    embeds = llm.embed_tokens(fro["llm"], gcfg.llm,
                              batch["input_ids"]).to(gcfg.dtype)
    embeds[:, gcfg.img_start:gcfg.img_start + block.shape[1]] = block
    return embeds


def capture(params: dict, cfg: LlavaNextConfig, batch: dict) -> dict:
    """The frozen half of the forward: packed embeddings through the decoder
    with the per-mask merged capture (``attn`` ``(B, L, H, M, n_img_max)``,
    ``hidden``, ``last_hidden``)."""
    gcfg = cfg.base
    M = batch["mask_valid"].shape[1]
    embeds = pack_embeds(params, cfg, batch)
    lw = torch.softmax(params["trainable"]["text_layer_weights"], dim=0)
    if gcfg.merge == "mean":
        mm = mask_ops.mean_merge_matrix(batch["mask_ids"], M)
    else:
        mm = mask_ops.segment_matrix(batch["mask_ids"], M)
    return llm.forward_capture(
        params["frozen"]["llm"], gcfg.llm, embeds, batch["attn_mask"],
        img_start=gcfg.img_start, n_img=cfg.n_img_max, merge_matrix=mm,
        merge=gcfg.merge, layer_weights=lw,
        position_ids=batch["position_ids"])


def forward(params: dict, cfg: LlavaNextConfig, batch: dict) -> dict:
    """Grounding forward for an anyres batch (schema of
    data/llava_next.py); outputs as ``grounding.forward``."""
    out = capture(params, cfg, batch)
    maps = assemble_frames(cfg, out["attn"], batch)
    return grounding.heads_forward(params, cfg.base, maps, out["hidden"],
                                   batch)


def assemble_frames(cfg: LlavaNextConfig, attn: torch.Tensor,
                    batch: dict) -> torch.Tensor:
    """Coarse + fine attention maps ``(B, L, H, M, n_max)`` -> the square
    frame, ``(B*M, Hc, Wc, 2*L*H)`` with channels ``[coarse layer-major |
    fine layer-major]``.  Uses ``fine_gather``/``fine_valid``/``fine_hw``/
    ``geom`` of the batch."""
    B, L_, H_, M, n = attn.shape
    g = cfg.grid
    fhm, fwm = cfg.max_fine_hw
    C = L_ * H_ * M
    flat = attn.reshape(B, C, n)
    coarse_maps = flat[..., :g * g].reshape(B, C, g, g)
    gather = batch["fine_gather"].long()[:, None, :].expand(-1, C, -1)
    fine = torch.gather(flat, 2, gather)
    fine = fine * batch["fine_valid"][:, None, :].to(fine.dtype)
    fine_maps = fine.reshape(B, C, fhm, fwm)

    Hc, Wc = cfg.coarse_frame
    geom = batch["geom"]
    zero = torch.zeros(2, device=attn.device)

    def to_frame(maps, src_h, src_w, b):
        """Sample ``[0, src_h) x [0, src_w)`` onto the image region of the
        square frame, clamp-replicated outside it."""
        cy, cx = geom["crop_y"][b], geom["crop_x"][b]
        ch = geom["crop_h"][b].clamp_min(1.0)
        cw = geom["crop_w"][b].clamp_min(1.0)
        scale = torch.stack([src_h / ch, src_w / cw])
        offset = torch.stack([-cy * src_h / ch, -cx * src_w / cw])
        hi = torch.stack([torch.as_tensor(src_h - 1.0, device=attn.device),
                          torch.as_tensor(src_w - 1.0, device=attn.device)])
        return affine_grid_sample(maps, scale, offset, (Hc, Wc), src_lo=zero,
                                  src_hi=hi, mode="clamp")

    cframes, fframes = [], []
    for b in range(B):
        cframes.append(to_frame(coarse_maps[b], float(g), float(g), b))
        fframes.append(to_frame(fine_maps[b], batch["fine_hw"][b, 0],
                                batch["fine_hw"][b, 1], b))
    cframes = torch.stack(cframes).reshape(B, L_ * H_, M, Hc, Wc)
    fframes = torch.stack(fframes).reshape(B, L_ * H_, M, Hc, Wc)
    maps = torch.cat([cframes, fframes], dim=1)  # (B, 2LH, M, Hc, Wc)
    return maps.permute(0, 2, 3, 4, 1).reshape(B * M, Hc, Wc, 2 * L_ * H_)
