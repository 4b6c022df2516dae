"""Family helpers shared by the data side and the models
(flmm_tpu/registry.py), for the families the port has."""

from __future__ import annotations

from flmm_tpu_torch.models.mask_head.unet import output_hw


def get_coarse_hw(cfg) -> tuple:
    """Canonical coarse-mask frame of a family config: LLaVA-NeXT's fixed
    square frame, else the U-Net's upsample rule over the attention grid of
    a contiguous image block."""
    if hasattr(cfg, "coarse_frame"):  # LlavaNextConfig
        return tuple(cfg.coarse_frame)
    return output_hw(cfg.unet, (cfg.clip_shape, cfg.clip_shape))
