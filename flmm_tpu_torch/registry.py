"""Model-family registry (flmm_tpu/registry.py) for the families the port
has: config presets, model modules, the reduced-resolution SAM schedule and
the coarse-mask frame."""

from __future__ import annotations

import dataclasses
import importlib

from flmm_tpu_torch.models.mask_head.unet import output_hw

# family -> (model module, {preset: "module:factory"}), as in the JAX
# registry; its mgm family is not ported
FAMILIES = {
    "deepseek_vl": ("flmm_tpu_torch.models.frozen.deepseek_vl", {
        "1_3b": "flmm_tpu_torch.configs.deepseek_vl:deepseek_vl_1_3b",
        "tiny": "flmm_tpu_torch.configs.deepseek_vl:tiny",
    }),
    "llava": ("flmm_tpu_torch.models.frozen.grounding", {
        "1_5_7b": "flmm_tpu_torch.configs.llava:llava_1_5_7b",
        "tiny": "flmm_tpu_torch.configs.llava:tiny_llava",
    }),
    "llava_next": ("flmm_tpu_torch.models.frozen.llava_next", {
        "vicuna_7b": "flmm_tpu_torch.configs.llava_next:llava_next_vicuna_7b",
        "mistral_7b":
            "flmm_tpu_torch.configs.llava_next:llava_next_mistral_7b",
        "tiny": "flmm_tpu_torch.configs.llava_next:tiny_llava_next",
    }),
    "hpt": ("flmm_tpu_torch.models.frozen.grounding", {
        "air": "flmm_tpu_torch.configs.hpt:hpt_air",
        "air_1_5": "flmm_tpu_torch.configs.hpt:hpt_air_1_5",
        "tiny": "flmm_tpu_torch.configs.hpt:tiny_hpt",
    }),
}


def _family(family: str):
    if family not in FAMILIES:
        raise NotImplementedError(
            f"family {family!r} is not ported to flmm_tpu_torch (ported: "
            f"{', '.join(FAMILIES)})")
    return FAMILIES[family]


def get_model(family: str):
    """The model module of a family (``init_params``, ``forward`` and, where
    ported, ``loss_fn``)."""
    return importlib.import_module(_family(family)[0])


def get_config(family: str, preset: str, **kwargs):
    presets = _family(family)[1]
    if preset not in presets:
        raise NotImplementedError(
            f"preset {preset!r} of family {family!r} is not ported (ported: "
            f"{', '.join(presets)})")
    mod, _, attr = presets[preset].partition(":")
    return getattr(importlib.import_module(mod), attr)(**kwargs)


def with_sam_size(cfg, img_size: int):
    """The config with the SAM refiner at another input resolution (the
    reduced-resolution deployment schedule, e.g. 448: a 28 x 28 grid in 2 x 2
    windows of 14), threading the grid through the prompt-encoder geometry
    and the dense-prompt resolution."""
    base = cfg.base if hasattr(cfg, "base") else cfg
    sam = base.sam
    if img_size % sam.encoder.patch_size:
        raise ValueError(f"SAM size {img_size} is not a multiple of the "
                         f"patch size {sam.encoder.patch_size}")
    grid = img_size // sam.encoder.patch_size
    new_sam = dataclasses.replace(
        sam,
        encoder=dataclasses.replace(sam.encoder, img_size=img_size),
        prompt=dataclasses.replace(sam.prompt, image_embedding_size=grid,
                                   input_image_size=img_size),
        prompt_size=4 * grid)
    new_base = dataclasses.replace(base, sam=new_sam)
    if hasattr(cfg, "base"):
        return dataclasses.replace(cfg, base=new_base)
    return new_base


def get_coarse_hw(cfg) -> tuple:
    """Canonical coarse-mask frame of a family config: LLaVA-NeXT's fixed
    square frame, else the U-Net's upsample rule over the attention grid of
    a contiguous image block."""
    if hasattr(cfg, "coarse_frame"):  # LlavaNextConfig
        return tuple(cfg.coarse_frame)
    return output_hw(cfg.unet, (cfg.clip_shape, cfg.clip_shape))
