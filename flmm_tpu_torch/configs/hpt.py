"""HPT presets (flmm_tpu/configs/hpt.py): the tower runs above its native
resolution (392 for the CLIP variant, 448 for SigLIP) with bicubic
position-embedding interpolation, features are taken at layer -2 and merged
as one contiguous image block.  ``tiny_hpt`` is the toy preset with the
same topology for the CPU tests."""

from __future__ import annotations

import dataclasses

import torch

from flmm_tpu_torch.configs.deepseek_vl import sam_vit_l, tiny
from flmm_tpu_torch.models.frozen.grounding import GroundingConfig
from flmm_tpu_torch.models.llm.decoder import DecoderConfig
from flmm_tpu_torch.models.mask_head.unet import UNetConfig
from flmm_tpu_torch.models.vision.vit import ViTConfig


def hpt_air(dtype=torch.bfloat16, llm: DecoderConfig | None = None,
            img_start: int = 10) -> GroundingConfig:
    """HPT-Air: CLIP-ViT-L/14 tower interpolated 336 -> 392 (grid 28)."""
    llm = llm or DecoderConfig(
        vocab_size=32064, hidden_size=4096, num_layers=32, num_heads=32,
        num_kv_heads=32, head_dim=128, intermediate_size=11008,
        rms_eps=1e-5, dtype=dtype,
    )
    vision = ViTConfig(
        hidden_size=1024, num_layers=24, num_heads=16, patch_size=14,
        image_size=336, mlp_dim=4096, use_class_token=True,
        use_pre_norm=True, patch_bias=False, act="quick_gelu",
        ln_eps=1e-5, final_norm=False, dtype=dtype,
    )
    grid = 392 // 14  # 28
    return GroundingConfig(
        llm=llm, vision=vision,
        unet=UNetConfig(in_channels=llm.num_layers * llm.num_heads),
        sam=sam_vit_l(dtype=dtype),
        projector_depth=2,
        img_start=img_start, num_img_tokens=grid * grid, clip_shape=grid,
        vision_select_layer=-2, vision_drop_cls=True,
        image_input_size=392,
        dtype=dtype,
    )


def hpt_air_1_5(dtype=torch.bfloat16, llm: DecoderConfig | None = None,
                img_start: int = 10) -> GroundingConfig:
    """HPT-Air-1.5: Llama-3-8B + SigLIP-SO400M/14 at 448 (grid 32)."""
    llm = llm or DecoderConfig(
        vocab_size=128256, hidden_size=4096, num_layers=32, num_heads=32,
        num_kv_heads=8, head_dim=128, intermediate_size=14336,
        rope_theta=500000.0, rms_eps=1e-5, dtype=dtype,
        # 1024 image tokens at S >= 1280: the eager capture holds the
        # (L, B, H, S, n_img) f32 image-block probabilities; with a
        # 128-aligned image block the flash-capture kernel emits only the
        # merged maps (the rule of configs/deepseek_vl.py)
        use_flash_capture=img_start % 128 == 0,
    )
    vision = ViTConfig(
        hidden_size=1152, num_layers=27, num_heads=16, patch_size=14,
        image_size=448, mlp_dim=4304, use_class_token=False,
        act="gelu_tanh", ln_eps=1e-6, final_norm=False, dtype=dtype,
    )
    grid = 448 // 14  # 32
    return GroundingConfig(
        llm=llm, vision=vision,
        unet=UNetConfig(in_channels=llm.num_layers * llm.num_heads),
        sam=sam_vit_l(dtype=dtype),
        projector_depth=2,
        img_start=img_start, num_img_tokens=grid * grid, clip_shape=grid,
        vision_select_layer=-2, vision_drop_cls=False,
        image_input_size=448,
        dtype=dtype,
    )


def tiny_hpt(dtype=torch.float32, img_start: int = 3) -> GroundingConfig:
    """Toy HPT topology: a native 32 px grid (4 x 4) fed 64 px inputs, so
    the bicubic pos-embed interpolation to 8 x 8 runs end to end."""
    vision = ViTConfig(
        hidden_size=32, num_layers=2, num_heads=2, patch_size=8,
        image_size=32, mlp_dim=64, use_class_token=True, use_pre_norm=True,
        patch_bias=False, act="quick_gelu", final_norm=False, dtype=dtype,
    )
    return dataclasses.replace(
        tiny(dtype=dtype, img_start=img_start), vision=vision,
        vision_select_layer=-2, vision_drop_cls=True, image_input_size=64,
    )
