"""LLaVA-1.5 presets (flmm_tpu/configs/llava.py): Vicuna-7B over a
CLIP-ViT-L/14-336 tower read at layer -2 with the CLS token dropped, a
576-token contiguous image block, U-Net in_channels = 32 layers x 32 heads,
and the ``tiny_llava`` toy preset with the same topology for the CPU
tests."""

from __future__ import annotations

import dataclasses

import torch

from flmm_tpu_torch.configs.deepseek_vl import sam_vit_l, tiny
from flmm_tpu_torch.models.frozen.grounding import GroundingConfig
from flmm_tpu_torch.models.llm.decoder import DecoderConfig
from flmm_tpu_torch.models.mask_head.unet import UNetConfig
from flmm_tpu_torch.models.vision.vit import ViTConfig


def clip_vit_l_336(dtype=torch.bfloat16) -> ViTConfig:
    """CLIP-ViT-L/14 at 336: CLS token, pre-norm, no patch bias,
    quick_gelu, LayerNorm eps 1e-5, no final norm."""
    return ViTConfig(
        hidden_size=1024, num_layers=24, num_heads=16, patch_size=14,
        image_size=336, mlp_dim=4096, use_class_token=True,
        use_pre_norm=True, patch_bias=False, act="quick_gelu",
        ln_eps=1e-5, final_norm=False, dtype=dtype,
    )


def vicuna_7b(dtype=torch.bfloat16) -> DecoderConfig:
    return DecoderConfig(
        vocab_size=32064, hidden_size=4096, num_layers=32, num_heads=32,
        num_kv_heads=32, head_dim=128, intermediate_size=11008,
        rope_theta=10000.0, rms_eps=1e-5, dtype=dtype,
    )


def llava_1_5_7b(dtype=torch.bfloat16, img_start: int = 35) -> GroundingConfig:
    """LLaVA-1.5-7B grounding stack; ``img_start`` is the image block's
    position under the vicuna template prompt."""
    return GroundingConfig(
        llm=vicuna_7b(dtype),
        vision=clip_vit_l_336(dtype),
        unet=UNetConfig(in_channels=32 * 32),
        sam=sam_vit_l(dtype=dtype),
        projector_depth=2,
        img_start=img_start, num_img_tokens=576, clip_shape=24,
        vision_select_layer=-2, vision_drop_cls=True,
        dtype=dtype,
    )


def tiny_llava(dtype=torch.float32, img_start: int = 3) -> GroundingConfig:
    """Toy LLaVA-topology config (CLS token + pre-norm + quick_gelu path)."""
    vision = ViTConfig(
        hidden_size=32, num_layers=2, num_heads=2, patch_size=8,
        image_size=64, mlp_dim=64, use_class_token=True, use_pre_norm=True,
        patch_bias=False, act="quick_gelu", final_norm=False, dtype=dtype,
    )
    return dataclasses.replace(
        tiny(dtype=dtype, img_start=img_start), vision=vision,
        vision_select_layer=-2, vision_drop_cls=True)
