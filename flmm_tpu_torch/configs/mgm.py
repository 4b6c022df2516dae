"""Mini-Gemini (MGM) presets (flmm_tpu/configs/mgm.py): CLIP-ViT-L/336 read
at layer -2 beside the ConvNeXt-L aux tower, Gemma-2B, Vicuna-7B,
Mistral-7B or Mixtral-8x7B as the decoder, U-Net in_channels = layers x
heads, doubled for HD (a 2 x 2 crop grid plus a global image; the U-Net
sees the stitched 48 x 48 map beside the upsampled global one), the
EVA-G/14 alternative tower and the ``tiny_mgm`` toy preset with Gemma's
decoder quirks for the CPU tests."""

from __future__ import annotations

import dataclasses

import torch

from flmm_tpu_torch.configs.deepseek_vl import sam_vit_l, tiny
from flmm_tpu_torch.configs.llava import clip_vit_l_336, vicuna_7b
from flmm_tpu_torch.models.frozen.grounding import GroundingConfig
from flmm_tpu_torch.models.frozen.mgm import MGMConfig
from flmm_tpu_torch.models.llm.decoder import DecoderConfig
from flmm_tpu_torch.models.mask_head.unet import UNetConfig
from flmm_tpu_torch.models.vision.convnext import ConvNeXtConfig
from flmm_tpu_torch.models.vision.vit import ViTConfig


def gemma_2b(dtype=torch.bfloat16) -> DecoderConfig:
    """Gemma-2B: MQA (8 query heads of 256, one KV head), the ``(1 + w)``
    RMSNorm, gelu_tanh, the embedding scaled by sqrt(d), tied LM head."""
    return DecoderConfig(
        vocab_size=256000, hidden_size=2048, num_layers=18, num_heads=8,
        num_kv_heads=1, head_dim=256, intermediate_size=16384,
        rms_eps=1e-6, act="gelu_tanh", embed_scale=True, gemma_norm=True,
        tie_embeddings=True, dtype=dtype,
    )


def _mgm(llm: DecoderConfig, dtype, image_grid: int, image_global: bool,
         aux_size: int, img_start: int) -> MGMConfig:
    n_crops = image_grid ** 2 + (1 if image_global else 0)
    chan_mult = 2 if (image_grid > 1 and image_global) else 1
    # HD packs n_crops * 576 image tokens: the decoder captures through the
    # flash-capture kernel (K5) when the image block is 128-aligned; the
    # single-crop presets keep the eager capture, as in the JAX package
    if n_crops > 1:
        llm = dataclasses.replace(
            llm, use_flash_capture=img_start % 128 == 0)
    base = GroundingConfig(
        llm=llm, vision=clip_vit_l_336(dtype),
        unet=UNetConfig(
            in_channels=chan_mult * llm.num_layers * llm.num_heads),
        sam=sam_vit_l(dtype=dtype),
        projector_depth=2,
        img_start=img_start, num_img_tokens=n_crops * 576, clip_shape=24,
        vision_select_layer=-2, vision_drop_cls=True,
        dtype=dtype,
    )
    return MGMConfig(
        base=base,
        aux=ConvNeXtConfig(image_size=aux_size, dtype=dtype),
        image_grid=image_grid, image_global=image_global,
    )


def mgm_gemma_2b(dtype=torch.bfloat16, img_start: int = 4) -> MGMConfig:
    return _mgm(gemma_2b(dtype), dtype, 1, False, 768, img_start)


def mgm_vicuna_7b(dtype=torch.bfloat16, img_start: int = 35) -> MGMConfig:
    return _mgm(vicuna_7b(dtype), dtype, 1, False, 768, img_start)


def mgm_vicuna_7b_hd(dtype=torch.bfloat16, img_start: int = 35) -> MGMConfig:
    return _mgm(vicuna_7b(dtype), dtype, 2, True, 1536, img_start)


def tiny_mgm(dtype=torch.float32, img_start: int = 3, hd: bool = False):
    """Toy MGM topology with Gemma's decoder quirks."""
    tiny_base = tiny(dtype=dtype, img_start=img_start)
    llm = DecoderConfig(
        vocab_size=256, hidden_size=64, num_layers=3, num_heads=4,
        num_kv_heads=1, head_dim=16, intermediate_size=128,
        act="gelu_tanh", embed_scale=True, gemma_norm=True,
        tie_embeddings=True, dtype=dtype,
    )
    vision = ViTConfig(
        hidden_size=32, num_layers=2, num_heads=2, patch_size=8,
        image_size=32, mlp_dim=64, use_class_token=True, use_pre_norm=True,
        patch_bias=False, act="quick_gelu", final_norm=False, dtype=dtype,
    )
    grid = 2 if hd else 1
    n_crops = grid ** 2 + (1 if hd else 0)
    chan_mult = 2 if hd else 1
    base = dataclasses.replace(
        tiny_base, llm=llm, vision=vision,
        unet=UNetConfig(in_channels=chan_mult * 3 * 4, base_channels=8,
                        upsample_input=16),
        num_img_tokens=n_crops * 16, clip_shape=4,
        vision_select_layer=-2, vision_drop_cls=True,
    )
    return MGMConfig(
        base=base,
        aux=ConvNeXtConfig(depths=(1, 1, 1, 1), dims=(8, 16, 32, 64),
                           image_size=64 * grid, dtype=dtype),
        image_grid=grid, image_global=hd,
    )


def mixtral_8x7b(dtype=torch.bfloat16) -> DecoderConfig:
    """Mixtral-8x7B: 8 experts a layer, the top 2 of them a token."""
    return DecoderConfig(
        vocab_size=32000, hidden_size=4096, num_layers=32, num_heads=32,
        num_kv_heads=8, head_dim=128, intermediate_size=14336,
        rope_theta=1e6, rms_eps=1e-5, num_experts=8, num_experts_per_tok=2,
        dtype=dtype,
    )


def mgm_mixtral_8x7b(dtype=torch.bfloat16, img_start: int = 4) -> MGMConfig:
    """MGM-Mixtral-8x7B (reference mgm/model/language_model/mgm_mixtral.py)."""
    return _mgm(mixtral_8x7b(dtype), dtype, 1, False, 768, img_start)


def mgm_mistral_7b(dtype=torch.bfloat16, img_start: int = 4) -> MGMConfig:
    """MGM-Mistral-7B (reference mgm/model/language_model/mgm_mistral.py)."""
    from flmm_tpu_torch.configs.llava_next import mistral_7b

    return _mgm(mistral_7b(dtype), dtype, 1, False, 768, img_start)


def eva_g_14(image_size: int = 336, dtype=torch.bfloat16) -> ViTConfig:
    """EVA-G/14 (MGM's alternative tower, reference mgm/model/
    multimodal_encoder/eva_encoder.py:453-465): dim 1408, depth 39, head dim
    88, mlp ratio 4.3637, class token, no final LayerNorm (the vendored
    model comments ``self.norm`` out and loads with ``strict=False``)."""
    return ViTConfig(
        hidden_size=1408, num_layers=39, num_heads=16, patch_size=14,
        image_size=image_size, mlp_dim=int(1408 * 4.3637),
        use_class_token=True, use_pre_norm=False, patch_bias=True,
        act="gelu", ln_eps=1e-6, final_norm=False, dtype=dtype,
    )
