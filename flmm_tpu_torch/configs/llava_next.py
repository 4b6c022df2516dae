"""LLaVA-NeXT (anyres) presets (flmm_tpu/configs/llava_next.py): the
CLIP-ViT-L/336 tower over a base view and up to four 336 tiles (pinpoints
up to 672x672 / 336x1008), Vicuna-7B or Mistral-7B, U-Net in_channels =
2 x layers x heads (coarse and fine streams), and the toy presets."""

from __future__ import annotations

import dataclasses

import torch

from flmm_tpu_torch.configs.deepseek_vl import sam_vit_l
from flmm_tpu_torch.configs.llava import clip_vit_l_336, vicuna_7b
from flmm_tpu_torch.data.llava_next import AnyresSpec
from flmm_tpu_torch.models.frozen.grounding import GroundingConfig
from flmm_tpu_torch.models.frozen.llava_next import LlavaNextConfig
from flmm_tpu_torch.models.llm.decoder import DecoderConfig
from flmm_tpu_torch.models.mask_head.refiner import SamRefinerConfig
from flmm_tpu_torch.models.mask_head.unet import UNetConfig
from flmm_tpu_torch.models.sam.image_encoder import SamEncoderConfig
from flmm_tpu_torch.models.sam.mask_decoder import MaskDecoderConfig
from flmm_tpu_torch.models.sam.prompt_encoder import PromptEncoderConfig
from flmm_tpu_torch.models.sam.transformer import TwoWayConfig
from flmm_tpu_torch.models.vision.vit import ViTConfig


def mistral_7b(dtype=torch.bfloat16) -> DecoderConfig:
    return DecoderConfig(
        vocab_size=32064, hidden_size=4096, num_layers=32, num_heads=32,
        num_kv_heads=8, head_dim=128, intermediate_size=14336,
        rope_theta=1e6, rms_eps=1e-5, dtype=dtype,
    )


def _preset(llm: DecoderConfig, dtype, img_start: int) -> LlavaNextConfig:
    anyres = AnyresSpec()
    # the flash-capture kernel (K5) carries the anyres sequence; it needs
    # S % 128 == 0 and a 128-aligned image block (the batch builder's
    # align_image_block=128), else the decoder takes the eager S x S path
    llm = dataclasses.replace(llm, use_flash_capture=True)
    base = GroundingConfig(
        llm=llm,
        vision=clip_vit_l_336(dtype),
        unet=UNetConfig(
            in_channels=2 * llm.num_layers * llm.num_heads,
            upsample_input=None,
        ),
        sam=sam_vit_l(dtype=dtype),
        projector_depth=2,
        img_start=img_start, num_img_tokens=anyres.n_img_max, clip_shape=24,
        vision_select_layer=-2, vision_drop_cls=True,
        dtype=dtype,
    )
    return LlavaNextConfig(
        base=base, max_tiles=anyres.max_tiles,
        max_fine_hw=anyres.max_fine_hw, n_img_max=anyres.n_img_max,
        coarse_frame=(64, 64),
        pinpoints=anyres.pinpoints, tile_size=anyres.tile_size,
    )


def llava_next_vicuna_7b(dtype=torch.bfloat16, img_start: int = 35):
    return _preset(vicuna_7b(dtype), dtype, img_start)


def llava_next_mistral_7b(dtype=torch.bfloat16, img_start: int = 4):
    return _preset(mistral_7b(dtype), dtype, img_start)


def tiny_anyres_spec() -> AnyresSpec:
    return AnyresSpec(
        tile_size=32, patch_size=8,
        pinpoints=((32, 64), (64, 32), (64, 64)),
    )


def tiny_llava_next(dtype=torch.float32, img_start: int = 3) -> LlavaNextConfig:
    anyres = tiny_anyres_spec()
    llm = DecoderConfig(
        vocab_size=256, hidden_size=64, num_layers=3, num_heads=4,
        num_kv_heads=2, head_dim=16, intermediate_size=128, dtype=dtype,
    )
    vision = ViTConfig(
        hidden_size=32, num_layers=2, num_heads=2, patch_size=8,
        image_size=32, mlp_dim=64, use_class_token=True, use_pre_norm=True,
        patch_bias=False, act="quick_gelu", final_norm=False, dtype=dtype,
    )
    sam = SamRefinerConfig(
        encoder=SamEncoderConfig(
            img_size=128, patch_size=16, embed_dim=32, depth=2, num_heads=2,
            mlp_ratio=2.0, out_chans=16, window_size=2,
            global_attn_indexes=(1,), dtype=dtype,
        ),
        prompt=PromptEncoderConfig(
            embed_dim=16, image_embedding_size=8, input_image_size=128,
            mask_in_chans=8, dtype=dtype,
        ),
        decoder=MaskDecoderConfig(
            transformer_dim=16,
            transformer=TwoWayConfig(depth=2, embed_dim=16, num_heads=2,
                                     mlp_dim=32, dtype=dtype),
            dtype=dtype,
        ),
        prompt_size=32, box_frame=32,
    )
    base = GroundingConfig(
        llm=llm, vision=vision,
        unet=UNetConfig(in_channels=2 * 3 * 4, base_channels=8,
                        upsample_input=None),
        sam=sam,
        projector_depth=2, img_start=img_start,
        num_img_tokens=anyres.n_img_max, clip_shape=anyres.grid,
        vision_select_layer=-2, vision_drop_cls=True,
        dtype=dtype,
    )
    return LlavaNextConfig(
        base=base, max_tiles=anyres.max_tiles,
        max_fine_hw=anyres.max_fine_hw, n_img_max=anyres.n_img_max,
        coarse_frame=(16, 16),
        pinpoints=anyres.pinpoints, tile_size=anyres.tile_size,
    )
