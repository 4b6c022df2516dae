"""DeepSeek-VL presets (flmm_tpu/configs/deepseek_vl.py): the 1.3B and 7B
grounding stacks, their SAM ViT-L refiner and the toy ``tiny`` and
``tiny_hybrid`` presets with the same topologies for the CPU tests.  The
config dataclasses live beside the modules they configure, as in the JAX
package."""

from __future__ import annotations

import dataclasses

import torch

from flmm_tpu_torch.models.frozen.grounding import GroundingConfig
from flmm_tpu_torch.models.llm.decoder import DecoderConfig
from flmm_tpu_torch.models.mask_head.refiner import SamRefinerConfig
from flmm_tpu_torch.models.mask_head.unet import UNetConfig
from flmm_tpu_torch.models.sam.image_encoder import SamEncoderConfig
from flmm_tpu_torch.models.sam.mask_decoder import MaskDecoderConfig
from flmm_tpu_torch.models.sam.prompt_encoder import PromptEncoderConfig
from flmm_tpu_torch.models.sam.transformer import TwoWayConfig
from flmm_tpu_torch.models.vision.sam_tower import SamTowerConfig
from flmm_tpu_torch.models.vision.vit import ViTConfig


def sam_vit_l(dtype=torch.bfloat16, flash: bool = True,
              img_size: int = 1024) -> SamRefinerConfig:
    """SAM ViT-L refiner (reference build_sam.py:27-34).  ``flash`` turns
    on the encoder's kernel path (taken on CUDA tensors only)."""
    if img_size % 16:
        raise ValueError(f"img_size {img_size} is not a multiple of 16")
    grid = img_size // 16
    return SamRefinerConfig(
        encoder=SamEncoderConfig(
            img_size=img_size, embed_dim=1024, depth=24, num_heads=16,
            global_attn_indexes=(5, 11, 17, 23), dtype=dtype,
            flash_global=flash, flash_window=flash,
            window_block_fused=flash,
        ),
        prompt=PromptEncoderConfig(
            dtype=torch.float32, image_embedding_size=grid,
            input_image_size=img_size),
        decoder=MaskDecoderConfig(dtype=torch.float32),
        use_text=True, use_mask=True, use_box=True, multimask_output=False,
        prompt_size=4 * grid,
    )


def deepseek_vl_1_3b(dtype=torch.bfloat16, img_start: int = 5,
                     sam_img_size: int = 1024) -> GroundingConfig:
    """DeepSeek-VL-1.3B-chat grounding stack: DeepSeek-LLM 1.3B (24 layers
    x 16 heads, hidden 2048, ffn 5504, vocab 102400) over a SigLIP-L/16-384
    tower, with the SAM ViT-L refiner."""
    llm = DecoderConfig(
        vocab_size=102400, hidden_size=2048, num_layers=24, num_heads=16,
        num_kv_heads=16, head_dim=128, intermediate_size=5504,
        rope_theta=10000.0, rms_eps=1e-6, dtype=dtype,
        use_flash_capture=img_start % 128 == 0,
    )
    vision = ViTConfig(
        hidden_size=1024, num_layers=24, num_heads=16, patch_size=16,
        image_size=384, mlp_dim=4096, use_class_token=False,
        act="gelu", ln_eps=1e-6, final_norm=True, dtype=dtype,
    )
    return GroundingConfig(
        llm=llm, vision=vision,
        unet=UNetConfig(in_channels=24 * 16),
        sam=sam_vit_l(dtype=dtype, img_size=sam_img_size),
        projector_depth=2, img_start=img_start, num_img_tokens=576,
        clip_shape=24, dtype=dtype,
    )


def deepseek_vl_7b(dtype=torch.bfloat16,
                   img_start: int = 5) -> GroundingConfig:
    """DeepSeek-VL-7B-chat grounding stack: DeepSeek-LLM 7B (30 layers x 32
    heads, hidden 4096, ffn 11008) over the hybrid tower, SAM-B at 1024 for
    576 high-resolution tokens beside SigLIP-L/16-384 (reference
    deepseek_vl/models/clip_encoder.py:126-203), fused by the split
    mlp_gelu projector; U-Net over 30 x 32 maps; the SAM ViT-L refiner.
    The SAM-B trunk keeps its config's plain path."""
    llm = DecoderConfig(
        vocab_size=102400, hidden_size=4096, num_layers=30, num_heads=32,
        num_kv_heads=32, head_dim=128, intermediate_size=11008,
        rope_theta=10000.0, rms_eps=1e-6, dtype=dtype,
        use_flash_capture=img_start % 128 == 0,
    )
    hybrid = SamTowerConfig(dtype=dtype)
    hybrid = dataclasses.replace(
        hybrid, encoder=dataclasses.replace(hybrid.encoder, dtype=dtype))
    return dataclasses.replace(
        deepseek_vl_1_3b(dtype, img_start=img_start), llm=llm,
        unet=UNetConfig(in_channels=30 * 32), hybrid_high=hybrid,
        image_input_size=384)


def tiny(dtype=torch.float32, img_start: int = 3) -> GroundingConfig:
    """Toy dimensions with the production topology (CPU-runnable)."""
    llm = DecoderConfig(
        vocab_size=256, hidden_size=64, num_layers=3, num_heads=4,
        num_kv_heads=2, head_dim=16, intermediate_size=128, dtype=dtype,
    )
    vision = ViTConfig(
        hidden_size=32, num_layers=2, num_heads=2, patch_size=8,
        image_size=64, mlp_dim=64, use_class_token=False, dtype=dtype,
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
    return GroundingConfig(
        llm=llm, vision=vision,
        unet=UNetConfig(in_channels=3 * 4, base_channels=8,
                        upsample_input=16),
        sam=sam, projector_depth=2, img_start=img_start, num_img_tokens=64,
        clip_shape=8, dtype=dtype,
    )


def tiny_hybrid(dtype=torch.float32, img_start: int = 3) -> GroundingConfig:
    """``tiny`` with a toy hybrid tower (the 7B topology): a 64 px SAM trunk
    of a 4 x 4 grid whose neck is resized to 32, so that the two stride-2
    convolutions give the 8 x 8 clip grid."""
    hybrid = SamTowerConfig(
        encoder=SamEncoderConfig(
            img_size=64, patch_size=16, embed_dim=16, depth=2, num_heads=2,
            mlp_ratio=2.0, out_chans=8, window_size=2,
            global_attn_indexes=(1,), dtype=dtype,
        ),
        downsample_channels=(16, 32), neck_size=32, dtype=dtype,
    )
    return dataclasses.replace(tiny(dtype=dtype, img_start=img_start),
                               hybrid_high=hybrid)
