"""DeepSeek-VL's SAM-B high-resolution vision tower
(flmm_tpu/models/vision/sam_tower.py), frozen, NHWC.

A SAM ViT-B ViTDet trunk whose neck output is resized bilinearly to
``neck_size`` and pushed through two stride-2 convolutions (512 -> 1024
channels), plus an "HD" residual: the first global block's output through a
second neck (``neck_hd``), the same resize and the same convolutions, scaled
by the learned ``hd_alpha`` (reference deepseek_vl/models/sam.py:168-196).
At 1024 px the output is ``(B, 24, 24, 1024)``: the hybrid tower's 576
high-resolution tokens.

The trunk runs the port's SAM encoder blocks
(:func:`flmm_tpu_torch.models.sam.image_encoder._block`) one by one, as the
JAX tower loops ``_block``, because the HD branch reads a block in the
middle of the trunk.  Its config keeps the encoder's ``flash_*`` defaults,
which are off, so the trunk takes the plain path on every device, as in the
JAX package.
"""

from __future__ import annotations

import dataclasses

import torch

from flmm_tpu_torch.models.sam import image_encoder as sam_enc
from flmm_tpu_torch.models.sam.common import channel_norm, conv2d
from flmm_tpu_torch.ops.resize import resize_bilinear

NECK_KEYS = ("neck0_kernel", "neck0_ln_w", "neck0_ln_b", "neck1_kernel",
             "neck1_ln_w", "neck1_ln_b")


@dataclasses.dataclass(frozen=True)
class SamTowerConfig:
    encoder: sam_enc.SamEncoderConfig = dataclasses.field(
        default_factory=lambda: sam_enc.SamEncoderConfig(
            embed_dim=768, depth=12, num_heads=12,
            global_attn_indexes=(2, 5, 8, 11)))
    downsample_channels: tuple = (512, 1024)
    neck_size: int = 96  # the neck output is resized to this side
    dtype: torch.dtype = torch.float32

    @property
    def out_channels(self) -> int:
        return self.downsample_channels[-1]


def init_params(cfg: SamTowerConfig, generator: torch.Generator,
                device) -> dict:
    """Random tower weights with the JAX tree's keys, shapes and dtypes:
    ``neck_hd`` a copy of the encoder neck and ``hd_alpha`` 0, as there."""
    enc = sam_enc.init_params(cfg.encoder, generator, device)
    downs = []
    cin = cfg.encoder.out_chans
    for cout in cfg.downsample_channels:
        k = torch.randn((3, 3, cin, cout), generator=generator,
                        device=device) / (9 * cin) ** 0.5
        downs.append({"k": k.to(cfg.dtype)})
        cin = cout
    return {
        "encoder": enc,
        "downsamples": downs,
        "neck_hd": {k: enc[k].clone() for k in NECK_KEYS},
        "hd_alpha": torch.zeros((1,), device=device),
    }


def _neck(x: torch.Tensor, p: dict, eps: float) -> torch.Tensor:
    x = conv2d(x, p["neck0_kernel"])
    x = channel_norm(x, p["neck0_ln_w"], p["neck0_ln_b"], eps)
    x = conv2d(x, p["neck1_kernel"], padding=1)
    return channel_norm(x, p["neck1_ln_w"], p["neck1_ln_b"], eps)


def _resize_and_downsample(x: torch.Tensor, cfg: SamTowerConfig,
                           downs: list) -> torch.Tensor:
    """Bilinear resize to ``neck_size`` (f32, cast back), then the stride-2
    convolutions (padding 1, no bias, kernels in the activations' dtype)."""
    n = cfg.neck_size
    x = resize_bilinear(x.permute(0, 3, 1, 2), (n, n)).permute(0, 2, 3, 1)
    for d in downs:
        x = conv2d(x, d["k"], stride=2, padding=1)
    return x


def forward(params: dict, cfg: SamTowerConfig,
            pixels: torch.Tensor) -> torch.Tensor:
    """Pixels ``(B, img, img, 3)`` -> ``(B, n / 4, n / 4, out_channels)``
    with ``n = neck_size``: ``(B, 24, 24, 1024)`` at SAM-B's 1024."""
    ecfg = cfg.encoder
    enc = params["encoder"]
    x = conv2d(pixels.to(ecfg.dtype), enc["patch_kernel"], enc["patch_bias"],
               stride=ecfg.patch_size)
    x = x + enc["pos_embed"].to(x.dtype)
    first_global = None
    for i, bp in enumerate(enc["blocks"]):
        is_global = i in ecfg.global_attn_indexes
        x = sam_enc._block(x, bp, ecfg, windowed=not is_global)
        if first_global is None and is_global:
            first_global = x
    main = _resize_and_downsample(_neck(x, enc, ecfg.ln_eps), cfg,
                                  params["downsamples"])
    hd = _resize_and_downsample(
        _neck(first_global, params["neck_hd"], ecfg.ln_eps), cfg,
        params["downsamples"])
    return main + hd * params["hd_alpha"].to(main.dtype)
