"""Trainable U-Net mask head (flmm_tpu/models/mask_head/unet.py), NHWC.

4 encoder stages of 2x [3x3 conv -> GroupNorm(1) -> ReLU] with 2x2 max
pooling between them, 3 decoder stages (f32 bilinear 2x upsample -> 1x1
conv -> GN -> ReLU, skip concat, 2 convs), a 1x1 ``conv_seg``; the input is
normalised per map, upsampled to ``upsample_input`` and zero-padded to a
multiple of ``2**(num_stages-1)``, the output cropped back.
"""

from __future__ import annotations

import dataclasses
import math

import torch
import torch.nn.functional as F

from flmm_tpu_torch import trace
from flmm_tpu_torch.models.sam.common import conv2d
from flmm_tpu_torch.ops.resize import resize_bilinear


@dataclasses.dataclass(frozen=True)
class UNetConfig:
    in_channels: int
    base_channels: int = 64
    num_stages: int = 4
    enc_num_convs: tuple = (2, 2, 2, 2)
    dec_num_convs: tuple = (2, 2, 2)
    normalize_input: bool = True
    upsample_input: int | None = 64
    dtype: torch.dtype = torch.float32

    def stage_channels(self, i: int) -> int:
        return self.base_channels * (2 ** i)


def _conv_params(generator, device, kh, kw, cin, cout, dtype):
    k = torch.randn((kh, kw, cin, cout), generator=generator, device=device)
    return {
        "k": (k * math.sqrt(2.0 / (kh * kw * cin))).to(dtype),
        "b": torch.zeros((cout,), dtype=dtype, device=device),
        "gn_w": torch.ones((cout,), dtype=dtype, device=device),
        "gn_b": torch.zeros((cout,), dtype=dtype, device=device),
    }


def init_params(cfg: UNetConfig, generator: torch.Generator, device) -> dict:
    def conv(kh, kw, cin, cout):
        return _conv_params(generator, device, kh, kw, cin, cout, cfg.dtype)

    n = cfg.num_stages
    enc = []
    cin = cfg.in_channels
    for i in range(n):
        cout = cfg.stage_channels(i)
        enc.append([conv(3, 3, cin if j == 0 else cout, cout)
                    for j in range(cfg.enc_num_convs[i])])
        cin = cout
    dec = []
    for i in range(1, n):
        c = cfg.stage_channels(i - 1)
        dec.append({
            "up": conv(1, 1, cfg.stage_channels(i), c),
            "convs": [conv(3, 3, 2 * c if j == 0 else c, c)
                      for j in range(cfg.dec_num_convs[i - 1])],
        })
    seg_k = torch.randn((1, 1, cfg.base_channels, 1), generator=generator,
                        device=device)
    return {
        "enc": enc,
        "dec": dec,
        "seg_k": (seg_k * math.sqrt(2.0 / cfg.base_channels)).to(cfg.dtype),
        "seg_b": torch.zeros((1,), dtype=cfg.dtype, device=device),
    }


def _group_norm1(x, w, b, eps=1e-5):
    """GroupNorm(num_groups=1): normalise over (H, W, C) per sample."""
    xf = x.float()
    mu = xf.mean(dim=(1, 2, 3), keepdim=True)
    var = ((xf - mu) ** 2).mean(dim=(1, 2, 3), keepdim=True)
    y = (xf - mu) * torch.rsqrt(var + eps)
    return (y * w.float() + b.float()).to(x.dtype)


def _conv_gn_relu(x, p, padding=1):
    y = conv2d(x, p["k"], p["b"], padding=padding)
    return torch.relu(_group_norm1(y, p["gn_w"], p["gn_b"]))


def _maxpool2(x):
    return F.max_pool2d(x.permute(0, 3, 1, 2), 2).permute(0, 2, 3, 1)


@trace.spanned("unet")
def forward(params: dict, cfg: UNetConfig, x: torch.Tensor) -> torch.Tensor:
    """``(M, h, w, C_in)`` attention maps -> ``(M, H, W)`` coarse logits."""
    x = x.to(cfg.dtype)
    if cfg.normalize_input:
        x = x / x.sum(dim=(1, 2), keepdim=True).clamp_min(1e-12)
    h, w = x.shape[1], x.shape[2]
    if cfg.upsample_input is not None:
        scale = max(1.0, cfg.upsample_input / max(h, w))
        h, w = int(h * scale), int(w * scale)
        x = resize_bilinear(x.permute(0, 3, 1, 2), (h, w),
                            scale=(scale, scale)).permute(0, 2, 3, 1)
    div = 2 ** (cfg.num_stages - 1)
    ph, pw = math.ceil(h / div) * div, math.ceil(w / div) * div
    x = F.pad(x, (0, 0, 0, pw - w, 0, ph - h))

    enc_outs = []
    for i, block in enumerate(params["enc"]):
        if i > 0:
            x = _maxpool2(x)
        for p in block:
            x = _conv_gn_relu(x, p)
        enc_outs.append(x)

    for i in range(cfg.num_stages - 1, 0, -1):
        dp = params["dec"][i - 1]
        x = x.permute(0, 3, 1, 2)
        x = resize_bilinear(x, (x.shape[-2] * 2, x.shape[-1] * 2))
        x = _conv_gn_relu(x.permute(0, 2, 3, 1), dp["up"], padding=0)
        x = torch.cat([enc_outs[i - 1], x], dim=-1)
        for p in dp["convs"]:
            x = _conv_gn_relu(x, p)

    x = x[:, :h, :w]
    return conv2d(x, params["seg_k"], params["seg_b"])[..., 0]


def output_hw(cfg: UNetConfig, in_hw: tuple[int, int]) -> tuple[int, int]:
    """Static output size for a given attention-grid input size."""
    h, w = in_hw
    if cfg.upsample_input is not None:
        scale = max(1.0, cfg.upsample_input / max(h, w))
        h, w = int(h * scale), int(w * scale)
    return h, w
