"""ConvNeXt auxiliary vision tower, MGM's high-resolution branch
(flmm_tpu/models/vision/convnext.py).

An open_clip ConvNeXt trunk (reference mgm/model/multimodal_encoder/
openclip_encoder.py): a stride-4 stem conv + LayerNorm, then four stages,
each (past the first) a LayerNorm + stride-2 conv downsample and blocks of
depthwise 7 x 7 conv -> LayerNorm (f32 statistics) -> Linear -> exact GELU ->
Linear -> layer scale ``gamma`` on a residual.  Every stage's output is
bilinearly upsampled to stage 0's resolution (input / 4) and the four are
concatenated: 192 + 384 + 768 + 1536 = 2880 channels for ConvNeXt-L.

Layout: activations stay NHWC ``(B, H, W, C)``, which the LayerNorms and the
block MLP's products want.  The convolutions take the NCHW view
``x.permute(0, 3, 1, 2)`` of that tensor, whose memory is channels-last, so
``F.conv2d`` runs cuDNN's NHWC kernels (the faster layout on Hopper for the
depthwise 7 x 7 in bf16) and its channels-last result permutes back to NHWC
without a copy.  The parameter tree keeps the JAX package's HWIO kernels, so
the weight bridge and the checkpoint loaders stay leaf for leaf; each
forward turns the conv kernels to torch's OIHW (ConvNeXt-L: 7.5 M of its
196 M weights, the rest are the MLP's ``(in, out)`` matrices, used as they
are).
"""

from __future__ import annotations

import dataclasses
import math

import torch
import torch.nn.functional as F

from flmm_tpu_torch.models.sam.common import layer_norm
from flmm_tpu_torch.ops.resize import resize_bilinear


@dataclasses.dataclass(frozen=True)
class ConvNeXtConfig:
    depths: tuple = (3, 3, 27, 3)  # ConvNeXt-L
    dims: tuple = (192, 384, 768, 1536)
    image_size: int = 768
    ln_eps: float = 1e-6
    dtype: torch.dtype = torch.float32

    @property
    def out_channels(self) -> int:
        return sum(self.dims)


def init_params(cfg: ConvNeXtConfig, generator: torch.Generator,
                device) -> dict:
    """Random parameters with the JAX tree's keys, shapes (HWIO kernels)
    and dtypes."""
    dt = cfg.dtype

    def w(shape, fan_in):
        return (torch.randn(shape, generator=generator, device=device)
                / math.sqrt(fan_in)).to(dt)

    def full(shape, value):
        return torch.full(shape, value, dtype=dt, device=device)

    def block(dim):
        return {
            "dw_k": w((7, 7, 1, dim), 49), "dw_b": full((dim,), 0.0),
            "ln_w": full((dim,), 1.0), "ln_b": full((dim,), 0.0),
            "w1": w((dim, 4 * dim), dim), "b1": full((4 * dim,), 0.0),
            "w2": w((4 * dim, dim), 4 * dim), "b2": full((dim,), 0.0),
            "gamma": full((dim,), 1e-6),
        }

    stages = []
    for i, (depth, dim) in enumerate(zip(cfg.depths, cfg.dims)):
        stage = {"blocks": [block(dim) for _ in range(depth)]}
        if i > 0:
            prev = cfg.dims[i - 1]
            stage["down_ln_w"] = full((prev,), 1.0)
            stage["down_ln_b"] = full((prev,), 0.0)
            stage["down_k"] = w((2, 2, prev, dim), 4 * prev)
            stage["down_b"] = full((dim,), 0.0)
        stages.append(stage)
    return {
        "stem_k": w((4, 4, 3, cfg.dims[0]), 48),
        "stem_b": full((cfg.dims[0],), 0.0),
        "stem_ln_w": full((cfg.dims[0],), 1.0),
        "stem_ln_b": full((cfg.dims[0],), 0.0),
        "stages": stages,
    }


def _conv(x: torch.Tensor, k_hwio: torch.Tensor, b: torch.Tensor,
          stride: int, padding: int = 0, groups: int = 1) -> torch.Tensor:
    """NHWC ``x`` through an HWIO kernel (``groups``: depthwise when equal
    to the channels), NHWC out in ``x.dtype``."""
    k = k_hwio.to(x.dtype).permute(3, 2, 0, 1)
    y = F.conv2d(x.permute(0, 3, 1, 2), k, b.to(x.dtype), stride=stride,
                 padding=padding, groups=groups)
    return y.permute(0, 2, 3, 1)


def _block_forward(x: torch.Tensor, p: dict, eps: float) -> torch.Tensor:
    y = _conv(x, p["dw_k"], p["dw_b"], 1, padding=3, groups=x.shape[-1])
    y = layer_norm(y, p["ln_w"], p["ln_b"], eps)
    y = F.gelu(y @ p["w1"].to(y.dtype) + p["b1"].to(y.dtype))
    y = y @ p["w2"].to(y.dtype) + p["b2"].to(y.dtype)
    return x + y * p["gamma"].to(y.dtype)


def forward(params: dict, cfg: ConvNeXtConfig,
            pixels: torch.Tensor) -> torch.Tensor:
    """Pixels ``(B, H, W, 3)`` -> ``(B, H/4, W/4, sum(dims))`` NHWC: every
    stage's output upsampled to stage 0's resolution, concatenated in stage
    order."""
    x = _conv(pixels.to(cfg.dtype), params["stem_k"], params["stem_b"], 4)
    x = layer_norm(x, params["stem_ln_w"], params["stem_ln_b"], cfg.ln_eps)
    feats = []
    for i, stage in enumerate(params["stages"]):
        if i > 0:
            x = layer_norm(x, stage["down_ln_w"], stage["down_ln_b"],
                           cfg.ln_eps)
            x = _conv(x, stage["down_k"], stage["down_b"], 2)
        for bp in stage["blocks"]:
            x = _block_forward(x, bp, cfg.ln_eps)
        feats.append(x)
    h0, w0 = feats[0].shape[1:3]
    ups = [feats[0]] + [
        resize_bilinear(f.permute(0, 3, 1, 2), (h0, w0)).permute(0, 2, 3, 1)
        for f in feats[1:]]
    return torch.cat(ups, dim=-1)
