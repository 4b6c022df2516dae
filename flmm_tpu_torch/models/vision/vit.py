"""Vision transformer tower (flmm_tpu/models/vision/vit.py), frozen.

NHWC images, stacked per-layer weights ``(L, ...)`` walked by a Python
loop.  On a CUDA tensor, when the shapes tile (the JAX gate at vit.py:197-201
with the backend test ``x.is_cuda``), each layer runs K3 for LN1 + qkv and
K4 for out-proj + LN2 + MLP.  Attention is plain unless ``flash`` is set:
then, on a CUDA tensor, every layer's attention is K7
(:func:`flmm_tpu_torch.ops.sam_flash.plain_flash_attention`), which reads q,
k and v in place from the layer's qkv rows.  An input above the native grid
resamples the position embedding bicubically.
"""

from __future__ import annotations

import dataclasses
import math

import torch

from flmm_tpu_torch import trace
from flmm_tpu_torch.models.sam.common import conv2d, layer_norm
from flmm_tpu_torch.ops._matmul import matmul_f32
from flmm_tpu_torch.ops.fused_block import activation, fused_ln_qkv, fused_proj_ln_mlp
from flmm_tpu_torch.ops.resize import resize_bicubic
from flmm_tpu_torch.ops.sam_flash import plain_flash_attention


@dataclasses.dataclass(frozen=True)
class ViTConfig:
    hidden_size: int
    num_layers: int
    num_heads: int
    patch_size: int
    image_size: int
    mlp_dim: int
    use_class_token: bool = False
    use_pre_norm: bool = False
    patch_bias: bool = True
    act: str = "gelu"  # 'gelu' | 'gelu_tanh' | 'quick_gelu'
    ln_eps: float = 1e-6
    final_norm: bool = True
    flash: bool = False
    fused_mlp: bool = True
    dtype: torch.dtype = torch.float32

    @property
    def grid(self) -> int:
        return self.image_size // self.patch_size

    @property
    def num_patches(self) -> int:
        return self.grid * self.grid

    @property
    def seq_len(self) -> int:
        return self.num_patches + (1 if self.use_class_token else 0)

    @property
    def head_dim(self) -> int:
        return self.hidden_size // self.num_heads


def init_params(cfg: ViTConfig, generator: torch.Generator, device) -> dict:
    d, f, L = cfg.hidden_size, cfg.mlp_dim, cfg.num_layers

    def w(shape, fan_in):
        return (torch.randn(shape, generator=generator, device=device)
                / math.sqrt(fan_in)).to(cfg.dtype)

    def full(shape, value):
        return torch.full(shape, value, dtype=cfg.dtype, device=device)

    params = {
        "patch_kernel": w((cfg.patch_size, cfg.patch_size, 3, d),
                          cfg.patch_size * cfg.patch_size * 3),
        "pos_embed": w((cfg.seq_len, d), d),
        "layers": {
            "ln1_w": full((L, d), 1.0), "ln1_b": full((L, d), 0.0),
            "ln2_w": full((L, d), 1.0), "ln2_b": full((L, d), 0.0),
            "wqkv": w((L, d, 3 * d), d), "bqkv": full((L, 3 * d), 0.0),
            "wo": w((L, d, d), d), "bo": full((L, d), 0.0),
            "w1": w((L, d, f), d), "b1": full((L, f), 0.0),
            "w2": w((L, f, d), f), "b2": full((L, d), 0.0),
        },
        "final_ln_w": full((d,), 1.0),
        "final_ln_b": full((d,), 0.0),
    }
    if cfg.patch_bias:
        params["patch_bias"] = full((d,), 0.0)
    if cfg.use_class_token:
        params["cls_token"] = full((d,), 0.0)
    if cfg.use_pre_norm:
        params["pre_ln_w"] = full((d,), 1.0)
        params["pre_ln_b"] = full((d,), 0.0)
    return params


def resample_pos_embed(pos: torch.Tensor, old_grid: int, new_grid: int,
                       has_cls: bool) -> torch.Tensor:
    """Bicubic position-embedding interpolation to another grid; the class
    token's row, if any, is kept aside."""
    if old_grid == new_grid:
        return pos
    cls, grid_pos = (pos[:1], pos[1:]) if has_cls else (None, pos)
    d = grid_pos.shape[-1]
    g = grid_pos.reshape(old_grid, old_grid, d).permute(2, 0, 1)
    g = resize_bicubic(g, (new_grid, new_grid))
    g = g.permute(1, 2, 0).reshape(new_grid * new_grid, d)
    return g if cls is None else torch.cat([cls, g], dim=0)


@trace.spanned("tower")
def forward(params: dict, cfg: ViTConfig, pixels: torch.Tensor,
            select_layer: int = -1) -> torch.Tensor:
    """Hidden states at ``select_layer`` (HF indexing: -1 is the final layer
    with the final LayerNorm when ``final_norm``), ``(B, seq, D)``."""
    B = pixels.shape[0]
    d = cfg.hidden_size
    x = conv2d(pixels.to(cfg.dtype), params["patch_kernel"],
               stride=cfg.patch_size)
    grid_hw = x.shape[1], x.shape[2]
    x = x.reshape(B, -1, d)
    if cfg.patch_bias:
        x = x + params["patch_bias"]
    if cfg.use_class_token:
        cls = params["cls_token"].to(x.dtype).expand(B, 1, d)
        x = torch.cat([cls, x], dim=1)
    pos = params["pos_embed"]
    if grid_hw != (cfg.grid, cfg.grid):
        if grid_hw[0] != grid_hw[1]:
            raise ValueError(f"non-square resample unsupported: {grid_hw}")
        pos = resample_pos_embed(pos, cfg.grid, grid_hw[0],
                                 cfg.use_class_token)
    x = x + pos.to(x.dtype)
    if cfg.use_pre_norm:
        x = layer_norm(x, params["pre_ln_w"], params["pre_ln_b"], cfg.ln_eps)

    H, hd = cfg.num_heads, cfg.head_dim
    S = x.shape[1]
    scale = 1.0 / math.sqrt(hd)
    use_flash = cfg.flash and x.is_cuda
    use_fused_mlp = (
        cfg.fused_mlp and x.is_cuda
        and cfg.act in ("gelu", "gelu_tanh", "quick_gelu")
        and d % 128 == 0 and cfg.mlp_dim % 512 == 0
    )
    n_keep = (cfg.num_layers if select_layer in (-1, cfg.num_layers) else
              (select_layer if select_layer >= 0
               else cfg.num_layers + select_layer) + 1)
    h = x
    for i in range(n_keep):
        lp = {k: v[i] for k, v in params["layers"].items()}
        if use_fused_mlp:
            qkv = fused_ln_qkv(h, lp["ln1_w"], lp["ln1_b"], lp["wqkv"],
                               lp["bqkv"], eps=cfg.ln_eps)
        else:
            y = layer_norm(h, lp["ln1_w"], lp["ln1_b"], cfg.ln_eps)
            qkv = y @ lp["wqkv"] + lp["bqkv"]
        q, k, v = (t.reshape(B, S, H, hd).transpose(1, 2)
                   for t in qkv.split(d, dim=-1))
        if use_flash:  # (B, H, S, hd) views in, (B, S, H, hd) memory out
            o = plain_flash_attention(q, k, v).transpose(1, 2).reshape(
                B, S, d)
        else:
            logits = matmul_f32(q, k.transpose(-1, -2)) * scale
            probs = torch.softmax(logits, dim=-1).to(h.dtype)
            o = (probs @ v).transpose(1, 2).reshape(B, S, d)
        if use_fused_mlp:
            h = fused_proj_ln_mlp(
                h, o, lp["wo"], lp["bo"], lp["ln2_w"], lp["ln2_b"],
                lp["w1"], lp["b1"], lp["w2"], lp["b2"], eps=cfg.ln_eps,
                act=cfg.act)
        else:
            h = h + (o @ lp["wo"] + lp["bo"])
            y2 = layer_norm(h, lp["ln2_w"], lp["ln2_b"], cfg.ln_eps)
            h = h + (activation(y2 @ lp["w1"] + lp["b1"], cfg.act) @ lp["w2"]
                     + lp["b2"])
    if select_layer in (-1, cfg.num_layers) and cfg.final_norm:
        return layer_norm(h, params["final_ln_w"], params["final_ln_b"],
                          cfg.ln_eps)
    return h
