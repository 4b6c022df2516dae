"""SAM torch checkpoints -> the port's SAM trees
(flmm_tpu/convert/sam_weights.py).

Consumes the official ``sam_vit_{b,l,h}`` state dict layout (reference
segment_anything/build_sam.py:55-107): the image encoder under
``image_encoder.``, the prompt encoder and the mask decoder under their own
prefixes.  Leaves go through float32 to the config's dtype on ``device``
(``hf_weights.leaf``).
"""

from __future__ import annotations

from typing import Any, Mapping

import torch

from flmm_tpu_torch.convert.hf_weights import leaf
from flmm_tpu_torch.models.sam.image_encoder import SamEncoderConfig
from flmm_tpu_torch.models.sam.mask_decoder import MaskDecoderConfig
from flmm_tpu_torch.models.sam.prompt_encoder import PromptEncoderConfig
from flmm_tpu_torch.ops.resize import resize_bicubic


def _hwio(t: torch.Tensor) -> torch.Tensor:
    """torch conv weight ``(O, I, kh, kw)`` -> HWIO."""
    return t.permute(2, 3, 1, 0).contiguous()


def _lin(get, name: str) -> dict:
    return {"w": get(name + ".weight").T.contiguous(),
            "b": get(name + ".bias")}


def _attn(get, prefix: str) -> dict:
    return {k: _lin(get, f"{prefix}.{k}_proj")
            for k in ("q", "k", "v", "out")}


def resize_rel_pos(table: torch.Tensor, target_len: int) -> torch.Tensor:
    """Linear-resample an ``(L, hd)`` decomposed rel-pos table to
    ``(target_len, hd)`` in float64: the reference's ``get_rel_pos``
    ``F.interpolate(mode='linear', align_corners=False)``
    (segment_anything/modeling/image_encoder.py:292-308).  An output row i
    samples input coordinate ``(i + 0.5) * L / target_len - 0.5``."""
    L = table.shape[0]
    if L == target_len:
        return table
    coords = ((torch.arange(target_len, dtype=torch.float64,
                            device=table.device) + 0.5)
              * (L / target_len) - 0.5).clamp(0.0, L - 1.0)
    lo = coords.floor().long()
    hi = (lo + 1).clamp(max=L - 1)
    t = (coords - lo)[:, None]
    table = table.double()
    return table[lo] * (1.0 - t) + table[hi] * t


def resize_pos_embed_2d(pos: torch.Tensor, target_grid: int) -> torch.Tensor:
    """Bicubic-resample a ``(G, G, D)`` absolute pos-embed grid in float32
    (the torch-parity a = -0.75 bicubic of the ViT towers)."""
    if pos.shape[0] == target_grid:
        return pos
    out = resize_bicubic(pos.float().permute(2, 0, 1)[None],
                         (target_grid, target_grid))[0]
    return out.permute(1, 2, 0).contiguous()


def encoder_params(sd: Mapping[str, Any], cfg: SamEncoderConfig,
                   prefix: str = "image_encoder.", dtype=None,
                   device="cpu") -> dict:
    """The encoder weights.  When ``cfg`` asks for another input resolution
    than the checkpoint's (the reduced-resolution schedule), the absolute
    pos-embed is resampled bicubically and the global blocks' rel-pos tables
    linearly to ``2 * grid - 1`` (window tables do not depend on it)."""
    dtype = dtype or cfg.dtype

    def raw(name):  # float32 on the device
        return leaf(sd[prefix + name], device, torch.float32)

    def get(name):
        return leaf(sd[prefix + name], device, dtype)

    blocks = []
    for i in range(cfg.depth):
        b = f"blocks.{i}."
        size = cfg.grid if i in cfg.global_attn_indexes else cfg.window_size
        blocks.append({
            "ln1_w": get(b + "norm1.weight"), "ln1_b": get(b + "norm1.bias"),
            "ln2_w": get(b + "norm2.weight"), "ln2_b": get(b + "norm2.bias"),
            "wqkv": get(b + "attn.qkv.weight").T.contiguous(),
            "bqkv": get(b + "attn.qkv.bias"),
            "wo": get(b + "attn.proj.weight").T.contiguous(),
            "bo": get(b + "attn.proj.bias"),
            "mlp": {
                "w1": get(b + "mlp.lin1.weight").T.contiguous(),
                "b1": get(b + "mlp.lin1.bias"),
                "w2": get(b + "mlp.lin2.weight").T.contiguous(),
                "b2": get(b + "mlp.lin2.bias"),
            },
            **{f"rel_pos_{a}": resize_rel_pos(
                raw(b + f"attn.rel_pos_{a}"), 2 * size - 1).to(dtype)
               for a in ("h", "w")},
        })
    return {
        "patch_kernel": _hwio(get("patch_embed.proj.weight")),
        "patch_bias": get("patch_embed.proj.bias"),
        "pos_embed": resize_pos_embed_2d(raw("pos_embed")[0],
                                         cfg.grid).to(dtype),
        "neck0_kernel": _hwio(get("neck.0.weight")),
        "neck0_ln_w": get("neck.1.weight"),
        "neck0_ln_b": get("neck.1.bias"),
        "neck1_kernel": _hwio(get("neck.2.weight")),
        "neck1_ln_w": get("neck.3.weight"),
        "neck1_ln_b": get("neck.3.bias"),
        "blocks": blocks,
    }


def prompt_encoder_params(sd: Mapping[str, Any], cfg: PromptEncoderConfig,
                          prefix: str = "prompt_encoder.", dtype=None,
                          device="cpu") -> dict:
    dtype = dtype or cfg.dtype

    def get(name):
        return leaf(sd[prefix + name], device, dtype)

    md = "mask_downscaling."
    return {
        "pe_gaussian": get("pe_layer.positional_encoding_gaussian_matrix"),
        "point_embeddings": torch.cat(
            [get(f"point_embeddings.{i}.weight") for i in range(4)], dim=0),
        "not_a_point": get("not_a_point_embed.weight"),
        "no_mask": get("no_mask_embed.weight"),
        "mask_down": {
            "k0": _hwio(get(md + "0.weight")), "b0": get(md + "0.bias"),
            "ln0_w": get(md + "1.weight"), "ln0_b": get(md + "1.bias"),
            "k1": _hwio(get(md + "3.weight")), "b1": get(md + "3.bias"),
            "ln1_w": get(md + "4.weight"), "ln1_b": get(md + "4.bias"),
            "k2": _hwio(get(md + "6.weight")), "b2": get(md + "6.bias"),
        },
    }


def _conv_transpose_kernel(w: torch.Tensor) -> torch.Tensor:
    """torch ConvTranspose2d weight ``(in, out, kH, kW)`` -> the HWIO kernel
    the port's transposed conv correlates with as a forward conv: spatially
    flipped, as the JAX package keeps it."""
    return w.permute(2, 3, 0, 1).flip(0, 1).contiguous()


def mask_decoder_params(sd: Mapping[str, Any], cfg: MaskDecoderConfig,
                        prefix: str = "mask_decoder.", dtype=None,
                        device="cpu") -> dict:
    dtype = dtype or cfg.dtype

    def get(name):  # a full key
        return leaf(sd[name], device, dtype)

    def mlp_layers(base, n):
        return [_lin(get, f"{prefix}{base}.layers.{j}") for j in range(n)]

    layers = []
    for i in range(cfg.transformer.depth):
        t = f"{prefix}transformer.layers.{i}."
        layers.append({
            "self_attn": _attn(get, t + "self_attn"),
            "cross_t2i": _attn(get, t + "cross_attn_token_to_image"),
            "cross_i2t": _attn(get, t + "cross_attn_image_to_token"),
            "mlp": {"w1": get(t + "mlp.lin1.weight").T.contiguous(),
                    "b1": get(t + "mlp.lin1.bias"),
                    "w2": get(t + "mlp.lin2.weight").T.contiguous(),
                    "b2": get(t + "mlp.lin2.bias")},
            **{f"ln{j}_{wb}": get(t + f"norm{j}.{name}")
               for j in range(1, 5)
               for wb, name in (("w", "weight"), ("b", "bias"))},
        })
    tr = prefix + "transformer."
    up = prefix + "output_upscaling."
    return {
        "iou_token": get(prefix + "iou_token.weight"),
        "mask_tokens": get(prefix + "mask_tokens.weight"),
        "transformer": {
            "layers": layers,
            "final_attn": _attn(get, tr + "final_attn_token_to_image"),
            "final_ln_w": get(tr + "norm_final_attn.weight"),
            "final_ln_b": get(tr + "norm_final_attn.bias"),
        },
        "upscale": {
            "k0": _conv_transpose_kernel(get(up + "0.weight")),
            "b0": get(up + "0.bias"),
            "ln_w": get(up + "1.weight"), "ln_b": get(up + "1.bias"),
            "k1": _conv_transpose_kernel(get(up + "3.weight")),
            "b1": get(up + "3.bias"),
        },
        "hyper_mlps": [mlp_layers(f"output_hypernetworks_mlps.{i}", 3)
                       for i in range(cfg.num_mask_tokens)],
        "iou_mlp": mlp_layers("iou_prediction_head", cfg.iou_head_depth),
    }
