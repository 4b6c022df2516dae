"""HF checkpoint state dicts -> the port's parameter trees
(flmm_tpu/convert/hf_weights.py).

Each converter takes a flat ``name -> tensor`` state dict (torch tensors, or
numpy arrays) and returns the tree the port's models read, on ``device``:
linear weights ``(in, out)`` (HF stores ``(out, in)``), HWIO patch kernels,
per-layer weights stacked on a leading layer axis.  Every leaf goes through
float32 to the config's dtype, as the JAX converters take it, so both
packages give the same bits from one checkpoint.  Covers the Llama family
(Llama / Vicuna / DeepSeek-LLM / Mistral / Gemma share the layout; Mixtral's
``block_sparse_moe`` experts stack on an expert axis), the CLIP and SigLIP
towers, the timm-style SigLIP trunk DeepSeek-VL vendors and the EVA-G trunk
of MGM's alternative tower.
"""

from __future__ import annotations

from typing import Any, Mapping

import numpy as np
import torch

from flmm_tpu_torch.models.llm.decoder import DecoderConfig
from flmm_tpu_torch.models.vision.vit import ViTConfig


def leaf(x: Any, device, dtype: torch.dtype) -> torch.Tensor:
    """One checkpoint tensor (or numpy array) -> ``dtype`` on ``device``,
    through float32."""
    t = torch.from_numpy(np.asarray(x)) if isinstance(x, np.ndarray) else x
    return t.detach().to(device).float().to(dtype)


class _Reader:
    """Reads and stacks the leaves of one state dict."""

    def __init__(self, sd: Mapping[str, Any], num_layers: int, device,
                 dtype: torch.dtype):
        self.sd, self.L, self.device, self.dtype = sd, num_layers, device, \
            dtype

    def get(self, name: str) -> torch.Tensor:
        return leaf(self.sd[name], self.device, self.dtype)

    def stack(self, fmt: str, transpose: bool = True) -> torch.Tensor:
        ws = [self.get(fmt.format(i=i)) for i in range(self.L)]
        return torch.stack([w.T if transpose else w for w in ws])

    def conv(self, name: str) -> torch.Tensor:
        """torch ``(O, I, kh, kw)`` -> HWIO."""
        return self.get(name).permute(2, 3, 1, 0).contiguous()


def llama_decoder_params(sd: Mapping[str, Any], cfg: DecoderConfig,
                         prefix: str = "model.", dtype=None,
                         device="cpu") -> dict:
    """An HF ``LlamaForCausalLM``-layout state dict."""
    r = _Reader(sd, cfg.num_layers, device, dtype or cfg.dtype)
    lay = prefix + "layers.{i}."
    layers = {
        "ln1": r.stack(lay + "input_layernorm.weight", False),
        "ln2": r.stack(lay + "post_attention_layernorm.weight", False),
        "wq": r.stack(lay + "self_attn.q_proj.weight"),
        "wk": r.stack(lay + "self_attn.k_proj.weight"),
        "wv": r.stack(lay + "self_attn.v_proj.weight"),
        "wo": r.stack(lay + "self_attn.o_proj.weight"),
    }
    if cfg.num_experts:
        # Mixtral block_sparse_moe: w1 the gate, w3 up, w2 down
        moe = lay + "block_sparse_moe."
        layers["router"] = r.stack(moe + "gate.weight")
        for key, name in (("w_gate", "w1"), ("w_up", "w3"),
                          ("w_down", "w2")):
            layers[key] = torch.stack([torch.stack([
                r.get(moe.format(i=i) + f"experts.{e}.{name}.weight").T
                for e in range(cfg.num_experts)]) for i in range(r.L)])
    else:
        for key, name in (("w_gate", "gate_proj"), ("w_up", "up_proj"),
                          ("w_down", "down_proj")):
            layers[key] = r.stack(lay + f"mlp.{name}.weight")
    if cfg.attn_bias:
        for name in ("q", "k", "v"):
            layers[f"b{name}"] = r.stack(
                lay + f"self_attn.{name}_proj.bias", False)
    params = {"embed": r.get(prefix + "embed_tokens.weight"),
              "layers": layers,
              "final_norm": r.get(prefix + "norm.weight")}
    if not cfg.tie_embeddings:
        params["lm_head"] = r.get("lm_head.weight").T.contiguous()
    return params


def _hf_tower_layers(r: _Reader, enc: str) -> dict:
    """The encoder layers of an HF CLIP / SigLIP tower (separate q, k, v
    projections fused into one qkv)."""
    return {
        "ln1_w": r.stack(enc + "layer_norm1.weight", False),
        "ln1_b": r.stack(enc + "layer_norm1.bias", False),
        "ln2_w": r.stack(enc + "layer_norm2.weight", False),
        "ln2_b": r.stack(enc + "layer_norm2.bias", False),
        "wqkv": torch.cat([r.stack(enc + f"self_attn.{n}_proj.weight")
                           for n in ("q", "k", "v")], dim=-1),
        "bqkv": torch.cat([r.stack(enc + f"self_attn.{n}_proj.bias", False)
                           for n in ("q", "k", "v")], dim=-1),
        "wo": r.stack(enc + "self_attn.out_proj.weight"),
        "bo": r.stack(enc + "self_attn.out_proj.bias", False),
        "w1": r.stack(enc + "mlp.fc1.weight"),
        "b1": r.stack(enc + "mlp.fc1.bias", False),
        "w2": r.stack(enc + "mlp.fc2.weight"),
        "b2": r.stack(enc + "mlp.fc2.bias", False),
    }


def clip_vit_params(sd: Mapping[str, Any], cfg: ViTConfig,
                    prefix: str = "vision_model.", dtype=None,
                    device="cpu") -> dict:
    """An HF ``CLIPVisionModel`` state dict (the LLaVA towers)."""
    r = _Reader(sd, cfg.num_layers, device, dtype or cfg.dtype)
    emb = prefix + "embeddings."
    params = {
        "patch_kernel": r.conv(emb + "patch_embedding.weight"),
        "pos_embed": r.get(emb + "position_embedding.weight"),
        "cls_token": r.get(emb + "class_embedding"),
        "pre_ln_w": r.get(prefix + "pre_layrnorm.weight"),
        "pre_ln_b": r.get(prefix + "pre_layrnorm.bias"),
        "layers": _hf_tower_layers(r, prefix + "encoder.layers.{i}."),
        "final_ln_w": r.get(prefix + "post_layernorm.weight"),
        "final_ln_b": r.get(prefix + "post_layernorm.bias"),
    }
    if cfg.patch_bias and emb + "patch_embedding.bias" in sd:
        params["patch_bias"] = r.get(emb + "patch_embedding.bias")
    return params


def siglip_vit_params(sd: Mapping[str, Any], cfg: ViTConfig,
                      prefix: str = "vision_model.", dtype=None,
                      device="cpu") -> dict:
    """An HF ``SiglipVisionModel`` state dict (the HPT-1.5 tower)."""
    r = _Reader(sd, cfg.num_layers, device, dtype or cfg.dtype)
    emb = prefix + "embeddings."
    return {
        "patch_kernel": r.conv(emb + "patch_embedding.weight"),
        "patch_bias": r.get(emb + "patch_embedding.bias"),
        "pos_embed": r.get(emb + "position_embedding.weight"),
        "layers": _hf_tower_layers(r, prefix + "encoder.layers.{i}."),
        "final_ln_w": r.get(prefix + "post_layernorm.weight"),
        "final_ln_b": r.get(prefix + "post_layernorm.bias"),
    }


def timm_siglip_vit_params(sd: Mapping[str, Any], cfg: ViTConfig,
                           dtype=None, device="cpu") -> dict:
    """The timm-style SigLIP trunk DeepSeek-VL vendors (fused qkv, keys like
    ``blocks.{i}.attn.qkv.weight``); the attention-pool head is ignored."""
    r = _Reader(sd, cfg.num_layers, device, dtype or cfg.dtype)
    pos = r.get("pos_embed")
    blk = "blocks.{i}."
    return {
        "patch_kernel": r.conv("patch_embed.proj.weight"),
        "patch_bias": r.get("patch_embed.proj.bias"),
        "pos_embed": pos[0] if pos.dim() == 3 else pos,
        "layers": {
            "ln1_w": r.stack(blk + "norm1.weight", False),
            "ln1_b": r.stack(blk + "norm1.bias", False),
            "ln2_w": r.stack(blk + "norm2.weight", False),
            "ln2_b": r.stack(blk + "norm2.bias", False),
            "wqkv": r.stack(blk + "attn.qkv.weight"),
            "bqkv": r.stack(blk + "attn.qkv.bias", False),
            "wo": r.stack(blk + "attn.proj.weight"),
            "bo": r.stack(blk + "attn.proj.bias", False),
            "w1": r.stack(blk + "mlp.fc1.weight"),
            "b1": r.stack(blk + "mlp.fc1.bias", False),
            "w2": r.stack(blk + "mlp.fc2.weight"),
            "b2": r.stack(blk + "mlp.fc2.bias", False),
        },
        "final_ln_w": r.get("norm.weight"),
        "final_ln_b": r.get("norm.bias"),
    }


def eva_vit_params(sd: Mapping[str, Any], cfg: ViTConfig, dtype=None,
                   device="cpu") -> dict:
    """The EVA-G trunk (reference mgm/model/multimodal_encoder/
    eva_encoder.py): fused qkv with a q and a v bias and an implicit zero k
    bias, class token, absolute position embeddings; the final LayerNorm
    only when the config applies one (the vendored model drops it)."""
    r = _Reader(sd, cfg.num_layers, device, dtype or cfg.dtype)
    blk = "blocks.{i}."
    bqkv = []
    for i in range(cfg.num_layers):
        qb = r.get(f"blocks.{i}.attn.q_bias")
        bqkv.append(torch.cat([qb, torch.zeros_like(qb),
                               r.get(f"blocks.{i}.attn.v_bias")]))
    pos = r.get("pos_embed")
    params = {
        "patch_kernel": r.conv("patch_embed.proj.weight"),
        "patch_bias": r.get("patch_embed.proj.bias"),
        "cls_token": r.get("cls_token").reshape(-1),
        "pos_embed": pos[0] if pos.dim() == 3 else pos,
        "layers": {
            "ln1_w": r.stack(blk + "norm1.weight", False),
            "ln1_b": r.stack(blk + "norm1.bias", False),
            "ln2_w": r.stack(blk + "norm2.weight", False),
            "ln2_b": r.stack(blk + "norm2.bias", False),
            "wqkv": r.stack(blk + "attn.qkv.weight"),
            "bqkv": torch.stack(bqkv),
            "wo": r.stack(blk + "attn.proj.weight"),
            "bo": r.stack(blk + "attn.proj.bias", False),
            "w1": r.stack(blk + "mlp.fc1.weight"),
            "b1": r.stack(blk + "mlp.fc1.bias", False),
            "w2": r.stack(blk + "mlp.fc2.weight"),
            "b2": r.stack(blk + "mlp.fc2.bias", False),
        },
    }
    if cfg.final_norm:
        params["final_ln_w"] = r.get("norm.weight")
        params["final_ln_b"] = r.get("norm.bias")
    return params
