"""SAM two-way transformer (flmm_tpu/models/sam/transformer.py): every
attention that takes the prompt tokens as keys accepts a validity mask, so
padded text-prompt slots are batched across masks."""

from __future__ import annotations

import dataclasses
import math

import torch

from flmm_tpu_torch.models.sam.common import layer_norm, linear, mlp_block
from flmm_tpu_torch.ops._matmul import matmul_f32


@dataclasses.dataclass(frozen=True)
class TwoWayConfig:
    depth: int = 2
    embed_dim: int = 256
    num_heads: int = 8
    mlp_dim: int = 2048
    attention_downsample_rate: int = 2
    ln_eps: float = 1e-5  # torch nn.LayerNorm default
    dtype: torch.dtype = torch.float32


def _attn_params(generator, device, d, internal, dtype):
    def w(i, o):
        return (torch.randn((i, o), generator=generator, device=device)
                / math.sqrt(i)).to(dtype)

    def zeros(n):
        return torch.zeros((n,), dtype=dtype, device=device)

    return {
        "q": {"w": w(d, internal), "b": zeros(internal)},
        "k": {"w": w(d, internal), "b": zeros(internal)},
        "v": {"w": w(d, internal), "b": zeros(internal)},
        "out": {"w": w(internal, d), "b": zeros(d)},
    }


def init_params(cfg: TwoWayConfig, generator: torch.Generator,
                device) -> dict:
    d = cfg.embed_dim
    internal = d // cfg.attention_downsample_rate

    def ones():
        return torch.ones((d,), dtype=cfg.dtype, device=device)

    def zeros(n=d):
        return torch.zeros((n,), dtype=cfg.dtype, device=device)

    layers = []
    for _ in range(cfg.depth):
        layer = {
            "self_attn": _attn_params(generator, device, d, d, cfg.dtype),
            "cross_t2i": _attn_params(generator, device, d, internal,
                                      cfg.dtype),
            "cross_i2t": _attn_params(generator, device, d, internal,
                                      cfg.dtype),
            "mlp": {
                "w1": (torch.randn((d, cfg.mlp_dim), generator=generator,
                                   device=device) / math.sqrt(d)
                       ).to(cfg.dtype),
                "b1": zeros(cfg.mlp_dim),
                "w2": (torch.randn((cfg.mlp_dim, d), generator=generator,
                                   device=device) / math.sqrt(cfg.mlp_dim)
                       ).to(cfg.dtype),
                "b2": zeros(),
            },
        }
        for i in range(1, 5):
            layer[f"ln{i}_w"], layer[f"ln{i}_b"] = ones(), zeros()
        layers.append(layer)
    return {
        "layers": layers,
        "final_attn": _attn_params(generator, device, d, internal, cfg.dtype),
        "final_ln_w": ones(), "final_ln_b": zeros(),
    }


def attention(p: dict, q, k, v, num_heads: int,
              key_mask: torch.Tensor | None = None) -> torch.Tensor:
    """Reference transformer.Attention; ``key_mask`` ``(B, Nk)`` True =
    attend."""
    q, k, v = linear(q, p["q"]), linear(k, p["k"]), linear(v, p["v"])
    B, Nq, C = q.shape
    hd = C // num_heads
    qh = q.reshape(B, Nq, num_heads, hd).transpose(1, 2)
    kh = k.reshape(B, k.shape[1], num_heads, hd).transpose(1, 2)
    vh = v.reshape(B, v.shape[1], num_heads, hd).transpose(1, 2)
    logits = matmul_f32(qh, kh.transpose(-1, -2)) / math.sqrt(hd)
    if key_mask is not None:
        logits = logits + torch.where(
            key_mask[:, None, None, :], 0.0, torch.finfo(torch.float32).min)
    probs = torch.softmax(logits, dim=-1).to(q.dtype)
    out = (probs @ vh).transpose(1, 2).reshape(B, Nq, C)
    return linear(out, p["out"])


def forward(params: dict, cfg: TwoWayConfig, image_embedding, image_pe,
            point_embedding, token_mask: torch.Tensor | None = None):
    """``(B, N_img, D)`` image tokens + pe and ``(B, N_tok, D)`` output and
    sparse-prompt tokens -> (queries, keys)."""
    nh = cfg.num_heads
    queries, keys = point_embedding, image_embedding
    for i, lp in enumerate(params["layers"]):
        if i == 0:  # skip_first_layer_pe
            queries = attention(lp["self_attn"], queries, queries, queries,
                                nh, key_mask=token_mask)
        else:
            q = queries + point_embedding
            queries = queries + attention(lp["self_attn"], q, q, queries, nh,
                                          key_mask=token_mask)
        queries = layer_norm(queries, lp["ln1_w"], lp["ln1_b"], cfg.ln_eps)

        q = queries + point_embedding
        k = keys + image_pe
        queries = queries + attention(lp["cross_t2i"], q, k, keys, nh)
        queries = layer_norm(queries, lp["ln2_w"], lp["ln2_b"], cfg.ln_eps)

        queries = queries + mlp_block(queries, lp["mlp"], act="relu")
        queries = layer_norm(queries, lp["ln3_w"], lp["ln3_b"], cfg.ln_eps)

        q = queries + point_embedding
        k = keys + image_pe
        keys = keys + attention(lp["cross_i2t"], k, q, queries, nh,
                                key_mask=token_mask)
        keys = layer_norm(keys, lp["ln4_w"], lp["ln4_b"], cfg.ln_eps)

    q = queries + point_embedding
    k = keys + image_pe
    queries = queries + attention(params["final_attn"], q, k, keys, nh)
    queries = layer_norm(queries, params["final_ln_w"], params["final_ln_b"],
                         cfg.ln_eps)
    return queries, keys
