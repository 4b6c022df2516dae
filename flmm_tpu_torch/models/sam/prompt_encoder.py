"""SAM prompt encoder (flmm_tpu/models/sam/prompt_encoder.py), batched over
prompts: points and box corners through the random-Fourier encoding plus
learned label and corner embeddings, dense mask prompts through the conv
downscaler."""

from __future__ import annotations

import dataclasses
import math

import torch
import torch.nn.functional as F

from flmm_tpu_torch.models.sam.common import channel_norm, conv2d


@dataclasses.dataclass(frozen=True)
class PromptEncoderConfig:
    embed_dim: int = 256
    image_embedding_size: int = 64
    input_image_size: int = 1024
    mask_in_chans: int = 16
    ln_eps: float = 1e-6
    dtype: torch.dtype = torch.float32


def init_params(cfg: PromptEncoderConfig, generator: torch.Generator,
                device) -> dict:
    d, c = cfg.embed_dim, cfg.mask_in_chans

    def w(shape, fan_in):
        return (torch.randn(shape, generator=generator, device=device)
                / math.sqrt(fan_in)).to(cfg.dtype)

    def full(shape, value):
        return torch.full(shape, value, dtype=cfg.dtype, device=device)

    return {
        "pe_gaussian": torch.randn((2, d // 2), generator=generator,
                                   device=device).to(cfg.dtype),
        "point_embeddings": w((4, d), d),
        "not_a_point": w((1, d), d),
        "no_mask": w((1, d), d),
        "mask_down": {
            "k0": w((2, 2, 1, c // 4), 4),
            "b0": full((c // 4,), 0.0),
            "ln0_w": full((c // 4,), 1.0),
            "ln0_b": full((c // 4,), 0.0),
            "k1": w((2, 2, c // 4, c), 4 * c // 4),
            "b1": full((c,), 0.0),
            "ln1_w": full((c,), 1.0),
            "ln1_b": full((c,), 0.0),
            "k2": w((1, 1, c, d), c),
            "b2": full((d,), 0.0),
        },
    }


def _pe_encode(params: dict, coords01: torch.Tensor) -> torch.Tensor:
    """Random-Fourier encoding of [0, 1] coords ``(..., 2)``; ``pe_gaussian``
    is a frozen buffer in the reference."""
    coords = 2.0 * coords01.float() - 1.0
    proj = 2.0 * math.pi * (coords @ params["pe_gaussian"].detach().float())
    return torch.cat([torch.sin(proj), torch.cos(proj)], dim=-1)


def dense_pe(params: dict, cfg: PromptEncoderConfig) -> torch.Tensor:
    """Positional grid ``(S, S, D)`` (reference get_dense_pe, NHWC)."""
    s = cfg.image_embedding_size
    dev = params["pe_gaussian"].device
    r = (torch.arange(s, dtype=torch.float32, device=dev) + 0.5) / s
    gy, gx = torch.meshgrid(r, r, indexing="ij")
    return _pe_encode(params, torch.stack([gx, gy], dim=-1)).to(cfg.dtype)


def embed_boxes(params: dict, cfg: PromptEncoderConfig,
                boxes: torch.Tensor) -> torch.Tensor:
    """``(M, 4)`` xyxy boxes in input-image pixels -> ``(M, 2, D)``."""
    pts = (boxes.reshape(-1, 2, 2) + 0.5) / cfg.input_image_size
    emb = _pe_encode(params, pts).to(cfg.dtype)
    corner = params["point_embeddings"]
    return emb + torch.stack([corner[2], corner[3]])


def embed_points(params: dict, cfg: PromptEncoderConfig,
                 coords: torch.Tensor, labels: torch.Tensor,
                 pad: bool) -> torch.Tensor:
    """``(M, N, 2)`` xy points in input-image pixels and ``(M, N)`` labels
    -> ``(M, N(+1), D)``.  Labels: 1 positive, 0 negative, -1 padding,
    which takes ``not_a_point`` (reference ``_embed_points``); ``pad``
    appends a ``(0, 0)`` point labelled -1, as the reference does when no
    box follows."""
    if pad:
        m = coords.shape[0]
        coords = torch.cat([coords, coords.new_zeros((m, 1, 2))], dim=1)
        labels = torch.cat([labels, labels.new_full((m, 1), -1)], dim=1)
    emb = _pe_encode(params, (coords + 0.5) / cfg.input_image_size).to(
        cfg.dtype)
    pe = params["point_embeddings"]
    lab = labels[..., None]
    emb = torch.where(lab == -1, params["not_a_point"][0], emb)
    emb = emb + torch.where(lab == 0, pe[0], 0.0)
    return emb + torch.where(lab == 1, pe[1], 0.0)


def embed_masks(params: dict, cfg: PromptEncoderConfig,
                masks: torch.Tensor) -> torch.Tensor:
    """``(M, 4S, 4S, 1)`` dense prompts -> ``(M, S, S, D)``."""
    p = params["mask_down"]
    x = conv2d(masks.to(cfg.dtype), p["k0"], p["b0"], stride=2)
    x = F.gelu(channel_norm(x, p["ln0_w"], p["ln0_b"], cfg.ln_eps))
    x = conv2d(x, p["k1"], p["b1"], stride=2)
    x = F.gelu(channel_norm(x, p["ln1_w"], p["ln1_b"], cfg.ln_eps))
    return conv2d(x, p["k2"], p["b2"])


def no_mask_dense(params: dict, cfg: PromptEncoderConfig,
                  m: int) -> torch.Tensor:
    s = cfg.image_embedding_size
    return params["no_mask"].reshape(1, 1, 1, -1).expand(
        m, s, s, cfg.embed_dim)
