"""SAM mask decoder (flmm_tpu/models/sam/mask_decoder.py), batched over
prompts with padded text tokens: IoU + mask tokens, two-way transformer,
4x transposed-conv upscaling, hypernetwork MLPs, IoU head."""

from __future__ import annotations

import dataclasses
import math

import torch
import torch.nn.functional as F

from flmm_tpu_torch.models.sam import transformer as twoway
from flmm_tpu_torch.models.sam.common import channel_norm, conv_transpose2d, mlp


@dataclasses.dataclass(frozen=True)
class MaskDecoderConfig:
    transformer_dim: int = 256
    num_multimask_outputs: int = 3
    iou_head_depth: int = 3
    iou_head_hidden_dim: int = 256
    ln_eps: float = 1e-6
    dtype: torch.dtype = torch.float32
    transformer: twoway.TwoWayConfig = dataclasses.field(
        default_factory=twoway.TwoWayConfig)

    @property
    def num_mask_tokens(self) -> int:
        return self.num_multimask_outputs + 1


def init_params(cfg: MaskDecoderConfig, generator: torch.Generator,
                device) -> dict:
    d = cfg.transformer_dim

    def w(shape, fan_in):
        return (torch.randn(shape, generator=generator, device=device)
                / math.sqrt(fan_in)).to(cfg.dtype)

    def zeros(n):
        return torch.zeros((n,), dtype=cfg.dtype, device=device)

    def mlp_params(dims):
        return [{"w": w((dims[i], dims[i + 1]), dims[i]),
                 "b": zeros(dims[i + 1])} for i in range(len(dims) - 1)]

    iou_dims = ([d] + [cfg.iou_head_hidden_dim] * (cfg.iou_head_depth - 1)
                + [cfg.num_mask_tokens])
    return {
        "iou_token": w((1, d), d),
        "mask_tokens": w((cfg.num_mask_tokens, d), d),
        "transformer": twoway.init_params(cfg.transformer, generator, device),
        "upscale": {
            "k0": w((2, 2, d, d // 4), d),
            "b0": zeros(d // 4),
            "ln_w": torch.ones((d // 4,), dtype=cfg.dtype, device=device),
            "ln_b": zeros(d // 4),
            "k1": w((2, 2, d // 4, d // 8), d // 4),
            "b1": zeros(d // 8),
        },
        "hyper_mlps": [mlp_params([d, d, d, d // 8])
                       for _ in range(cfg.num_mask_tokens)],
        "iou_mlp": mlp_params(iou_dims),
    }


def forward(params: dict, cfg: MaskDecoderConfig, image_embeddings,
            image_pe, sparse_prompts, dense_prompts,
            sparse_valid: torch.Tensor | None = None):
    """Masks for prompt sets sharing one image.

    Args:
      image_embeddings: ``(S, S, D)`` or ``(M, S, S, D)``.
      image_pe: ``(S, S, D)``.
      sparse_prompts: ``(M, Ns, D)`` box-corner + text tokens (padded).
      dense_prompts: ``(M, S, S, D)``.
      sparse_valid: ``(M, Ns)`` bool.

    Returns ``(masks (M, n_tokens, 4S, 4S), iou_pred (M, n_tokens))``.
    """
    d = cfg.transformer_dim
    m = sparse_prompts.shape[0]
    out_tokens = torch.cat([params["iou_token"], params["mask_tokens"]])
    out_tokens = out_tokens[None].expand(m, -1, -1)
    tokens = torch.cat([out_tokens.to(cfg.dtype),
                        sparse_prompts.to(cfg.dtype)], dim=1)
    token_mask = None
    if sparse_valid is not None:
        token_mask = torch.cat([
            torch.ones((m, 1 + cfg.num_mask_tokens), dtype=torch.bool,
                       device=sparse_valid.device), sparse_valid], dim=1)
    src = image_embeddings
    if src.dim() == 3:
        src = src[None].expand(m, -1, -1, -1)
    src = src + dense_prompts.to(cfg.dtype)
    s = src.shape[1]
    src_flat = src.reshape(m, s * s, d)
    pe_flat = image_pe.reshape(1, s * s, d).expand(m, -1, -1)

    hs, src_out = twoway.forward(params["transformer"], cfg.transformer,
                                 src_flat, pe_flat, tokens,
                                 token_mask=token_mask)
    iou_token_out = hs[:, 0]
    mask_tokens_out = hs[:, 1:1 + cfg.num_mask_tokens]

    up = params["upscale"]
    x = conv_transpose2d(src_out.reshape(m, s, s, d), up["k0"], up["b0"])
    x = F.gelu(channel_norm(x, up["ln_w"], up["ln_b"], cfg.ln_eps))
    x = F.gelu(conv_transpose2d(x, up["k1"], up["b1"]))

    hyper = torch.stack([mlp(mask_tokens_out[:, i], params["hyper_mlps"][i])
                         for i in range(cfg.num_mask_tokens)], dim=1)
    masks = torch.einsum("mnc,myxc->mnyx", hyper.float(), x.float()).to(
        cfg.dtype)
    return masks, mlp(iou_token_out, params["iou_mlp"])
