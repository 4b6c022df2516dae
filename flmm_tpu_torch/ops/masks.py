"""Mask/attention aggregation ops (flmm_tpu/ops/masks.py), batched over
any leading dims."""

from __future__ import annotations

import torch


def segment_matrix(mask_ids: torch.Tensor, num_masks: int) -> torch.Tensor:
    """One-hot ``(..., S, M)`` f32 token-to-mask membership; id -1 belongs
    to no mask."""
    cols = torch.arange(num_masks, device=mask_ids.device)
    return (mask_ids[..., :, None] == cols).float()


def mean_merge_matrix(mask_ids: torch.Tensor, num_masks: int) -> torch.Tensor:
    """``(..., S, M)`` matrix whose product with token-major data gives the
    per-mask means."""
    onehot = segment_matrix(mask_ids, num_masks)
    return onehot / onehot.sum(dim=-2, keepdim=True).clamp_min(1.0)


def mask_to_box(mask: torch.Tensor) -> torch.Tensor:
    """``[x0, y0, x1, y1]`` (exclusive max) of binary masks ``(..., H, W)``;
    an empty mask gives the full-frame box (reference mask_refiner.py:87-89).
    Returns f32 ``(..., 4)``."""
    h, w = mask.shape[-2:]
    m = mask.bool()
    rows, cols = m.any(dim=-1), m.any(dim=-2)
    ridx = torch.arange(h, device=mask.device)
    cidx = torch.arange(w, device=mask.device)
    y0 = torch.where(rows, ridx, h).amin(dim=-1)
    y1 = torch.where(rows, ridx, -1).amax(dim=-1)
    x0 = torch.where(cols, cidx, w).amin(dim=-1)
    x1 = torch.where(cols, cidx, -1).amax(dim=-1)
    box = torch.stack([x0, y0, x1 + 1, y1 + 1], dim=-1).float()
    full = torch.tensor([0.0, 0.0, w, h], device=mask.device)
    return torch.where(rows.any(dim=-1)[..., None], box, full)


def merge_attention(attn: torch.Tensor, mask_ids: torch.Tensor,
                    num_masks: int, merge: str = "mean") -> torch.Tensor:
    """Per-token attention ``(..., S, N)`` -> per-mask maps ``(..., M, N)``
    in f32 over the tokens with ``mask_ids == m`` (``(S,)``): their mean or
    their max (reference ``apply_merge``).  A mask that matches no token
    gets a 0 map."""
    a = attn.float()
    if merge == "mean":
        return torch.einsum("...sn,sm->...mn", a,
                            mean_merge_matrix(mask_ids, num_masks))
    if merge == "max":
        onehot = segment_matrix(mask_ids, num_masks) > 0  # (S, M)
        big_neg = torch.finfo(torch.float32).min
        masked = torch.where(onehot[:, :, None], a[..., :, None, :], big_neg)
        out = masked.amax(dim=-3)
        return torch.where(out <= big_neg / 2, 0.0, out)
    raise ValueError(f"unknown merge {merge!r}")


def merge_text_embeds(hidden: torch.Tensor,
                      token_index: torch.Tensor) -> torch.Tensor:
    """The hidden states ``(S, D)`` at each mask's token positions ``(M,
    T)`` -> ``(M, T, D)`` (padded rows repeat position 0; callers carry the
    ``(M, T)`` validity)."""
    return hidden[token_index.long()]
