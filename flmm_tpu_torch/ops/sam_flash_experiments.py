"""K12: the bake-off variants of the SAM attention kernels
(flmm_tpu/ops/sam_flash_experiments.py).  Ported so far: the spatial
head-major window attention ``sam_window_attention_v10`` (the pallas_call at
:1222) with ``qkv_head_major_perm``; the other variants are queued in
ROADMAP.md.

v10 takes the qkv tensor as the projection leaves it, spatial ``(B, Hp, Wp,
nh * 3 * hd)`` with the columns permuted head-major ``[q_h | k_h | v_h]``,
and returns the attention output spatially ``(B, Hp, Wp, nh * hd)``: the
window partition and the head split are addressing inside the kernel
(csrc/spatial_window_attention.cu), so nothing is windowised or transposed
outside.  Keys at or beyond ``grid_hw`` are masked out of the softmax
(unlike K1 and K6, where pad tokens stay in it).  The JAX kernel leaves the
output beyond ``grid_hw`` unspecified; here it is 0, on both the kernel and
the plain path.  As in the JAX wrapper, only the thin bias rows are made
outside, by two einsums over the unscaled q.
"""

from __future__ import annotations

import math

import torch

from flmm_tpu_torch.ops import _cuda
from flmm_tpu_torch.ops.sam_flash import HEAD_DIM, LOG2E, rel_pos_coords, \
    sam_global_attention_v8_plain


def qkv_head_major_perm(nh: int, hd: int, device=None) -> torch.Tensor:
    """Column permutation taking a standard ``[q all | k all | v all]`` qkv
    projection to the head-major ``[q_h | k_h | v_h]`` layout v10 reads:
    ``w_hm = w[:, perm]``."""
    C = nh * hd
    idx = torch.arange(3 * C, device=device).reshape(3, nh, hd)
    return idx.permute(1, 0, 2).reshape(-1)


def _geometry(name, qkv, rel_pos_h, side: int, grid_hw: int):
    if qkv.dim() != 4:
        raise ValueError(f"{name}: qkv {tuple(qkv.shape)} is not (B, Hp, Wp, "
                         "nh * 3 * hd)")
    B, Hp, Wp, C3 = qkv.shape
    hd = rel_pos_h.shape[-1]
    if (Hp % side or Wp % side or C3 % (3 * hd) or 2 * side > hd
            or not 0 < grid_hw <= min(Hp, Wp)):
        raise ValueError(f"{name}: qkv {tuple(qkv.shape)} with side {side}, "
                         f"head_dim {hd} and grid_hw {grid_hw}: needs Hp and "
                         "Wp multiples of side, 2 * side <= head_dim and "
                         "0 < grid_hw <= Hp, Wp")
    return B, Hp, Wp, C3 // (3 * hd), hd


def _grid_valid(Hp: int, Wp: int, grid_hw: int, device) -> torch.Tensor:
    """``(Hp, Wp)`` bool: inside the valid ``grid_hw`` square."""
    return ((torch.arange(Hp, device=device) < grid_hw)[:, None]
            & (torch.arange(Wp, device=device) < grid_hw)[None, :])


def sam_window_attention_v10_plain(qkv, rel_pos_h, rel_pos_w, side: int,
                                   grid_hw: int):
    """K12 v10's plain version: window partition and head split as copies,
    then the plain rel-pos attention with the keys beyond ``grid_hw`` masked
    (on a grid without pad this is K6's plain route), the output back in
    place and 0 beyond ``grid_hw``."""
    B, Hp, Wp, nh, hd = _geometry("sam_window_attention_v10_plain", qkv,
                                  rel_pos_h, side, grid_hw)
    nwy, nwx, T = Hp // side, Wp // side, side * side
    x = qkv.reshape(B, nwy, side, nwx, side, nh, 3, hd)
    x = x.permute(6, 0, 1, 3, 5, 2, 4, 7).reshape(3, -1, T, hd)
    valid = _grid_valid(Hp, Wp, grid_hw, qkv.device)
    key_valid = valid.reshape(nwy, side, nwx, side).permute(0, 2, 1, 3)
    key_valid = key_valid.reshape(1, nwy, nwx, 1, T).expand(
        B, nwy, nwx, nh, T).reshape(-1, T)
    out = sam_global_attention_v8_plain(x[0], x[1], x[2], rel_pos_h,
                                        rel_pos_w, side, key_valid=key_valid)
    out = out.reshape(B, nwy, nwx, nh, side, side, hd)
    out = out.permute(0, 1, 4, 2, 5, 3, 6).reshape(B, Hp, Wp, nh * hd)
    return torch.where(valid[None, :, :, None], out, 0.0)


def window_bias_rows(qkv, rel_pos_h, rel_pos_w, side: int) -> torch.Tensor:
    """The decomposed rel-pos bias rows ``[bias_h | bias_w]`` of every
    (image, window, head), ``(B, nwy, nwx, nh, T, 2 * side)`` f32 in the log2
    domain, from the unscaled q columns of the head-major spatial qkv."""
    B, Hp, Wp, C3 = qkv.shape
    hd = rel_pos_h.shape[-1]
    nh, nwy, nwx = C3 // (3 * hd), Hp // side, Wp // side
    coords = rel_pos_coords(side, qkv.device)
    rh = rel_pos_h[coords].to(qkv.dtype).float()  # (side, side, hd)
    rw = rel_pos_w[coords].to(qkv.dtype).float()
    q_sp = qkv.reshape(B, nwy, side, nwx, side, nh, 3 * hd)[..., :hd].float()
    bias_h = torch.einsum("bYyXxhd,ykd->bYXhyxk", q_sp, rh)
    bias_w = torch.einsum("bYyXxhd,xkd->bYXhyxk", q_sp, rw)
    bias = torch.cat([bias_h, bias_w], dim=-1) * LOG2E
    return bias.reshape(B, nwy, nwx, nh, side * side, 2 * side)


def sam_window_attention_v10(qkv, rel_pos_h, rel_pos_w, side: int,
                             grid_hw: int):
    """Windowed ViTDet attention over SPATIAL, HEAD-MAJOR qkv (K12 v10).

    Args:
      qkv: ``(B, Hp, Wp, nh*3*hd)`` with ``Hp`` / ``Wp`` multiples of
        ``side`` (zero-padded beyond ``grid_hw``); per-token layout
        ``[q_h | k_h | v_h]`` per head (column-permuted wqkv).
      grid_hw: valid spatial extent (e.g. 64 for SAM-1024).

    Returns ``(B, Hp, Wp, nh*hd)``, 0 beyond ``grid_hw``.
    """
    name = "sam_window_attention_v10"
    _cuda.check_no_grad(name, qkv, rel_pos_h, rel_pos_w)
    if not qkv.is_cuda:
        return sam_window_attention_v10_plain(qkv, rel_pos_h, rel_pos_w, side,
                                              grid_hw)
    B, Hp, Wp, nh, hd = _geometry(name, qkv, rel_pos_h, side, grid_hw)
    if hd != HEAD_DIM:
        raise ValueError(f"{name}: kernel built for head_dim {HEAD_DIM}, "
                         f"got {hd}")
    bias = window_bias_rows(qkv, rel_pos_h, rel_pos_w, side)
    out = torch.empty((B, Hp, Wp, nh * hd), dtype=qkv.dtype,
                      device=qkv.device)
    # contiguous and 16-byte aligned: each token's q | k | v of one head is
    # 384 contiguous bytes at a multiple of 16
    _cuda.check_cuda(name, qkv, out)
    _cuda.check_cuda(name, bias, dtype=torch.float32)
    _cuda.launch("flmm_spatial_window_attention", qkv.data_ptr(),
                 bias.data_ptr(), B, Hp, Wp, nh, hd, side, grid_hw,
                 LOG2E / math.sqrt(hd), out.data_ptr(), _cuda.stream(qkv))
    sam_window_attention_v10.launches += 1
    return out


sam_window_attention_v10.launches = 0
