"""K1: one whole SAM window block over window-major tokens
(flmm_tpu/ops/window_block.py::window_block).

The TPU kernel keeps every weight of the block (~25 MB) resident in VMEM and
runs LN1 + qkv + 16-head attention + out-proj + LN2 + MLP per window group.
No SM holds that, so on Hopper the block is three kernels over all windows:

1. csrc/ln_gemm.cu -- masked LN1 fused into the qkv product: the normed
   rows of geometric pad tokens are zeroed, so pad keys carry ``k = b_k``
   and ``v = b_v`` and stay in the softmax, as in the reference;
2. csrc/relpos_attention.cu -- per (window, head) attention read straight
   out of the ``(NW, T, 3C)`` qkv tensor, the decomposed rel-pos bias rows
   added in-kernel, base-2 softmax;
3. csrc/block_tail.cu -- out-proj + residual + LN2 + MLP + residual, the
   ``(N, 4C)`` hidden kept on chip.

The qkv tensor makes one round trip through device memory.  The wrapper
counts one launch of K1 per call.
"""

from __future__ import annotations

import math

import torch

from flmm_tpu_torch.models.sam.common import layer_norm
from flmm_tpu_torch.ops import _cuda
from flmm_tpu_torch.ops.fused_block import activation, block_tail, ln_gemm
from flmm_tpu_torch.ops.sam_flash import LN2, LOG2E, rel_pos_coords, relpos_attention


def scaled_qkv_weights(wqkv, bqkv, nh: int, hd: int):
    """Fold ``scale * log2(e)`` (base-2 softmax domain) into the q columns
    of a ``(C, 3C)`` qkv projection, rounded back to its dtype."""
    C = nh * hd
    scale2 = (1.0 / math.sqrt(hd)) * LOG2E
    colscale = torch.cat([
        torch.full((C,), scale2, dtype=torch.float32, device=wqkv.device),
        torch.ones((2 * C,), dtype=torch.float32, device=wqkv.device)])
    return ((wqkv.float() * colscale).to(wqkv.dtype),
            (bqkv.float() * colscale).to(bqkv.dtype))


def _masked_ln(x, ln_w, ln_b, valid, eps):
    """LayerNorm with the rows of pad tokens (``valid`` False) zeroed."""
    y = layer_norm(x, ln_w, ln_b, eps)
    return y if valid is None else y.masked_fill(~valid[..., None], 0.0)


def window_rel_bias_from_x(x, valid, ln_w, ln_b, wq_s, bq_s, rel_pos_h,
                           rel_pos_w, side: int, nh: int, hd: int,
                           eps: float = 1e-6):
    """Decomposed rel-pos bias rows ``(NW, nh, T, 2*side)`` for every
    (window, head), log2 domain, recomputing the q projection from the
    residual stream ``x`` ``(NW, T, C)``.  ``wq_s``/``bq_s`` are the q
    third of :func:`scaled_qkv_weights`."""
    NW, T, C = x.shape
    if T != side * side:
        raise ValueError(f"window_rel_bias_from_x: T={T}, side={side}")
    y = _masked_ln(x, ln_w, ln_b, valid, eps)
    q = ((y @ wq_s).float() + bq_s.float()).to(x.dtype)
    q = q.reshape(NW, side, side, nh, hd)
    coords = rel_pos_coords(side, x.device)
    # q carries scale*log2e; the bias is log2e * (q_raw . r), so the
    # tables take the residual sqrt(hd).  The products accumulate in f32
    # and round once to x.dtype, as the JAX einsums do.
    mult = math.sqrt(hd)
    rh = (rel_pos_h[coords] * mult).to(x.dtype)
    rw = (rel_pos_w[coords] * mult).to(x.dtype)
    bias_h = torch.einsum("wyxhd,ykd->whyxk", q, rh)
    bias_w = torch.einsum("wyxhd,xkd->whyxk", q, rw)
    return torch.cat([bias_h, bias_w], dim=-1).reshape(NW, nh, T, 2 * side)


def window_block_plain(x, bias, valid, ln1_w, ln1_b, wqkv_s, bqkv_s, wo, bo,
                       ln2_w, ln2_b, w1, b1, w2, b2, side: int,
                       num_heads: int, eps: float = 1e-6):
    """The same block in natural-base math (softmax of ``ln 2 * score``)."""
    NW, T, C = x.shape
    nh, hd = num_heads, C // num_heads
    y1 = _masked_ln(x, ln1_w, ln1_b, valid, eps)
    qkv = y1 @ wqkv_s + bqkv_s
    q, k, v = (t.reshape(NW, T, nh, hd).transpose(1, 2)
               for t in qkv.split(C, dim=-1))
    s = q.float() @ k.float().transpose(-1, -2)  # (NW, nh, T, T)
    b = bias.float()
    s = (s.reshape(NW, nh, T, side, side) + b[..., :side, None]
         + b[..., None, side:]).reshape(NW, nh, T, T)
    p = torch.softmax(s * LN2, dim=-1).to(x.dtype)
    attn = (p @ v).transpose(1, 2).reshape(NW, T, C)
    xr = x + (attn @ wo + bo)
    h = activation(layer_norm(xr, ln2_w, ln2_b, eps) @ w1 + b1, "gelu")
    return xr + (h @ w2 + b2)


def window_block(x, bias, valid, ln1_w, ln1_b, wqkv_s, bqkv_s, wo, bo,
                 ln2_w, ln2_b, w1, b1, w2, b2, side: int, num_heads: int,
                 eps: float = 1e-6):
    """One whole window block over window-major tokens (K1).

    Args:
      x: ``(NW, T, C)`` residual stream, ``T = side * side``.
      bias: ``(NW, nh, T, 2*side)`` log2-domain rel-pos rows
        (:func:`window_rel_bias_from_x`).
      valid: ``(NW, T)`` bool geometric-pad mask, or None.
      wqkv_s, bqkv_s: :func:`scaled_qkv_weights` output.

    Returns ``(NW, T, C)``.
    """
    _cuda.check_no_grad("window_block", x, bias, ln1_w, ln1_b, wqkv_s,
                        bqkv_s, wo, bo, ln2_w, ln2_b, w1, b1, w2, b2)
    if not x.is_cuda:
        return window_block_plain(x, bias, valid, ln1_w, ln1_b, wqkv_s,
                                  bqkv_s, wo, bo, ln2_w, ln2_b, w1, b1, w2,
                                  b2, side, num_heads, eps)
    NW, T, C = x.shape
    nh = num_heads
    hd = C // nh
    if T != side * side or wqkv_s.shape != (C, 3 * C) or hd != 64 \
            or bias.shape != (NW, nh, T, 2 * side):
        raise ValueError(f"window_block: x {tuple(x.shape)} bias "
                         f"{tuple(bias.shape)} side {side} heads {nh}")
    x = x.contiguous()
    bias = bias.contiguous()
    _cuda.check_cuda("window_block", x, bias, ln1_w, ln1_b, wqkv_s, bqkv_s)
    xf = x.reshape(NW * T, C)
    qkv = torch.empty((NW * T, 3 * C), dtype=x.dtype, device=x.device)
    ln_gemm(xf, ln1_w, ln1_b, eps,
            None if valid is None else valid.reshape(-1).contiguous(),
            wqkv_s, bqkv_s, qkv)
    attn = torch.empty((NW * T, C), dtype=x.dtype, device=x.device)
    strides = (T * 3 * C, hd, 3 * C)
    relpos_attention(qkv, strides, qkv[:, C:], qkv[:, 2 * C:], strides, nh,
                     bias, side, NW * nh, T, attn, (T * C, hd, C))
    out = torch.empty_like(xf)
    block_tail(xf, attn, wo, bo, ln2_w, ln2_b, eps, w1, b1, w2, b2, "gelu",
               out)
    window_block.launches += 1
    return out.reshape(NW, T, C)


window_block.launches = 0
