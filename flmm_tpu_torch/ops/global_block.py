"""K10: the attention half of a SAM global block -- LN1 + qkv + global
attention with decomposed rel-pos bias + output projection + residual, the
result in f32 (flmm_tpu/ops/global_block.py::global_attn_block).

The TPU kernel holds one image's LN output (8 MB) in VMEM and walks the
heads on a sequential grid, adding each head's ``attn_h @ Wo[h]`` into an f32
output block it revisits.  No SM holds 8 MB, and blocks on Hopper run in no
order, so heads adding into one output would race.  The port runs three
hand-written phases over all images instead:

1. csrc/ln_gemm.cu -- LN1 fused into the qkv product with the scaled
   weights (q carries ``scale * log2(e)``);
2. csrc/relpos_attention.cu -- per (image, head) attention read straight
   out of the ``(B*S, 3C)`` qkv rows, the log2-domain bias rows added to the
   f32 scores in registers, base-2 softmax; each head's output is rounded to
   the working dtype, as in the TPU kernel;
3. csrc/ln_gemm.cu, f32 epilogue -- ``x + attn @ wo + bo``: one block owns
   an output tile and sums over all heads' columns in a fixed order in f32,
   so there are no atomics and two runs give the same bits; the result is
   written unrounded and the caller casts once.

The qkv rows and the per-head attention output make one round trip through
device memory (100 MB + 34 MB per bs-4 layer).  The wrapper counts one
launch of K10 per call and raises no other wrapper's count.
"""

from __future__ import annotations

import torch

from flmm_tpu_torch.models.sam.common import layer_norm
from flmm_tpu_torch.ops import _cuda, sam_flash
from flmm_tpu_torch.ops.fused_block import gemm_residual_f32, ln_gemm
from flmm_tpu_torch.ops.window_block import window_rel_bias_from_x


def global_rel_bias_from_x(x, ln_w, ln_b, wq_s, bq_s, rel_pos_h, rel_pos_w,
                           side: int, nh: int, hd: int, eps: float = 1e-6):
    """Decomposed rel-pos bias rows ``(B, nh, S, 2*side)`` for every (image,
    head) in the log2 domain, recomputing the q projection from the residual
    stream ``x`` ``(B, S, C)``: the window rows' function over whole images,
    with no pad tokens.  ``wq_s``/``bq_s`` are the q third of
    :func:`flmm_tpu_torch.ops.window_block.scaled_qkv_weights`."""
    return window_rel_bias_from_x(x, None, ln_w, ln_b, wq_s, bq_s, rel_pos_h,
                                  rel_pos_w, side, nh, hd, eps)


def global_attn_block_plain(x, bias, ln1_w, ln1_b, wqkv_s, bqkv_s, wo, bo,
                            side: int, num_heads: int, eps: float = 1e-6):
    """The same half-block in natural-base math (softmax of ``ln 2 *
    score``), f32 result.  Query rows are chunked so at most
    ``sam_flash.MAX_PLAIN_SCORES`` f32 scores exist at a time."""
    B, S, C = x.shape
    nh, hd = num_heads, C // num_heads
    qkv = layer_norm(x, ln1_w, ln1_b, eps) @ wqkv_s + bqkv_s
    q, k, v = (t.reshape(B, S, nh, hd).transpose(1, 2)
               for t in qkv.split(C, dim=-1))
    kt = k.float().transpose(-1, -2)
    rows = max(1, min(S, sam_flash.MAX_PLAIN_SCORES // (B * nh * S)))
    outs = []
    for r0 in range(0, S, rows):
        b = bias[:, :, r0:r0 + rows].float()
        n = b.shape[2]
        s = q[:, :, r0:r0 + rows].float() @ kt  # (B, nh, n, S)
        s = (s.reshape(B, nh, n, side, side) + b[..., :side, None]
             + b[..., None, side:]).reshape(B, nh, n, S)
        p = torch.softmax(s * sam_flash.LN2, dim=-1).to(x.dtype)
        outs.append((p @ v).transpose(1, 2).reshape(B, n, C))
    attn = torch.cat(outs, dim=1)
    return x.float() + attn.float() @ wo.float() + bo.float()


def global_attn_block(x, bias, ln1_w, ln1_b, wqkv_s, bqkv_s, wo, bo,
                      side: int, num_heads: int, eps: float = 1e-6):
    """The attention half of a global block (K10).

    Args:
      x: ``(B, S, C)`` spatial-major residual stream, ``S = side * side``.
      bias: ``(B, nh, S, 2*side)`` log2-domain rel-pos rows
        (:func:`global_rel_bias_from_x`).
      wqkv_s, bqkv_s: ``scaled_qkv_weights`` output, ``(C, 3C)`` layout.

    Returns the pre-LN2 residual ``(B, S, C)`` in **f32**: the residual, the
    projection bias and all heads' projections summed in f32; the caller
    rounds once.
    """
    _cuda.check_no_grad("global_attn_block", x, bias, ln1_w, ln1_b, wqkv_s,
                        bqkv_s, wo, bo)
    if not x.is_cuda:
        return global_attn_block_plain(x, bias, ln1_w, ln1_b, wqkv_s, bqkv_s,
                                       wo, bo, side, num_heads, eps)
    B, S, C = x.shape
    nh = num_heads
    hd = C // nh
    if (S != side * side or wqkv_s.shape != (C, 3 * C) or wo.shape != (C, C)
            or hd != sam_flash.HEAD_DIM
            or bias.shape != (B, nh, S, 2 * side)):
        raise ValueError(f"global_attn_block: x {tuple(x.shape)} bias "
                         f"{tuple(bias.shape)} side {side} heads {nh} (the "
                         f"kernel is built for head_dim {sam_flash.HEAD_DIM})")
    x = x.contiguous()
    bias = bias.contiguous()
    _cuda.check_cuda("global_attn_block", x, bias, ln1_w, ln1_b, wqkv_s,
                     bqkv_s)
    xf = x.reshape(B * S, C)
    qkv = torch.empty((B * S, 3 * C), dtype=x.dtype, device=x.device)
    ln_gemm(xf, ln1_w, ln1_b, eps, None, wqkv_s, bqkv_s, qkv)
    attn = torch.empty((B * S, C), dtype=x.dtype, device=x.device)
    strides = (S * 3 * C, hd, 3 * C)
    sam_flash.relpos_attention(qkv, strides, qkv[:, C:], qkv[:, 2 * C:],
                               strides, nh, bias, side, B * nh, S, attn,
                               (S * C, hd, C))
    out = torch.empty((B * S, C), dtype=torch.float32, device=x.device)
    gemm_residual_f32(attn, wo, bo, xf, out)
    global_attn_block.launches += 1
    return out.reshape(B, S, C)


global_attn_block.launches = 0
