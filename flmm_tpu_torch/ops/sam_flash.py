"""SAM attention with decomposed relative-position bias: K2
(flmm_tpu/ops/sam_flash.py::sam_global_attention_v8) over a global layer's
grid and K6 (::sam_window_attention_v9) over the 14x14 windows of the split
window path; and K7 (::plain_flash_attention), the bias-free attention of
the vision towers (csrc/plain_flash.cu).

The JAX wrappers prepare thin operands outside their kernels
(``_global_augmented_operands`` and the v9 wrapper at :88-103): q scaled by
``scale * log2(e)`` and the bias rows ``(G, S, 2*side)`` in the log2
domain, folded into an augmented-K product.  K2 and K6 here launch
csrc/relpos_attention_sm90.cu, which reads the unscaled q, k and v in place
and the two rel-pos tables, forms the bias rows itself with one more
tensor-core product (:func:`table_bias_rows` is its plain twin), puts
``scale * log2(e)`` on the f32 scores and never writes the ``(G, S, S)``
scores: the wrapper runs no pass over q.  The global variants of
flmm_tpu_torch.ops.sam_flash_experiments launch the same kernel in their
own softmax modes, from the tables too.
"""

from __future__ import annotations

import math

import torch

from flmm_tpu_torch.ops import _cuda
from flmm_tpu_torch.ops._matmul import matmul_f32

LOG2E = 1.4426950408889634
LN2 = 0.6931471805599453
HEAD_DIM = 64  # the rel-pos kernel's head width
PLAIN_HEAD_DIMS = (64, 72)  # the bias-free kernel's (72: SigLIP-SO400M)
# f32 scores the plain global attention holds at a time (256 MB)
MAX_PLAIN_SCORES = 1 << 26
# what csrc/relpos_attention_sm90.cu does with the f32 scores (its softmax
# modes): base-2 softmax with the running max (K1, K2, K6, K10, global v7);
# natural-base softmax over bias rows rounded to bf16 (global v2 / v3 / v6),
# exp2 of the raw log2-domain scores with no max (global v11),
# natural-base softmax of the scores times ``scale`` plus ``bias_h``, then
# plus ``bias_w`` (global v1), or natural-base softmax with scores, exponent
# and probabilities rounded to bf16 and the denominator summed from the
# rounded probabilities (global v4)
SOFTMAX_LOG2, SOFTMAX_NATURAL, SOFTMAX_LOG2_NO_MAX = 0, 1, 2
SOFTMAX_NATURAL_SCALE_AFTER, SOFTMAX_NATURAL_BF16 = 3, 4
LOG2_DOMAIN = (SOFTMAX_LOG2, SOFTMAX_LOG2_NO_MAX)
# the largest grid side the wgmma kernel takes, in every mode: its tables
# come in as chunks of rows, and at side 147 the f32 bias rows of one
# consumer warpgroup, the tables, Q and the K / V ring just fit a block's
# 227 KB of shared memory
MAX_TABLE_SIDE = 147


def rel_pos_coords(side: int, device) -> torch.Tensor:
    """``(side, side)`` gather indices ``q - k + side - 1`` (q == k grid)."""
    r = torch.arange(side, device=device)
    return r[:, None] - r[None, :] + side - 1


def global_bias_rows(q, rel_pos_h, rel_pos_w, side: int,
                     log2_domain: bool = True, dtype=None) -> torch.Tensor:
    """Decomposed rel-pos bias rows ``[bias_h | bias_w]``, ``(G, S, 2*side)``
    in ``dtype`` (default ``q.dtype``), from the unscaled q (reference
    add_decomposed_rel_pos); in the log2 domain, or with
    ``log2_domain=False`` in natural base."""
    G, S, hd = q.shape
    coords = rel_pos_coords(side, q.device)
    rh = rel_pos_h[coords].to(q.dtype)
    rw = rel_pos_w[coords].to(q.dtype)
    qg = q.reshape(G, side, side, hd).float()
    bias_h = torch.einsum("gyxd,ykd->gyxk", qg, rh.float())
    bias_w = torch.einsum("gyxd,xkd->gyxk", qg, rw.float())
    if log2_domain:
        bias_h, bias_w = bias_h * LOG2E, bias_w * LOG2E
    return torch.cat([bias_h, bias_w], dim=-1).reshape(
        G, S, 2 * side).to(dtype or q.dtype)


def table_bias_rows(q, rel_pos_h, rel_pos_w, side: int,
                    log2_domain: bool = True) -> torch.Tensor:
    """The bias rows ``(G, S, 2*side)`` in f32 and the log2 domain as
    csrc/relpos_attention_sm90.cu forms them from the tables: the product of
    the unscaled q with each ``(2*side - 1, hd)`` table, then for query
    ``(y, x)`` and key row (column) ``k`` the column ``y - k + side - 1``
    (``x - k + side - 1``), times log2(e) (with ``log2_domain=False`` in
    natural base, as csrc/window_attention_sm90.cu keeps them).  The plain
    twin of the kernels' staging; the function of
    :func:`global_bias_rows`."""
    G, S, hd = q.shape
    n = 2 * side - 1
    t = torch.arange(S, device=q.device)
    k = torch.arange(side, device=q.device)
    rows = []
    for table, pos in ((rel_pos_h, t // side), (rel_pos_w, t % side)):
        prod = matmul_f32(q, table[:n].to(q.dtype).transpose(0, 1))
        idx = pos[:, None] - k[None, :] + side - 1  # (S, side)
        rows.append(torch.gather(prod, 2, idx.expand(G, S, side)))
    rows = torch.cat(rows, dim=-1)
    return rows * LOG2E if log2_domain else rows


def sam_global_attention_v8_plain(q, k, v, rel_pos_h, rel_pos_w, side: int,
                                  key_valid=None):
    """K2's plain version (and, reshaped, K6's): natural-base attention with
    decomposed rel-pos bias over ``(G, S, hd)``, softmax in f32; query rows
    are chunked so at most ``MAX_PLAIN_SCORES`` f32 scores exist at a time
    (the unchunked ``(64, 4096, 4096)`` scores of a bs-4 SAM-1024 global
    layer would take 4.3 GB).  ``key_valid`` ``(G, S)`` bool, if given,
    masks keys out of the softmax (the spatial window attention's ragged
    edge); every head needs one valid key."""
    G, S, hd = q.shape
    scale = 1.0 / math.sqrt(hd)
    coords = rel_pos_coords(side, q.device)
    rh = rel_pos_h[coords].float()
    rw = rel_pos_w[coords].float()
    kt = k.transpose(1, 2)
    rows = max(1, min(S, MAX_PLAIN_SCORES // (G * S)))
    outs = []
    for r0 in range(0, S, rows):
        qc = q[:, r0:r0 + rows].float()
        n = qc.shape[1]
        t = torch.arange(r0, r0 + n, device=q.device)
        logits = matmul_f32(q[:, r0:r0 + rows], kt) * scale
        bias_h = torch.einsum("gtd,tkd->gtk", qc, rh[t // side])
        bias_w = torch.einsum("gtd,tkd->gtk", qc, rw[t % side])
        logits = (logits.reshape(G, n, side, side) + bias_h[..., :, None]
                  + bias_w[..., None, :]).reshape(G, n, S)
        if key_valid is not None:
            logits = logits.masked_fill(~key_valid[:, None, :], float("-inf"))
        probs = torch.softmax(logits, dim=-1).to(q.dtype)
        outs.append(probs @ v)
    return torch.cat(outs, dim=1)


def _launch(name, q, k, v, rel_pos_h, rel_pos_w, side: int,
            softmax: int = SOFTMAX_LOG2):
    """Launch csrc/relpos_attention_sm90.cu in the ``softmax`` mode over
    ``(G, S, 64)`` heads or ``(NW, nh, S, 64)`` strided views, read in place
    with the first ``2 * side - 1`` rows of the tables in bf16; the output
    has q's shape, in memory ``(G, S, 64)`` or ``(NW, S, nh, 64)``.  The
    factor of the f32 scores is ``scale * log2(e)``, or ``scale`` for
    ``SOFTMAX_NATURAL_BF16``, whose scores stay in natural base."""
    S, hd = q.shape[-2:]
    if (S != side * side or k.shape != q.shape or v.shape != q.shape
            or q.dim() not in (3, 4)):
        raise ValueError(f"{name}: q {tuple(q.shape)} k {tuple(k.shape)} v "
                         f"{tuple(v.shape)} side {side}")
    if hd != HEAD_DIM:
        raise ValueError(f"{name}: kernel built for head_dim {HEAD_DIM}, "
                         f"got {hd}")
    tables = kernel_tables(name, rel_pos_h, rel_pos_w, side, MAX_TABLE_SIDE)
    G = math.prod(q.shape[:-2])
    nh = 1 if q.dim() == 3 else q.shape[1]
    scale = 1.0 / math.sqrt(hd)
    if q.dim() == 3:
        q, k, v = q.contiguous(), k.contiguous(), v.contiguous()
        out = torch.empty((G, S, hd), dtype=q.dtype, device=q.device)
        out_view, out_strides = out, (S * hd, 0, hd)
    else:
        out = torch.empty((q.shape[0], S, nh, hd), dtype=q.dtype,
                          device=q.device)
        out_view, out_strides = out.transpose(1, 2), (S * nh * hd, hd, nh * hd)
    # (s_b, s_h, s_t) of k and v, read in place
    strides = _head_strides(name, k)
    if _head_strides(name, v) != strides:
        raise ValueError(f"{name}: k and v differ in strides: {k.stride()} "
                         f"{v.stride()}")
    _cuda.check_cuda(name, *tables, out)
    relpos_attention_sm90(
        q, _head_strides(name, q), k, v, strides, nh, side, G, S, out,
        out_strides, tables=tables, softmax=softmax,
        alpha=scale * (1.0 if softmax == SOFTMAX_NATURAL_BF16 else LOG2E))
    return out_view


def kernel_tables(name, rel_pos_h, rel_pos_w, side: int, max_side: int):
    """The first ``2 * side - 1`` rows of the two rel-pos tables in bf16,
    contiguous, as a wgmma kernel reads them; raise unless ``1 <= side <=
    max_side`` and both tables have those rows."""
    n = 2 * side - 1
    if (not 1 <= side <= max_side or rel_pos_h.shape[0] < n
            or rel_pos_w.shape[0] < n):
        raise ValueError(
            f"{name}: the kernel takes grid sides 1 to {max_side} and tables "
            f"of 2 * side - 1 rows; got side {side}, tables "
            f"{tuple(rel_pos_h.shape)} {tuple(rel_pos_w.shape)}")
    return [t[:n].to(torch.bfloat16).contiguous()
            for t in (rel_pos_h, rel_pos_w)]


def sam_global_attention_v8(q, k, v, rel_pos_h, rel_pos_w, side: int):
    """Global ViTDet attention over ``(G, S, hd)`` heads (K2); keys at or
    beyond ``S = side**2`` are masked in-kernel for any grid side from 1 to
    ``MAX_TABLE_SIDE``."""
    _cuda.check_no_grad("sam_global_attention_v8", q, k, v, rel_pos_h,
                        rel_pos_w)
    if not q.is_cuda:
        return sam_global_attention_v8_plain(q, k, v, rel_pos_h, rel_pos_w,
                                             side)
    if q.dim() != 3:
        raise ValueError(f"sam_global_attention_v8: q {tuple(q.shape)} is "
                         "not (G, S, hd)")
    out = _launch("sam_global_attention_v8", q, k, v, rel_pos_h, rel_pos_w,
                  side)
    sam_global_attention_v8.launches += 1
    return out


sam_global_attention_v8.launches = 0


def sam_window_attention_v9_plain(q, k, v, rel_pos_h, rel_pos_w, side: int):
    """K6's plain version over ``(G, T, hd)`` or ``(NW, nh, T, hd)``: the
    window-heads through :func:`sam_global_attention_v8_plain`."""
    T, hd = q.shape[-2:]
    out = sam_global_attention_v8_plain(
        q.reshape(-1, T, hd), k.reshape(-1, T, hd), v.reshape(-1, T, hd),
        rel_pos_h, rel_pos_w, side)
    return out.reshape(q.shape)


def sam_window_attention_v9(q, k, v, rel_pos_h, rel_pos_w, side: int):
    """Windowed ViTDet attention (K6) over window-heads ``(G, T=side**2,
    64)``, or over ``(NW, nh, T, 64)`` strided views of a windowised
    ``(NW, T, 3C)`` qkv tensor (then g = w * nh + h, read in place); the
    output has q's shape."""
    _cuda.check_no_grad("sam_window_attention_v9", q, k, v, rel_pos_h,
                        rel_pos_w)
    if not q.is_cuda:
        return sam_window_attention_v9_plain(q, k, v, rel_pos_h, rel_pos_w,
                                             side)
    out = _launch("sam_window_attention_v9", q, k, v, rel_pos_h, rel_pos_w,
                  side)
    sam_window_attention_v9.launches += 1
    return out


sam_window_attention_v9.launches = 0


def relpos_attention_sm90(q, q_strides, k, v, strides, nh, side, G, S, out,
                          out_strides, bias=None, tables=None,
                          softmax: int = SOFTMAX_LOG2,
                          alpha: float = 1.0) -> None:
    """Launch csrc/relpos_attention_sm90.cu: the ``softmax`` mode of ``alpha
    * q.k`` plus the bias.  Element ``(g, t, d)`` of k and v is at ``(g //
    nh) * strides[0] + (g % nh) * strides[1] + t * strides[2] + d`` from
    each pointer, of q likewise with ``q_strides``, of ``out`` with
    ``out_strides``.  The bias is ``bias``, ``(G, S, 2*side)`` log2-domain
    rows (``SOFTMAX_LOG2`` only), or else comes from ``tables``, the two
    ``(2*side - 1, 64)`` bf16 rel-pos tables in natural base (the kernel
    stages their products with q as the mode rounds them).  Uncounted: the
    wrappers count."""
    th, tw = (None, None) if tables is None else (t.data_ptr() for t in tables)
    _cuda.launch(
        "flmm_relpos_attention_sm90", q.data_ptr(), *q_strides, k.data_ptr(),
        v.data_ptr(), *strides, nh, None if bias is None else bias.data_ptr(),
        th, tw, side, G, S, softmax, alpha, out.data_ptr(), *out_strides,
        _cuda.stream(q))


def plain_flash_attention_plain(q, k, v):
    """K7's plain version: ``softmax(q k^T / sqrt(hd)) v`` over ``(..., S,
    hd)``; q is scaled in f32 and rounded to its dtype before the product,
    as the JAX wrapper does, scores and softmax are f32."""
    qs = (q.float() * (1.0 / math.sqrt(q.shape[-1]))).to(q.dtype)
    logits = matmul_f32(qs, k.transpose(-1, -2))
    return torch.softmax(logits, dim=-1).to(q.dtype) @ v


def plain_flash_boxes(x) -> torch.Tensor:
    """The plain twin of what csrc/plain_flash.cu stages of a ``(G, S, hd)``
    operand: each head row as ``ceil(hd / 64)`` boxes of 64 columns and the
    tokens in tiles of 64, zeros past ``hd`` and past ``S`` (the kernel's
    tensor map ends there), ``(G, S rounded up to 64, 64 * boxes)``.  At hd
    72 the second box is columns 64-71 and zeros."""
    G, S, hd = x.shape
    return torch.nn.functional.pad(
        x, (0, -(-hd // 64) * 64 - hd, 0, -(-S // 64) * 64 - S))


def _head_strides(name, t):
    """``(s_b, s_h, s_t)`` of a ``(G, S, hd)`` or ``(B, H, S, hd)`` bf16 CUDA
    tensor the kernel reads in place with 16-byte loads."""
    if (t.dtype != torch.bfloat16 or not t.is_cuda or t.stride(-1) != 1
            or t.data_ptr() % 16 or any(s % 8 for s in t.stride()[:-1])):
        raise ValueError(
            f"{name}: q, k and v must be bf16 CUDA tensors with a contiguous "
            "last dim, strides that are multiples of 8 and 16-byte "
            f"alignment; got {t.dtype}, strides {t.stride()}")
    if t.dim() == 3:
        return (t.stride(0), 0, t.stride(1))
    return t.stride()[:3]


def plain_flash_attention(q, k, v):
    """Bias-free, non-causal attention for ViT towers (K7) over ``(G, S,
    hd)`` heads, or over ``(B, H, S, hd)`` strided views of a ``(B, S, 3 * H
    * hd)`` qkv tensor, read in place; any S, hd 64 or 72.  The ``(G, S, S)``
    scores never reach device memory.  The output has q's shape, in memory
    ``(G, S, hd)`` or ``(B, S, H, hd)``."""
    name = "plain_flash_attention"
    _cuda.check_no_grad(name, q, k, v)
    if not q.is_cuda:
        return plain_flash_attention_plain(q, k, v)
    if q.dim() not in (3, 4) or k.shape != q.shape or v.shape != q.shape:
        raise ValueError(f"{name}: q {tuple(q.shape)} k {tuple(k.shape)} v "
                         f"{tuple(v.shape)}")
    S, hd = q.shape[-2:]
    if hd not in PLAIN_HEAD_DIMS:
        raise ValueError(f"{name}: kernel built for head_dim in "
                         f"{PLAIN_HEAD_DIMS}, got {hd}")
    G = math.prod(q.shape[:-2])
    if q.dim() == 3:
        nh = 1
        out = torch.empty((G, S, hd), dtype=q.dtype, device=q.device)
        out_view, out_strides = out, (S * hd, 0, hd)
    else:
        nh = q.shape[1]
        out = torch.empty((q.shape[0], S, nh, hd), dtype=q.dtype,
                          device=q.device)
        out_view, out_strides = out.transpose(1, 2), (S * nh * hd, hd, nh * hd)
    _cuda.launch(
        "flmm_plain_flash",
        q.data_ptr(), *_head_strides(name, q),
        k.data_ptr(), *_head_strides(name, k),
        v.data_ptr(), *_head_strides(name, v),
        nh, G, S, hd, 1.0 / math.sqrt(hd), out.data_ptr(), *out_strides,
        _cuda.stream(q))
    plain_flash_attention.launches += 1
    return out_view


plain_flash_attention.launches = 0
