"""SAM attention with decomposed relative-position bias: K2
(flmm_tpu/ops/sam_flash.py::sam_global_attention_v8) over a global layer's
grid and K6 (::sam_window_attention_v9) over the 14x14 windows of the split
window path; and K7 (::plain_flash_attention), the bias-free attention of
the vision towers (csrc/plain_flash.cu).

Each wrapper prepares the thin operands outside the kernel as the JAX
package does (``_global_augmented_operands`` and the v9 wrapper at
:88-103): q scaled by ``scale * log2(e)`` and the bias rows
``(G, S, 2*side)`` in the log2 domain from the unscaled q, both rounded to
the working dtype.  The TPU kernels fold the bias into an augmented-K
product; the Hopper kernel (csrc/relpos_attention.cu) adds it to the f32
scores in registers and never writes the ``(G, S, S)`` scores.
"""

from __future__ import annotations

import math

import torch

from flmm_tpu_torch.ops import _cuda

LOG2E = 1.4426950408889634
LN2 = 0.6931471805599453
HEAD_DIM = 64  # the rel-pos kernel's head width
PLAIN_HEAD_DIMS = (64, 72)  # the bias-free kernel's (72: SigLIP-SO400M)
# f32 scores the plain global attention holds at a time (256 MB)
MAX_PLAIN_SCORES = 1 << 26


def rel_pos_coords(side: int, device) -> torch.Tensor:
    """``(side, side)`` gather indices ``q - k + side - 1`` (q == k grid)."""
    r = torch.arange(side, device=device)
    return r[:, None] - r[None, :] + side - 1


def global_bias_rows(q, rel_pos_h, rel_pos_w, side: int) -> torch.Tensor:
    """Decomposed rel-pos bias rows ``[bias_h | bias_w]``, ``(G, S, 2*side)``
    in the log2 domain and ``q.dtype``, from the unscaled q (reference
    add_decomposed_rel_pos)."""
    G, S, hd = q.shape
    coords = rel_pos_coords(side, q.device)
    rh = rel_pos_h[coords].to(q.dtype)
    rw = rel_pos_w[coords].to(q.dtype)
    qg = q.reshape(G, side, side, hd).float()
    bias_h = torch.einsum("gyxd,ykd->gyxk", qg, rh.float()) * LOG2E
    bias_w = torch.einsum("gyxd,xkd->gyxk", qg, rw.float()) * LOG2E
    return torch.cat([bias_h, bias_w], dim=-1).reshape(
        G, S, 2 * side).to(q.dtype)


def sam_global_attention_v8_plain(q, k, v, rel_pos_h, rel_pos_w, side: int):
    """K2's plain version (and, reshaped, K6's): natural-base attention with
    decomposed rel-pos bias over ``(G, S, hd)``, softmax in f32; query rows
    are chunked so at most ``MAX_PLAIN_SCORES`` f32 scores exist at a time
    (the unchunked ``(64, 4096, 4096)`` scores of a bs-4 SAM-1024 global
    layer would take 4.3 GB)."""
    G, S, hd = q.shape
    scale = 1.0 / math.sqrt(hd)
    coords = rel_pos_coords(side, q.device)
    rh = rel_pos_h[coords].float()
    rw = rel_pos_w[coords].float()
    kf = k.float()
    rows = max(1, min(S, MAX_PLAIN_SCORES // (G * S)))
    outs = []
    for r0 in range(0, S, rows):
        qc = q[:, r0:r0 + rows].float()
        n = qc.shape[1]
        t = torch.arange(r0, r0 + n, device=q.device)
        logits = (qc @ kf.transpose(1, 2)) * scale
        bias_h = torch.einsum("gtd,tkd->gtk", qc, rh[t // side])
        bias_w = torch.einsum("gtd,tkd->gtk", qc, rw[t % side])
        logits = (logits.reshape(G, n, side, side) + bias_h[..., :, None]
                  + bias_w[..., None, :]).reshape(G, n, S)
        probs = torch.softmax(logits, dim=-1).to(q.dtype)
        outs.append(probs @ v)
    return torch.cat(outs, dim=1)


def _launch(name, q, k, v, rel_pos_h, rel_pos_w, side: int):
    """Prepare the operands as the JAX wrappers do and launch
    csrc/relpos_attention.cu over ``(G, S, 64)`` heads or ``(NW, nh, S,
    64)`` strided views; the output has q's shape, in memory ``(G, S, 64)``
    or ``(NW, S, nh, 64)``."""
    S, hd = q.shape[-2:]
    if (S != side * side or k.shape != q.shape or v.shape != q.shape
            or q.dim() not in (3, 4)):
        raise ValueError(f"{name}: q {tuple(q.shape)} k {tuple(k.shape)} v "
                         f"{tuple(v.shape)} side {side}")
    if hd != HEAD_DIM:
        raise ValueError(f"{name}: kernel built for head_dim {HEAD_DIM}, "
                         f"got {hd}")
    G = math.prod(q.shape[:-2])
    nh = 1 if q.dim() == 3 else q.shape[1]
    qs = (q.float() * (LOG2E / math.sqrt(hd))).to(q.dtype).reshape(
        G, S, hd).contiguous()
    bias = global_bias_rows(q.reshape(G, S, hd), rel_pos_h, rel_pos_w, side)
    if q.dim() == 3:
        k, v = k.contiguous(), v.contiguous()
        out = torch.empty_like(qs)
        out_view, out_strides = out, (S * hd, 0, hd)
    else:
        out = torch.empty((q.shape[0], S, nh, hd), dtype=q.dtype,
                          device=q.device)
        out_view, out_strides = out.transpose(1, 2), (S * nh * hd, hd, nh * hd)
    _cuda.check_cuda(name, qs, bias, out)
    # (s_b, s_h, s_t) of k and v, read in place
    strides = k.stride()[:3] if k.dim() == 4 else (k.stride(0), 0,
                                                   k.stride(1))
    for t in (k, v):
        if (t.dtype != torch.bfloat16 or not t.is_cuda or t.stride() !=
                k.stride() or t.stride(-1) != 1 or any(s % 8 for s in strides)
                or t.data_ptr() % 16):
            raise ValueError(
                f"{name}: k and v must be bf16 CUDA tensors with one set of "
                "strides, a contiguous last dim, strides that are multiples "
                f"of 8 and 16-byte alignment; got {t.dtype}, strides "
                f"{t.stride()}")
    relpos_attention(qs, (S * nh * hd, S * hd, hd), k, v, strides, nh, bias,
                     side, G, S, out, out_strides)
    return out_view


def sam_global_attention_v8(q, k, v, rel_pos_h, rel_pos_w, side: int):
    """Global ViTDet attention over ``(G, S, hd)`` heads (K2); keys at or
    beyond ``S = side**2`` are masked in-kernel for any grid side."""
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


def relpos_attention(q, q_strides, k, v, strides, nh, bias, side, G, S, out,
                     out_strides) -> None:
    """Launch csrc/relpos_attention.cu; element ``(g, t, d)`` of k and v is
    at ``(g // nh) * strides[0] + (g % nh) * strides[1] + t * strides[2] +
    d`` from each pointer, of q likewise with ``q_strides``.  Uncounted: the
    K1, K2 and K6 wrappers count."""
    _cuda.launch(
        "flmm_relpos_attention", q.data_ptr(), *q_strides, k.data_ptr(),
        v.data_ptr(), *strides, nh, bias.data_ptr(), side, G, S, HEAD_DIM,
        out.data_ptr(), *out_strides, _cuda.stream(q))


def plain_flash_attention_plain(q, k, v):
    """K7's plain version: ``softmax(q k^T / sqrt(hd)) v`` over ``(..., S,
    hd)``; q is scaled in f32 and rounded to its dtype before the product,
    as the JAX wrapper does, scores and softmax are f32."""
    qs = (q.float() * (1.0 / math.sqrt(q.shape[-1]))).to(q.dtype)
    logits = qs.float() @ k.float().transpose(-1, -2)
    return torch.softmax(logits, dim=-1).to(q.dtype) @ v


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
