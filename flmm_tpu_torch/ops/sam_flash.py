"""K2: global ViTDet attention with decomposed relative-position bias
(flmm_tpu/ops/sam_flash.py::sam_global_attention_v8).

The wrapper prepares the thin operands outside the kernel as the JAX
package does (``_global_augmented_operands``): q scaled by
``scale * log2(e)`` and the bias rows ``(G, S, 2*side)`` in the log2 domain,
both rounded to the working dtype.  The kernel (csrc/relpos_attention.cu)
adds the bias in its score loop and never writes the ``(G, S, S)`` scores.
"""

from __future__ import annotations

import math

import torch

from flmm_tpu_torch.ops import _cuda

LOG2E = 1.4426950408889634
LN2 = 0.6931471805599453
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
    """Natural-base attention with decomposed rel-pos bias over ``(G, S,
    hd)``; query rows are chunked so at most ``MAX_PLAIN_SCORES`` f32 scores
    exist at a time (the unchunked ``(64, 4096, 4096)`` scores of a bs-4
    SAM-1024 global layer would take 4.3 GB)."""
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


def sam_global_attention_v8(q, k, v, rel_pos_h, rel_pos_w, side: int):
    """Global ViTDet attention over ``(G, S, hd)`` heads (K2); keys at or
    beyond ``S = side**2`` are masked in-kernel for any grid side."""
    if not q.is_cuda:
        return sam_global_attention_v8_plain(q, k, v, rel_pos_h, rel_pos_w,
                                             side)
    G, S, hd = q.shape
    if S != side * side or k.shape != q.shape or v.shape != q.shape:
        raise ValueError(f"sam_global_attention_v8: q {tuple(q.shape)} k "
                         f"{tuple(k.shape)} v {tuple(v.shape)} side {side}")
    if hd != 64:
        raise ValueError(f"sam_global_attention_v8: kernel built for "
                         f"head_dim 64, got {hd}")
    qs = (q.float() * (LOG2E / math.sqrt(hd))).to(q.dtype)
    bias = global_bias_rows(q, rel_pos_h, rel_pos_w, side)
    k, v = k.contiguous(), v.contiguous()
    out = torch.empty_like(qs)
    _cuda.check_cuda("sam_global_attention_v8", qs, k, v, bias, out)
    relpos_attention(qs, k, v, (S * hd, 0, hd), 1, bias, side, G, S, out,
                     (S * hd, 0, hd))
    sam_global_attention_v8.launches += 1
    return out


sam_global_attention_v8.launches = 0


def relpos_attention(q, k, v, strides, nh, bias, side, G, S, out,
                     out_strides) -> None:
    """Launch csrc/relpos_attention.cu; element ``(g, t, d)`` of q/k/v is at
    ``(g // nh) * strides[0] + (g % nh) * strides[1] + t * strides[2] + d``
    from each pointer.  Uncounted: the K1 and K2 wrappers count."""
    _cuda.launch(
        "flmm_relpos_attention", q.data_ptr(), k.data_ptr(), v.data_ptr(),
        *strides, nh, bias.data_ptr(), side, G, S, 64, out.data_ptr(),
        *out_strides, _cuda.stream(q))
