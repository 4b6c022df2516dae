"""K12: the bake-off variants of the SAM attention kernels
(flmm_tpu/ops/sam_flash_experiments.py).  Ported so far: the spatial
head-major window attention ``sam_window_attention_v10`` (the pallas_call at
:1222) with ``qkv_head_major_perm``; seven global variants with K2's
contract ``(q, k, v, rel_pos_h, rel_pos_w, side) -> out`` over ``(G, S =
side**2, 64)`` heads: ``sam_global_attention`` (v1, :1107), ``_v2`` (:781),
``_v3`` (:1046), ``_v4`` (:859), ``_v6`` (:942), ``_v7`` (:981) and ``_v11``
(:1309); and eight window variants with K6's contract over ``(G, T =
side**2, 64)`` window-heads or ``(NW, nh, T, 64)`` strided views of a
windowised qkv tensor: ``sam_window_attention`` (v1, :695), ``_v2`` (:422),
``_v3`` (:640), ``_v4`` and ``_v5`` (one pallas_call at :545), ``_v6``
(:185), ``_v7`` (:270) and ``_v8`` (:346).

v10 takes the qkv tensor as the projection leaves it, spatial ``(B, Hp, Wp,
nh * 3 * hd)`` with the columns permuted head-major ``[q_h | k_h | v_h]``,
and returns the attention output spatially ``(B, Hp, Wp, nh * hd)``: the
window partition and the head split are the addressing of a 3D tensor map
inside the kernel (csrc/window_attention_sm90.cu), so nothing is windowised
or transposed outside.  Keys at or beyond ``grid_hw`` are masked out of the
softmax (unlike K1 and K6, where pad tokens stay in it).  The JAX kernel
leaves the output beyond ``grid_hw`` unspecified; here it is 0, on both the
kernel and the plain path.  The JAX wrapper makes the thin bias rows
outside; the kernel forms them from the tables.

The global variants differ from K2 (``sam_flash.sam_global_attention_v8``)
as functions only in the domain of the operands their wrappers round to the
working dtype and in the softmax: v3 and v6 (one function; ``block_q`` and
``chunks`` only order the TPU's work) scale q by ``scale`` alone, keep the
bias rows in natural base and take ``exp(s - max)``; v7 has K2's log2-domain
operands and ``exp2(s - max)``; v11 has them too and takes ``exp2(s)`` with
no max, so it needs every log2-domain score below 128 (about 88 nats) and
gives a non-finite row otherwise, as on the TPU.  v1 leaves q unscaled,
multiplies the f32 scores by ``scale`` and adds bias rows rounded to bf16
whatever q's dtype, ``(s + bias_h) + bias_w`` (the TPU kernel streams key
tiles with a running max: the same function up to summation order).  v2 is
v3 with the bias rows rounded to bf16 and not to q's dtype: one function on
the card, another for the f32 inputs of the CPU tests.  v4 has v3's operands
and rounds every score to bf16, takes the max and ``exp`` in bf16 and divides
by the f32 sum of the bf16-rounded ``p`` (on the TPU a ones-column of v): by
its contract the softmax weights carry about 0.4% of rounding.  Each wrapper
mirrors the shape preconditions of its JAX function (the query and key tiles
of v1 refuse SAM-768's 2304 tokens, the query tile of v2 takes them).  All
seven launch K2's wgmma + TMA core, csrc/relpos_attention_sm90.cu, in the
matching ``SOFTMAX_*`` mode: it reads q, k and v in place and the two rel-pos
tables, stages the bias rows from the tables rounded as each JAX wrapper
rounds them (:func:`global_table_bias` is the plain twin) and puts the q
scaling on the f32 scores, so the wrappers run no pass over q and make no
bias rows; like K2 they take grid sides 1 to ``sam_flash.MAX_TABLE_SIDE``.

The window variants take a one-shot natural-base softmax over a window's T
keys and differ as functions only in where the operands are rounded: v1 and
v6 leave q unscaled, multiply the f32 scores by ``scale`` and add bias rows
rounded to bf16 whatever q's dtype is (v1 adds ``bias_h`` then ``bias_w`` to
the scores, v6 adds the two to each other first: another order of two f32
additions); v7 and v8 (one function: v8 adds the selection columns to the
keys outside its TPU kernel, v7 inside) scale q in f32, round it and the bias
rows to q's dtype and take the scores out of one f32 sum; v2 scales and
rounds q likewise and adds a dense bias, ``bias_h + bias_w`` summed in f32
and rounded to bf16 once, ``(G, tp, tp)`` with ``tp`` = T rounded up to 16 and
-1e30 in the pad rows and columns (:func:`window_dense_bias`).  v3, v4 and v5
share one operand builder on the TPU, ``a = [q * scale | bias_h | bias_w |
1]`` against ``b = [k^T ; sel_h ; sel_w ; pad row]``: v7's operands, the
bias inside the f32 accumulation, and a penalty on the ``tp - T`` pad keys
through the ones column (-1e30 for v3, -1e4 rounded to q's dtype for v4 and
v5).  v3 is v7's function; v4 rounds every score to bf16, takes the max and
``exp`` in bf16 and divides by the f32 sum of the rounded ``p``; v5 keeps
f32 scores and ``exp`` but divides by the f32 sum of ``p`` rounded to v's
dtype.  All eight, and v10, launch csrc/window_attention_sm90.cu, a wgmma +
TMA core that reads q, k and v in place and the two rel-pos tables, forms
the bias rows itself from the tables (:func:`window_table_bias` is the plain
twin of what it stages) and folds the q scaling into the f32 scores (at
head_dim 64, ``scale`` = 2^-3 and ``bf16(q * scale) = q * scale``): the
wrappers run no pass over q, and v2's dense ``(G, tp, tp)`` tensor exists on
the plain path only.  v1 and v6 pass its ``SCALE_AFTER`` mode, v7, v8 and
v3 ``SCALED_Q`` (one function with it), v4 ``SCALED_Q_BF16``, v5
``SCALED_Q_ROUNDED_P``, v2 ``DENSE_BIAS``.
"""

from __future__ import annotations

import math

import torch

from flmm_tpu_torch.ops import _cuda, sam_flash
from flmm_tpu_torch.ops._matmul import matmul_f32
from flmm_tpu_torch.ops.sam_flash import HEAD_DIM, LOG2E, \
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


def spatial_heads(qkv, side: int, nh: int, hd: int) -> torch.Tensor:
    """The window partition and head split of the head-major spatial qkv as
    copies: ``(3, B * nwy * nwx * nh, T, hd)``, q, k and v of window-head
    ``((b * nwy + wy) * nwx + wx) * nh + h``, token ``t = y * side + x``."""
    B, Hp, Wp, _ = qkv.shape
    x = qkv.reshape(B, Hp // side, side, Wp // side, side, nh, 3, hd)
    return x.permute(6, 0, 1, 3, 5, 2, 4, 7).reshape(3, -1, side * side, hd)


def sam_window_attention_v10_plain(qkv, rel_pos_h, rel_pos_w, side: int,
                                   grid_hw: int):
    """K12 v10's plain version: window partition and head split as copies,
    then the plain rel-pos attention with the keys beyond ``grid_hw`` masked
    (on a grid without pad this is K6's plain route), the output back in
    place and 0 beyond ``grid_hw``."""
    B, Hp, Wp, nh, hd = _geometry("sam_window_attention_v10_plain", qkv,
                                  rel_pos_h, side, grid_hw)
    nwy, nwx, T = Hp // side, Wp // side, side * side
    x = spatial_heads(qkv, side, nh, hd)
    valid = _grid_valid(Hp, Wp, grid_hw, qkv.device)
    key_valid = valid.reshape(nwy, side, nwx, side).permute(0, 2, 1, 3)
    key_valid = key_valid.reshape(1, nwy, nwx, 1, T).expand(
        B, nwy, nwx, nh, T).reshape(-1, T)
    out = sam_global_attention_v8_plain(x[0], x[1], x[2], rel_pos_h,
                                        rel_pos_w, side, key_valid=key_valid)
    out = out.reshape(B, nwy, nwx, nh, side, side, hd)
    out = out.permute(0, 1, 4, 2, 5, 3, 6).reshape(B, Hp, Wp, nh * hd)
    return torch.where(valid[None, :, :, None], out, 0.0)


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
    tables = sam_flash.kernel_tables(name, rel_pos_h, rel_pos_w, side,
                                     MAX_WINDOW_SIDE)
    out = torch.empty((B, Hp, Wp, nh * hd), dtype=qkv.dtype,
                      device=qkv.device)
    # contiguous and 16-byte aligned, as the 3D tensor map reads it
    _cuda.check_cuda(name, qkv, out, *tables)
    spatial_window_attention_sm90(qkv, tables, side, grid_hw, out)
    sam_window_attention_v10.launches += 1
    return out


def spatial_window_attention_sm90(qkv, tables, side: int, grid_hw: int,
                                  out) -> None:
    """Launch csrc/window_attention_sm90.cu's ``SPATIAL_LOG2`` mode over the
    contiguous head-major ``(B, Hp, Wp, nh * 192)`` qkv into ``(B, Hp, Wp,
    nh * 64)`` ``out``; ``tables`` as :func:`sam_flash.kernel_tables` gives
    them.  Uncounted: the wrapper counts."""
    B, Hp, Wp, C3 = qkv.shape
    _cuda.launch("flmm_spatial_window_attention_sm90", qkv.data_ptr(),
                 tables[0].data_ptr(), tables[1].data_ptr(), B, Hp, Wp,
                 C3 // (3 * HEAD_DIM), side, grid_hw,
                 LOG2E / math.sqrt(HEAD_DIM), out.data_ptr(),
                 _cuda.stream(qkv))


sam_window_attention_v10.launches = 0


def _needs_aligned(S: int, side: int):
    """v3, v4, v6, v7: the TPU query tiling needs ``S % 8 == 0``."""
    return None if S % 8 == 0 else "S % 8 == 0"


def _needs_v1_tiles(S: int, side: int):
    """v1: query tiles of ``min(512, S)`` and key tiles of ``min(1024, S)``
    divide S, and a key tile holds whole grid rows."""
    bq, bk = min(512, S), min(1024, S)
    if S % bq == 0 and S % bk == 0 and bk % side == 0:
        return None
    return ("S a multiple of min(512, S) and of min(1024, S), the key tile "
            "a multiple of side")


def _needs_v2_tiles(S: int, side: int):
    """v2: query tiles of ``min(256, S)`` divide S."""
    return None if S % min(256, S) == 0 else "S a multiple of min(256, S)"


# variant -> (SOFTMAX_* code, dtype of the bias rows (None: q's), the JAX
# function's shape precondition (None: v11 pads and masks))
GLOBAL_VARIANTS = {
    "v1": (sam_flash.SOFTMAX_NATURAL_SCALE_AFTER, torch.bfloat16,
           _needs_v1_tiles),
    "v2": (sam_flash.SOFTMAX_NATURAL, torch.bfloat16, _needs_v2_tiles),
    "v3": (sam_flash.SOFTMAX_NATURAL, None, _needs_aligned),
    "v4": (sam_flash.SOFTMAX_NATURAL_BF16, None, _needs_aligned),
    "v6": (sam_flash.SOFTMAX_NATURAL, None, _needs_aligned),
    "v7": (sam_flash.SOFTMAX_LOG2, None, _needs_aligned),
    "v11": (sam_flash.SOFTMAX_LOG2_NO_MAX, None, None),
}


def _global_variant_plain(q, k, v, rel_pos_h, rel_pos_w, side: int,
                          variant: str):
    """The function of a global variant with the roundings of its JAX
    wrapper and kernel: q scaled in f32 and rounded to its dtype (v1: left
    unscaled, the f32 scores times ``scale``), the bias rows rounded to q's
    dtype or to bf16 (natural base or log2 domain), f32 scores, ``p`` as the
    variant's softmax says, rounded to v's dtype before the value product,
    the f32 sum of the unrounded ``p`` clamped at 1e-30 as denominator.  v4:
    the scores rounded to bf16, ``p = exp(s - max)`` in bf16 arithmetic, the
    f32 sum of the rounded ``p`` as denominator.  Query rows are chunked
    under ``sam_flash.MAX_PLAIN_SCORES``."""
    softmax, bias_dtype, _ = GLOBAL_VARIANTS[variant]
    G, S, hd = q.shape
    scale = 1.0 / math.sqrt(hd)
    log2_domain = softmax in sam_flash.LOG2_DOMAIN
    scale_after = softmax == sam_flash.SOFTMAX_NATURAL_SCALE_AFTER
    mult = LOG2E if log2_domain else 1.0
    qs = q if scale_after else (q.float() * (mult * scale)).to(q.dtype)
    bias = sam_flash.global_bias_rows(q, rel_pos_h, rel_pos_w, side,
                                      log2_domain, bias_dtype)
    kt = k.transpose(1, 2)
    rows = max(1, min(S, sam_flash.MAX_PLAIN_SCORES // (G * S)))
    outs = []
    for r0 in range(0, S, rows):
        b = bias[:, r0:r0 + rows].float()
        n = b.shape[1]
        s = matmul_f32(qs[:, r0:r0 + rows], kt).reshape(G, n, side, side)
        bh, bw = b[..., :side, None], b[..., None, side:]
        s = ((s * scale + bh) + bw if scale_after
             else s + bh + bw).reshape(G, n, S)
        if softmax == sam_flash.SOFTMAX_NATURAL_BF16:
            s = s.bfloat16()
            p = torch.exp(s - s.amax(dim=-1, keepdim=True)).float()
        else:
            if softmax != sam_flash.SOFTMAX_LOG2_NO_MAX:
                s = s - s.amax(dim=-1, keepdim=True)
            p = torch.exp2(s) if log2_domain else torch.exp(s)
        denom = p.sum(dim=-1, keepdim=True).clamp_min(1e-30)
        outs.append((matmul_f32(p.to(v.dtype), v) / denom).to(q.dtype))
    return torch.cat(outs, dim=1)


def global_table_bias(q, rel_pos_h, rel_pos_w, side: int,
                      variant: str) -> torch.Tensor:
    """The plain twin of the bias rows csrc/relpos_attention_sm90.cu stages
    for a global variant over ``(G, S, hd)`` heads, ``(G, S, 2 * side)`` in
    f32: the table product of the unscaled q gathered at ``y - k + side -
    1`` (:func:`sam_flash.table_bias_rows`), rounded to bf16 in natural base
    (v1, v2, v3, v4, v6) or in the log2 domain (v11), as each JAX wrapper
    rounds the rows it hands its ``pallas_call``; v7's are K2's f32
    log2-domain rows."""
    softmax = GLOBAL_VARIANTS[variant][0]
    rows = sam_flash.table_bias_rows(
        q, rel_pos_h, rel_pos_w, side,
        log2_domain=softmax in sam_flash.LOG2_DOMAIN)
    if softmax == sam_flash.SOFTMAX_LOG2:
        return rows
    return rows.bfloat16().float()


def _global_variant(variant, q, k, v, rel_pos_h, rel_pos_w, side: int,
                    wrapper):
    """Shared body of the seven wrappers: no grad, the JAX contract on the
    shape, the plain version on CPU tensors, then the kernel."""
    name = wrapper.__name__
    softmax, _, needs = GLOBAL_VARIANTS[variant]
    _cuda.check_no_grad(name, q, k, v, rel_pos_h, rel_pos_w)
    shaped = (q.dim() == 3 and q.shape[1] == side * side
              and k.shape == q.shape and v.shape == q.shape)
    unmet = needs(q.shape[1], side) if shaped and needs else None
    if not shaped or unmet:
        raise ValueError(
            f"{name}: q {tuple(q.shape)} k {tuple(k.shape)} v "
            f"{tuple(v.shape)} side {side}: needs (G, S, hd) heads with S = "
            "side**2" + (f" and {unmet}" if unmet else ""))
    if not q.is_cuda:
        return _global_variant_plain(q, k, v, rel_pos_h, rel_pos_w, side,
                                     variant)
    out = sam_flash._launch(name, q, k, v, rel_pos_h, rel_pos_w, side,
                            softmax)
    wrapper.launches += 1
    return out


def sam_global_attention_plain(q, k, v, rel_pos_h, rel_pos_w, side: int):
    """Global v1's plain version: ``scale`` on the f32 scores of the unscaled
    q, bf16 bias rows added one after the other, ``exp(s - max)``."""
    return _global_variant_plain(q, k, v, rel_pos_h, rel_pos_w, side, "v1")


def sam_global_attention(q, k, v, rel_pos_h, rel_pos_w, side: int):
    """Global ViTDet attention, v1: q unscaled, ``scale`` on the f32 scores,
    the two bias rows rounded to bf16; S must tile as the TPU kernel's query
    and key tiles do."""
    return _global_variant("v1", q, k, v, rel_pos_h, rel_pos_w, side,
                           sam_global_attention)


sam_global_attention.launches = 0


def sam_global_attention_v2_plain(q, k, v, rel_pos_h, rel_pos_w, side: int):
    """Global v2's plain version: v3 with the bias rows rounded to bf16."""
    return _global_variant_plain(q, k, v, rel_pos_h, rel_pos_w, side, "v2")


def sam_global_attention_v2(q, k, v, rel_pos_h, rel_pos_w, side: int):
    """Global ViTDet attention, v2: q scaled and rounded, the bias rows
    rounded to bf16, one-shot natural-base softmax; on bf16 inputs v3's
    function, through v3's kernel instantiation."""
    return _global_variant("v2", q, k, v, rel_pos_h, rel_pos_w, side,
                           sam_global_attention_v2)


sam_global_attention_v2.launches = 0


def sam_global_attention_v3_plain(q, k, v, rel_pos_h, rel_pos_w, side: int):
    """Global v3's plain version: natural-base operands, ``exp(s - max)``."""
    return _global_variant_plain(q, k, v, rel_pos_h, rel_pos_w, side, "v3")


def sam_global_attention_v3(q, k, v, rel_pos_h, rel_pos_w, side: int):
    """Global ViTDet attention, v3: q scaled by ``scale`` and the bias rows
    in natural base, both rounded to the working dtype; full-row softmax."""
    return _global_variant("v3", q, k, v, rel_pos_h, rel_pos_w, side,
                           sam_global_attention_v3)


sam_global_attention_v3.launches = 0


def sam_global_attention_v4_plain(q, k, v, rel_pos_h, rel_pos_w, side: int):
    """Global v4's plain version: v3's operands, the scores rounded to bf16,
    max and ``exp`` in bf16, the f32 sum of the rounded ``p`` below."""
    return _global_variant_plain(q, k, v, rel_pos_h, rel_pos_w, side, "v4")


def sam_global_attention_v4(q, k, v, rel_pos_h, rel_pos_w, side: int):
    """Global ViTDet attention, v4: v3 with bf16 scores, a bf16 ``exp`` and
    the denominator summed from the rounded probabilities; the softmax
    weights carry about 0.4% of rounding by contract."""
    return _global_variant("v4", q, k, v, rel_pos_h, rel_pos_w, side,
                           sam_global_attention_v4)


sam_global_attention_v4.launches = 0


def sam_global_attention_v6_plain(q, k, v, rel_pos_h, rel_pos_w, side: int):
    """Global v6's plain version: v3's function."""
    return _global_variant_plain(q, k, v, rel_pos_h, rel_pos_w, side, "v6")


def sam_global_attention_v6(q, k, v, rel_pos_h, rel_pos_w, side: int):
    """Global ViTDet attention, v6: v3's function (the TPU kernel chunks the
    query tile, which only orders its work); one Hopper kernel serves both
    names."""
    return _global_variant("v6", q, k, v, rel_pos_h, rel_pos_w, side,
                           sam_global_attention_v6)


sam_global_attention_v6.launches = 0


def sam_global_attention_v7_plain(q, k, v, rel_pos_h, rel_pos_w, side: int):
    """Global v7's plain version: log2-domain operands, ``exp2(s - max)``."""
    return _global_variant_plain(q, k, v, rel_pos_h, rel_pos_w, side, "v7")


def sam_global_attention_v7(q, k, v, rel_pos_h, rel_pos_w, side: int):
    """Global ViTDet attention, v7: v3 with the operands pre-multiplied by
    log2(e) and a base-2 softmax; K2's function where ``S % 8 == 0``, through
    K2's kernel instantiation."""
    return _global_variant("v7", q, k, v, rel_pos_h, rel_pos_w, side,
                           sam_global_attention_v7)


sam_global_attention_v7.launches = 0


def sam_global_attention_v11_plain(q, k, v, rel_pos_h, rel_pos_w, side: int):
    """Global v11's plain version: log2-domain operands, ``exp2(s)`` with no
    max; a row holding a score of 128 or more comes out non-finite."""
    return _global_variant_plain(q, k, v, rel_pos_h, rel_pos_w, side, "v11")


def sam_global_attention_v11(q, k, v, rel_pos_h, rel_pos_w, side: int):
    """Global ViTDet attention, v11: K2 without the max subtraction, for any
    grid side (keys at or beyond S are masked in-kernel).  Precondition:
    every log2-domain score below 128, i.e. every attention logit below
    about 88 nats; beyond it the row is not finite."""
    return _global_variant("v11", q, k, v, rel_pos_h, rel_pos_w, side,
                           sam_global_attention_v11)


sam_global_attention_v11.launches = 0


# what the variants' functions do between their two products: the f32
# scores of the unscaled q times ``scale`` (window v1 / v6), the scores of a q
# that was scaled and rounded (window v7 / v8 / v3), both plus the two thin
# bias rows; or the scores of such a q plus a dense ``(tp, tp)`` bias (window
# v2); or v7's scores rounded to bf16 with a bf16 softmax (v4), or with the
# probabilities rounded before the denominator sums them (v5).  The codes are
# csrc/window_attention_sm90.cu's ``MODE``s (v10's, 5, has an entry point of
# its own)
(WINDOW_SCALE_AFTER, WINDOW_SCALED_Q, WINDOW_DENSE_BIAS, WINDOW_SCALED_Q_BF16,
 WINDOW_SCALED_Q_ROUNDED_P) = range(5)
WINDOW_MODES = {"v1": WINDOW_SCALE_AFTER, "v6": WINDOW_SCALE_AFTER,
                "v7": WINDOW_SCALED_Q, "v8": WINDOW_SCALED_Q,
                "v3": WINDOW_SCALED_Q, "v2": WINDOW_DENSE_BIAS,
                "v4": WINDOW_SCALED_Q_BF16, "v5": WINDOW_SCALED_Q_ROUNDED_P}
# the window core holds a row of 208 key columns in registers (13 k16 steps)
MAX_WINDOW_TOKENS = 208
MAX_WINDOW_SIDE = 14
DENSE_BIAS_PAD = -1e30  # v2's pad rows and columns, as in the JAX wrapper
# the augmented-operand variants: the score of a pad key (T <= key < tp),
# rounded to q's dtype, as their JAX wrapper builds it
AUGMENTED_PAD = {"v3": -1e30, "v4": -1e4, "v5": -1e4}


def window_dense_bias(q, rel_pos_h, rel_pos_w, side: int) -> torch.Tensor:
    """Window v2's bias: ``bias_h + bias_w`` of the unscaled q summed in f32
    and rounded to bf16 once, dense ``(G, tp, tp)`` over ``(G, T, hd)``
    heads with ``tp`` = T rounded up to 16 and ``DENSE_BIAS_PAD`` in the pad
    rows and columns.  One pass writes the sum into place (``torch.add``
    computes in f32 and rounds into its bf16 ``out``), so no f32 ``(G, T,
    T)`` tensor exists."""
    G, T, _ = q.shape
    tp = -(-T // 16) * 16
    rows = sam_flash.global_bias_rows(q, rel_pos_h, rel_pos_w, side,
                                      log2_domain=False, dtype=torch.float32)
    dense = torch.empty((G, tp, tp), dtype=torch.bfloat16, device=q.device)
    dense[:, T:] = DENSE_BIAS_PAD
    dense[:, :T, T:] = DENSE_BIAS_PAD
    torch.add(rows[..., :side, None], rows[..., None, side:],
              out=dense[:, :T, :T].unflatten(-1, (side, side)))
    return dense


def window_table_bias(q, rel_pos_h, rel_pos_w, side: int,
                      variant: str) -> torch.Tensor:
    """The plain twin of the bias csrc/window_attention_sm90.cu stages for
    ``(G, T, hd)`` window-heads: the table product of the unscaled q
    gathered at ``y - k + side - 1`` (:func:`sam_flash.table_bias_rows`),
    then rounded as the variant's kernel mode does, all as f32: the
    natural-base rows ``(G, T, 2 * side)`` rounded to bf16 (v1, v6, v7, v8,
    v3, v4, v5); v2's ``(G, T, T)`` per-score ``bf16(bias_h + bias_w)`` of
    the f32 rows; v10's log2-domain rows rounded to bf16."""
    rows = sam_flash.table_bias_rows(q, rel_pos_h, rel_pos_w, side,
                                     log2_domain=variant == "v10")
    if variant != "v2":
        return rows.bfloat16().float()
    G, T, _ = rows.shape
    dense = rows[..., :side, None] + rows[..., None, side:]
    return dense.reshape(G, T, T).bfloat16().float()


def _window_variant_plain(q, k, v, rel_pos_h, rel_pos_w, side: int,
                          variant: str):
    """The function of a window variant with the roundings of its JAX
    wrapper and kernel, over ``(G, T, hd)`` or ``(NW, nh, T, hd)``.  v1 / v6:
    f32 scores of the unscaled q times ``scale``, plus bias rows rounded to
    bf16 whatever q's dtype (v1 ``(s + bias_h) + bias_w``, v6 ``s + (bias_h
    + bias_w)``).  v7 / v8 / v3 / v4 / v5: q scaled in f32 and rounded to its
    dtype, the bias rows rounded to it too.  v2: q scaled and rounded
    likewise, plus the dense bf16 bias of :func:`window_dense_bias`.  Then
    ``p = exp(s - max)``, rounded to v's dtype before the value product,
    over the f32 sum of the unrounded ``p`` clamped at 1e-30.  v3 / v4 / v5
    also score the ``tp - T`` pad keys of their JAX wrapper, at
    :data:`AUGMENTED_PAD`, against zero rows of v; v4 rounds the scores to
    bf16 and takes ``s - max`` and ``exp`` in bf16, v5 rounds ``p`` to v's
    dtype, and both sum the rounded ``p`` as the denominator.  Window-heads
    are chunked under ``sam_flash.MAX_PLAIN_SCORES``."""
    T, hd = q.shape[-2:]
    shape = q.shape
    q, k, v = (t.reshape(-1, T, hd) for t in (q, k, v))
    G = q.shape[0]
    scale = 1.0 / math.sqrt(hd)
    mode = WINDOW_MODES[variant]
    heads = max(1, sam_flash.MAX_PLAIN_SCORES // (T * T))
    outs = []
    for g0 in range(0, G, heads):
        qc, kc, vc = (t[g0:g0 + heads] for t in (q, k, v))
        n = qc.shape[0]
        qs = (qc if mode == WINDOW_SCALE_AFTER
              else (qc.float() * scale).to(qc.dtype))
        s = matmul_f32(qs, kc.transpose(1, 2))
        if mode == WINDOW_DENSE_BIAS:
            dense = window_dense_bias(qc, rel_pos_h, rel_pos_w, side)
            s = s + dense[:, :T, :T].float()
        else:
            bias = sam_flash.global_bias_rows(
                qc, rel_pos_h, rel_pos_w, side, log2_domain=False,
                dtype=(torch.bfloat16 if mode == WINDOW_SCALE_AFTER
                       else None)).float()
            bh, bw = bias[..., :side, None], bias[..., None, side:]
            s = s.reshape(n, T, side, side)
            if mode == WINDOW_SCALE_AFTER:
                s = s * scale
                s = (s + bh) + bw if variant == "v1" else s + (bh + bw)
            else:
                s = s + bh + bw
        s = s.reshape(n, T, T)
        if variant in AUGMENTED_PAD:
            tp = -(-T // 16) * 16
            pen = torch.tensor(AUGMENTED_PAD[variant], dtype=qc.dtype,
                               device=qc.device).float()
            s = torch.cat([s, pen.expand(n, T, tp - T)], dim=-1)
            vc = torch.cat([vc, vc.new_zeros(n, tp - T, hd)], dim=1)
        if mode == WINDOW_SCALED_Q_BF16:
            s = s.bfloat16()
            p = torch.exp(s - s.amax(dim=-1, keepdim=True)).float()
        else:
            p = torch.exp(s - s.amax(dim=-1, keepdim=True))
            if mode == WINDOW_SCALED_Q_ROUNDED_P:
                p = p.to(vc.dtype).float()
        denom = p.sum(dim=-1, keepdim=True).clamp_min(1e-30)
        outs.append((matmul_f32(p.to(vc.dtype), vc) / denom).to(qc.dtype))
    return torch.cat(outs).reshape(shape)


def _window_variant(variant, q, k, v, rel_pos_h, rel_pos_w, side: int,
                    wrapper):
    """Shared body of the eight wrappers: no grad, the JAX contract on the
    shape, the plain version on CPU tensors, then the kernel over ``(G, T,
    64)`` heads or ``(NW, nh, T, 64)`` strided views read in place; the
    output has q's shape, in memory ``(G, T, 64)`` or ``(NW, T, nh, 64)``."""
    name = wrapper.__name__
    _cuda.check_no_grad(name, q, k, v, rel_pos_h, rel_pos_w)
    if (q.dim() not in (3, 4) or q.shape[-2] != side * side
            or k.shape != q.shape or v.shape != q.shape):
        raise ValueError(
            f"{name}: q {tuple(q.shape)} k {tuple(k.shape)} v "
            f"{tuple(v.shape)} side {side}: needs (G, T, hd) heads or (NW, "
            "nh, T, hd) views with T = side**2")
    if not q.is_cuda:
        return _window_variant_plain(q, k, v, rel_pos_h, rel_pos_w, side,
                                     variant)
    T, hd = q.shape[-2:]
    if hd != HEAD_DIM or T > MAX_WINDOW_TOKENS:
        raise ValueError(f"{name}: kernel built for head_dim {HEAD_DIM} and "
                         f"at most {MAX_WINDOW_TOKENS} tokens a window, got "
                         f"head_dim {hd} and {T} tokens")
    G = math.prod(q.shape[:-2])
    nh = 1 if q.dim() == 3 else q.shape[1]
    tables = sam_flash.kernel_tables(name, rel_pos_h, rel_pos_w, side,
                                     MAX_WINDOW_SIDE)
    if q.dim() == 3:
        q, k, v = q.contiguous(), k.contiguous(), v.contiguous()
        out = torch.empty((G, T, hd), dtype=q.dtype, device=q.device)
        out_view, out_strides = out, (T * hd, 0, hd)
    else:
        out = torch.empty((q.shape[0], T, nh, hd), dtype=q.dtype,
                          device=q.device)
        out_view, out_strides = out.transpose(1, 2), (T * nh * hd, hd, nh * hd)
    _cuda.check_cuda(name, out, *tables)

    strides = sam_flash._head_strides(name, k)
    if sam_flash._head_strides(name, v) != strides:
        raise ValueError(f"{name}: k and v differ in strides: {k.stride()} "
                         f"{v.stride()}")
    window_attention_sm90(q, sam_flash._head_strides(name, q), k, v, strides,
                          nh, tables, side, G, T, WINDOW_MODES[variant], out,
                          out_strides)
    wrapper.launches += 1
    return out_view


def window_attention_sm90(q, q_strides, k, v, strides, nh, tables,
                          side: int, G: int, T: int, mode: int, out,
                          out_strides) -> None:
    """Launch csrc/window_attention_sm90.cu in one of the ``WINDOW_*`` modes
    over ``(G, T, 64)`` window-heads: element ``(g, t, d)`` of k and v at
    ``(g // nh) * strides[0] + (g % nh) * strides[1] + t * strides[2] + d``,
    of q with ``q_strides``, of ``out`` with ``out_strides``; ``tables`` as
    :func:`sam_flash.kernel_tables` gives them.  Uncounted: the wrappers
    count."""
    _cuda.launch(
        "flmm_window_attention_sm90", q.data_ptr(), *q_strides, k.data_ptr(),
        v.data_ptr(), *strides, nh, tables[0].data_ptr(),
        tables[1].data_ptr(), side, G, T, mode, out.data_ptr(), *out_strides,
        _cuda.stream(q))


def sam_window_attention_plain(q, k, v, rel_pos_h, rel_pos_w, side: int):
    """Window v1's plain version: scale on the f32 scores, bf16 bias rows
    added one after the other."""
    return _window_variant_plain(q, k, v, rel_pos_h, rel_pos_w, side, "v1")


def sam_window_attention(q, k, v, rel_pos_h, rel_pos_w, side: int):
    """Windowed ViTDet attention, v1: q unscaled, ``scale`` on the f32
    scores, the two bias rows rounded to bf16."""
    return _window_variant("v1", q, k, v, rel_pos_h, rel_pos_w, side,
                           sam_window_attention)


sam_window_attention.launches = 0


def sam_window_attention_v2_plain(q, k, v, rel_pos_h, rel_pos_w, side: int):
    """Window v2's plain version: q scaled and rounded, the dense bias
    summed in f32 and rounded to bf16 once."""
    return _window_variant_plain(q, k, v, rel_pos_h, rel_pos_w, side, "v2")


def sam_window_attention_v2(q, k, v, rel_pos_h, rel_pos_w, side: int):
    """Windowed ViTDet attention, v2: the decomposed bias expanded outside
    the kernel to a dense ``(G, tp, tp)`` bf16 tensor, pad rows and columns
    at -1e30; it lives for this call only."""
    return _window_variant("v2", q, k, v, rel_pos_h, rel_pos_w, side,
                           sam_window_attention_v2)


sam_window_attention_v2.launches = 0


def sam_window_attention_v3_plain(q, k, v, rel_pos_h, rel_pos_w, side: int):
    """Window v3's plain version: v7's operands and softmax, with the pad
    keys of the JAX wrapper at -1e30."""
    return _window_variant_plain(q, k, v, rel_pos_h, rel_pos_w, side, "v3")


def sam_window_attention_v3(q, k, v, rel_pos_h, rel_pos_w, side: int):
    """Windowed ViTDet attention, v3: ``[q * scale | bias_h | bias_w | 1]``
    against ``[k^T ; sel_h ; sel_w ; pad row]``, one augmented product on the
    TPU; v7's function, through v7's kernel instantiation."""
    return _window_variant("v3", q, k, v, rel_pos_h, rel_pos_w, side,
                           sam_window_attention_v3)


sam_window_attention_v3.launches = 0


def sam_window_attention_v4_plain(q, k, v, rel_pos_h, rel_pos_w, side: int):
    """Window v4's plain version: v3's operands with the pad keys at -1e4,
    the scores rounded to bf16, max and ``exp`` in bf16, the f32 sum of the
    rounded ``p`` below."""
    return _window_variant_plain(q, k, v, rel_pos_h, rel_pos_w, side, "v4")


def sam_window_attention_v4(q, k, v, rel_pos_h, rel_pos_w, side: int):
    """Windowed ViTDet attention, v4: v3's augmented operands, bf16 scores,
    a bf16 ``exp`` and the denominator summed from the rounded
    probabilities; the softmax weights carry about 0.4% of rounding by
    contract."""
    return _window_variant("v4", q, k, v, rel_pos_h, rel_pos_w, side,
                           sam_window_attention_v4)


sam_window_attention_v4.launches = 0


def sam_window_attention_v5_plain(q, k, v, rel_pos_h, rel_pos_w, side: int):
    """Window v5's plain version: v4's operands, f32 scores and ``exp``,
    ``p`` rounded to v's dtype before both the value product and the f32
    sum that divides it."""
    return _window_variant_plain(q, k, v, rel_pos_h, rel_pos_w, side, "v5")


def sam_window_attention_v5(q, k, v, rel_pos_h, rel_pos_w, side: int):
    """Windowed ViTDet attention, v5: v4's augmented operands with f32
    scores and an f32 softmax whose denominator sums the rounded
    probabilities (the TPU kernel's pipelining orders its work only)."""
    return _window_variant("v5", q, k, v, rel_pos_h, rel_pos_w, side,
                           sam_window_attention_v5)


sam_window_attention_v5.launches = 0


def sam_window_attention_v6_plain(q, k, v, rel_pos_h, rel_pos_w, side: int):
    """Window v6's plain version: v1 with the two bias rows added to each
    other before they meet the scores."""
    return _window_variant_plain(q, k, v, rel_pos_h, rel_pos_w, side, "v6")


def sam_window_attention_v6(q, k, v, rel_pos_h, rel_pos_w, side: int):
    """Windowed ViTDet attention, v6: v1 with ``[bias_h | bias_w]`` as one
    bf16 row; v1's Hopper kernel serves it."""
    return _window_variant("v6", q, k, v, rel_pos_h, rel_pos_w, side,
                           sam_window_attention_v6)


sam_window_attention_v6.launches = 0


def sam_window_attention_v7_plain(q, k, v, rel_pos_h, rel_pos_w, side: int):
    """Window v7's plain version: q scaled and rounded, bias rows in q's
    dtype, scores out of one f32 sum."""
    return _window_variant_plain(q, k, v, rel_pos_h, rel_pos_w, side, "v7")


def sam_window_attention_v7(q, k, v, rel_pos_h, rel_pos_w, side: int):
    """Windowed ViTDet attention, v7: ``[q * scale | bias_h | bias_w]``
    rounded to q's dtype, one augmented product on the TPU."""
    return _window_variant("v7", q, k, v, rel_pos_h, rel_pos_w, side,
                           sam_window_attention_v7)


sam_window_attention_v7.launches = 0


def sam_window_attention_v8_plain(q, k, v, rel_pos_h, rel_pos_w, side: int):
    """Window v8's plain version: v7's function."""
    return _window_variant_plain(q, k, v, rel_pos_h, rel_pos_w, side, "v8")


def sam_window_attention_v8(q, k, v, rel_pos_h, rel_pos_w, side: int):
    """Windowed ViTDet attention, v8: v7's function (the TPU kernel gets its
    selection columns added to the keys outside); one Hopper kernel serves
    both names."""
    return _window_variant("v8", q, k, v, rel_pos_h, rel_pos_w, side,
                           sam_window_attention_v8)


sam_window_attention_v8.launches = 0
