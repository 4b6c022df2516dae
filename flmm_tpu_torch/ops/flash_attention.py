"""K5: causal flash attention with the mean-merged text->image capture
(flmm_tpu/ops/flash_attention.py::flash_attention_with_merged_capture), and
K9: the same attention with the raw capture (::flash_attention_with_capture).

The replacement for ``output_attentions=True``: besides the attention
output it returns, per mask, the merged probabilities of the query rows over
the image keys ``[img_start, img_start + n_img)``, without an ``S x S``
matrix in device memory.  The wrapper launches csrc/flash_capture_sm90.cu
for CUDA tensors and takes the plain PyTorch version only for CPU tensors.

Alignment contract, as in the JAX package: ``S`` and ``img_start`` are
multiples of 128 and the 128-padded image block fits in the sequence.
Beyond the JAX signature, k and v may carry ``KV`` heads that divide ``H``
(GQA: query head ``h`` reads kv head ``h // (H // KV)``), so the decoder
passes them without the repeated copies, and every operand may be a strided
view whose last dimension is contiguous.  Under sequence sharding
(parallel/sequence.py) K5 takes one rank's query rows ``[q_offset,
q_offset + S_loc)`` against all ``S`` keys, both multiples of 128.
"""

from __future__ import annotations

import math

import torch

from flmm_tpu_torch.ops import _cuda
from flmm_tpu_torch.ops._matmul import matmul_f32

BLOCK = 128


def _check_contract(q, k, v, key_valid, merge_matrix, img_start, n_img,
                    q_offset):
    B, H, S_loc, hd = q.shape
    S = k.shape[2]
    n_img_pad = math.ceil(n_img / BLOCK) * BLOCK
    if S % BLOCK or img_start % BLOCK or img_start + n_img_pad > S:
        raise ValueError(
            f"flash_attention_with_merged_capture: needs S % {BLOCK} == 0, "
            f"img_start % {BLOCK} == 0 and img_start + n_img_pad <= S, got "
            f"S={S}, img_start={img_start}, n_img={n_img}")
    if (q_offset < 0 or q_offset % BLOCK or S_loc % BLOCK
            or q_offset + S_loc > S):
        raise ValueError(
            f"flash_attention_with_merged_capture: the query rows [q_offset, "
            f"q_offset + S_loc) need q_offset % {BLOCK} == 0, S_loc % {BLOCK}"
            f" == 0 and q_offset + S_loc <= S, got q_offset={q_offset}, "
            f"S_loc={S_loc}, S={S}")
    KV = k.shape[1]
    if (k.shape != (B, KV, S, hd) or v.shape != k.shape or H % KV
            or key_valid.shape != (B, S)
            or merge_matrix.shape[:2] != (B, S_loc)):
        raise ValueError(
            "flash_attention_with_merged_capture: q "
            f"{tuple(q.shape)} k {tuple(k.shape)} v {tuple(v.shape)} "
            f"key_valid {tuple(key_valid.shape)} merge_matrix "
            f"{tuple(merge_matrix.shape)}")


def _causal_attention_plain(q, k, v, key_valid, q_offset: int = 0):
    """``(out, p)`` over f32 scores in device memory: p ``(B, H, S_q, S)``
    is the softmax over the keys ``j <= q_offset + i`` with ``key_valid``,
    a row without such a key gives p = 0 (the kernels' guard), the output
    is ``p.to(q.dtype) @ v``."""
    S_q, hd, S = q.shape[2], q.shape[3], k.shape[2]
    rep = q.shape[1] // k.shape[1]
    if rep > 1:
        k = k.repeat_interleave(rep, dim=1)
        v = v.repeat_interleave(rep, dim=1)
    logits = matmul_f32(q, k.transpose(-1, -2)) / math.sqrt(hd)
    rows = torch.arange(S_q, device=q.device) + q_offset
    causal = rows[:, None] >= torch.arange(S, device=q.device)[None, :]
    allow = causal[None, None] & key_valid.bool()[:, None, None, :]
    logits = logits.masked_fill_(~allow, float("-inf"))
    row_max = logits.amax(dim=-1, keepdim=True)
    row_max = torch.where(torch.isfinite(row_max), row_max, 0.0)
    p = torch.exp(logits.sub_(row_max))  # exp(-inf) = 0 where masked
    p = p.div_(p.sum(dim=-1, keepdim=True).clamp_min(1e-30))
    return p.to(q.dtype) @ v, p


def flash_attention_with_merged_capture_plain(q, k, v, key_valid,
                                              merge_matrix, img_start: int,
                                              n_img: int, q_offset: int = 0):
    """K5's plain version: the merged capture from the full f32
    probabilities (of the query rows ``[q_offset, q_offset + S_loc)``)."""
    out, p = _causal_attention_plain(q, k, v, key_valid, q_offset)
    merged = torch.einsum("bhsn,bsm->bhmn",
                          p[..., img_start:img_start + n_img],
                          merge_matrix.float())
    return out, merged


def _check_strided(fn: str, q, k, v) -> None:
    """q, k, v as the kernels read them in place."""
    for name, t in (("q", q), ("k", k), ("v", v)):
        if (t.dtype != torch.bfloat16 or not t.is_cuda or t.stride(-1) != 1
                or any(s % 8 for s in t.stride()[:3])
                or t.data_ptr() % 16):
            raise ValueError(
                f"{fn}: {name} must be a bf16 CUDA tensor with a contiguous "
                "last dim, strides that are multiples of 8 and 16-byte "
                f"alignment; got {t.dtype}, strides {t.stride()}")


def flash_attention_with_merged_capture(q, k, v, key_valid, merge_matrix,
                                        img_start: int, n_img: int,
                                        q_offset: int = 0):
    """Causal flash attention emitting per-mask merged attention images.

    Args:
      q: ``(B, H, S_loc, 128)``, the query rows ``[q_offset, q_offset +
        S_loc)`` (all ``S`` by default); k, v: ``(B, KV, S, 128)``, ``KV``
        dividing H.
      key_valid: ``(B, S)`` bool key validity (mid-sequence holes, e.g. the
        anyres image-pad slots and the alignment pads).
      merge_matrix: ``(B, S_loc, M)`` mean-merge matrix rows of the query
        rows (pre-normalised over all S), any ``M``.
      q_offset: the first query row's global index; it and ``S_loc`` are
        multiples of 128.

    Returns ``(out (B, H, S_loc, hd) in q.dtype, merged (B, H, M, n_img)
    f32)``; ``merged`` sums over the given query rows only.
    """
    _cuda.check_no_grad("flash_attention_with_merged_capture", q, k, v,
                        key_valid, merge_matrix)
    _check_contract(q, k, v, key_valid, merge_matrix, img_start, n_img,
                    q_offset)
    if not q.is_cuda:
        return flash_attention_with_merged_capture_plain(
            q, k, v, key_valid, merge_matrix, img_start, n_img, q_offset)
    B, H, S_loc, hd = q.shape
    S = k.shape[2]
    KV, M = k.shape[1], merge_matrix.shape[-1]
    if hd != 128:
        raise ValueError(f"flash_attention_with_merged_capture: kernel built "
                         f"for head_dim 128, got {hd}")
    _check_strided("flash_attention_with_merged_capture", q, k, v)
    valid = key_valid.contiguous()
    mm = merge_matrix.float().contiguous()
    _cuda.check_cuda("flash_attention_with_merged_capture", valid,
                     dtype=torch.bool)
    _cuda.check_cuda("flash_attention_with_merged_capture", mm,
                     dtype=torch.float32)
    # out is (B, S, H, hd) in memory, so out.transpose(1, 2) reshapes to the
    # decoder's (B, S, H * hd) rows without a copy
    out = torch.empty((B, S_loc, H, hd), dtype=q.dtype, device=q.device)
    lse = torch.empty((B * H, S_loc), dtype=torch.float32, device=q.device)
    # which 64-row query blocks merge into a mask: the capture pass skips
    # the others
    flags = torch.empty((B, S_loc // 64), dtype=torch.uint8, device=q.device)
    merged = torch.empty((B, H, M, n_img), dtype=torch.float32,
                         device=q.device)
    _cuda.launch(
        "flmm_flash_capture", q.data_ptr(), *q.stride()[:3], k.data_ptr(),
        *k.stride()[:3], v.data_ptr(), *v.stride()[:3], B, H, KV, S, S_loc,
        q_offset, hd, valid.data_ptr(), mm.data_ptr(), M, img_start, n_img,
        out.data_ptr(), S_loc * H * hd, hd, H * hd, lse.data_ptr(),
        flags.data_ptr(), merged.data_ptr(), _cuda.stream(q))
    flash_attention_with_merged_capture.launches += 1
    return out.transpose(1, 2), merged


flash_attention_with_merged_capture.launches = 0


def _length_mask(lengths, S: int) -> torch.Tensor:
    """``(B, S)`` bool key validity of left-aligned sequences."""
    return torch.arange(S, device=lengths.device)[None, :] < lengths[:, None]


def flash_attention_with_capture_plain(q, k, v, lengths, img_start: int,
                                       n_img: int):
    """K9's plain version: eager f32 softmax under the causal and length
    mask, the image-key columns of its probabilities as the side output."""
    out, p = _causal_attention_plain(q, k, v,
                                     _length_mask(lengths, q.shape[2]))
    return out, p[..., img_start:img_start + n_img]


def flash_attention_with_capture(q, k, v, lengths, img_start: int,
                                 n_img: int):
    """Causal attention + image-block probability side output (K9).

    Args:
      q: ``(B, H, S, 128)``; k, v: ``(B, KV, S, 128)``, ``KV`` dividing H
        (``KV == H``: already head-repeated, the JAX contract).
      lengths: ``(B,)`` integer valid sequence lengths (left-aligned).
      img_start: multiple of 128; ``n_img``: image-block width.

    Returns ``(out (B, H, S, hd) in q.dtype, img_probs (B, H, S, n_img)
    f32)``.
    """
    name = "flash_attention_with_capture"
    _cuda.check_no_grad(name, q, k, v)
    B, H, S, hd = q.shape
    n_img_pad = math.ceil(n_img / BLOCK) * BLOCK
    if S % BLOCK or img_start % BLOCK or img_start + n_img_pad > S:
        raise ValueError(
            f"{name}: needs S % {BLOCK} == 0, img_start % {BLOCK} == 0 and "
            f"img_start + n_img_pad <= S, got S={S}, img_start={img_start}, "
            f"n_img={n_img}")
    KV = k.shape[1]
    if (k.shape != (B, KV, S, hd) or v.shape != k.shape or H % KV
            or lengths.shape != (B,)):
        raise ValueError(f"{name}: q {tuple(q.shape)} k {tuple(k.shape)} v "
                         f"{tuple(v.shape)} lengths {tuple(lengths.shape)}")
    if not q.is_cuda:
        return flash_attention_with_capture_plain(q, k, v, lengths, img_start,
                                                  n_img)
    if hd != 128:
        raise ValueError(f"{name}: kernel built for head_dim 128, got {hd}")
    _check_strided(name, q, k, v)
    valid = _length_mask(lengths, S).contiguous()
    _cuda.check_cuda(name, valid, dtype=torch.bool)
    # out is (B, S, H, hd) in memory, as K5's
    out = torch.empty((B, S, H, hd), dtype=q.dtype, device=q.device)
    lse = torch.empty((B * H, S), dtype=torch.float32, device=q.device)
    probs = torch.empty((B, H, S, n_img), dtype=torch.float32,
                        device=q.device)
    _cuda.launch(
        "flmm_flash_capture_raw", q.data_ptr(), *q.stride()[:3], k.data_ptr(),
        *k.stride()[:3], v.data_ptr(), *v.stride()[:3], B, H, KV, S, hd,
        valid.data_ptr(), img_start, n_img, out.data_ptr(), S * H * hd, hd,
        H * hd, lse.data_ptr(), probs.data_ptr(), _cuda.stream(q))
    flash_attention_with_capture.launches += 1
    return out.transpose(1, 2), probs


flash_attention_with_capture.launches = 0
