"""K5: causal flash attention with the mean-merged text->image capture
(flmm_tpu/ops/flash_attention.py::flash_attention_with_merged_capture).

The replacement for ``output_attentions=True``: besides the attention
output it returns, per mask, the merged probabilities of the query rows over
the image keys ``[img_start, img_start + n_img)``, without an ``S x S``
matrix in device memory.  The wrapper launches csrc/flash_capture.cu for
CUDA tensors and takes the plain PyTorch version only for CPU tensors.

Alignment contract, as in the JAX package: ``S`` and ``img_start`` are
multiples of 128 and the 128-padded image block fits in the sequence.
Beyond the JAX signature, k and v may carry ``KV`` heads that divide ``H``
(GQA: query head ``h`` reads kv head ``h // (H // KV)``), so the decoder
passes them without the repeated copies, and every operand may be a strided
view whose last dimension is contiguous.
"""

from __future__ import annotations

import math

import torch

from flmm_tpu_torch.ops import _cuda

BLOCK = 128
MAX_MASKS = 32  # csrc/flash_capture.cu MAX_M


def _check_contract(q, k, v, key_valid, merge_matrix, img_start, n_img):
    B, H, S, hd = q.shape
    n_img_pad = math.ceil(n_img / BLOCK) * BLOCK
    if S % BLOCK or img_start % BLOCK or img_start + n_img_pad > S:
        raise ValueError(
            f"flash_attention_with_merged_capture: needs S % {BLOCK} == 0, "
            f"img_start % {BLOCK} == 0 and img_start + n_img_pad <= S, got "
            f"S={S}, img_start={img_start}, n_img={n_img}")
    KV = k.shape[1]
    if (k.shape != (B, KV, S, hd) or v.shape != k.shape or H % KV
            or key_valid.shape != (B, S)
            or merge_matrix.shape[:2] != (B, S)):
        raise ValueError(
            "flash_attention_with_merged_capture: q "
            f"{tuple(q.shape)} k {tuple(k.shape)} v {tuple(v.shape)} "
            f"key_valid {tuple(key_valid.shape)} merge_matrix "
            f"{tuple(merge_matrix.shape)}")


def flash_attention_with_merged_capture_plain(q, k, v, key_valid,
                                              merge_matrix, img_start: int,
                                              n_img: int):
    """The same function over f32 scores in device memory: p is the softmax
    over the keys ``j <= i`` with ``key_valid``, a row without such a key
    gives p = 0 (the kernels' guard), the output is ``p.to(q.dtype) @ v``."""
    B, H, S, hd = q.shape
    rep = H // k.shape[1]
    if rep > 1:
        k = k.repeat_interleave(rep, dim=1)
        v = v.repeat_interleave(rep, dim=1)
    logits = (q.float() @ k.float().transpose(-1, -2)) / math.sqrt(hd)
    causal = torch.ones((S, S), dtype=torch.bool, device=q.device).tril()
    allow = causal[None, None] & key_valid.bool()[:, None, None, :]
    logits = logits.masked_fill_(~allow, float("-inf"))
    row_max = logits.amax(dim=-1, keepdim=True)
    row_max = torch.where(torch.isfinite(row_max), row_max, 0.0)
    p = torch.exp(logits.sub_(row_max))  # exp(-inf) = 0 where masked
    p = p.div_(p.sum(dim=-1, keepdim=True).clamp_min(1e-30))
    out = p.to(q.dtype) @ v
    merged = torch.einsum("bhsn,bsm->bhmn",
                          p[..., img_start:img_start + n_img],
                          merge_matrix.float())
    return out, merged


def flash_attention_with_merged_capture(q, k, v, key_valid, merge_matrix,
                                        img_start: int, n_img: int):
    """Causal flash attention emitting per-mask merged attention images.

    Args:
      q: ``(B, H, S, 128)``; k, v: ``(B, KV, S, 128)``, ``KV`` dividing H.
      key_valid: ``(B, S)`` bool key validity (mid-sequence holes, e.g. the
        anyres image-pad slots and the alignment pads).
      merge_matrix: ``(B, S, M)`` mean-merge matrix (rows pre-normalised),
        ``M <= 32``.

    Returns ``(out (B, H, S, hd) in q.dtype, merged (B, H, M, n_img) f32)``.
    """
    _cuda.check_no_grad("flash_attention_with_merged_capture", q, k, v,
                        key_valid, merge_matrix)
    _check_contract(q, k, v, key_valid, merge_matrix, img_start, n_img)
    if not q.is_cuda:
        return flash_attention_with_merged_capture_plain(
            q, k, v, key_valid, merge_matrix, img_start, n_img)
    B, H, S, hd = q.shape
    KV, M = k.shape[1], merge_matrix.shape[-1]
    if hd != 128 or M > MAX_MASKS:
        raise ValueError(f"flash_attention_with_merged_capture: kernel built "
                         f"for head_dim 128 and at most {MAX_MASKS} masks, "
                         f"got {hd} and {M}")
    for name, t in (("q", q), ("k", k), ("v", v)):
        if (t.dtype != torch.bfloat16 or not t.is_cuda or t.stride(-1) != 1
                or any(s % 8 for s in t.stride()[:3])
                or t.data_ptr() % 16):
            raise ValueError(
                f"flash_attention_with_merged_capture: {name} must be a bf16 "
                "CUDA tensor with a contiguous last dim, strides that are "
                f"multiples of 8 and 16-byte alignment; got {t.dtype}, "
                f"strides {t.stride()}")
    valid = key_valid.contiguous()
    mm = merge_matrix.float().contiguous()
    _cuda.check_cuda("flash_attention_with_merged_capture", valid,
                     dtype=torch.bool)
    _cuda.check_cuda("flash_attention_with_merged_capture", mm,
                     dtype=torch.float32)
    # out is (B, S, H, hd) in memory, so out.transpose(1, 2) reshapes to the
    # decoder's (B, S, H * hd) rows without a copy
    out = torch.empty((B, S, H, hd), dtype=q.dtype, device=q.device)
    lse = torch.empty((B * H, S), dtype=torch.float32, device=q.device)
    merged = torch.empty((B, H, M, n_img), dtype=torch.float32,
                         device=q.device)
    _cuda.launch(
        "flmm_flash_capture", q.data_ptr(), *q.stride()[:3], k.data_ptr(),
        *k.stride()[:3], v.data_ptr(), *v.stride()[:3], B, H, KV, S, hd,
        valid.data_ptr(), mm.data_ptr(), M, img_start, n_img,
        out.data_ptr(), S * H * hd, hd, H * hd, lse.data_ptr(),
        merged.data_ptr(), _cuda.stream(q))
    flash_attention_with_merged_capture.launches += 1
    return out.transpose(1, 2), merged


flash_attention_with_merged_capture.launches = 0
