"""Fused transformer-block pieces: K3 ``fused_ln_qkv``, K4
``fused_proj_ln_mlp`` and K8 ``fused_ln_mlp`` (flmm_tpu/ops/fused_block.py).

Each wrapper launches its hand-written Hopper kernels (csrc/ln_gemm.cu,
csrc/block_tail.cu: a LayerNorm row pass and products on the wgmma + TMA
GEMM core of csrc/gemm_sm90.cuh) for CUDA tensors and takes the plain
PyTorch version, which has the same signature, only for CPU tensors.
``launches`` on each wrapper counts its kernel launches.  The kernels take
every width ``C % 128 == 0`` with ``F % 128 == 0``.
:func:`staged_tail_plain` is the plain twin of the staging csrc/block_tail.cu
does: where it keeps f32 and where it rounds to bf16.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F

from flmm_tpu_torch.models.sam.common import layer_norm
from flmm_tpu_torch.ops import _cuda

# Activation codes shared with csrc/common.cuh (enum Act).
ACTS = ("gelu", "gelu_tanh", "quick_gelu", "relu")


def activation(x: torch.Tensor, kind: str) -> torch.Tensor:
    """The four activations of flmm_tpu/ops/fused_block.py:42-48, with the
    exact erf GELU (the TPU's rational erf stood in for a missing erf)."""
    if kind == "gelu":
        return F.gelu(x)
    if kind == "gelu_tanh":
        return F.gelu(x, approximate="tanh")
    if kind == "quick_gelu":
        return x * torch.sigmoid(1.702 * x)
    if kind == "relu":
        return torch.relu(x)
    raise ValueError(kind)


def fused_ln_qkv_plain(x, ln_w, ln_b, w, b, eps: float = 1e-6):
    """``LN(x) @ w + b`` over ``(..., C)`` tokens."""
    return layer_norm(x, ln_w, ln_b, eps) @ w + b


def fused_ln_qkv(x, ln_w, ln_b, w, b, eps: float = 1e-6):
    """``LN(x) @ w + b`` (K3): the LN row pass writes the normed rows in
    bf16 once, the product adds the bias and rounds once.

    Args:
      x: ``(..., C)``; w: ``(C, P)``; b: ``(P,)``.

    Returns ``(..., P)`` in ``x.dtype``.
    """
    _cuda.check_no_grad("fused_ln_qkv", x, ln_w, ln_b, w, b)
    if not x.is_cuda:
        return fused_ln_qkv_plain(x, ln_w, ln_b, w, b, eps)
    C = x.shape[-1]
    P = w.shape[1]
    if w.shape != (C, P) or b.shape != (P,) or ln_w.shape != (C,) \
            or ln_b.shape != (C,):
        raise ValueError(f"fused_ln_qkv: bad shapes x {tuple(x.shape)} "
                         f"w {tuple(w.shape)} b {tuple(b.shape)}")
    xf = x.reshape(-1, C).contiguous()
    _cuda.check_cuda("fused_ln_qkv", xf, ln_w, ln_b, w, b)
    out = torch.empty((xf.shape[0], P), dtype=x.dtype, device=x.device)
    ln_gemm(xf, ln_w, ln_b, eps, None, w, b, out)
    fused_ln_qkv.launches += 1
    return out.reshape(*x.shape[:-1], P)


fused_ln_qkv.launches = 0


def fused_proj_ln_mlp_plain(shortcut, attn, wo, bo, ln_w, ln_b, w1, b1, w2,
                            b2, eps: float = 1e-6, act: str = "gelu"):
    """``x = shortcut + attn @ wo + bo;  x + W2 act(W1 LN(x) + b1) + b2``."""
    x = shortcut + (attn @ wo + bo)
    h = activation(layer_norm(x, ln_w, ln_b, eps) @ w1 + b1, act)
    return x + (h @ w2 + b2)


def fused_proj_ln_mlp(shortcut, attn, wo, bo, ln_w, ln_b, w1, b1, w2, b2,
                      eps: float = 1e-6, act: str = "gelu"):
    """The post-attention tail of a pre-norm block (K4) on the staging of
    :func:`staged_tail_plain`: the residual base in f32 and the ``(N, F)``
    hidden in bf16 each make one round trip through device memory.

    Args:
      shortcut, attn: ``(..., C)``; wo: ``(C, C)``; w1: ``(C, F)``;
      w2: ``(F, C)``.
    """
    _cuda.check_no_grad("fused_proj_ln_mlp", shortcut, attn, wo, bo, ln_w,
                        ln_b, w1, b1, w2, b2)
    if not shortcut.is_cuda:
        return fused_proj_ln_mlp_plain(shortcut, attn, wo, bo, ln_w, ln_b,
                                       w1, b1, w2, b2, eps, act)
    C = shortcut.shape[-1]
    if attn.shape != shortcut.shape:
        raise ValueError("fused_proj_ln_mlp: attn and shortcut differ in "
                         f"shape: {tuple(attn.shape)} {tuple(shortcut.shape)}")
    xf = shortcut.reshape(-1, C).contiguous()
    af = attn.reshape(-1, C).contiguous()
    out = torch.empty_like(xf)
    block_tail(xf, af, wo, bo, ln_w, ln_b, eps, w1, b1, w2, b2, act, out)
    fused_proj_ln_mlp.launches += 1
    return out.reshape(shortcut.shape)


fused_proj_ln_mlp.launches = 0


def fused_ln_mlp_plain(x, ln_w, ln_b, w1, b1, w2, b2, eps: float = 1e-6,
                       act: str = "gelu"):
    """``x + W2 act(W1 LN(x) + b1) + b2`` over ``(..., C)`` tokens."""
    h = activation(layer_norm(x, ln_w, ln_b, eps) @ w1 + b1, act)
    return x + (h @ w2 + b2)


def fused_ln_mlp(x, ln_w, ln_b, w1, b1, w2, b2, eps: float = 1e-6,
                 act: str = "gelu"):
    """The LN2 + MLP + residual half of a pre-norm block (K8): the LN row
    pass, the hidden product (bf16 hidden) and the residual product.

    Args:
      x: ``(..., C)``; w1: ``(C, F)``; w2: ``(F, C)``.
    """
    _cuda.check_no_grad("fused_ln_mlp", x, ln_w, ln_b, w1, b1, w2, b2)
    if not x.is_cuda:
        return fused_ln_mlp_plain(x, ln_w, ln_b, w1, b1, w2, b2, eps, act)
    C = x.shape[-1]
    Fh = w1.shape[1]
    if (w1.shape != (C, Fh) or w2.shape != (Fh, C) or b1.shape != (Fh,)
            or b2.shape != (C,) or ln_w.shape != (C,) or ln_b.shape != (C,)):
        raise ValueError(f"fused_ln_mlp: weight shapes do not match C={C}, "
                         f"F={Fh}")
    _check_widths("fused_ln_mlp", C, Fh)
    xf = x.reshape(-1, C).contiguous()
    out = torch.empty_like(xf)
    ln = torch.empty_like(xf)
    h = torch.empty((xf.shape[0], Fh), dtype=xf.dtype, device=xf.device)
    _cuda.check_cuda("fused_ln_mlp", xf, ln_w, ln_b, w1, b1, w2, b2, out)
    _cuda.launch(
        "flmm_ln_mlp", xf.data_ptr(), xf.shape[0], C, Fh, ln_w.data_ptr(),
        ln_b.data_ptr(), eps, w1.data_ptr(), b1.data_ptr(), w2.data_ptr(),
        b2.data_ptr(), ACTS.index(act), out.data_ptr(), ln.data_ptr(),
        h.data_ptr(), _cuda.stream(xf))
    fused_ln_mlp.launches += 1
    return out.reshape(x.shape)


fused_ln_mlp.launches = 0


def staged_tail_plain(shortcut, attn, wo, bo, ln_w, ln_b, w1, b1, w2, b2,
                      eps: float = 1e-6, act: str = "gelu"):
    """The tail as csrc/block_tail.cu stages it, in plain PyTorch: ``x =
    shortcut + (attn @ wo + bo)`` kept in f32, the LN row pass rounded to
    the working dtype, ``h = act(LN(x) @ w1 + b1)`` rounded to it (the TPU
    kernel's rounding point), ``out = x + (h @ w2 + b2)`` rounded once.
    ``attn=None`` (with ``wo``, ``bo`` None) is K8's staging: x is the input
    rows, read in the working dtype.  Products accumulate in f32."""
    dt = shortcut.dtype
    x = shortcut.float()
    if attn is not None:
        x = x + (attn.float() @ wo.float() + bo.float())
    y = layer_norm(x, ln_w.float(), ln_b.float(), eps).to(dt)
    h = activation(y.float() @ w1.float() + b1.float(), act).to(dt)
    return (x + (h.float() @ w2.float() + b2.float())).to(dt)


def _check_widths(name, C, Fh) -> None:
    """The widths the GEMM core's block kernels take."""
    if C % 128 or Fh % 128:
        raise ValueError(f"{name}: the kernels take C and F multiples of "
                         f"128, got C={C}, F={Fh}")


def ln_gemm(x2d, ln_w, ln_b, eps, row_valid, w, b, out) -> None:
    """Launch csrc/ln_gemm.cu: ``out = (LN(x2d) zeroed where not
    row_valid) @ w + b``, with an ``(M, K)`` scratch for the normed rows.
    Uncounted: the K1, K3 and K10 wrappers count."""
    M, K = x2d.shape
    N = w.shape[1]
    if row_valid is not None:
        _cuda.check_cuda("ln_gemm", row_valid, dtype=torch.bool)
        if row_valid.shape != (M,):
            raise ValueError(f"ln_gemm: row_valid {tuple(row_valid.shape)}")
    if K % 8 or N % 8:
        raise ValueError(f"ln_gemm: needs K % 8 == 0 and N % 8 == 0, got "
                         f"K={K}, N={N}")
    ln_out = torch.empty_like(x2d)
    _cuda.launch(
        "flmm_ln_gemm", x2d.data_ptr(), M, K, ln_w.data_ptr(),
        ln_b.data_ptr(), eps,
        None if row_valid is None else row_valid.data_ptr(),
        w.data_ptr(), N, b.data_ptr(), out.data_ptr(), ln_out.data_ptr(),
        _cuda.stream(x2d))


def block_tail(xf, af, wo, bo, ln_w, ln_b, eps, w1, b1, w2, b2, act,
               out) -> None:
    """Launch csrc/block_tail.cu on ``(N, C)`` rows, with the f32 residual
    base, the normed rows and the hidden as scratch.  Uncounted: the K1 and
    K4 wrappers count."""
    N, C = xf.shape
    Fh = w1.shape[1]
    if (wo.shape != (C, C) or w1.shape != (C, Fh) or w2.shape != (Fh, C)
            or b1.shape != (Fh,) or bo.shape != (C,) or b2.shape != (C,)):
        raise ValueError("block_tail: weight shapes do not match C="
                         f"{C}, F={Fh}")
    _check_widths("block_tail", C, Fh)
    _cuda.check_cuda("block_tail", xf, af, wo, bo, ln_w, ln_b, w1, b1, w2,
                     b2, out)
    x32 = torch.empty((N, C), dtype=torch.float32, device=xf.device)
    ln = torch.empty_like(xf)
    h = torch.empty((N, Fh), dtype=xf.dtype, device=xf.device)
    _cuda.launch(
        "flmm_block_tail", xf.data_ptr(), af.data_ptr(), N, C, Fh,
        wo.data_ptr(), bo.data_ptr(), ln_w.data_ptr(), ln_b.data_ptr(), eps,
        w1.data_ptr(), b1.data_ptr(), w2.data_ptr(), b2.data_ptr(),
        ACTS.index(act), out.data_ptr(), x32.data_ptr(), ln.data_ptr(),
        h.data_ptr(), _cuda.stream(xf))


def gemm_residual_f32(a, w, b, resid, out) -> None:
    """Launch the f32-epilogue entry of csrc/ln_gemm.cu: ``out (M, N) f32 =
    resid + a @ w + b`` with bf16 operands, one block per output tile and a
    fixed summation order.  Uncounted: the K10 wrapper counts."""
    M, K = a.shape
    N = w.shape[1]
    if (w.shape != (K, N) or b.shape != (N,) or resid.shape != (M, N)
            or out.shape != (M, N) or K % 8 or N % 8):
        raise ValueError(f"gemm_residual_f32: a {tuple(a.shape)} w "
                         f"{tuple(w.shape)} resid {tuple(resid.shape)}; needs "
                         "K % 8 == 0 and N % 8 == 0")
    _cuda.check_cuda("gemm_residual_f32", a, w, b, resid)
    _cuda.check_cuda("gemm_residual_f32", out, dtype=torch.float32)
    _cuda.launch(
        "flmm_gemm_residual_f32", a.data_ptr(), M, K, w.data_ptr(), N,
        b.data_ptr(), resid.data_ptr(), out.data_ptr(), _cuda.stream(a))
