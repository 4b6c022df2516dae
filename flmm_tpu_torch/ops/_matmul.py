"""The product of the port's plain attention paths: the operands as they
are, the result in f32.

The JAX package's unfused paths multiply bf16 operands and accumulate in f32
(``preferred_element_type=jnp.float32``).  On a card that is one tensor-core
product with an f32 result, ``torch.bmm(a, b, out_dtype=torch.float32)``;
upcasting both operands first gives the same values (a product of two bf16
numbers is exact in f32) through an f32 GEMM off the tensor cores' bf16 rate.
The f32-result product exists for CUDA tensors only and has no derivative, so
CPU tensors, operands that are not both bf16 and operands autograd follows
keep the upcast form.
"""

from __future__ import annotations

import torch


def matmul_f32(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """``a @ b`` in f32 over ``(..., M, K)`` and ``(..., K, N)`` with equal
    leading dims, or a 2-D ``b`` shared by all of them."""
    if not (a.is_cuda and a.dtype == b.dtype == torch.bfloat16) or (
            torch.is_grad_enabled() and (a.requires_grad or b.requires_grad)):
        return a.float() @ b.float()
    if b.dim() == 2:
        out = torch.mm(a.reshape(-1, a.shape[-1]), b,
                       out_dtype=torch.float32)
        return out.reshape(*a.shape[:-1], b.shape[-1])
    if a.shape[:-2] != b.shape[:-2]:
        raise ValueError(f"matmul_f32: leading dims of {tuple(a.shape)} and "
                         f"{tuple(b.shape)} differ")
    out = torch.bmm(a.reshape(-1, *a.shape[-2:]), b.reshape(-1, *b.shape[-2:]),
                    out_dtype=torch.float32)
    return out.reshape(*a.shape[:-1], b.shape[-1])
