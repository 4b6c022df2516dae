"""Int8 W8A8 products of the frozen towers (flmm_tpu/ops/quant.py).

* weights: per-output-channel symmetric int8, ``scale = max|w| / 127``,
  computed once at load time (:func:`quantize_weight`);
* activations: per-token dynamic symmetric int8, computed on the fly inside
  :func:`int8_matmul`.

Both round half to even (``jnp.round`` and ``torch.round`` do) and floor the
scales at 1e-8, as the JAX package does.  No Pallas kernel computes the
product there: it is an XLA ``dot_general`` int8 x int8 -> int32.  Here a
CUDA tensor takes ``torch._int_mm`` (cuBLASLt); a CPU tensor takes the plain
twin :func:`int8_product_plain`, an f64 product of the int8 operands, which
is the int32 product exactly (every partial sum is an integer of at most
``K * 127 * 127`` in magnitude, far below 2**53).  A CUDA tensor never takes
the plain twin: a shape ``torch._int_mm`` refuses raises.

The rescale follows the JAX order, ``y.float() * x_scale * w_scale``, then
the cast to ``x``'s dtype.

``torch._int_mm`` takes the weight either way round, but runs a row-major
``(K, N)`` weight several times slower than a column-major one (and refuses
some small shapes in that layout): the quantisers here give their int8
weights column-major (the same values, strides ``(1, K)``), and the product
makes a row-major weight column-major before it calls the library.

``max / 127`` is computed as XLA computes it: under ``jax.jit`` XLA turns
the division by the constant into a product with ``f32(1 / 127)``, which
differs from the quotient in the last bit for about one value in 20.  The
JAX forward is jitted, and so is the decoder's ``quantize_params``; the SAM
encoder's ``quantize_params`` runs op by op and divides.
"""

from __future__ import annotations

import torch

# torch._int_mm on a card wants more rows than this, and K and N multiples
# of INT_MM_ALIGN
INT_MM_MIN_ROWS = 16
INT_MM_ALIGN = 8
# f32(1 / 127): what XLA multiplies by where a jitted function divides by 127
INV_127 = 1.0 / 127.0


def _over_127(m: torch.Tensor, jitted: bool) -> torch.Tensor:
    return m * INV_127 if jitted else m / 127.0


def column_major(w: torch.Tensor) -> torch.Tensor:
    """``w`` with the same values and its last two axes laid out
    column-major (a no-op where they already are)."""
    if w.stride(-2) == 1 and w.stride(-1) == w.shape[-2]:
        return w
    return w.transpose(-1, -2).contiguous().transpose(-1, -2)


def quantize_weight(w: torch.Tensor, jitted: bool = False
                    ) -> tuple[torch.Tensor, torch.Tensor]:
    """Per-output-channel symmetric int8 quantisation of an ``(in, out)``
    matrix (or of each ``(in, out)`` slice of a stack): ``(w_q int8
    column-major, scale f32 (out,))``; ``jitted`` takes the scale as XLA
    computes it under ``jax.jit``."""
    wf = w.float()
    scale = _over_127(torch.clamp_min(wf.abs().amax(dim=-2), 1e-8), jitted)
    w_q = torch.clamp(torch.round(wf / scale.unsqueeze(-2)), -127, 127)
    return column_major(w_q.to(torch.int8)), scale


def quantize_activations(x: torch.Tensor) -> tuple[torch.Tensor,
                                                   torch.Tensor]:
    """Per-token symmetric int8 of ``(..., in)``: ``(x_q int8, x_scale f32
    (..., 1))``, the scale as the jitted JAX forward computes it."""
    xf = x.float()
    x_scale = _over_127(torch.clamp_min(xf.abs().amax(dim=-1, keepdim=True),
                                        1e-8), jitted=True)
    x_q = torch.clamp(torch.round(xf / x_scale), -127, 127)
    return x_q.to(torch.int8), x_scale


def int8_product_plain(x_q: torch.Tensor, w_q: torch.Tensor) -> torch.Tensor:
    """The exact int32 product of ``(M, K)`` and ``(K, N)`` int8 matrices on
    any device, through f64 (exact for any K below 2**38)."""
    return (x_q.double() @ w_q.double()).to(torch.int32)


def int8_product(x_q: torch.Tensor, w_q: torch.Tensor) -> torch.Tensor:
    """The int32 product of ``(M, K)`` and ``(K, N)`` int8 matrices:
    ``torch._int_mm`` on a card (rows padded with zeros up to 17 where there
    are fewer, then sliced back), the plain twin on the CPU."""
    if not x_q.is_cuda:
        return int8_product_plain(x_q, w_q)
    M, K = x_q.shape
    N = w_q.shape[1]
    if K % INT_MM_ALIGN or N % INT_MM_ALIGN:
        raise ValueError(
            f"int8_product: torch._int_mm takes K and N in multiples of "
            f"{INT_MM_ALIGN}, not a ({M}, {K}) x ({K}, {N}) product")
    w_q = column_major(w_q)
    if M <= INT_MM_MIN_ROWS:
        pad = torch.zeros((INT_MM_MIN_ROWS + 1, K), dtype=torch.int8,
                          device=x_q.device)
        pad[:M] = x_q
        return torch._int_mm(pad, w_q)[:M]
    return torch._int_mm(x_q.contiguous(), w_q)


def int8_matmul(x: torch.Tensor, w_q: torch.Tensor,
                w_scale: torch.Tensor) -> torch.Tensor:
    """``x @ dequant(w_q)`` with dynamic per-token activation quantisation.

    ``x``: ``(..., in)`` activations (any float dtype); ``w_q``: ``(in,
    out)`` int8; ``w_scale``: ``(out,)`` f32.  Returns ``(..., out)`` in
    ``x.dtype``."""
    x_q, x_scale = quantize_activations(x)
    lead = x.shape[:-1]
    y = int8_product(x_q.reshape(-1, x.shape[-1]), w_q)
    y = y.reshape(*lead, w_q.shape[1])
    return (y.float() * x_scale * w_scale).to(x.dtype)


def int8_matmul_plain(x: torch.Tensor, w_q: torch.Tensor,
                      w_scale: torch.Tensor) -> torch.Tensor:
    """:func:`int8_matmul` through the plain twin on any device (the
    yardstick the card's product is held to)."""
    x_q, x_scale = quantize_activations(x)
    y = int8_product_plain(x_q.reshape(-1, x.shape[-1]), w_q)
    y = y.reshape(*x.shape[:-1], w_q.shape[1])
    return (y.float() * x_scale * w_scale).to(x.dtype)


def dense(x: torch.Tensor, p: dict, name: str) -> torch.Tensor:
    """``x @ p[name]``, or the int8 product where the dict carries the
    quantised ``<name>_q`` / ``<name>_s`` instead."""
    w_q = p.get(name + "_q")
    if w_q is not None:
        return int8_matmul(x, w_q, p[name + "_s"])
    return x @ p[name]
