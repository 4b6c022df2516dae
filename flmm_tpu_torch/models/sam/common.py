"""Shared SAM building blocks (flmm_tpu/models/sam/common.py), NHWC.

Linear weights are ``(in, out)`` and applied as ``x @ w``; conv kernels are
HWIO, as in the JAX parameter tree.  :func:`mlp_block` takes the int8
product where the dict carries ``w1_q`` / ``w2_q`` (ops/quant.py).
"""

from __future__ import annotations

import torch
import torch.nn.functional as F

from flmm_tpu_torch.ops.quant import dense
from flmm_tpu_torch.parallel import frozen as shard


def layer_norm(x: torch.Tensor, w: torch.Tensor, b: torch.Tensor,
               eps: float = 1e-6) -> torch.Tensor:
    """LayerNorm over the last axis, statistics in f32, result in x.dtype."""
    xf = x.float()
    mu = xf.mean(-1, keepdim=True)
    var = ((xf - mu) ** 2).mean(-1, keepdim=True)
    y = (xf - mu) * torch.rsqrt(var + eps)
    return (y * w.float() + b.float()).to(x.dtype)


def channel_norm(x, w, b, eps: float = 1e-6):
    """Reference ``LayerNorm2d``: over the channel axis, which is last in
    NHWC -- the same reduction as :func:`layer_norm`."""
    return layer_norm(x, w, b, eps)


def mlp_block(x: torch.Tensor, p: dict, act: str = "gelu",
              tp=None) -> torch.Tensor:
    """Two-layer MLP; under tp (``p`` holds this rank's columns of ``w1``
    and rows of ``w2``) the second product is summed over the model axis
    before the replicated ``b2`` is added."""
    h = dense(x, p, "w1") + p["b1"]
    if act == "gelu":
        h = F.gelu(h)
    elif act == "relu":
        h = torch.relu(h)
    else:
        raise ValueError(act)
    if tp is not None:
        return shard.row_product(h, p["w2"], tp, h.dtype) + p["b2"]
    return dense(h, p, "w2") + p["b2"]


def linear(x: torch.Tensor, p: dict) -> torch.Tensor:
    return x @ p["w"] + p["b"]


def mlp(x: torch.Tensor, layers: list, sigmoid_output: bool = False):
    """Reference mask_decoder.MLP: ReLU between layers, none at the end."""
    n = len(layers)
    for i, p in enumerate(layers):
        x = linear(x, p)
        if i < n - 1:
            x = torch.relu(x)
    if sigmoid_output:
        x = torch.sigmoid(x)
    return x


def conv2d(x: torch.Tensor, kernel: torch.Tensor,
           bias: torch.Tensor | None = None, stride: int = 1,
           padding: int = 0) -> torch.Tensor:
    """NHWC conv with an HWIO kernel; returns a contiguous NHWC tensor."""
    y = F.conv2d(x.permute(0, 3, 1, 2), kernel.to(x.dtype).permute(3, 2, 0, 1),
                 stride=stride, padding=padding)
    y = y.permute(0, 2, 3, 1).contiguous()
    if bias is not None:
        y = y + bias.to(y.dtype)
    return y


def conv_transpose2d(x: torch.Tensor, kernel: torch.Tensor,
                     bias: torch.Tensor | None = None,
                     stride: int = 2) -> torch.Tensor:
    """NHWC transposed conv with kernel size == stride, as
    ``jax.lax.conv_transpose(..., "VALID")`` computes it with an HWIO kernel:
    output pixel ``(i*s + a, j*s + b)`` takes ``kernel[s-1-a, s-1-b]``."""
    n, h, w, _ = x.shape
    k = kernel.shape[0]
    if kernel.shape[1] != k or k != stride:
        raise ValueError(f"conv_transpose2d: kernel {tuple(kernel.shape)} "
                         f"with stride {stride}")
    kf = kernel.flip(0, 1).to(x.dtype)
    y = torch.einsum("nijc,abco->niajbo", x, kf).reshape(
        n, h * k, w * k, kernel.shape[3])
    if bias is not None:
        y = y + bias.to(y.dtype)
    return y
