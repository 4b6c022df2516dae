"""K11: the window-major <-> spatial relayout of the SAM encoder's token
grid (flmm_tpu/ops/boundary.py::windowize and ::dewindowize).

``windowize`` turns ``(B, H, W, C)`` into window-major ``(NW, ws*ws, C)``
with the grid zero-padded up to whole windows, and returns the geometry
tuple ``(B, H, W, Hp, Wp)``; ``dewindowize`` goes back and crops.  Both are
pure copies, so on an H100 the bytes bound them: csrc/boundary.cu moves
16-byte vectors, writes the pad slots itself and reads only valid tokens,
where the plain versions make a padded copy and a permuted copy.  The
wrappers launch the kernels for CUDA tensors and take the plain versions
only for CPU tensors; the result equals the plain version bit for bit.

The plain versions are the encoder's own relayout
(``models/sam/image_encoder.py`` imports them): as in the JAX package, the
encoder keeps calling the plain pair and the kernels' caller is the kernel
bench's ``boundary`` op.
"""

from __future__ import annotations

import torch

from flmm_tpu_torch.ops import _cuda

DTYPES = (torch.bfloat16, torch.float32)


def windowize_plain(x: torch.Tensor, ws: int):
    """(B, H, W, C) -> window-major (B*nwy*nwx, ws*ws, C) + geometry; the
    grid is zero-padded up to whole windows."""
    B, H, W, C = x.shape
    pad_h = (ws - H % ws) % ws
    pad_w = (ws - W % ws) % ws
    xp = torch.nn.functional.pad(x, (0, 0, 0, pad_w, 0, pad_h))
    Hp, Wp = H + pad_h, W + pad_w
    xw = xp.reshape(B, Hp // ws, ws, Wp // ws, ws, C)
    xw = xw.permute(0, 1, 3, 2, 4, 5).reshape(-1, ws * ws, C)
    return xw, (B, H, W, Hp, Wp)


def dewindowize_plain(xw: torch.Tensor, geom: tuple, ws: int) -> torch.Tensor:
    """Window-major (NW, ws*ws, C) -> (B, H, W, C), cropped to the grid."""
    B, H, W, Hp, Wp = geom
    C = xw.shape[-1]
    x = xw.reshape(B, Hp // ws, Wp // ws, ws, ws, C)
    x = x.permute(0, 1, 3, 2, 4, 5).reshape(B, Hp, Wp, C)
    return x[:, :H, :W]


def _vectors_per_token(name: str, t: torch.Tensor) -> int:
    """Check what the kernels read and return C * itemsize / 16."""
    _cuda.check_cuda(name, t, dtype=t.dtype)
    row_bytes = t.shape[-1] * t.element_size()
    if t.dtype not in DTYPES or row_bytes % 16:
        raise ValueError(f"{name}: kernel built for {DTYPES} with a token row "
                         f"that is a multiple of 16 bytes, got {t.dtype} and "
                         f"{row_bytes} bytes")
    return row_bytes // 16


def windowize(x: torch.Tensor, ws: int):
    """``(B, H, W, C)`` spatial -> window-major ``(NW, T, C)`` + geometry
    (K11b; drop-in for the encoder's relayout)."""
    _cuda.check_no_grad("windowize", x)
    if not x.is_cuda:
        return windowize_plain(x, ws)
    if x.dim() != 4:
        raise ValueError(f"windowize: x {tuple(x.shape)} is not (B, H, W, C)")
    B, H, W, C = x.shape
    Hp, Wp = -(-H // ws) * ws, -(-W // ws) * ws
    vpt = _vectors_per_token("windowize", x)
    out = torch.empty((B * (Hp // ws) * (Wp // ws), ws * ws, C),
                      dtype=x.dtype, device=x.device)
    _cuda.launch("flmm_windowize", x.data_ptr(), out.data_ptr(), B, H, W, Hp,
                 Wp, ws, vpt, _cuda.stream(x))
    windowize.launches += 1
    return out, (B, H, W, Hp, Wp)


windowize.launches = 0


def dewindowize(xw: torch.Tensor, geom: tuple, ws: int) -> torch.Tensor:
    """``(NW, T, C)`` window-major -> ``(B, H, W, C)`` spatial, cropped
    (K11a); the result is contiguous."""
    _cuda.check_no_grad("dewindowize", xw)
    if not xw.is_cuda:
        return dewindowize_plain(xw, geom, ws)
    B, H, W, Hp, Wp = geom
    C = xw.shape[-1]
    if (xw.dim() != 3 or Hp % ws or Wp % ws or H > Hp or W > Wp
            or xw.shape[:2] != (B * (Hp // ws) * (Wp // ws), ws * ws)):
        raise ValueError(f"dewindowize: xw {tuple(xw.shape)} does not match "
                         f"geometry {geom} with windows of {ws}")
    vpt = _vectors_per_token("dewindowize", xw)
    out = torch.empty((B, H, W, C), dtype=xw.dtype, device=xw.device)
    _cuda.launch("flmm_dewindowize", xw.data_ptr(), out.data_ptr(), B, H, W,
                 Hp, Wp, ws, vpt, _cuda.stream(xw))
    dewindowize.launches += 1
    return out


dewindowize.launches = 0
