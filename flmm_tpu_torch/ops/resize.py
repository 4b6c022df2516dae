"""Resize primitives with PyTorch's sampling conventions
(flmm_tpu/ops/resize.py): nearest with the legacy asymmetric floor,
``align_corners=False`` bilinear and bicubic resize and the affine
grid-sample that replaces the reference's crop -> resize -> pad chains."""

from __future__ import annotations

import torch


def resize_nearest_torch(x: torch.Tensor,
                         out_hw: tuple[int, int]) -> torch.Tensor:
    """``F.interpolate(mode='nearest')`` over the last two dims: source
    index ``floor(dst * in / out)``, computed in f32 as the JAX gather
    does."""
    h, w = x.shape[-2], x.shape[-1]
    oh, ow = out_hw

    def src(n_out: int, n_in: int) -> torch.Tensor:
        pos = torch.arange(n_out, dtype=torch.float32, device=x.device)
        return torch.floor(pos * torch.tensor(
            n_in / n_out, dtype=torch.float32)).long()

    return x.index_select(-2, src(oh, h)).index_select(-1, src(ow, w))


def _linear_1d(x: torch.Tensor, out_size: int, dim: int,
               scale: float) -> torch.Tensor:
    """1-D linear resample, ``src = (dst + 0.5) / scale - 0.5``, edge taps
    clamped."""
    n = x.shape[dim]
    pos = (torch.arange(out_size, dtype=torch.float32, device=x.device)
           + 0.5) / scale - 0.5
    i0 = torch.floor(pos)
    t = (pos - i0).clamp(0.0, 1.0)
    lo = i0.clamp(0, n - 1).long()
    hi = (i0 + 1).clamp(0, n - 1).long()
    shape = [1] * x.dim()
    shape[dim] = out_size
    t = t.reshape(shape)
    return (x.index_select(dim, lo) * (1.0 - t)
            + x.index_select(dim, hi) * t)


def resize_bilinear(x: torch.Tensor, out_hw: tuple[int, int],
                    scale: tuple[float, float] | None = None) -> torch.Tensor:
    """``F.interpolate(mode='bilinear', align_corners=False)`` over the last
    two dims, computed in f32 and cast back.

    ``scale``: when given, torch's ``scale_factor=`` coordinate map
    ``src = (dst + 0.5) / scale - 0.5`` with the given scale, not
    ``out / in`` (the U-Net input upsample).
    """
    dtype = x.dtype
    h, w = x.shape[-2], x.shape[-1]
    sy, sx = scale if scale is not None else (out_hw[0] / h, out_hw[1] / w)
    y = _linear_1d(x.float(), out_hw[0], x.dim() - 2, sy)
    y = _linear_1d(y, out_hw[1], x.dim() - 1, sx)
    return y.to(dtype)


def resize_bicubic(x: torch.Tensor, out_hw: tuple[int, int]) -> torch.Tensor:
    """Bicubic resize over the last two dims (Keys kernel at a = -0.75,
    half-pixel centres, border clamp: flmm_tpu/ops/resize.py::resize_bicubic
    carries torch's own ``F.interpolate(mode='bicubic',
    align_corners=False)`` over), computed in f32 and cast back."""
    y = torch.nn.functional.interpolate(
        x.float().reshape(1, -1, *x.shape[-2:]), size=tuple(out_hw),
        mode="bicubic", align_corners=False)
    return y.reshape(*x.shape[:-2], *out_hw).to(x.dtype)


def affine_grid_sample(img: torch.Tensor, scale: torch.Tensor,
                       offset: torch.Tensor, out_hw: tuple[int, int],
                       fill: torch.Tensor | float = 0.0,
                       src_lo: torch.Tensor | None = None,
                       src_hi: torch.Tensor | None = None,
                       mode: str = "fill") -> torch.Tensor:
    """Bilinear sampling of ``img`` ``(..., H, W)`` on an axis-aligned grid.

    Output pixel ``(i, j)`` samples the source at
    ``((i + 0.5) * scale[0] + offset[0] - 0.5, (j + 0.5) * scale[1] +
    offset[1] - 0.5)``.  Within the inclusive ROI ``[src_lo, src_hi]``
    (default: the whole image), ``mode='clamp'`` clamps the coordinates into
    the ROI (crop, then resize) and ``mode='fill'`` reads ``fill`` for taps
    outside it (pad with ``fill``, then resize).
    """
    dtype = img.dtype
    img = img.float()
    h, w = img.shape[-2], img.shape[-1]
    oh, ow = out_hw
    dev = img.device
    lo = (torch.zeros(2, device=dev) if src_lo is None else src_lo.float())
    hi = (torch.tensor([h - 1.0, w - 1.0], device=dev) if src_hi is None
          else src_hi.float())
    ys = (torch.arange(oh, dtype=torch.float32, device=dev) + 0.5) \
        * scale[0] + offset[0] - 0.5
    xs = (torch.arange(ow, dtype=torch.float32, device=dev) + 0.5) \
        * scale[1] + offset[1] - 0.5
    if mode == "clamp":
        ys = torch.minimum(torch.maximum(ys, lo[0]), hi[0])
        xs = torch.minimum(torch.maximum(xs, lo[1]), hi[1])
    elif mode != "fill":
        raise ValueError(f"unknown mode {mode!r}")

    y0, x0 = torch.floor(ys), torch.floor(xs)
    wy = (ys - y0)[:, None]
    wx = xs - x0

    def taps(iy, ix):
        rows = img.index_select(-2, iy.clamp(0, h - 1).long())
        return rows.index_select(-1, ix.clamp(0, w - 1).long())

    v00, v01 = taps(y0, x0), taps(y0, x0 + 1)
    v10, v11 = taps(y0 + 1, x0), taps(y0 + 1, x0 + 1)
    if mode == "fill":
        fillv = torch.as_tensor(fill, dtype=torch.float32, device=dev)

        def inside(iy, ix):
            vy = (iy >= lo[0]) & (iy <= hi[0])
            vx = (ix >= lo[1]) & (ix <= hi[1])
            return (vy[:, None] & vx[None, :]).float()

        def filled(v, m):
            return v * m + fillv * (1.0 - m)

        v00 = filled(v00, inside(y0, x0))
        v01 = filled(v01, inside(y0, x0 + 1))
        v10 = filled(v10, inside(y0 + 1, x0))
        v11 = filled(v11, inside(y0 + 1, x0 + 1))
    top = v00 * (1.0 - wx) + v01 * wx
    bot = v10 * (1.0 - wx) + v11 * wx
    return (top * (1.0 - wy) + bot * wy).to(dtype)
