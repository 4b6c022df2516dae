"""Building blocks of the reference: norms, products, convolutions,
resamplers, mask ops and losses, all in float32.  NHWC images, linear
weights ``(in, out)``, conv kernels HWIO."""

from __future__ import annotations

import torch
import torch.nn.functional as F


class NS(dict):
    """A configuration dict read by attribute, nested dicts included."""

    def __getattr__(self, key):
        try:
            value = self[key]
        except KeyError as e:
            raise AttributeError(key) from e
        return NS(value) if isinstance(value, dict) else value


def layer_norm(x, w, b, eps: float = 1e-6):
    mu = x.mean(-1, keepdim=True)
    var = ((x - mu) ** 2).mean(-1, keepdim=True)
    return (x - mu) * torch.rsqrt(var + eps) * w + b


def rms_norm(x, w, eps: float):
    return x * torch.rsqrt((x * x).mean(-1, keepdim=True) + eps) * w


def group_norm1(x, w, b, eps: float = 1e-5):
    """GroupNorm with one group over (H, W, C) of each NHWC sample."""
    mu = x.mean(dim=(1, 2, 3), keepdim=True)
    var = ((x - mu) ** 2).mean(dim=(1, 2, 3), keepdim=True)
    return (x - mu) * torch.rsqrt(var + eps) * w + b


def activation(x, kind: str):
    if kind == "gelu":
        return F.gelu(x)
    if kind == "gelu_tanh":
        return F.gelu(x, approximate="tanh")
    if kind == "quick_gelu":
        return x * torch.sigmoid(1.702 * x)
    if kind == "relu":
        return torch.relu(x)
    if kind == "silu":
        return F.silu(x)
    raise ValueError(kind)


def linear(x, p: dict):
    return x @ p["w"] + p["b"]


def mlp(x, layers: list):
    """ReLU between the layers, none after the last."""
    for i, p in enumerate(layers):
        x = linear(x, p)
        if i < len(layers) - 1:
            x = torch.relu(x)
    return x


def mlp_block(x, p: dict, act: str = "gelu"):
    return activation(x @ p["w1"] + p["b1"], act) @ p["w2"] + p["b2"]


def conv2d(x, kernel, bias=None, stride: int = 1, padding: int = 0):
    y = F.conv2d(x.permute(0, 3, 1, 2), kernel.permute(3, 2, 0, 1),
                 stride=stride, padding=padding).permute(0, 2, 3, 1)
    return y if bias is None else y + bias


def conv_transpose2d(x, kernel, bias=None):
    """Transposed conv with kernel size == stride: output pixel ``(i*s + a,
    j*s + b)`` takes ``kernel[s-1-a, s-1-b]``."""
    n, h, w, _ = x.shape
    k = kernel.shape[0]
    y = torch.einsum("nijc,abco->niajbo", x, kernel.flip(0, 1)).reshape(
        n, h * k, w * k, kernel.shape[3])
    return y if bias is None else y + bias


def _linear_1d(x, out_size: int, dim: int, scale: float):
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
    return x.index_select(dim, lo) * (1.0 - t) + x.index_select(dim, hi) * t


def resize_bilinear(x, out_hw, scale=None):
    """Bilinear, half-pixel centres, over the last two dims; ``scale``
    gives the coordinate map of a ``scale_factor=`` resize."""
    h, w = x.shape[-2], x.shape[-1]
    sy, sx = scale if scale is not None else (out_hw[0] / h, out_hw[1] / w)
    y = _linear_1d(x, out_hw[0], x.dim() - 2, sy)
    return _linear_1d(y, out_hw[1], x.dim() - 1, sx)


def resize_bicubic(x, out_hw):
    y = F.interpolate(x.reshape(1, -1, *x.shape[-2:]), size=tuple(out_hw),
                      mode="bicubic", align_corners=False)
    return y.reshape(*x.shape[:-2], *out_hw)


def affine_grid_sample(img, scale, offset, out_hw, fill=0.0, src_lo=None,
                       src_hi=None, mode: str = "fill"):
    """Bilinear sampling of ``(..., H, W)`` at ``(i + 0.5) * scale + offset
    - 0.5``; ``clamp`` clamps the coordinates into the ROI, ``fill`` reads
    ``fill`` for taps outside it."""
    h, w = img.shape[-2], img.shape[-1]
    oh, ow = out_hw
    dev = img.device
    lo = torch.zeros(2, device=dev) if src_lo is None else src_lo.float()
    hi = (torch.tensor([h - 1.0, w - 1.0], device=dev) if src_hi is None
          else src_hi.float())
    ys = (torch.arange(oh, dtype=torch.float32, device=dev) + 0.5) \
        * scale[0] + offset[0] - 0.5
    xs = (torch.arange(ow, dtype=torch.float32, device=dev) + 0.5) \
        * scale[1] + offset[1] - 0.5
    if mode == "clamp":
        ys = torch.minimum(torch.maximum(ys, lo[0]), hi[0])
        xs = torch.minimum(torch.maximum(xs, lo[1]), hi[1])
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

        def filled(v, iy, ix):
            m = (((iy >= lo[0]) & (iy <= hi[0]))[:, None]
                 & ((ix >= lo[1]) & (ix <= hi[1]))[None, :]).float()
            return v * m + fillv * (1.0 - m)

        v00, v01 = filled(v00, y0, x0), filled(v01, y0, x0 + 1)
        v10, v11 = filled(v10, y0 + 1, x0), filled(v11, y0 + 1, x0 + 1)
    top = v00 * (1.0 - wx) + v01 * wx
    bot = v10 * (1.0 - wx) + v11 * wx
    return top * (1.0 - wy) + bot * wy


def mean_merge_matrix(mask_ids, num_masks: int):
    """``(B, S, M)``: the product with token-major data gives per-mask
    means over the tokens of each mask."""
    cols = torch.arange(num_masks, device=mask_ids.device)
    onehot = (mask_ids[..., :, None] == cols).float()
    return onehot / onehot.sum(dim=-2, keepdim=True).clamp_min(1.0)


def mask_to_box(mask):
    """``[x0, y0, x1, y1]`` (exclusive max) of boolean masks; an empty mask
    gives the whole frame."""
    h, w = mask.shape[-2:]
    rows, cols = mask.any(dim=-1), mask.any(dim=-2)
    ridx = torch.arange(h, device=mask.device)
    cidx = torch.arange(w, device=mask.device)
    y0 = torch.where(rows, ridx, h).amin(dim=-1)
    y1 = torch.where(rows, ridx, -1).amax(dim=-1)
    x0 = torch.where(cols, cidx, w).amin(dim=-1)
    x1 = torch.where(cols, cidx, -1).amax(dim=-1)
    box = torch.stack([x0, y0, x1 + 1, y1 + 1], dim=-1).float()
    full = torch.tensor([0.0, 0.0, w, h], device=mask.device)
    return torch.where(rows.any(dim=-1)[..., None], box, full)


def rel_pos_coords(side: int, device):
    r = torch.arange(side, device=device)
    return r[:, None] - r[None, :] + side - 1


def bce_terms(logits, targets):
    return (0.5 * (logits + logits.abs()) - logits * targets
            + torch.log1p(torch.exp(-logits.abs())))


def grounding_losses(coarse_logits, gt_coarse, coarse_weight, sam_logits,
                     gt_sam, sam_weight, mask_valid) -> dict:
    """BCE + naive Dice (eps 1) of both heads: BCE as per-sample means over
    the valid pixels weighted by each sample's mask count, Dice per valid
    mask.  Returns the ``loss`` and its ``coarse`` and ``sam`` parts."""
    B, M = mask_valid.shape
    mv = mask_valid.float()
    m_s = mv.sum(1)
    m_norm = m_s.sum().clamp_min(1.0)

    def head(logits, gt, pix_w):
        w = torch.broadcast_to(pix_w[:, None] * mv[:, :, None, None],
                               logits.shape)
        num = (bce_terms(logits, gt) * w).sum(dim=(2, 3)).sum(1)
        den = w.sum(dim=(1, 2, 3)).clamp_min(1.0)
        bce = ((num / den) * m_s).sum() / m_norm
        p = (torch.sigmoid(logits) * w).reshape(B * M, -1)
        t = (gt * w).reshape(B * M, -1)
        dice = 1.0 - (2.0 * (p * t).sum(-1) + 1.0) / (
            p.sum(-1) + t.sum(-1) + 1.0)
        dice = (dice * mv.reshape(-1)).sum() / mv.sum().clamp_min(1.0)
        return bce + dice

    coarse = head(coarse_logits, gt_coarse, coarse_weight)
    sam = head(sam_logits, gt_sam, sam_weight)
    return {"loss": coarse + sam, "coarse": coarse, "sam": sam}
