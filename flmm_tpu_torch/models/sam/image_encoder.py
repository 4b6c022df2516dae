"""SAM ViTDet image encoder (flmm_tpu/models/sam/image_encoder.py), frozen.

NHWC throughout.  On a CUDA tensor the encoder takes the JAX package's
kernel path, with the backend test ``x.is_cuda``:

* runs of window blocks stay window-major ``(NW, T, C)`` and go through K1
  (:func:`flmm_tpu_torch.ops.window_block.window_block`) when the grid has
  at least 25 windows per image (SAM at 1024);
* other window blocks (the reduced-resolution schedule, e.g. SAM-448 with
  2x2 windows per image) take the split path: K3 (LN1 + qkv), K6 (window
  attention, :func:`flmm_tpu_torch.ops.sam_flash.sam_window_attention_v9`)
  and K4 (out-proj + LN2 + MLP);
* global blocks go through K3, K2 (attention) and K4; with
  ``global_block_fused`` beside the whole-block window path they go through
  K10 (:func:`flmm_tpu_torch.ops.global_block.global_attn_block`: LN1 + qkv
  + attention + out-proj + residual, f32 result, rounded here once) and K8
  (:func:`flmm_tpu_torch.ops.fused_block.fused_ln_mlp`: LN2 + MLP).

K3 and K4 need the fused-MLP gate (``fused_mlp``, C % 128, F % 512);
without it the attention kernel runs between the plain LN + qkv and the
plain out-proj + MLP.  Everything else, and every CPU tensor, takes the
plain path.  Pad tokens of a grid that does not divide into windows get
``k = b_k`` and ``v = b_v`` and stay in the softmax on every path, as in
the reference.  Not ported yet: the superseded kernel variants (K12) and
the int8 encoder.
"""

from __future__ import annotations

import dataclasses
import math

import torch

from flmm_tpu_torch.models.sam.common import channel_norm, conv2d, layer_norm, mlp_block
from flmm_tpu_torch.ops import global_block as gb
from flmm_tpu_torch.ops import window_block as wb
from flmm_tpu_torch.ops.fused_block import fused_ln_mlp, fused_ln_qkv, \
    fused_proj_ln_mlp
from flmm_tpu_torch.ops.sam_flash import rel_pos_coords, sam_global_attention_v8, \
    sam_window_attention_v9


@dataclasses.dataclass(frozen=True)
class SamEncoderConfig:
    img_size: int = 1024
    patch_size: int = 16
    embed_dim: int = 1024  # vit_l
    depth: int = 24
    num_heads: int = 16
    mlp_ratio: float = 4.0
    out_chans: int = 256
    window_size: int = 14
    global_attn_indexes: tuple = (5, 11, 17, 23)
    ln_eps: float = 1e-6
    flash_global: bool = False
    flash_window: bool = False
    global_kernel: str = "v8"
    window_kernel: str = "v9"
    fused_mlp: bool = True
    window_block_fused: bool = False
    global_block_fused: bool = False
    dtype: torch.dtype = torch.float32

    def __post_init__(self):
        if self.global_kernel != "v8" or self.window_kernel != "v9":
            raise NotImplementedError(
                "only the production kernels (global v8, window v9) exist "
                "in the port; the replay variants are not ported")

    @property
    def grid(self) -> int:
        return self.img_size // self.patch_size

    @property
    def head_dim(self) -> int:
        return self.embed_dim // self.num_heads


def init_params(cfg: SamEncoderConfig, generator: torch.Generator,
                device) -> dict:
    """Random encoder weights with the JAX tree's keys, shapes and dtypes."""
    d = cfg.embed_dim
    f = int(d * cfg.mlp_ratio)

    def w(shape, fan_in):
        return (torch.randn(shape, generator=generator, device=device)
                / math.sqrt(fan_in)).to(cfg.dtype)

    def full(shape, value):
        return torch.full(shape, value, dtype=cfg.dtype, device=device)

    blocks = []
    for i in range(cfg.depth):
        size = cfg.grid if i in cfg.global_attn_indexes else cfg.window_size
        blocks.append({
            "ln1_w": full((d,), 1.0), "ln1_b": full((d,), 0.0),
            "ln2_w": full((d,), 1.0), "ln2_b": full((d,), 0.0),
            "wqkv": w((d, 3 * d), d), "bqkv": full((3 * d,), 0.0),
            "wo": w((d, d), d), "bo": full((d,), 0.0),
            "mlp": {
                "w1": w((d, f), d), "b1": full((f,), 0.0),
                "w2": w((f, d), f), "b2": full((d,), 0.0),
            },
            "rel_pos_h": full((2 * size - 1, cfg.head_dim), 0.0),
            "rel_pos_w": full((2 * size - 1, cfg.head_dim), 0.0),
        })
    return {
        "patch_kernel": w((cfg.patch_size, cfg.patch_size, 3, d),
                          3 * cfg.patch_size ** 2),
        "patch_bias": full((d,), 0.0),
        "pos_embed": full((cfg.grid, cfg.grid, d), 0.0),
        "neck0_kernel": w((1, 1, d, cfg.out_chans), d),
        "neck0_ln_w": full((cfg.out_chans,), 1.0),
        "neck0_ln_b": full((cfg.out_chans,), 0.0),
        "neck1_kernel": w((3, 3, cfg.out_chans, cfg.out_chans),
                          9 * cfg.out_chans),
        "neck1_ln_w": full((cfg.out_chans,), 1.0),
        "neck1_ln_b": full((cfg.out_chans,), 0.0),
        "blocks": blocks,
    }


def _attention(x: torch.Tensor, bp: dict, cfg: SamEncoderConfig):
    """Plain windowless attention over ``(B', H', W', C)`` with decomposed
    rel-pos bias; for the 64x64 global grid the scores are chunked over
    query rows (image_encoder.py:176-188) so at most ~2M rows x keys exist
    per image at a time."""
    B, H, W, C = x.shape
    nh, hd = cfg.num_heads, cfg.head_dim
    qkv = x.reshape(B, H * W, C) @ bp["wqkv"] + bp["bqkv"]
    q, k, v = (t.reshape(B, H * W, nh, hd) for t in qkv.split(C, dim=-1))
    scale = 1.0 / math.sqrt(hd)
    rh = bp["rel_pos_h"].float()[rel_pos_coords(H, x.device)]  # (H, H, hd)
    rw = bp["rel_pos_w"].float()[rel_pos_coords(W, x.device)]
    kf = k.float().permute(0, 2, 3, 1)  # (B, nh, hd, HW)
    vh = v.transpose(1, 2)  # (B, nh, HW, hd)

    def attend(q_rows, rh_rows):
        """q_rows: (B, h', W, nh, hd); rh_rows: (h', H, hd)."""
        hq = q_rows.shape[1]
        rqf = q_rows.float()
        qf = rqf.reshape(B, hq * W, nh, hd).transpose(1, 2)
        logits = (qf @ kf) * scale  # (B, nh, hq*W, HW)
        bias_h = torch.einsum("byxhd,ykd->bhyxk", rqf, rh_rows)
        bias_w = torch.einsum("byxhd,xkd->bhyxk", rqf, rw)
        logits = logits.reshape(B, nh, hq, W, H, W)
        logits = logits + bias_h[..., :, None] + bias_w[..., None, :]
        logits = logits.reshape(B, nh, hq * W, H * W)
        probs = torch.softmax(logits, dim=-1).to(x.dtype)
        return (probs @ vh).transpose(1, 2).reshape(B, hq * W, C)

    q_grid = q.reshape(B, H, W, nh, hd)
    rows_per_chunk = max(1, min(H, (1 << 21) // max(1, H * W * W)))
    if H % rows_per_chunk != 0 or H * W <= 4096 // 2:
        out = attend(q_grid, rh)
    else:
        out = torch.cat([
            attend(q_grid[:, r0:r0 + rows_per_chunk],
                   rh[r0:r0 + rows_per_chunk])
            for r0 in range(0, H, rows_per_chunk)], dim=1)
    return (out @ bp["wo"] + bp["bo"]).reshape(B, H, W, C)


def _flash_global_core(qkv: torch.Tensor, bp: dict, cfg: SamEncoderConfig):
    """Global attention core through K2: ``(B, H, W, 3C) -> (B, H, W, C)``."""
    B, H, W, C3 = qkv.shape
    C = C3 // 3
    nh, hd = cfg.num_heads, cfg.head_dim

    def heads(t):
        return t.reshape(B, H * W, nh, hd).transpose(1, 2).reshape(
            B * nh, H * W, hd).contiguous()

    q, k, v = qkv.reshape(B, H * W, C3).split(C, dim=-1)
    out = sam_global_attention_v8(heads(q), heads(k), heads(v),
                                  bp["rel_pos_h"], bp["rel_pos_w"], H)
    return out.reshape(B, nh, H * W, hd).transpose(1, 2).reshape(B, H, W, C)


def _flash_window_core(qkv: torch.Tensor, bp: dict, cfg: SamEncoderConfig):
    """Windowed attention core through K6: ``(B, H, W, 3C) -> (B, H, W, C)``.

    The grid is padded to whole windows with the ``bqkv`` row, which is what
    a zero-padded LN output projects to: pad tokens keep ``k = b_k`` and
    ``v = b_v``, as on the plain path and in the reference (the JAX
    ``_flash_window_core`` pads qkv with zeros instead).  One relayout makes
    the qkv window-major; K6 reads q, k and v out of it as ``(NW, nh, T,
    hd)`` strided views."""
    B, H, W, C3 = qkv.shape
    C = C3 // 3
    ws, nh, hd = cfg.window_size, cfg.num_heads, cfg.head_dim
    pad_h, pad_w = (ws - H % ws) % ws, (ws - W % ws) % ws
    Hp, Wp = H + pad_h, W + pad_w
    if pad_h or pad_w:
        qkvp = bp["bqkv"].to(qkv.dtype).expand(B, Hp, Wp, C3).clone()
        qkvp[:, :H, :W] = qkv
    else:
        qkvp = qkv
    T = ws * ws
    qkvw = qkvp.reshape(B, Hp // ws, ws, Wp // ws, ws, C3).permute(
        0, 1, 3, 2, 4, 5).reshape(-1, T, C3)
    nw = qkvw.shape[0]

    def heads(i):
        return qkvw[..., i * C:(i + 1) * C].reshape(nw, T, nh, hd).transpose(
            1, 2)

    out = sam_window_attention_v9(heads(0), heads(1), heads(2),
                                  bp["rel_pos_h"], bp["rel_pos_w"], ws)
    out = out.transpose(1, 2).reshape(B, Hp // ws, Wp // ws, ws, ws, C)
    out = out.permute(0, 1, 3, 2, 4, 5).reshape(B, Hp, Wp, C)
    return out[:, :H, :W]


def _flash_block(x: torch.Tensor, bp: dict, cfg: SamEncoderConfig,
                 windowed: bool):
    """One block through the attention kernel (K6 windowed, K2 global),
    with K3 before and K4 after it when the fused-MLP gate holds.  The CUDA
    gate is the caller's; on CPU tensors every wrapper takes its plain
    version."""
    B, H, W, C = x.shape
    mlp = bp["mlp"]
    fused = cfg.fused_mlp and C % 128 == 0 and mlp["w1"].shape[1] % 512 == 0
    if fused:
        qkv = fused_ln_qkv(x, bp["ln1_w"], bp["ln1_b"], bp["wqkv"],
                           bp["bqkv"], eps=cfg.ln_eps)
    else:
        y = layer_norm(x, bp["ln1_w"], bp["ln1_b"], cfg.ln_eps)
        qkv = y.reshape(B, H * W, C) @ bp["wqkv"] + bp["bqkv"]
    core = _flash_window_core if windowed else _flash_global_core
    attn = core(qkv.reshape(B, H, W, 3 * C), bp, cfg)
    if fused:
        return fused_proj_ln_mlp(
            x, attn, bp["wo"], bp["bo"], bp["ln2_w"], bp["ln2_b"],
            mlp["w1"], mlp["b1"], mlp["w2"], mlp["b2"], eps=cfg.ln_eps)
    x = x + (attn.reshape(B, H * W, C) @ bp["wo"]
             + bp["bo"]).reshape(B, H, W, C)
    return x + mlp_block(layer_norm(x, bp["ln2_w"], bp["ln2_b"],
                                    cfg.ln_eps), mlp)


def _ln_mlp_residual(x: torch.Tensor, bp: dict, cfg: SamEncoderConfig):
    """``x + MLP(LN2(x))`` over ``(B, H, W, C)``: K8 on a CUDA tensor when
    the shapes tile, else plain."""
    B, H, W, C = x.shape
    mlp = bp["mlp"]
    if (cfg.fused_mlp and x.is_cuda and (B * H * W) % 256 == 0
            and C % 128 == 0 and mlp["w1"].shape[1] % 512 == 0):
        return fused_ln_mlp(x, bp["ln2_w"], bp["ln2_b"], mlp["w1"], mlp["b1"],
                            mlp["w2"], mlp["b2"], eps=cfg.ln_eps)
    y = layer_norm(x, bp["ln2_w"], bp["ln2_b"], cfg.ln_eps)
    return x + mlp_block(y, mlp)


def _block(x: torch.Tensor, bp: dict, cfg: SamEncoderConfig, windowed: bool):
    B, H, W, C = x.shape
    flash = cfg.flash_window if windowed else (cfg.flash_global and H == W)
    if flash and x.is_cuda:
        return _flash_block(x, bp, cfg, windowed)
    shortcut = x
    x = layer_norm(x, bp["ln1_w"], bp["ln1_b"], cfg.ln_eps)
    if windowed:
        xw, geom = _windowize(x, cfg.window_size)
        ws = cfg.window_size
        xw = _attention(xw.reshape(-1, ws, ws, C), bp, cfg)
        x = _dewindowize(xw.reshape(-1, ws * ws, C), geom, ws)
    else:
        x = _attention(x, bp, cfg)
    x = shortcut + x
    y = layer_norm(x, bp["ln2_w"], bp["ln2_b"], cfg.ln_eps)
    return x + mlp_block(y, bp["mlp"])


def _windowize(x: torch.Tensor, ws: int):
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


def _dewindowize(xw: torch.Tensor, geom: tuple, ws: int) -> torch.Tensor:
    B, H, W, Hp, Wp = geom
    C = xw.shape[-1]
    x = xw.reshape(B, Hp // ws, Wp // ws, ws, ws, C)
    x = x.permute(0, 1, 3, 2, 4, 5).reshape(B, Hp, Wp, C)
    return x[:, :H, :W]


def _window_valid_tokens(geom: tuple, ws: int, device):
    """(NW, T) bool -- False on geometric pad slots; None when no pad."""
    B, H, W, Hp, Wp = geom
    if Hp == H and Wp == W:
        return None
    v = torch.zeros((Hp, Wp), dtype=torch.bool, device=device)
    v[:H, :W] = True
    vw = v.reshape(Hp // ws, ws, Wp // ws, ws).permute(0, 2, 1, 3)
    return vw.reshape(-1, ws * ws).repeat(B, 1)


def _window_block_fused(xw, bp, cfg: SamEncoderConfig, valid):
    """One whole window block in window-major layout through K1; only the
    thin rel-pos bias rows are computed outside, from the residual stream."""
    nh, hd, ws = cfg.num_heads, cfg.head_dim, cfg.window_size
    w_s, b_s = wb.scaled_qkv_weights(bp["wqkv"], bp["bqkv"], nh, hd)
    C = cfg.embed_dim
    bias = wb.window_rel_bias_from_x(
        xw, valid, bp["ln1_w"], bp["ln1_b"], w_s[:, :C], b_s[:C],
        bp["rel_pos_h"], bp["rel_pos_w"], ws, nh, hd, eps=cfg.ln_eps)
    mlp = bp["mlp"]
    return wb.window_block(
        xw, bias, valid, bp["ln1_w"], bp["ln1_b"], w_s, b_s,
        bp["wo"], bp["bo"], bp["ln2_w"], bp["ln2_b"],
        mlp["w1"], mlp["b1"], mlp["w2"], mlp["b2"], ws, nh, eps=cfg.ln_eps)


def _global_block_fused(x: torch.Tensor, bp: dict, cfg: SamEncoderConfig):
    """One whole global block: K10 for the attention half, whose f32 result
    is rounded to ``cfg.dtype`` here, once; then LN2 + MLP (K8).  The thin
    rel-pos bias rows are computed outside, from the residual stream."""
    B, H, W, C = x.shape
    nh, hd = cfg.num_heads, cfg.head_dim
    w_s, b_s = wb.scaled_qkv_weights(bp["wqkv"], bp["bqkv"], nh, hd)
    xs = x.reshape(B, H * W, C)
    bias = gb.global_rel_bias_from_x(
        xs, bp["ln1_w"], bp["ln1_b"], w_s[:, :C], b_s[:C],
        bp["rel_pos_h"], bp["rel_pos_w"], H, nh, hd, eps=cfg.ln_eps)
    o = gb.global_attn_block(
        xs, bias, bp["ln1_w"], bp["ln1_b"], w_s, b_s, bp["wo"], bp["bo"], H,
        nh, eps=cfg.ln_eps)
    return _ln_mlp_residual(o.to(cfg.dtype).reshape(B, H, W, C), bp, cfg)


def forward(params: dict, cfg: SamEncoderConfig,
            pixels: torch.Tensor) -> torch.Tensor:
    """Encode normalised, corner-padded ``(B, img, img, 3)`` images into
    ``(B, grid, grid, out_chans)`` NHWC embeddings."""
    x = conv2d(pixels.to(cfg.dtype), params["patch_kernel"],
               params["patch_bias"], stride=cfg.patch_size)
    x = x + params["pos_embed"].to(x.dtype)
    ws = cfg.window_size
    n_win_img = -(-x.shape[1] // ws) * -(-x.shape[2] // ws)
    use_wb = (cfg.window_block_fused and n_win_img >= 25 and x.is_cuda
              and cfg.embed_dim % 128 == 0)
    xw = geom = valid = None
    for i, bp in enumerate(params["blocks"]):
        windowed = i not in cfg.global_attn_indexes
        if use_wb and windowed:
            if xw is None:
                xw, geom = _windowize(x, ws)
                xw = xw.contiguous()
                valid = _window_valid_tokens(geom, ws, x.device)
            xw = _window_block_fused(xw, bp, cfg, valid)
        else:
            if xw is not None:
                x = _dewindowize(xw, geom, ws)
                xw = None
            if (cfg.global_block_fused and use_wb and not windowed
                    and x.shape[1] == x.shape[2]
                    and (x.shape[1] * x.shape[2]) % 256 == 0):
                x = _global_block_fused(x, bp, cfg)
            else:
                x = _block(x, bp, cfg, windowed=windowed)
    if xw is not None:
        x = _dewindowize(xw, geom, ws)
    x = conv2d(x, params["neck0_kernel"])
    x = channel_norm(x, params["neck0_ln_w"], params["neck0_ln_b"], cfg.ln_eps)
    x = conv2d(x, params["neck1_kernel"], padding=1)
    x = channel_norm(x, params["neck1_ln_w"], params["neck1_ln_b"], cfg.ln_eps)
    return x
