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
the reference.  The window relayout is the plain pair of ops/boundary.py, as
in the JAX encoder (the K11 kernels' caller is the kernel bench).
``global_kernel`` picks the global attention kernel of the split path: K2
(``v8``) or one of the bake-off variants ``v1``, ``v2``, ``v3``, ``v4``,
``v6``, ``v7``, ``v11`` (ops/sam_flash_experiments.py), which run only on a
grid of a multiple of 128 tokens, as in the JAX encoder (``v8`` masks any
grid); a grid that a variant's own tiling refuses (``v1`` at SAM-768) raises
in its wrapper.  ``window_kernel`` picks the window attention kernel of the
split path: K6 (``v9``) or one of the ported variants ``v1``, ``v2``,
``v6``, ``v7``, ``v8``; at SAM-1024 with ``window_block_fused`` every window
layer is K1 and the name launches nothing.  Not ported yet: the
augmented-operand window variants ``v3``, ``v4``, ``v5`` (K12; the spatial
window attention v10 is ported, but has another contract and no encoder
setting reaches it).

An encoder from :func:`quantize_params` carries ``<name>_q`` / ``<name>_s``
in place of ``wqkv``, ``wo``, ``w1`` and ``w2``: its projections take the
int8 product of ops/quant.py, and every kernel that reads the plain weights
(K1, K10, K3, K4, K8) closes its gate, as in the JAX encoder.  Such a block
takes the split path with the int8 products around the attention kernel:
K6 in the window layers, K2 (or the named variant) in the global ones.
"""

from __future__ import annotations

import dataclasses
import math

import torch

from flmm_tpu_torch import trace
from flmm_tpu_torch.models.sam.common import channel_norm, conv2d, layer_norm, mlp_block
from flmm_tpu_torch.ops import global_block as gb
from flmm_tpu_torch.ops import sam_flash_experiments as sfx
from flmm_tpu_torch.ops import window_block as wb
from flmm_tpu_torch.ops._matmul import matmul_f32
from flmm_tpu_torch.ops.boundary import dewindowize_plain as _dewindowize
from flmm_tpu_torch.ops.boundary import windowize_plain as _windowize
from flmm_tpu_torch.ops.fused_block import fused_ln_mlp, fused_ln_qkv, \
    fused_proj_ln_mlp
from flmm_tpu_torch.ops.quant import dense, quantize_weight
from flmm_tpu_torch.ops.sam_flash import rel_pos_coords, sam_global_attention_v8, \
    sam_window_attention_v9
from flmm_tpu_torch.parallel import frozen as shard


# global_kernel -> wrapper: every name of the JAX package (its v1 is the
# function without a suffix)
GLOBAL_KERNELS = {
    "v8": sam_global_attention_v8,
    "v1": sfx.sam_global_attention,
    "v2": sfx.sam_global_attention_v2,
    "v3": sfx.sam_global_attention_v3,
    "v4": sfx.sam_global_attention_v4,
    "v6": sfx.sam_global_attention_v6,
    "v7": sfx.sam_global_attention_v7,
    "v11": sfx.sam_global_attention_v11,
}
# window_kernel -> wrapper, likewise, every name of the JAX package with the
# (q, k, v, rel_pos_h, rel_pos_w, side) contract; v10 takes the spatial qkv
# and is refused by name
WINDOW_KERNELS = {
    "v9": sam_window_attention_v9,
    "v1": sfx.sam_window_attention,
    "v2": sfx.sam_window_attention_v2,
    "v3": sfx.sam_window_attention_v3,
    "v4": sfx.sam_window_attention_v4,
    "v5": sfx.sam_window_attention_v5,
    "v6": sfx.sam_window_attention_v6,
    "v7": sfx.sam_window_attention_v7,
    "v8": sfx.sam_window_attention_v8,
}


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
        if self.global_kernel not in GLOBAL_KERNELS:
            raise NotImplementedError(
                f"global_kernel {self.global_kernel!r} names no global "
                "attention kernel (the JAX package's names, all ported: "
                f"{', '.join(GLOBAL_KERNELS)})")
        if self.window_kernel not in WINDOW_KERNELS:
            raise NotImplementedError(
                f"window_kernel {self.window_kernel!r} names no kernel with "
                "the (q, k, v, rel_pos_h, rel_pos_w, side) contract (the JAX "
                f"package's names, all ported: {', '.join(WINDOW_KERNELS)}; "
                "v10 takes the spatial qkv: sam_window_attention_v10)")

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


def _attention(x: torch.Tensor, bp: dict, cfg: SamEncoderConfig, tp=None):
    """Plain windowless attention over ``(B', H', W', C)`` with decomposed
    rel-pos bias: the qkv product, :func:`_attention_core`, the
    out-projection (:func:`_out_proj`)."""
    B, H, W, C = x.shape
    qkv = dense(x.reshape(B, H * W, C), bp, "wqkv") + bp["bqkv"]
    out = _attention_core(qkv.reshape(B, H, W, -1), bp, _local(cfg, tp))
    return _out_proj(out, bp, tp).reshape(B, H, W, C)


def _local(cfg: SamEncoderConfig, tp) -> SamEncoderConfig:
    """The config of the heads a block holds: all of them, or under tp
    this rank's (parallel/frozen.py cut ``bp`` to them)."""
    return cfg if tp is None else shard.local_sam_config(cfg, tp)


def _out_proj(attn: torch.Tensor, bp: dict, tp) -> torch.Tensor:
    """The attention's out-projection ``(B, N, C') -> (B, N, C)``; under tp
    a row product summed over the model axis, the replicated bias added
    once after the sum."""
    if tp is None:
        return dense(attn, bp, "wo") + bp["bo"]
    return shard.row_product(attn, bp["wo"], tp, attn.dtype) + bp["bo"]


def _attention_core(qkv: torch.Tensor, bp: dict, cfg: SamEncoderConfig):
    """The attention of ``cfg.num_heads`` heads over a ``(B, H, W, 3C)``
    qkv grid: ``(B, H*W, C)``.  For the 64x64 global grid the scores are
    chunked over query rows (image_encoder.py:176-188) so at most ~2M rows
    x keys exist per image at a time."""
    B, H, W, C3 = qkv.shape
    C = C3 // 3
    nh, hd = cfg.num_heads, cfg.head_dim
    q, k, v = (t.reshape(B, H * W, nh, hd)
               for t in qkv.reshape(B, H * W, C3).split(C, dim=-1))
    scale = 1.0 / math.sqrt(hd)
    rh = bp["rel_pos_h"].float()[rel_pos_coords(H, qkv.device)]  # (H, H, hd)
    rw = bp["rel_pos_w"].float()[rel_pos_coords(W, qkv.device)]
    kt = k.permute(0, 2, 3, 1)  # (B, nh, hd, HW)
    vh = v.transpose(1, 2)  # (B, nh, HW, hd)

    def attend(q_rows, rh_rows):
        """q_rows: (B, h', W, nh, hd); rh_rows: (h', H, hd)."""
        hq = q_rows.shape[1]
        rqf = q_rows.float()
        qh = q_rows.reshape(B, hq * W, nh, hd).transpose(1, 2)
        logits = matmul_f32(qh, kt) * scale  # (B, nh, hq*W, HW)
        bias_h = torch.einsum("byxhd,ykd->bhyxk", rqf, rh_rows)
        bias_w = torch.einsum("byxhd,xkd->bhyxk", rqf, rw)
        logits = logits.reshape(B, nh, hq, W, H, W)
        logits = logits + bias_h[..., :, None] + bias_w[..., None, :]
        logits = logits.reshape(B, nh, hq * W, H * W)
        probs = torch.softmax(logits, dim=-1).to(qkv.dtype)
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
    return out


def _flash_global_core(qkv: torch.Tensor, bp: dict, cfg: SamEncoderConfig):
    """Global attention core through K2 or the variant ``cfg.global_kernel``
    names: ``(B, H, W, 3C) -> (B, H, W, C)``."""
    B, H, W, C3 = qkv.shape
    C = C3 // 3
    nh, hd = cfg.num_heads, cfg.head_dim

    def heads(t):
        return t.reshape(B, H * W, nh, hd).transpose(1, 2).reshape(
            B * nh, H * W, hd).contiguous()

    q, k, v = qkv.reshape(B, H * W, C3).split(C, dim=-1)
    kernel = GLOBAL_KERNELS[cfg.global_kernel]
    out = kernel(heads(q), heads(k), heads(v), bp["rel_pos_h"],
                 bp["rel_pos_w"], H)
    return out.reshape(B, nh, H * W, hd).transpose(1, 2).reshape(B, H, W, C)


def _flash_window_core(qkv: torch.Tensor, bp: dict, cfg: SamEncoderConfig):
    """Windowed attention core through K6 or the variant
    ``cfg.window_kernel`` names: ``(B, H, W, 3C) -> (B, H, W, C)``.

    The grid is padded to whole windows with the ``bqkv`` row, which is what
    a zero-padded LN output projects to: pad tokens keep ``k = b_k`` and
    ``v = b_v``, as on the plain path and in the reference (the JAX
    ``_flash_window_core`` pads qkv with zeros instead).  One relayout makes
    the qkv window-major; the kernel reads q, k and v out of it as ``(NW,
    nh, T, hd)`` strided views."""
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

    kernel = WINDOW_KERNELS[cfg.window_kernel]
    out = kernel(heads(0), heads(1), heads(2), bp["rel_pos_h"],
                 bp["rel_pos_w"], ws)
    out = out.transpose(1, 2).reshape(B, Hp // ws, Wp // ws, ws, ws, C)
    out = out.permute(0, 1, 3, 2, 4, 5).reshape(B, Hp, Wp, C)
    return out[:, :H, :W]


def _flash_block(x: torch.Tensor, bp: dict, cfg: SamEncoderConfig,
                 windowed: bool, tp=None):
    """One block through the attention kernel (K6 windowed, K2 global),
    with K3 before and K4 after it when the fused-MLP gate holds.  Under tp
    (``bp`` holds this rank's heads and MLP columns) K3 and the attention
    kernel run on the local heads, and the out-projection and the MLP's
    second product are row products summed before the residual: K4 fuses
    that residual add and is not used.  The CUDA gate is the caller's; on
    CPU tensors every wrapper takes its plain version."""
    B, H, W, C = x.shape
    mlp = bp["mlp"]
    fused = (cfg.fused_mlp and not quantized(bp) and C % 128 == 0
             and mlp["w1"].shape[1] * (1 if tp is None else tp.size)
             % 512 == 0)
    if fused:
        qkv = fused_ln_qkv(x, bp["ln1_w"], bp["ln1_b"], bp["wqkv"],
                           bp["bqkv"], eps=cfg.ln_eps)
    else:
        y = layer_norm(x, bp["ln1_w"], bp["ln1_b"], cfg.ln_eps)
        qkv = dense(y.reshape(B, H * W, C), bp, "wqkv") + bp["bqkv"]
    core = _flash_window_core if windowed else _flash_global_core
    attn = core(qkv.reshape(B, H, W, -1), bp, _local(cfg, tp))
    if fused and tp is None:
        return fused_proj_ln_mlp(
            x, attn, bp["wo"], bp["bo"], bp["ln2_w"], bp["ln2_b"],
            mlp["w1"], mlp["b1"], mlp["w2"], mlp["b2"], eps=cfg.ln_eps)
    x = x + _out_proj(attn.reshape(B, H * W, -1), bp, tp).reshape(B, H, W, C)
    return x + mlp_block(layer_norm(x, bp["ln2_w"], bp["ln2_b"],
                                    cfg.ln_eps), mlp, tp=tp)


def _ln_mlp_residual(x: torch.Tensor, bp: dict, cfg: SamEncoderConfig):
    """``x + MLP(LN2(x))`` over ``(B, H, W, C)``: K8 on a CUDA tensor when
    the shapes tile, else plain."""
    B, H, W, C = x.shape
    mlp = bp["mlp"]
    if (cfg.fused_mlp and x.is_cuda and "w1" in mlp and (B * H * W) % 256 == 0
            and C % 128 == 0 and mlp["w1"].shape[1] % 512 == 0):
        return fused_ln_mlp(x, bp["ln2_w"], bp["ln2_b"], mlp["w1"], mlp["b1"],
                            mlp["w2"], mlp["b2"], eps=cfg.ln_eps)
    y = layer_norm(x, bp["ln2_w"], bp["ln2_b"], cfg.ln_eps)
    return x + mlp_block(y, mlp)


def quantized(bp: dict) -> bool:
    """Whether a block carries int8 weights (no ``wqkv`` or no ``w1``):
    the gates of K1, K10, K3, K4 and K8 test for the plain weights."""
    return "wqkv" not in bp or "w1" not in bp["mlp"]


def flash_gate(cfg: SamEncoderConfig, H: int, W: int, windowed: bool) -> bool:
    """The config's side of the split kernel path's gate (the other side is
    ``x.is_cuda``): a global layer takes its attention kernel on a square
    grid of a multiple of 128 tokens; ``v8`` masks its keys and takes any
    (its kernel: sides 1 to ``sam_flash.MAX_TABLE_SIDE``, 147, which covers
    every configured SAM size and SAM up to 2352 px)."""
    if windowed:
        return cfg.flash_window
    return (cfg.flash_global and H == W
            and ((H * W) % 128 == 0 or cfg.global_kernel == "v8"))


def _block(x: torch.Tensor, bp: dict, cfg: SamEncoderConfig, windowed: bool,
           tp=None):
    """One block: :func:`_flash_block` where its gate holds on a CUDA
    tensor, else plain; under tp (``bp`` cut to this rank's heads and MLP
    columns) the projections after the attention and the MLP are row
    products summed over the model axis."""
    B, H, W, C = x.shape
    if flash_gate(cfg, H, W, windowed) and x.is_cuda:
        return _flash_block(x, bp, cfg, windowed, tp)
    shortcut = x
    x = layer_norm(x, bp["ln1_w"], bp["ln1_b"], cfg.ln_eps)
    if windowed:
        xw, geom = _windowize(x, cfg.window_size)
        ws = cfg.window_size
        xw = _attention(xw.reshape(-1, ws, ws, C), bp, cfg, tp)
        x = _dewindowize(xw.reshape(-1, ws * ws, C), geom, ws)
    else:
        x = _attention(x, bp, cfg, tp)
    x = shortcut + x
    y = layer_norm(x, bp["ln2_w"], bp["ln2_b"], cfg.ln_eps)
    return x + mlp_block(y, bp["mlp"], tp=tp)


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


@trace.spanned("sam_encoder")
def forward(params: dict, cfg: SamEncoderConfig,
            pixels: torch.Tensor) -> torch.Tensor:
    """Encode normalised, corner-padded ``(B, img, img, 3)`` images into
    ``(B, grid, grid, out_chans)`` NHWC embeddings."""
    x = conv2d(pixels.to(cfg.dtype), params["patch_kernel"],
               params["patch_bias"], stride=cfg.patch_size)
    x = x + params["pos_embed"].to(x.dtype)
    ws = cfg.window_size
    n_win_img = -(-x.shape[1] // ws) * -(-x.shape[2] // ws)
    tp = shard.tp_axis(params)
    use_wb = (cfg.window_block_fused and n_win_img >= 25 and x.is_cuda
              and cfg.embed_dim % 128 == 0 and tp is None)
    xw = geom = valid = None
    for i, bp in enumerate(params["blocks"]):
        windowed = i not in cfg.global_attn_indexes
        if use_wb and windowed and not quantized(bp):
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
                    and not quantized(bp) and x.shape[1] == x.shape[2]
                    and (x.shape[1] * x.shape[2]) % 256 == 0):
                x = _global_block_fused(x, bp, cfg)
            else:
                x = _block(x, bp, cfg, windowed=windowed, tp=tp)
    if xw is not None:
        x = _dewindowize(xw, geom, ws)
    x = conv2d(x, params["neck0_kernel"])
    x = channel_norm(x, params["neck0_ln_w"], params["neck0_ln_b"], cfg.ln_eps)
    x = conv2d(x, params["neck1_kernel"], padding=1)
    x = channel_norm(x, params["neck1_ln_w"], params["neck1_ln_b"], cfg.ln_eps)
    return x


def quantize_params(params: dict) -> dict:
    """Int8-quantise every per-token projection of a (frozen) encoder:
    ``wqkv``, ``wo`` and the MLP's ``w1`` / ``w2`` become ``<name>_q`` int8
    and ``<name>_s`` f32 per-output-channel scales.  The attention cores,
    the convolutions and everything else stay in their dtype.  ``params``
    is left as it is."""
    out = {k: v for k, v in params.items() if k != "blocks"}
    blocks = []
    with torch.no_grad():
        for bp in params["blocks"]:
            nb = {k: v for k, v in bp.items()
                  if k not in ("wqkv", "wo", "mlp")}
            for name in ("wqkv", "wo"):
                nb[name + "_q"], nb[name + "_s"] = quantize_weight(bp[name])
            mlp = {k: v for k, v in bp["mlp"].items()
                   if k not in ("w1", "w2")}
            for name in ("w1", "w2"):
                mlp[name + "_q"], mlp[name + "_s"] = quantize_weight(
                    bp["mlp"][name])
            nb["mlp"] = mlp
            blocks.append(nb)
    out["blocks"] = blocks
    return out
