"""Operation and byte counts of the grounding forward, from the widths of a
configuration file and the shapes and validity of a batch; never from the
program's launch grid.

Each function counts the products of one stage (2 operations per
multiply-add; softmax, norms and resamplers are not counted), in two ways:
``needed=False`` what the port's unfused path computes, which
``torch.utils.flop_counter.FlopCounterMode`` confirms on the tiny presets
(benchmark/tests), and ``needed=True`` what the request needs: the
decoder over valid tokens with causal attention over the valid pairs only,
the capture over the text rows, the heads over the valid masks and their
valid text tokens, the towers over the valid tiles, the SAM encoder's
projections over the image's tokens and its window attention over the
valid queries of each window.  The share of a peak is taken of the
needed count, so a change that stops computing padding raises img/s
without lifting a share past 100%.

``k5_calls`` and ``relpos_calls`` give the operations and bytes of each
call of the flash-capture kernel (K5) and of the rel-pos attention kernel
(K1's attention, K2), frozen copies of ``chip_smoke.py``'s phase-3
arithmetic (``check_capture`` at chip_smoke.py:1097-1110 and the K2 / K1
checks at :1241-1296), counted as the request needs them."""

from __future__ import annotations

import math

import numpy as np

PEAK_FLOPS = 989e12  # H100 SXM, dense bf16 (chip_smoke.py:438)
PEAK_BYTES = 3.35e12  # H100 SXM HBM3 (chip_smoke.py:438)
BF16, F32 = 2, 4


def _np(a):
    return a.detach().cpu().numpy() if hasattr(a, "detach") else np.asarray(a)


def vit(cfg, n_images: float, needed: bool, select_layer: int = -1) -> float:
    """Patch embedding, then each kept layer's qkv, scores, weighted sum,
    out-projection and MLP over ``n_images`` images."""
    d, f, L = cfg["hidden_size"], cfg["mlp_dim"], cfg["num_layers"]
    p = cfg["patch_size"]
    g2 = (cfg["image_size"] // p) ** 2
    S = g2 + (1 if cfg["use_class_token"] else 0)
    keep = (L if select_layer in (-1, L) else
            (select_layer if select_layer >= 0 else L + select_layer) + 1)
    layer = 2 * S * (4 * d * d + 2 * d * f) + 4 * S * S * d
    return n_images * (2 * g2 * d * p * p * 3 + keep * layer)


def aligner(n_in: int, widths: list, n_tokens: float) -> float:
    flops, w_in = 0.0, n_in
    for w in widths:
        flops += 2 * n_tokens * w_in * w
        w_in = w
    return flops


def decoder_rows(attn_mask, mask_ids) -> dict:
    """The row counts the decoder's cost depends on, per batch."""
    valid = _np(attn_mask).astype(bool)
    ids = _np(mask_ids)
    before = np.cumsum(valid, axis=1)  # valid keys at or before each row
    return {"B": valid.shape[0], "S": valid.shape[1],
            "tokens": int(valid.sum()),
            "pairs": int((before * valid).sum()),
            "text_rows": int((ids >= 0).sum())}


def decoder(cfg, rows: dict, n_img: int, n_masks: int, needed: bool) -> float:
    """Projections and gated MLP per token, attention scores and weighted
    sum, the capture's merge of the image columns."""
    D, L, H, KV, hd, F = (cfg[k] for k in (
        "hidden_size", "num_layers", "num_heads", "num_kv_heads", "head_dim",
        "intermediate_size"))
    per_token = 2 * D * hd * (2 * H + 2 * KV) + 6 * D * F
    if needed:
        tokens, pairs, merge_rows = rows["tokens"], rows["pairs"], \
            rows["text_rows"]
        return L * (tokens * per_token + 4 * H * hd * pairs
                    + 2 * H * n_masks * n_img * merge_rows)
    B, S = rows["B"], rows["S"]
    return L * (B * S * per_token + 4 * B * H * S * S * hd
                + 2 * B * H * S * n_img * n_masks)


def unet(cfg, n_maps: float, in_hw: tuple) -> float:
    """3 x 3 convolutions of the encoder and decoder stages, the 1 x 1
    up-projections and the 1 x 1 segmentation head."""
    h, w = in_hw
    if cfg["upsample_input"] is not None:
        s = max(1.0, cfg["upsample_input"] / max(h, w))
        h, w = int(h * s), int(w * s)
    n = cfg["num_stages"]
    div = 2 ** (n - 1)
    ph, pw = math.ceil(h / div) * div, math.ceil(w / div) * div
    ch = [cfg["base_channels"] * 2 ** i for i in range(n)]
    flops, cin = 0.0, cfg["in_channels"]
    for i in range(n):
        px = (ph >> i) * (pw >> i)
        for j in range(cfg["enc_num_convs"][i]):
            flops += 2 * px * 9 * (cin if j == 0 else ch[i]) * ch[i]
        cin = ch[i]
    for i in range(n - 1, 0, -1):
        px = (ph >> (i - 1)) * (pw >> (i - 1))
        c = ch[i - 1]
        flops += 2 * px * ch[i] * c
        for j in range(cfg["dec_num_convs"][i - 1]):
            flops += 2 * px * 9 * (2 * c if j == 0 else c) * c
    flops += 2 * h * w * ch[0]
    return n_maps * flops


def sam_encoder(cfg, n_images: float, needed: bool) -> float:
    """Patch embedding, the blocks (projections over the grid, or over the
    windows' padded grid where the unfused path computes them; attention
    scores, weighted sums and the two rel-pos bias products), the neck."""
    C, depth, nh = cfg["embed_dim"], cfg["depth"], cfg["num_heads"]
    p, ws = cfg["patch_size"], cfg["window_size"]
    hd = C // nh
    F = int(C * cfg["mlp_ratio"])
    G = cfg["img_size"] // p
    Gp = -(-G // ws) * ws
    T = ws * ws
    n_win = (Gp // ws) ** 2
    out = cfg["out_chans"]
    flops = 2 * G * G * C * p * p * 3
    for i in range(depth):
        if i in cfg["global_attn_indexes"]:
            S = G * G
            flops += 2 * S * C * 4 * C + 4 * S * S * C + 4 * S * G * C
        else:
            proj = G * G if needed else Gp * Gp
            queries = G * G if needed else n_win * T
            flops += 2 * proj * C * 4 * C + 4 * queries * T * C \
                + 4 * queries * ws * C
        flops += 4 * G * G * C * F
    flops += 2 * G * G * C * out + 2 * G * G * out * out * 9
    return n_images * flops


def forward(model_cfg, family: str, batch: dict, needed: bool) -> dict:
    """The forward's operations by stage for one batch (numpy or tensors
    of the program's batch schema)."""
    nxt = family == "llava_next"
    cfg = model_cfg["base"] if nxt else model_cfg
    vc, lc = cfg["vision"], cfg["llm"]
    mv = _np(batch["mask_valid"]).astype(bool)
    B, M = mv.shape
    tv = _np(batch["text_valid"]).astype(bool)
    T = tv.shape[-1]
    rows = decoder_rows(batch["attn_mask"], batch["mask_ids"])
    if nxt:
        views = (_np(batch["tile_valid"]).sum() if needed
                 else _np(batch["tile_valid"]).size)
        n_img = model_cfg["n_img_max"]
        maps_hw = tuple(model_cfg["coarse_frame"])
    else:
        views = B
        n_img = cfg["num_img_tokens"]
        maps_hw = (cfg["clip_shape"], cfg["clip_shape"])
    g2 = (vc["image_size"] // vc["patch_size"]) ** 2
    out = {
        "tower": vit(vc, views, needed, cfg["vision_select_layer"]),
        "aligner": aligner(vc["hidden_size"],
                           [lc["hidden_size"]] * cfg["projector_depth"],
                           views * g2),
        "decoder": decoder(lc, rows, n_img, M, needed),
        "sam_encoder": sam_encoder(cfg["sam"]["encoder"], B, needed),
    }
    n_masks = mv.sum() if needed else B * M
    text_rows = (tv & mv[..., None]).sum() if needed else B * M * T
    sparse = (tv.sum(-1) + 2) if needed else np.full((B, M), T + 2)
    n_tok = cfg["sam"]["decoder"]["num_multimask_outputs"] + 1
    # the self-attention scores run over each mask's own tokens
    tokens = 1 + n_tok + sparse
    sq = float(((tokens ** 2) * (mv if needed else 1)).sum())
    out["unet"] = unet(cfg["unet"], n_masks, maps_hw)
    out["text_proj"] = 2 * text_rows * lc["hidden_size"] * \
        cfg["sam"]["prompt"]["embed_dim"]
    out["heads_sam"] = _sam_heads(cfg["sam"], n_masks, text_rows + 2 * n_masks,
                                  sq, B)
    return {k: float(v) for k, v in out.items()}


def _sam_heads(sam_cfg, n_masks, n_sparse_rows, self_scores, n_images):
    """Prompt encoder and mask decoder: ``n_sparse_rows`` sparse tokens (box
    corners and text) over all masks; ``self_scores`` the sum over masks of
    the squared token count of each; the dense positional grid once an
    image."""
    pc, dc = sam_cfg["prompt"], sam_cfg["decoder"]
    tc = dc["transformer"]
    d = tc["embed_dim"]
    di = d // tc["attention_downsample_rate"]
    c = pc["mask_in_chans"]
    s = pc["image_embedding_size"]
    s2, P = s * s, 4 * s
    n_tok = dc["num_multimask_outputs"] + 1
    q = n_masks * (1 + n_tok) + n_sparse_rows
    flops = n_masks * (2 * (P // 2) ** 2 * (c // 4) * 4
                       + 2 * s2 * c * 4 * (c // 4) + 2 * s2 * d * c)
    flops += n_images * 2 * s2 * 2 * (d // 2) + 2 * 2 * n_masks * 2 * (d // 2)

    def cross(n_q, n_kv, from_tokens):
        """A downsampled attention: queries from ``n_q`` rows, keys and
        values from ``n_kv``; ``from_tokens`` says which side the scores
        run over per mask."""
        return (2 * n_q * d * di + 2 * 2 * n_kv * d * di + 2 * n_q * di * d
                + from_tokens)

    img = n_masks * s2
    for i in range(tc["depth"]):
        flops += 2 * q * d * d * 4 + 4 * d * self_scores
        flops += cross(q, img, 4 * q * s2 * di)
        flops += 4 * q * d * tc["mlp_dim"]
        flops += cross(img, q, 4 * q * s2 * di)
    flops += cross(q, img, 4 * q * s2 * di)
    flops += n_masks * (2 * s2 * d * 4 * (d // 4)
                        + 2 * 4 * s2 * (d // 4) * 4 * (d // 8))
    flops += n_masks * n_tok * 2 * (2 * d * d + d * (d // 8))
    flops += n_masks * 2 * n_tok * P * P * (d // 8)
    hid = dc["iou_head_hidden_dim"]
    flops += n_masks * 2 * (d * hid + hid * hid * (dc["iou_head_depth"] - 2)
                            + hid * n_tok)
    return flops


def heads_backward(fwd: dict) -> float:
    """The trained heads' backward: two products (the input's and the
    weight's gradient) per forward product of the U-Net, the text
    projection, the prompt encoder and the mask decoder."""
    return 2.0 * (fwd["unet"] + fwd["text_proj"] + fwd["heads_sam"])


# ----------------------------------------------------------- kernel calls


def k5_calls(lc, batch: dict, img_start: int, n_img: int) -> tuple:
    """``(flop, bytes)`` of the flash-capture kernel over one forward (one
    call a layer): 4 * hd FLOP per visible (query, key) pair and head over
    the valid queries, 2 * M * n_img per text row and head for the merge;
    q, k, v and o of the valid tokens in bf16, the f32 lse of the valid
    queries and the f32 merged capture, each moved once
    (chip_smoke.py:1097-1110, with the pairs of valid queries only)."""
    rows = decoder_rows(batch["attn_mask"], batch["mask_ids"])
    M = _np(batch["mask_valid"]).shape[1]
    H, KV, hd, L = (lc[k] for k in ("num_heads", "num_kv_heads", "head_dim",
                                    "num_layers"))
    flop = 4 * H * hd * rows["pairs"] + 2 * H * M * n_img * rows["text_rows"]
    moved = (rows["tokens"] * hd * (2 * H + 2 * KV) * BF16
             + rows["tokens"] * H * F32 + rows["B"] * H * M * n_img * F32)
    return L * flop, L * moved


def relpos_calls(enc) -> list:
    """``(flop, bytes)`` of each call of the rel-pos attention kernel over
    one image's SAM encoder, one call a layer: a window layer's attention
    over each window's valid queries and all its keys, a global layer's
    over the grid, 4 * hd FLOP per (query, key) pair and head; q, k, v and
    o in bf16 and the two tables, each moved once (chip_smoke.py:1241-1296).
    A call over a batch is the image's times the batch."""
    C, nh, ws = enc["embed_dim"], enc["num_heads"], enc["window_size"]
    hd = C // nh
    G = enc["img_size"] // enc["patch_size"]
    Gp = -(-G // ws) * ws
    n_win, T = (Gp // ws) ** 2, ws * ws
    window = (4 * hd * nh * G * G * T,
              n_win * T * C * 4 * BF16 + 2 * (2 * ws - 1) * hd * BF16)
    glob = (4 * hd * nh * (G * G) ** 2,
            G * G * C * 4 * BF16 + 2 * (2 * G - 1) * hd * BF16)
    return [glob if i in enc["global_attn_indexes"] else window
            for i in range(enc["depth"])]


def bound_s(flop: float, moved: float) -> float:
    """The least time of a call: the larger of its operations over the
    peak rate and its bytes over the memory rate."""
    return max(flop / PEAK_FLOPS, moved / PEAK_BYTES)
