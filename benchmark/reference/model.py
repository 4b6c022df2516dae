"""The grounding forward and its loss in float32: vision tower, aligner or
LLaVA-NeXT's anyres packing, frozen decoder with the per-mask merged
capture, U-Net, text projection, SAM image encoder, prompt encoder and
mask decoder.  ``cfg`` is the configuration file's ``model`` entry (an
:class:`~benchmark.reference.layers.NS`); ``params`` the same tree the
program is given, cast to float32."""

from __future__ import annotations

import math

import torch

from benchmark.reference import layers as nn

# ---------------------------------------------------------------- towers


def vit_forward(p: dict, cfg, pixels, select_layer: int = -1):
    """Hidden states at ``select_layer`` (HF indexing), ``(B, seq, D)``."""
    B, d = pixels.shape[0], cfg.hidden_size
    x = nn.conv2d(pixels, p["patch_kernel"], stride=cfg.patch_size)
    grid = x.shape[1]
    x = x.reshape(B, -1, d)
    if cfg.patch_bias:
        x = x + p["patch_bias"]
    if cfg.use_class_token:
        x = torch.cat([p["cls_token"].expand(B, 1, d), x], dim=1)
    pos = p["pos_embed"]
    native = cfg.image_size // cfg.patch_size
    if grid != native:
        cls, gp = (pos[:1], pos[1:]) if cfg.use_class_token else (None, pos)
        g = nn.resize_bicubic(gp.reshape(native, native, d).permute(2, 0, 1),
                              (grid, grid)).permute(1, 2, 0).reshape(-1, d)
        pos = g if cls is None else torch.cat([cls, g])
    x = x + pos
    if cfg.use_pre_norm:
        x = nn.layer_norm(x, p["pre_ln_w"], p["pre_ln_b"], cfg.ln_eps)
    H = cfg.num_heads
    hd = d // H
    S = x.shape[1]
    L = cfg.num_layers
    n_keep = (L if select_layer in (-1, L) else
              (select_layer if select_layer >= 0 else L + select_layer) + 1)
    h = x
    for i in range(n_keep):
        lp = {k: v[i] for k, v in p["layers"].items()}
        y = nn.layer_norm(h, lp["ln1_w"], lp["ln1_b"], cfg.ln_eps)
        q, k, v = ((y @ lp["wqkv"] + lp["bqkv"]).split(d, dim=-1))
        q, k, v = (t.reshape(B, S, H, hd).transpose(1, 2) for t in (q, k, v))
        probs = torch.softmax(q @ k.transpose(-1, -2) / math.sqrt(hd), -1)
        o = (probs @ v).transpose(1, 2).reshape(B, S, d)
        h = h + o @ lp["wo"] + lp["bo"]
        y2 = nn.layer_norm(h, lp["ln2_w"], lp["ln2_b"], cfg.ln_eps)
        h = h + nn.mlp_block(y2, lp, cfg.act)
    if select_layer in (-1, L) and cfg.final_norm:
        return nn.layer_norm(h, p["final_ln_w"], p["final_ln_b"], cfg.ln_eps)
    return h


def project(x, layers: list):
    """The 'mlp_gelu' aligner: GELU between linear layers."""
    for i, p in enumerate(layers):
        if i > 0:
            x = torch.nn.functional.gelu(x)
        x = nn.linear(x, p)
    return x


# --------------------------------------------------------------- decoder


def _rope(x, cos, sin):
    half = x.shape[-1] // 2
    rotated = torch.cat([-x[..., half:], x[..., :half]], dim=-1)
    return x * cos[:, :, None] + rotated * sin[:, :, None]


def decoder_capture(p: dict, cfg, embeds, valid, position_ids, img_start: int,
                    n_img: int, merge_matrix, layer_weights) -> tuple:
    """The frozen decoder over ``embeds`` with causal + padding masking:
    the per-mask mean of each layer's text->image attention probabilities
    ``(B, L, H, M, n_img)`` and the layer-weighted hidden sum ``(B, S, D)``
    (its last term after the final norm)."""
    B, S, D = embeds.shape
    H, KV, hd, L = cfg.num_heads, cfg.num_kv_heads, cfg.head_dim, \
        cfg.num_layers
    pos = position_ids.float()
    half = hd // 2
    inv = 1.0 / (cfg.rope_theta ** (torch.arange(
        0, half, dtype=torch.float32, device=embeds.device) / half))
    freqs = pos[..., None] * inv
    emb = torch.cat([freqs, freqs], dim=-1)
    cos, sin = torch.cos(emb), torch.sin(emb)
    ar = torch.arange(S, device=embeds.device)
    allow = (ar[:, None] >= ar[None])[None] & valid[:, None, :]
    bias = torch.where(allow, 0.0, torch.finfo(torch.float32).min)[:, None]
    h = embeds
    acc = torch.zeros_like(embeds)
    sides = []
    for i in range(L):
        lp = {k: v[i] for k, v in p["layers"].items()}
        x = nn.rms_norm(h, lp["ln1"], cfg.rms_eps)
        q = _rope((x @ lp["wq"]).reshape(B, S, H, hd), cos, sin)
        k = _rope((x @ lp["wk"]).reshape(B, S, KV, hd), cos, sin)
        v = (x @ lp["wv"]).reshape(B, S, KV, hd)
        k = k.repeat_interleave(H // KV, dim=2).transpose(1, 2)
        v = v.repeat_interleave(H // KV, dim=2).transpose(1, 2)
        q = q.transpose(1, 2)
        probs = torch.softmax(q @ k.transpose(-1, -2) / math.sqrt(hd) + bias,
                              dim=-1)
        out = (probs @ v).transpose(1, 2).reshape(B, S, H * hd)
        h = h + out @ lp["wo"]
        x2 = nn.rms_norm(h, lp["ln2"], cfg.rms_eps)
        h = h + (nn.activation(x2 @ lp["w_gate"], cfg.act)
                 * (x2 @ lp["w_up"])) @ lp["w_down"]
        if i < L - 1:
            acc = acc + layer_weights[i] * h
        sides.append(torch.einsum(
            "bhsn,bsm->bhmn", probs[..., img_start:img_start + n_img],
            merge_matrix))
        del probs, q, k, v
    last = nn.rms_norm(h, p["final_norm"], cfg.rms_eps)
    hidden = acc + layer_weights[L - 1] * last
    return torch.stack(sides, dim=1), hidden


# ------------------------------------------------------------ SAM encoder


def _sam_attention(x, bp: dict, cfg, rows: int = 8):
    """Windowless attention with the decomposed rel-pos bias over ``(B, H,
    W, C)``, ``rows`` query rows of the grid at a time."""
    B, H, W, C = x.shape
    nh = cfg.num_heads
    hd = C // nh
    qkv = x.reshape(B, H * W, C) @ bp["wqkv"] + bp["bqkv"]
    q, k, v = (t.reshape(B, H * W, nh, hd) for t in qkv.split(C, dim=-1))
    rh = bp["rel_pos_h"][nn.rel_pos_coords(H, x.device)]
    rw = bp["rel_pos_w"][nn.rel_pos_coords(W, x.device)]
    kt, vh = k.permute(0, 2, 3, 1), v.transpose(1, 2)
    qg = q.reshape(B, H, W, nh, hd)
    outs = []
    for r0 in range(0, H, rows):
        qr = qg[:, r0:r0 + rows]
        hq = qr.shape[1]
        logits = (qr.reshape(B, hq * W, nh, hd).transpose(1, 2) @ kt) \
            / math.sqrt(hd)
        bh = torch.einsum("byxhd,ykd->bhyxk", qr, rh[r0:r0 + rows])
        bw = torch.einsum("byxhd,xkd->bhyxk", qr, rw)
        logits = (logits.reshape(B, nh, hq, W, H, W) + bh[..., :, None]
                  + bw[..., None, :]).reshape(B, nh, hq * W, H * W)
        outs.append((torch.softmax(logits, -1) @ vh).transpose(1, 2)
                    .reshape(B, hq * W, C))
    out = torch.cat(outs, dim=1)
    return (out @ bp["wo"] + bp["bo"]).reshape(B, H, W, C)


def sam_encoder(p: dict, cfg, pixels):
    """``(B, img, img, 3)`` -> ``(B, grid, grid, out_chans)``; windowed
    blocks zero-pad the grid to whole windows."""
    x = nn.conv2d(pixels, p["patch_kernel"], p["patch_bias"],
                  stride=cfg.patch_size) + p["pos_embed"]
    ws = cfg.window_size
    for i, bp in enumerate(p["blocks"]):
        shortcut = x
        y = nn.layer_norm(x, bp["ln1_w"], bp["ln1_b"], cfg.ln_eps)
        if i in cfg.global_attn_indexes:
            y = _sam_attention(y, bp, cfg)
        else:
            B, H, W, C = y.shape
            ph, pw = (ws - H % ws) % ws, (ws - W % ws) % ws
            yp = torch.nn.functional.pad(y, (0, 0, 0, pw, 0, ph))
            Hp, Wp = H + ph, W + pw
            yw = yp.reshape(B, Hp // ws, ws, Wp // ws, ws, C).permute(
                0, 1, 3, 2, 4, 5).reshape(-1, ws, ws, C)
            yw = _sam_attention(yw, bp, cfg, rows=ws)
            y = yw.reshape(B, Hp // ws, Wp // ws, ws, ws, C).permute(
                0, 1, 3, 2, 4, 5).reshape(B, Hp, Wp, C)[:, :H, :W]
        x = shortcut + y
        x = x + nn.mlp_block(nn.layer_norm(x, bp["ln2_w"], bp["ln2_b"],
                                           cfg.ln_eps), bp["mlp"])
    x = nn.conv2d(x, p["neck0_kernel"])
    x = nn.layer_norm(x, p["neck0_ln_w"], p["neck0_ln_b"], cfg.ln_eps)
    x = nn.conv2d(x, p["neck1_kernel"], padding=1)
    return nn.layer_norm(x, p["neck1_ln_w"], p["neck1_ln_b"], cfg.ln_eps)


# ------------------------------------------------------------ mask heads


def unet(p: dict, cfg, x):
    """``(M, h, w, C)`` attention maps -> ``(M, H, W)`` coarse logits."""
    if cfg.normalize_input:
        x = x / x.sum(dim=(1, 2), keepdim=True).clamp_min(1e-12)
    h, w = x.shape[1], x.shape[2]
    if cfg.upsample_input is not None:
        s = max(1.0, cfg.upsample_input / max(h, w))
        h, w = int(h * s), int(w * s)
        x = nn.resize_bilinear(x.permute(0, 3, 1, 2), (h, w),
                               scale=(s, s)).permute(0, 2, 3, 1)
    div = 2 ** (cfg.num_stages - 1)
    ph, pw = math.ceil(h / div) * div, math.ceil(w / div) * div
    x = torch.nn.functional.pad(x, (0, 0, 0, pw - w, 0, ph - h))

    def conv_gn_relu(x, q, padding=1):
        y = nn.conv2d(x, q["k"], q["b"], padding=padding)
        return torch.relu(nn.group_norm1(y, q["gn_w"], q["gn_b"]))

    skips = []
    for i, block in enumerate(p["enc"]):
        if i > 0:
            x = torch.nn.functional.max_pool2d(
                x.permute(0, 3, 1, 2), 2).permute(0, 2, 3, 1)
        for q in block:
            x = conv_gn_relu(x, q)
        skips.append(x)
    for i in range(cfg.num_stages - 1, 0, -1):
        dp = p["dec"][i - 1]
        x = x.permute(0, 3, 1, 2)
        x = nn.resize_bilinear(x, (x.shape[-2] * 2, x.shape[-1] * 2))
        x = conv_gn_relu(x.permute(0, 2, 3, 1), dp["up"], padding=0)
        x = torch.cat([skips[i - 1], x], dim=-1)
        for q in dp["convs"]:
            x = conv_gn_relu(x, q)
    return nn.conv2d(x[:, :h, :w], p["seg_k"], p["seg_b"])[..., 0]


def _pe(pp: dict, coords01):
    proj = 2.0 * math.pi * ((2.0 * coords01 - 1.0) @ pp["pe_gaussian"])
    return torch.cat([torch.sin(proj), torch.cos(proj)], dim=-1)


def _attention(p: dict, q, k, v, nh: int, key_mask=None):
    q, k, v = nn.linear(q, p["q"]), nn.linear(k, p["k"]), nn.linear(v, p["v"])
    B, Nq, C = q.shape
    hd = C // nh
    qh, kh, vh = (t.reshape(B, t.shape[1], nh, hd).transpose(1, 2)
                  for t in (q, k, v))
    logits = qh @ kh.transpose(-1, -2) / math.sqrt(hd)
    if key_mask is not None:
        logits = logits + torch.where(key_mask[:, None, None, :], 0.0,
                                      torch.finfo(torch.float32).min)
    out = (torch.softmax(logits, -1) @ vh).transpose(1, 2).reshape(B, Nq, C)
    return nn.linear(out, p["out"])


def _two_way(p: dict, cfg, keys, pe, tokens, token_mask):
    nh, eps = cfg.num_heads, cfg.ln_eps
    queries = tokens
    for i, lp in enumerate(p["layers"]):
        if i == 0:
            queries = _attention(lp["self_attn"], queries, queries, queries,
                                 nh, token_mask)
        else:
            q = queries + tokens
            queries = queries + _attention(lp["self_attn"], q, q, queries, nh,
                                           token_mask)
        queries = nn.layer_norm(queries, lp["ln1_w"], lp["ln1_b"], eps)
        queries = queries + _attention(lp["cross_t2i"], queries + tokens,
                                       keys + pe, keys, nh)
        queries = nn.layer_norm(queries, lp["ln2_w"], lp["ln2_b"], eps)
        queries = queries + nn.mlp_block(queries, lp["mlp"], "relu")
        queries = nn.layer_norm(queries, lp["ln3_w"], lp["ln3_b"], eps)
        keys = keys + _attention(lp["cross_i2t"], keys + pe, queries + tokens,
                                 queries, nh, token_mask)
        keys = nn.layer_norm(keys, lp["ln4_w"], lp["ln4_b"], eps)
    queries = queries + _attention(p["final_attn"], queries + tokens,
                                   keys + pe, keys, nh)
    return nn.layer_norm(queries, p["final_ln_w"], p["final_ln_b"], eps), keys


def mask_decoder(p: dict, cfg, image_embedding, image_pe, sparse, dense,
                 sparse_valid):
    """``(M, n_tokens, 4S, 4S)`` masks and ``(M, n_tokens)`` IoU
    predictions for the prompt sets of one image."""
    d = cfg.transformer_dim
    m = sparse.shape[0]
    n_tok = cfg.num_multimask_outputs + 1
    out_tokens = torch.cat([p["iou_token"], p["mask_tokens"]])[None].expand(
        m, -1, -1)
    tokens = torch.cat([out_tokens, sparse], dim=1)
    token_mask = torch.cat([torch.ones((m, 1 + n_tok), dtype=torch.bool,
                                       device=sparse.device), sparse_valid],
                           dim=1)
    src = image_embedding[None] + dense
    s = src.shape[1]
    hs, src_out = _two_way(p["transformer"], cfg.transformer,
                           src.reshape(m, s * s, d),
                           image_pe.reshape(1, s * s, d).expand(m, -1, -1),
                           tokens, token_mask)
    up = p["upscale"]
    x = nn.conv_transpose2d(src_out.reshape(m, s, s, d), up["k0"], up["b0"])
    x = torch.nn.functional.gelu(nn.layer_norm(x, up["ln_w"], up["ln_b"],
                                               cfg.ln_eps))
    x = torch.nn.functional.gelu(nn.conv_transpose2d(x, up["k1"], up["b1"]))
    hyper = torch.stack([nn.mlp(hs[:, 1 + i], p["hyper_mlps"][i])
                         for i in range(n_tok)], dim=1)
    masks = torch.einsum("mnc,myxc->mnyx", hyper, x)
    return masks, nn.mlp(hs[:, 0], p["iou_mlp"])


def refine(p: dict, cfg, image_embedding, coarse, geom: dict, text,
           text_valid, boxes=None) -> dict:
    """SAM refinement of one image's coarse masks ``(M, Hc, Wc)``: a box
    from the thresholded coarse mask, the coarse logits as the dense
    prompt, the text tokens beside the box corners.  ``boxes``: the boxes
    to prompt with instead of the thresholded ones (the check prompts
    with the program's, and judges them by ``box_view``, the coarse logits
    in the box's frame)."""
    M, Hc, Wc = coarse.shape
    P = cfg.prompt_size
    dev = coarse.device
    cy, cx, ch, cw, nh, nw = (geom[k] for k in (
        "crop_y", "crop_x", "crop_h", "crop_w", "sam_h", "sam_w"))
    src_lo = torch.stack([cy, cx])
    src_hi = torch.stack([cy + ch - 1.0, cx + cw - 1.0])
    ys = torch.arange(Hc, device=dev)[:, None]
    xs = torch.arange(Wc, device=dev)[None, :]
    in_roi = (ys >= cy) & (ys <= src_hi[0]) & (xs >= cx) & (xs <= src_hi[1])
    # F-LMM reads the pad value on the host: it takes no gradient
    pad = torch.clamp(torch.where(in_roi, coarse, torch.inf).amin(),
                      max=-1.0).detach()
    ratio = float(cfg.encoder.img_size) / P
    prompt_masks = nn.affine_grid_sample(
        coarse, torch.stack([ratio * ch / nh, ratio * cw / nw]), src_lo,
        (P, P), fill=pad, src_lo=src_lo, src_hi=src_hi, mode="fill")
    bf = cfg.box_frame
    view = nn.affine_grid_sample(coarse, torch.stack([ch / bf, cw / bf]),
                                 src_lo, (bf, bf), src_lo=src_lo,
                                 src_hi=src_hi, mode="clamp")
    if boxes is None:
        boxes = nn.mask_to_box(torch.sigmoid(view) > 0.5) \
            * torch.stack([nw, nh, nw, nh]) / bf
    pp, pc = p["prompt"], cfg.prompt
    corners = _pe(pp, (boxes.reshape(-1, 2, 2) + 0.5) / pc.input_image_size) \
        + torch.stack([pp["point_embeddings"][2], pp["point_embeddings"][3]])
    sparse = torch.cat([corners, text], dim=1)
    sparse_valid = torch.cat([torch.ones((M, 2), dtype=torch.bool,
                                         device=dev), text_valid], dim=1)
    md = pp["mask_down"]
    x = nn.conv2d(prompt_masks[..., None], md["k0"], md["b0"], stride=2)
    x = torch.nn.functional.gelu(nn.layer_norm(x, md["ln0_w"], md["ln0_b"],
                                               pc.ln_eps))
    x = nn.conv2d(x, md["k1"], md["b1"], stride=2)
    x = torch.nn.functional.gelu(nn.layer_norm(x, md["ln1_w"], md["ln1_b"],
                                               pc.ln_eps))
    dense = nn.conv2d(x, md["k2"], md["b2"])
    s = pc.image_embedding_size
    r = (torch.arange(s, dtype=torch.float32, device=dev) + 0.5) / s
    gy, gx = torch.meshgrid(r, r, indexing="ij")
    image_pe = _pe(pp, torch.stack([gx, gy], dim=-1))
    masks, iou = mask_decoder(p["decoder"], cfg.decoder, image_embedding,
                              image_pe, sparse, dense, sparse_valid)
    return {"sam_logits": masks[:, 0], "iou_pred": iou[:, 0], "boxes": boxes,
            "box_view": view}


def heads(params: dict, cfg, attn_nhwc, hidden, batch: dict,
          boxes=None) -> dict:
    """U-Net over the attention maps, text prompts from the hidden states,
    the SAM refiner per image; ``boxes``: the boxes to prompt the first
    ``len(boxes)`` images with, if given."""
    tra = params["trainable"]
    B, M = batch["mask_valid"].shape
    coarse = unet(tra["unet"], cfg.unet, attn_nhwc)
    coarse = coarse.reshape(B, M, *coarse.shape[-2:])
    rows = torch.arange(B, device=hidden.device)[:, None, None]
    tp = tra["text_proj"]
    text = (hidden[rows, batch["text_idx"].long()] @ tp["w"] + tp["b"]) \
        * batch["text_valid"][..., None]
    geom = batch["geom"]
    img_emb = sam_encoder(params["frozen"]["sam_encoder"], cfg.sam.encoder,
                          batch["sam_pixel_values"])
    outs = [refine(tra["sam"], cfg.sam, img_emb[b], coarse[b],
                   {k: geom[k][b] for k in geom}, text[b],
                   batch["text_valid"][b],
                   boxes[b] if boxes is not None and b < len(boxes) else None)
            for b in range(B)]
    return {"coarse_logits": coarse, "hidden": hidden,
            **{k: torch.stack([o[k] for o in outs]) for k in outs[0]}}


# ---------------------------------------------------------------- models


def _embed(fro: dict, ids):
    return fro["llm"]["embed"][ids.long()]


def grounding_forward(params: dict, cfg, batch: dict, boxes=None) -> dict:
    """DeepSeek-VL-style contiguous image block: tower -> aligner ->
    decoder capture -> heads; ``boxes``: the prompts' boxes, if given."""
    fro = params["frozen"]
    B, M = batch["mask_valid"].shape
    feats = vit_forward(fro["vision"], cfg.vision, batch["pixel_values"],
                        cfg.vision_select_layer)
    if cfg.vision_drop_cls:
        feats = feats[:, 1:]
    embeds = _embed(fro, batch["input_ids"])
    n = cfg.num_img_tokens
    embeds[:, cfg.img_start:cfg.img_start + n] = project(feats,
                                                         fro["projector"])
    return _capture_and_heads(params, cfg, batch, embeds, n, boxes,
                              lambda attn: attn.permute(0, 3, 1, 2, 4).reshape(
                                  B * M, -1, cfg.clip_shape, cfg.clip_shape)
                              .permute(0, 2, 3, 1))


def _capture_and_heads(params, cfg, batch, embeds, n_img, boxes, to_maps):
    M = batch["mask_valid"].shape[1]
    lw = torch.softmax(params["trainable"]["text_layer_weights"], dim=0)
    attn, hidden = decoder_capture(
        params["frozen"]["llm"], cfg.llm, embeds, batch["attn_mask"].bool(),
        batch["position_ids"], cfg.img_start, n_img,
        nn.mean_merge_matrix(batch["mask_ids"], M), lw)
    return heads(params, cfg, to_maps(attn), hidden, batch, boxes)


def llava_next_forward(params: dict, ncfg, batch: dict, boxes=None) -> dict:
    """LLaVA-NeXT: the tower over the base view and the tiles, the block
    gather through ``[features | newline | zero]`` into the padded image
    block, the decoder capture, the coarse and fine maps resampled into the
    square frame, the heads."""
    cfg = ncfg.base
    fro = params["frozen"]
    B = batch["input_ids"].shape[0]
    g = cfg.clip_shape
    tiles = batch["tiles"]
    nt = tiles.shape[1]
    feats = vit_forward(fro["vision"], cfg.vision,
                        tiles.reshape(B * nt, *tiles.shape[2:]),
                        cfg.vision_select_layer)
    if cfg.vision_drop_cls:
        feats = feats[:, 1:]
    feats = project(feats, fro["projector"])
    d = feats.shape[-1]
    feats = feats.reshape(B, nt * g * g, d)
    table = torch.cat([feats, fro["image_newline"].expand(B, 1, d),
                       feats.new_zeros((B, 1, d))], dim=1)
    block = torch.gather(table, 1, batch["block_index"].long()[..., None]
                         .expand(-1, -1, d))
    block = block * batch["block_valid"][..., None].float()
    embeds = _embed(fro, batch["input_ids"])
    n = ncfg.n_img_max
    embeds[:, cfg.img_start:cfg.img_start + n] = block

    def to_maps(attn):
        _, L, H, M, _ = attn.shape
        C = L * H * M
        flat = attn.reshape(B, C, n)
        coarse_maps = flat[..., :g * g].reshape(B, C, g, g)
        fine = torch.gather(flat, 2, batch["fine_gather"].long()[:, None]
                            .expand(-1, C, -1))
        fine = fine * batch["fine_valid"][:, None].float()
        fine_maps = fine.reshape(B, C, *ncfg.max_fine_hw)
        Hc, Wc = ncfg.coarse_frame
        geom = batch["geom"]
        zero = torch.zeros(2, device=attn.device)

        def frame(maps, sh, sw, b):
            cy, cx = geom["crop_y"][b], geom["crop_x"][b]
            ch = geom["crop_h"][b].clamp_min(1.0)
            cw = geom["crop_w"][b].clamp_min(1.0)
            hi = torch.stack([torch.as_tensor(sh - 1.0, device=attn.device),
                              torch.as_tensor(sw - 1.0, device=attn.device)])
            return nn.affine_grid_sample(
                maps, torch.stack([sh / ch, sw / cw]),
                torch.stack([-cy * sh / ch, -cx * sw / cw]), (Hc, Wc),
                src_lo=zero, src_hi=hi, mode="clamp")

        cf = torch.stack([frame(coarse_maps[b], float(g), float(g), b)
                          for b in range(B)]).reshape(B, L * H, M, Hc, Wc)
        ff = torch.stack([frame(fine_maps[b], batch["fine_hw"][b, 0],
                                batch["fine_hw"][b, 1], b)
                          for b in range(B)]).reshape(B, L * H, M, Hc, Wc)
        maps = torch.cat([cf, ff], dim=1)
        return maps.permute(0, 2, 3, 4, 1).reshape(B * M, Hc, Wc, 2 * L * H)

    return _capture_and_heads(params, cfg, batch, embeds, n, boxes, to_maps)


def forward(params: dict, family: str, cfg, batch: dict, boxes=None):
    if family == "llava_next":
        return llava_next_forward(params, cfg, batch, boxes)
    return grounding_forward(params, cfg, batch, boxes)


def base(family: str, cfg):
    return cfg.base if family == "llava_next" else cfg


def loss(params: dict, family: str, cfg, batch: dict, boxes=None):
    """The loss and its parts, and under ``boxes`` the boxes the SAM
    prompts took (``boxes``: those to prompt with, for the first rows)."""
    out = forward(params, family, cfg, batch, boxes)
    parts = nn.grounding_losses(
        out["coarse_logits"], batch["gt_coarse"], batch["coarse_weight"],
        out["sam_logits"], batch["gt_sam"], batch["sam_weight"],
        batch["mask_valid"])
    return {**parts, "boxes": out["boxes"].detach()}
