"""Inverse checkpoint writers: the port's parameter trees -> state dicts in
the released on-disk layouts, and a ``.safetensors`` writer.

They are what the loaders of ``flmm_tpu_torch.convert`` (and of
``flmm_tpu.convert``) read: ``deepseek-ai/deepseek-vl-*-chat``
(``language_model.*`` HF Llama keys, ``vision_model.vision_tower.*`` timm
SigLIP keys, ``aligner.layers.*``), llava-hf (``language_model.model.*``,
``vision_tower.vision_model.*``, ``multi_modal_projector.*``), HPT's
``llm/``, ``visual_encoder/``, ``projector/`` folders, MGM's main
checkpoint (``model.*`` HF Llama / Gemma / Mixtral keys with
``block_sparse_moe`` experts, ``model.mm_projector.*``,
``model.vlm_uni_{query,aux,val}_projector.*``) and its open_clip ConvNeXt
(``visual.trunk.*``), the official SAM ``.pth`` (``image_encoder.*``,
``prompt_encoder.*``, ``mask_decoder.*``) and a released F-LMM trained
checkpoint (``mask_head.*`` mmseg UNetHead,
``text_proj.*``, ``text_layer_weights``, ``sam.model.prompt_encoder.*``,
``sam.model.mask_decoder.*``).  Test fixtures, used by the CPU tests and by
chip_smoke.py on the card; they import neither JAX nor PIL.
"""

from __future__ import annotations

import json
import pathlib
import struct

import torch

_ST_NAMES = {torch.float64: "F64", torch.float32: "F32", torch.float16: "F16",
             torch.bfloat16: "BF16", torch.int64: "I64", torch.int32: "I32",
             torch.int16: "I16", torch.int8: "I8", torch.uint8: "U8",
             torch.bool: "BOOL"}


def write_safetensors(path, tensors: dict) -> int:
    """``{name: tensor}`` -> one ``.safetensors`` file: an 8-byte
    little-endian header length, the JSON header (padded with spaces to 8
    bytes), the raw data, the widest dtypes first so every tensor stays
    aligned.  Returns the bytes written."""
    names = sorted(tensors, key=lambda k: (-tensors[k].element_size(), k))
    header, offset = {}, 0
    for k in names:
        t = tensors[k]
        n = t.numel() * t.element_size()
        header[k] = {"dtype": _ST_NAMES[t.dtype], "shape": list(t.shape),
                     "data_offsets": [offset, offset + n]}
        offset += n
    blob = json.dumps(header, separators=(",", ":")).encode()
    blob += b" " * (-len(blob) % 8)
    path = pathlib.Path(path)
    with open(path, "wb") as f:
        f.write(struct.pack("<Q", len(blob)))
        f.write(blob)
        for k in names:
            t = tensors[k].detach().contiguous().cpu()
            f.write(t.reshape(-1).view(torch.uint8).numpy().tobytes())
    return 8 + len(blob) + offset


def write_shards(dirpath, sd: dict, n_shards: int) -> int:
    """``sd`` as ``n_shards`` safetensors files of about equal size, in the
    HF shard naming; returns the bytes written."""
    dirpath = pathlib.Path(dirpath)
    dirpath.mkdir(parents=True, exist_ok=True)
    total = sum(t.numel() * t.element_size() for t in sd.values())
    shards, cur, size = [], {}, 0
    for k in sorted(sd):
        cur[k] = sd[k]
        size += sd[k].numel() * sd[k].element_size()
        if size >= total * (len(shards) + 1) / n_shards \
                and len(shards) < n_shards - 1:
            shards.append(cur)
            cur = {}
    shards.append(cur)
    return sum(write_safetensors(
        dirpath / f"model-{i + 1:05d}-of-{len(shards):05d}.safetensors", s)
        for i, s in enumerate(shards))


def _w(t: torch.Tensor, dtype=None) -> torch.Tensor:
    """A tree leaf as a CPU checkpoint tensor (``dtype`` default: its own)."""
    return t.detach().to("cpu", dtype or t.dtype).contiguous()


def _oihw(k: torch.Tensor, dtype=None) -> torch.Tensor:
    """HWIO -> torch ``(O, I, kh, kw)``."""
    return _w(k.permute(3, 2, 0, 1), dtype)


def llama_state_dict(tree: dict, prefix: str = "model.",
                     head_key: str = "lm_head.weight", dtype=None) -> dict:
    """Inverse of ``hf_weights.llama_decoder_params`` (Mixtral's
    ``block_sparse_moe`` keys when the tree has a router)."""
    lay, sd = tree["layers"], {}
    names = {"wq": "self_attn.q_proj", "wk": "self_attn.k_proj",
             "wv": "self_attn.v_proj", "wo": "self_attn.o_proj"}
    moe = "router" in lay
    if not moe:
        names.update({"w_gate": "mlp.gate_proj", "w_up": "mlp.up_proj",
                      "w_down": "mlp.down_proj"})
    for i in range(lay["ln1"].shape[0]):
        p = f"{prefix}layers.{i}."
        sd[p + "input_layernorm.weight"] = _w(lay["ln1"][i], dtype)
        sd[p + "post_attention_layernorm.weight"] = _w(lay["ln2"][i], dtype)
        for key, name in names.items():
            sd[p + name + ".weight"] = _w(lay[key][i].T, dtype)
        if moe:
            m = p + "block_sparse_moe."
            sd[m + "gate.weight"] = _w(lay["router"][i].T, dtype)
            for key, name in (("w_gate", "w1"), ("w_up", "w3"),
                              ("w_down", "w2")):
                for e in range(lay[key].shape[1]):
                    sd[m + f"experts.{e}.{name}.weight"] = _w(
                        lay[key][i, e].T, dtype)
        for b in ("bq", "bk", "bv"):
            if b in lay:
                sd[p + f"self_attn.{b[1]}_proj.bias"] = _w(lay[b][i], dtype)
    sd[prefix + "embed_tokens.weight"] = _w(tree["embed"], dtype)
    sd[prefix + "norm.weight"] = _w(tree["final_norm"], dtype)
    if "lm_head" in tree:
        sd[head_key] = _w(tree["lm_head"].T, dtype)
    return sd


def timm_siglip_state_dict(tree: dict, dtype=None) -> dict:
    """Inverse of ``hf_weights.timm_siglip_vit_params``."""
    lay = tree["layers"]
    sd = {"patch_embed.proj.weight": _oihw(tree["patch_kernel"], dtype),
          "patch_embed.proj.bias": _w(tree["patch_bias"], dtype),
          "pos_embed": _w(tree["pos_embed"][None], dtype),
          "norm.weight": _w(tree["final_ln_w"], dtype),
          "norm.bias": _w(tree["final_ln_b"], dtype)}
    names = {"ln1_w": "norm1.weight", "ln1_b": "norm1.bias",
             "ln2_w": "norm2.weight", "ln2_b": "norm2.bias",
             "wqkv": "attn.qkv.weight", "bqkv": "attn.qkv.bias",
             "wo": "attn.proj.weight", "bo": "attn.proj.bias",
             "w1": "mlp.fc1.weight", "b1": "mlp.fc1.bias",
             "w2": "mlp.fc2.weight", "b2": "mlp.fc2.bias"}
    for i in range(lay["ln1_w"].shape[0]):
        for key, name in names.items():
            t = lay[key][i]
            sd[f"blocks.{i}.{name}"] = _w(t.T if t.dim() == 2 else t, dtype)
    return sd


def hf_tower_state_dict(tree: dict, prefix: str = "vision_model.",
                        dtype=None) -> dict:
    """Inverse of ``hf_weights.clip_vit_params`` / ``siglip_vit_params``
    (which keys exist follows the tree: class token, pre-norm)."""
    lay, emb = tree["layers"], prefix + "embeddings."
    sd = {emb + "patch_embedding.weight": _oihw(tree["patch_kernel"], dtype),
          emb + "position_embedding.weight": _w(tree["pos_embed"], dtype),
          prefix + "post_layernorm.weight": _w(tree["final_ln_w"], dtype),
          prefix + "post_layernorm.bias": _w(tree["final_ln_b"], dtype)}
    if "patch_bias" in tree:
        sd[emb + "patch_embedding.bias"] = _w(tree["patch_bias"], dtype)
    if "cls_token" in tree:
        sd[emb + "class_embedding"] = _w(tree["cls_token"], dtype)
    if "pre_ln_w" in tree:
        sd[prefix + "pre_layrnorm.weight"] = _w(tree["pre_ln_w"], dtype)
        sd[prefix + "pre_layrnorm.bias"] = _w(tree["pre_ln_b"], dtype)
    d = lay["wo"].shape[-1]
    for i in range(lay["ln1_w"].shape[0]):
        p = f"{prefix}encoder.layers.{i}."
        for j, n in enumerate("qkv"):
            sd[p + f"self_attn.{n}_proj.weight"] = _w(
                lay["wqkv"][i][:, j * d:(j + 1) * d].T, dtype)
            sd[p + f"self_attn.{n}_proj.bias"] = _w(
                lay["bqkv"][i][j * d:(j + 1) * d], dtype)
        for key, name in {"ln1_w": "layer_norm1.weight",
                          "ln1_b": "layer_norm1.bias",
                          "ln2_w": "layer_norm2.weight",
                          "ln2_b": "layer_norm2.bias",
                          "wo": "self_attn.out_proj.weight",
                          "bo": "self_attn.out_proj.bias",
                          "w1": "mlp.fc1.weight", "b1": "mlp.fc1.bias",
                          "w2": "mlp.fc2.weight",
                          "b2": "mlp.fc2.bias"}.items():
            t = lay[key][i]
            sd[p + name] = _w(t.T if t.dim() == 2 else t, dtype)
    return sd


def linear_layers_state_dict(layers: list, prefix: str, indices,
                             dtype=None) -> dict:
    """``[{'w', 'b'}]`` -> a Sequential's Linears at ``indices``."""
    sd = {}
    for i, layer in zip(indices, layers):
        sd[f"{prefix}{i}.weight"] = _w(layer["w"].T, dtype)
        sd[f"{prefix}{i}.bias"] = _w(layer["b"], dtype)
    return sd


def deepseek_vl_state_dict(frozen: dict, dtype=None) -> dict:
    """The deepseek-vl-chat checkpoint of a frozen tree (llm, vision,
    projector); the aligner is Sequential(Linear, GELU, Linear)."""
    sd = {}
    for k, t in llama_state_dict(frozen["llm"], dtype=dtype).items():
        sd["language_model." + k] = t
    for k, t in timm_siglip_state_dict(frozen["vision"], dtype).items():
        sd["vision_model.vision_tower." + k] = t
    sd.update(linear_layers_state_dict(
        frozen["projector"], "aligner.layers.",
        range(0, 2 * len(frozen["projector"]), 2), dtype))
    return sd


def llava_state_dict(frozen: dict, dtype=None) -> dict:
    """The llava-hf checkpoint of a frozen tree (``image_newline`` too when
    the tree has one)."""
    sd = llama_state_dict(frozen["llm"], prefix="language_model.model.",
                          head_key="language_model.lm_head.weight",
                          dtype=dtype)
    sd.update(hf_tower_state_dict(frozen["vision"],
                                  "vision_tower.vision_model.", dtype))
    sd.update(linear_layers_state_dict(frozen["projector"],
                                       "multi_modal_projector.linear_",
                                       (1, 2), dtype))
    if "image_newline" in frozen:
        sd["image_newline"] = _w(frozen["image_newline"], dtype)
    return sd


def hpt_checkpoint(root, frozen: dict, siglip: bool, dtype=None):
    """HPT's three folders under ``root``: ``llm/`` and ``visual_encoder/``
    (with a config.json naming the tower) and ``projector/``, each one
    ``pytorch_model.bin``."""
    root = pathlib.Path(root)
    parts = {"llm": llama_state_dict(frozen["llm"], dtype=dtype),
             "visual_encoder": hf_tower_state_dict(frozen["vision"],
                                                   dtype=dtype),
             "projector": linear_layers_state_dict(
                 frozen["projector"], "model.",
                 range(0, 2 * len(frozen["projector"]), 2), dtype)}
    for name, sd in parts.items():
        (root / name).mkdir(parents=True, exist_ok=True)
        torch.save(sd, root / name / "pytorch_model.bin")
    (root / "visual_encoder" / "config.json").write_text(json.dumps(
        {"model_type": "siglip_vision_model" if siglip
         else "clip_vision_model"}))
    return root


def convnext_state_dict(tree: dict, prefix: str = "visual.trunk.",
                        dtype=None) -> dict:
    """Inverse of ``load.convnext_params``: an open_clip ConvNeXt trunk."""
    sd = {"stem.0.weight": _oihw(tree["stem_k"], dtype),
          "stem.0.bias": _w(tree["stem_b"], dtype),
          "stem.1.weight": _w(tree["stem_ln_w"], dtype),
          "stem.1.bias": _w(tree["stem_ln_b"], dtype)}
    for s_i, stage in enumerate(tree["stages"]):
        if s_i > 0:
            down = f"stages.{s_i}.downsample."
            sd[down + "0.weight"] = _w(stage["down_ln_w"], dtype)
            sd[down + "0.bias"] = _w(stage["down_ln_b"], dtype)
            sd[down + "1.weight"] = _oihw(stage["down_k"], dtype)
            sd[down + "1.bias"] = _w(stage["down_b"], dtype)
        for b_i, bp in enumerate(stage["blocks"]):
            blk = f"stages.{s_i}.blocks.{b_i}."
            sd[blk + "conv_dw.weight"] = _oihw(bp["dw_k"], dtype)
            for key, name in (("dw_b", "conv_dw.bias"),
                              ("ln_w", "norm.weight"), ("ln_b", "norm.bias"),
                              ("b1", "mlp.fc1.bias"), ("b2", "mlp.fc2.bias"),
                              ("gamma", "gamma")):
                sd[blk + name] = _w(bp[key], dtype)
            sd[blk + "mlp.fc1.weight"] = _w(bp["w1"].T, dtype)
            sd[blk + "mlp.fc2.weight"] = _w(bp["w2"].T, dtype)
    return {prefix + k: t for k, t in sd.items()}


def mgm_state_dict(frozen: dict, dtype=None) -> dict:
    """MGM's main checkpoint of a frozen tree: the LLM under ``model.``
    (``lm_head.weight`` at the top when the tree has one),
    ``model.mm_projector`` as Sequential(Linear, GELU, Linear) and the
    three ``model.vlm_uni_*_projector`` Sequential(LayerNorm, Linear)."""
    sd = llama_state_dict(frozen["llm"], prefix="model.", dtype=dtype)
    sd.update(linear_layers_state_dict(
        frozen["projector"], "model.mm_projector.",
        range(0, 2 * len(frozen["projector"]), 2), dtype))
    for name in ("query", "aux", "val"):
        p = frozen[f"uni_{name}"]
        base = f"model.vlm_uni_{name}_projector."
        sd[base + "0.weight"] = _w(p["ln_w"], dtype)
        sd[base + "0.bias"] = _w(p["ln_b"], dtype)
        sd[base + "1.weight"] = _w(p["w"].T, dtype)
        sd[base + "1.bias"] = _w(p["b"], dtype)
    return sd


def mgm_checkpoints(root, frozen: dict, dtype=None) -> dict:
    """MGM's three checkpoints under ``root``: the main one
    (``mgm/pytorch_model.bin``), the CLIP tower's HF directory
    (``clip/pytorch_model.bin``) and the open_clip ConvNeXt
    (``convnext/open_clip_pytorch_model.bin``).  Returns their paths."""
    root = pathlib.Path(root)
    paths = {"checkpoint": root / "mgm", "clip": root / "clip",
             "aux": root / "convnext"}
    for p in paths.values():
        p.mkdir(parents=True, exist_ok=True)
    torch.save(mgm_state_dict(frozen, dtype),
               paths["checkpoint"] / "pytorch_model.bin")
    torch.save(hf_tower_state_dict(frozen["vision"], dtype=dtype),
               paths["clip"] / "pytorch_model.bin")
    torch.save(convnext_state_dict(frozen["aux_tower"], dtype=dtype),
               paths["aux"] / "open_clip_pytorch_model.bin")
    return paths


def sam_encoder_state_dict(tree: dict, prefix: str = "image_encoder.",
                           dtype=None) -> dict:
    """Inverse of ``sam_weights.encoder_params`` at the tree's own size."""
    sd = {"patch_embed.proj.weight": _oihw(tree["patch_kernel"], dtype),
          "patch_embed.proj.bias": _w(tree["patch_bias"], dtype),
          "pos_embed": _w(tree["pos_embed"][None], dtype)}
    for j in (0, 1):
        sd[f"neck.{2 * j}.weight"] = _oihw(tree[f"neck{j}_kernel"], dtype)
        sd[f"neck.{2 * j + 1}.weight"] = _w(tree[f"neck{j}_ln_w"], dtype)
        sd[f"neck.{2 * j + 1}.bias"] = _w(tree[f"neck{j}_ln_b"], dtype)
    for i, bp in enumerate(tree["blocks"]):
        b = f"blocks.{i}."
        for key, name in {"ln1_w": "norm1.weight", "ln1_b": "norm1.bias",
                          "ln2_w": "norm2.weight", "ln2_b": "norm2.bias",
                          "bqkv": "attn.qkv.bias", "bo": "attn.proj.bias",
                          "rel_pos_h": "attn.rel_pos_h",
                          "rel_pos_w": "attn.rel_pos_w"}.items():
            sd[b + name] = _w(bp[key], dtype)
        sd[b + "attn.qkv.weight"] = _w(bp["wqkv"].T, dtype)
        sd[b + "attn.proj.weight"] = _w(bp["wo"].T, dtype)
        for n in (1, 2):
            sd[b + f"mlp.lin{n}.weight"] = _w(bp["mlp"][f"w{n}"].T, dtype)
            sd[b + f"mlp.lin{n}.bias"] = _w(bp["mlp"][f"b{n}"], dtype)
    return {prefix + k: t for k, t in sd.items()}


def prompt_encoder_state_dict(tree: dict, prefix: str = "prompt_encoder.",
                              dtype=None) -> dict:
    md, sd = tree["mask_down"], {}
    sd["pe_layer.positional_encoding_gaussian_matrix"] = _w(
        tree["pe_gaussian"], dtype)
    for i in range(4):
        sd[f"point_embeddings.{i}.weight"] = _w(
            tree["point_embeddings"][i:i + 1], dtype)
    sd["not_a_point_embed.weight"] = _w(tree["not_a_point"], dtype)
    sd["no_mask_embed.weight"] = _w(tree["no_mask"], dtype)
    for j, idx in ((0, 0), (1, 3), (2, 6)):
        sd[f"mask_downscaling.{idx}.weight"] = _oihw(md[f"k{j}"], dtype)
        sd[f"mask_downscaling.{idx}.bias"] = _w(md[f"b{j}"], dtype)
    for j, idx in ((0, 1), (1, 4)):
        sd[f"mask_downscaling.{idx}.weight"] = _w(md[f"ln{j}_w"], dtype)
        sd[f"mask_downscaling.{idx}.bias"] = _w(md[f"ln{j}_b"], dtype)
    return {prefix + k: t for k, t in sd.items()}


def _lin_sd(p: dict, name: str, dtype) -> dict:
    return {name + ".weight": _w(p["w"].T, dtype),
            name + ".bias": _w(p["b"], dtype)}


def _attn_sd(p: dict, name: str, dtype) -> dict:
    sd = {}
    for k in ("q", "k", "v", "out"):
        sd.update(_lin_sd(p[k], f"{name}.{k}_proj", dtype))
    return sd


def _conv_transpose_weight(k: torch.Tensor, dtype) -> torch.Tensor:
    """Inverse of ``sam_weights._conv_transpose_kernel``."""
    return _w(k.flip(0, 1).permute(2, 3, 0, 1), dtype)


def mask_decoder_state_dict(tree: dict, prefix: str = "mask_decoder.",
                            dtype=None) -> dict:
    tr, sd = tree["transformer"], {}
    sd["iou_token.weight"] = _w(tree["iou_token"], dtype)
    sd["mask_tokens.weight"] = _w(tree["mask_tokens"], dtype)
    for i, lp in enumerate(tr["layers"]):
        t = f"transformer.layers.{i}."
        sd.update(_attn_sd(lp["self_attn"], t + "self_attn", dtype))
        sd.update(_attn_sd(lp["cross_t2i"], t + "cross_attn_token_to_image",
                           dtype))
        sd.update(_attn_sd(lp["cross_i2t"], t + "cross_attn_image_to_token",
                           dtype))
        for n in (1, 2):
            sd[t + f"mlp.lin{n}.weight"] = _w(lp["mlp"][f"w{n}"].T, dtype)
            sd[t + f"mlp.lin{n}.bias"] = _w(lp["mlp"][f"b{n}"], dtype)
        for j in range(1, 5):
            sd[t + f"norm{j}.weight"] = _w(lp[f"ln{j}_w"], dtype)
            sd[t + f"norm{j}.bias"] = _w(lp[f"ln{j}_b"], dtype)
    sd.update(_attn_sd(tr["final_attn"],
                       "transformer.final_attn_token_to_image", dtype))
    sd["transformer.norm_final_attn.weight"] = _w(tr["final_ln_w"], dtype)
    sd["transformer.norm_final_attn.bias"] = _w(tr["final_ln_b"], dtype)
    up = tree["upscale"]
    sd["output_upscaling.0.weight"] = _conv_transpose_weight(up["k0"], dtype)
    sd["output_upscaling.0.bias"] = _w(up["b0"], dtype)
    sd["output_upscaling.1.weight"] = _w(up["ln_w"], dtype)
    sd["output_upscaling.1.bias"] = _w(up["ln_b"], dtype)
    sd["output_upscaling.3.weight"] = _conv_transpose_weight(up["k1"], dtype)
    sd["output_upscaling.3.bias"] = _w(up["b1"], dtype)
    for i, mlp in enumerate(tree["hyper_mlps"]):
        for j, p in enumerate(mlp):
            sd.update(_lin_sd(p, f"output_hypernetworks_mlps.{i}.layers.{j}",
                              dtype))
    for j, p in enumerate(tree["iou_mlp"]):
        sd.update(_lin_sd(p, f"iou_prediction_head.layers.{j}", dtype))
    return {prefix + k: t for k, t in sd.items()}


def _conv_module_sd(p: dict, prefix: str, dtype) -> dict:
    """One mmcv ConvModule; its conv bias only where the tree's is not zero
    (mmcv's ``bias='auto'`` drops it before a norm)."""
    sd = {prefix + ".conv.weight": _oihw(p["k"], dtype),
          prefix + ".gn.weight": _w(p["gn_w"], dtype),
          prefix + ".gn.bias": _w(p["gn_b"], dtype)}
    if bool((p["b"] != 0).any()):
        sd[prefix + ".conv.bias"] = _w(p["b"], dtype)
    return sd


def unet_state_dict(tree: dict, prefix: str = "mask_head.",
                    dtype=None) -> dict:
    """Inverse of ``load.unet_params``: mmseg's UNetHead with a MaxPool2d
    ahead of every encoder block but the first."""
    sd = {}
    for i, convs in enumerate(tree["enc"]):
        for j, p in enumerate(convs):
            sd.update(_conv_module_sd(
                p, f"encoder.{i}.{0 if i == 0 else 1}.convs.{j}", dtype))
    for d, dec in enumerate(tree["dec"]):
        sd.update(_conv_module_sd(
            dec["up"], f"decoder.{d}.upsample.interp_upsample.1", dtype))
        for j, p in enumerate(dec["convs"]):
            sd.update(_conv_module_sd(
                p, f"decoder.{d}.conv_block.convs.{j}", dtype))
    sd["conv_seg.weight"] = _oihw(tree["seg_k"], dtype)
    sd["conv_seg.bias"] = _w(tree["seg_b"], dtype)
    return {prefix + k: t for k, t in sd.items()}


def released_trained_state_dict(trainable: dict, dtype=None) -> dict:
    """A released F-LMM trained checkpoint of a trainable tree."""
    sd = unet_state_dict(trainable["unet"], dtype=dtype)
    sd["text_proj.weight"] = _w(trainable["text_proj"]["w"].T, dtype)
    sd["text_proj.bias"] = _w(trainable["text_proj"]["b"], dtype)
    sd["text_layer_weights"] = _w(trainable["text_layer_weights"], dtype)
    sd.update(prompt_encoder_state_dict(trainable["sam"]["prompt"],
                                        "sam.model.prompt_encoder.", dtype))
    sd.update(mask_decoder_state_dict(trainable["sam"]["decoder"],
                                      "sam.model.mask_decoder.", dtype))
    return sd
