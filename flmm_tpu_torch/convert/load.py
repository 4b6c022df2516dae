"""Checkpoint assembly: HF / SAM / released F-LMM checkpoints -> the port's
parameter trees (flmm_tpu/convert/load.py).

``load_state_dict`` reads a single ``.pth`` / ``.bin`` / ``.pt`` through
``torch.load(..., weights_only=True)``, a directory of ``pytorch_model*.bin``
shards (or any ``*.bin``), and ``*.safetensors`` files or shards through
this module's own reader (bf16 stays bf16; the ``safetensors`` package is
not needed).  The family loaders build the frozen trees on ``device``;
``reference_trained`` converts a released F-LMM checkpoint into the
trainable tree.  The MGM loaders (``convnext_params``, ``mgm_frozen``) wait
for the MGM family.
"""

from __future__ import annotations

import json
import os
import pathlib
import struct
from typing import Any, Mapping

import torch

from flmm_tpu_torch.convert import hf_weights, sam_weights
from flmm_tpu_torch.convert.hf_weights import leaf

# safetensors dtype names
_ST_DTYPES = {
    "F64": torch.float64, "F32": torch.float32, "F16": torch.float16,
    "BF16": torch.bfloat16, "I64": torch.int64, "I32": torch.int32,
    "I16": torch.int16, "I8": torch.int8, "U8": torch.uint8,
    "BOOL": torch.bool,
}


def read_safetensors(path: str | pathlib.Path) -> dict:
    """A ``.safetensors`` file -> ``{name: tensor}`` on the CPU.  The format:
    an 8-byte little-endian header length, a JSON header of dtype, shape and
    byte offsets, then the raw little-endian data.  The tensors share one
    buffer read whole from the file."""
    path = pathlib.Path(path)
    with open(path, "rb") as f:
        (n,) = struct.unpack("<Q", f.read(8))
        header = json.loads(f.read(n))
        buf = bytearray(os.path.getsize(path) - 8 - n)
        if f.readinto(buf) != len(buf):
            raise ValueError(f"{path}: data ends early")
    out = {}
    for name, info in header.items():
        if name == "__metadata__":
            continue
        if info["dtype"] not in _ST_DTYPES:
            raise ValueError(f"{path}: tensor {name} has dtype "
                             f"{info['dtype']}, which is not supported")
        dtype = _ST_DTYPES[info["dtype"]]
        start, end = info["data_offsets"]
        numel = 1
        for s in info["shape"]:
            numel *= s
        if (end - start) != numel * dtype.itemsize or end > len(buf):
            raise ValueError(f"{path}: tensor {name} has bad offsets")
        t = (torch.frombuffer(buf, dtype=dtype, count=numel, offset=start)
             if numel else torch.empty(0, dtype=dtype))
        out[name] = t.reshape(info["shape"])
    return out


def load_state_dict(path: str | pathlib.Path) -> dict:
    """A checkpoint directory (safetensors shards or torch bins) or a single
    file -> a flat ``name -> tensor`` dict on the CPU."""
    path = pathlib.Path(path)
    if path.is_file():
        if path.suffix == ".safetensors":
            return read_safetensors(path)
        raw = torch.load(path, map_location="cpu", weights_only=True)
        return dict(raw.get("state_dict", raw))
    sd: dict = {}
    st_files = sorted(path.glob("*.safetensors"))
    if st_files:
        for f in st_files:
            sd.update(read_safetensors(f))
        return sd
    # HF shards are pytorch_model*.bin; open_clip releases ship one
    # open_clip_pytorch_model.bin, so any *.bin is taken when those are absent
    bins = sorted(path.glob("pytorch_model*.bin")) or sorted(
        path.glob("*.bin"))
    if not bins:
        raise FileNotFoundError(f"no weights found under {path}")
    for f in bins:
        sd.update(torch.load(f, map_location="cpu", weights_only=True))
    return sd


def strip_prefix(sd: Mapping[str, Any], prefix: str) -> dict:
    return {k[len(prefix):]: v for k, v in sd.items() if k.startswith(prefix)}


def submodule(sd: Mapping[str, Any], *candidates: str) -> dict:
    """A submodule's dict under the first prefix that has keys (HF moves
    module paths across versions: released llava checkpoints use
    ``language_model.model.*``, transformers >= 4.52 ``model.language_model
    .*``)."""
    for prefix in candidates:
        sub = strip_prefix(sd, prefix)
        if sub:
            return sub
    raise KeyError(f"none of {candidates} found; sample keys: "
                   f"{list(sd)[:5]}")


def llm_with_head(sd: Mapping[str, Any], *candidates: str) -> dict:
    """The LLM submodule with the ``lm_head`` re-attached, laid out for
    ``llama_decoder_params(prefix='')``: the head is top-level (transformers
    >= 4.52 llava), beside the stripped prefix (released llava-hf) or inside
    it already (deepseek's ``language_model.``)."""
    sub = dict(submodule(sd, *candidates))
    if "lm_head.weight" not in sub:
        for k in sd:
            if k.endswith("lm_head.weight"):
                sub["lm_head.weight"] = sd[k]
                break
    return sub


def _seq_linear_layers(sd: Mapping[str, Any], device) -> list:
    """A Sequential of Linears (and activations) -> ordered f32 layers."""
    idx = sorted({int(k.split(".")[-2]) for k in sd
                  if k.endswith(".weight") and k.split(".")[-2].isdigit()})
    return [{"w": leaf(sd[_key(sd, i, "weight")], device,
                       torch.float32).T.contiguous(),
             "b": leaf(sd[_key(sd, i, "bias")], device, torch.float32)}
            for i in idx]


def _key(sd, i, kind):
    for k in sd:
        if k.endswith(f".{i}.{kind}") or k == f"{i}.{kind}":
            return k
    raise KeyError((i, kind))


def _mlp_gelu_layers(sd, prefix: str, device) -> list:
    """DeepSeek's aligner Sequential(Linear, GELU, Linear, ...)."""
    layers = _seq_linear_layers(strip_prefix(dict(sd), prefix + "."), device)
    if not layers:
        raise KeyError(f"no projector layers under {prefix}")
    return layers


def _base(cfg):
    return cfg.base if hasattr(cfg, "base") else cfg


def _sam_encoder(sam_checkpoint, cfg, device) -> dict:
    return sam_weights.encoder_params(load_state_dict(sam_checkpoint),
                                      _base(cfg).sam.encoder, device=device)


# ---------------------------------------------------------------------------
# family assemblies (frozen trees)
# ---------------------------------------------------------------------------


def deepseek_vl_frozen(checkpoint_dir: str, cfg,
                       sam_checkpoint: str | None = None,
                       device="cpu") -> dict:
    """deepseek-ai/deepseek-vl-*-chat -> frozen tree.  Key layout
    (deepseek_vl/models/modeling_vlm.py): ``language_model.*`` (HF Llama),
    ``vision_model.vision_tower.*`` (timm SigLIP trunk), ``aligner.layers.*``
    (mlp_gelu).  A hybrid-tower config (DeepSeek-VL-7B) is refused:
    ``flmm_tpu``'s loader reads no SAM-B tower and no split projector (it
    would return the 1.3B layout's tree), so the port has no layout to hold
    one to."""
    if getattr(cfg, "hybrid_high", None) is not None:
        raise NotImplementedError(
            "deepseek_vl_frozen: the hybrid tower of DeepSeek-VL-7B is not "
            "readable from a checkpoint: flmm_tpu/convert/load.py:101-122 "
            "reads neither the SAM-B high-resolution tower (vision_high) nor "
            "the split projector (high_up, low_up, layers), so neither does "
            "the port (ROADMAP queue 1, the hybrid loader)")
    sd = load_state_dict(checkpoint_dir)
    frozen = {
        "llm": hf_weights.llama_decoder_params(
            llm_with_head(sd, "language_model."), cfg.llm, device=device),
        "vision": hf_weights.timm_siglip_vit_params(
            submodule(sd, "vision_model.vision_tower."), cfg.vision,
            device=device),
        "projector": _mlp_gelu_layers(sd, "aligner.layers", device),
    }
    if sam_checkpoint:
        frozen["sam_encoder"] = _sam_encoder(sam_checkpoint, cfg, device)
    return frozen


def llava_frozen(checkpoint_dir: str, cfg, sam_checkpoint: str | None = None,
                 next_variant: bool = False, device="cpu") -> dict:
    """llava-hf/llava-1.5-*-hf or llava-v1.6 -> frozen tree."""
    base = _base(cfg)
    sd = load_state_dict(checkpoint_dir)
    llm_sd = llm_with_head(sd, "language_model.model.",
                           "model.language_model.", "language_model.")
    vis_sd = submodule(sd, "vision_tower.", "model.vision_tower.")
    proj_sd = submodule(sd, "multi_modal_projector.",
                        "model.multi_modal_projector.")
    f32 = torch.float32
    frozen = {
        "llm": hf_weights.llama_decoder_params(llm_sd, base.llm, prefix="",
                                               device=device),
        "vision": hf_weights.clip_vit_params(vis_sd, base.vision,
                                             device=device),
        "projector": [
            {"w": leaf(proj_sd[f"linear_{i}.weight"], device,
                       f32).T.contiguous(),
             "b": leaf(proj_sd[f"linear_{i}.bias"], device, f32)}
            for i in (1, 2)],
    }
    if next_variant:
        for key in ("image_newline", "model.image_newline"):
            if key in sd:
                frozen["image_newline"] = leaf(sd[key], device, f32)
    if sam_checkpoint:
        frozen["sam_encoder"] = _sam_encoder(sam_checkpoint, cfg, device)
    return frozen


def hpt_frozen(checkpoint_dir: str, cfg, sam_checkpoint: str | None = None,
               device="cpu") -> dict:
    """HPT checkpoints: ``llm/``, ``visual_encoder/`` and ``projector/``
    subfolders (reference flmm/models/frozen_hpt.py:72-105); the tower is
    SigLIP when its config.json says so, else CLIP."""
    root = pathlib.Path(checkpoint_dir)
    vis_json = root / "visual_encoder" / "config.json"
    vis_cfg = json.loads(vis_json.read_text()) if vis_json.exists() else {}
    conv = (hf_weights.siglip_vit_params
            if "siglip" in str(vis_cfg.get("model_type", "")).lower()
            else hf_weights.clip_vit_params)
    frozen = {
        "llm": hf_weights.llama_decoder_params(
            load_state_dict(root / "llm"), cfg.llm, device=device),
        "vision": conv(load_state_dict(root / "visual_encoder"), cfg.vision,
                       device=device),
        "projector": _seq_linear_layers(load_state_dict(root / "projector"),
                                        device),
    }
    if sam_checkpoint:
        frozen["sam_encoder"] = _sam_encoder(sam_checkpoint, cfg, device)
    return frozen


def sam_trainable(sam_checkpoint: str, cfg, device="cpu") -> dict:
    """The SAM prompt encoder and mask decoder from the official checkpoint
    (the reference fine-tunes them from this init)."""
    sd = load_state_dict(sam_checkpoint)
    return {"prompt": sam_weights.prompt_encoder_params(sd, cfg.prompt,
                                                        device=device),
            "decoder": sam_weights.mask_decoder_params(sd, cfg.decoder,
                                                       device=device)}


def _conv_module(sd: Mapping[str, Any], prefix: str, dtype,
                 device="cpu") -> dict:
    """One mmcv ConvModule (conv, a bias only when no norm follows, and
    GroupNorm) -> the port's conv params; the norm's submodule name
    depends on its type ('gn' for GroupNorm)."""
    k = leaf(sd[prefix + ".conv.weight"], device, dtype).permute(
        2, 3, 1, 0).contiguous()
    b = (leaf(sd[prefix + ".conv.bias"], device, dtype)
         if prefix + ".conv.bias" in sd
         else torch.zeros((k.shape[-1],), dtype=dtype, device=device))
    for norm in ("gn", "norm", "bn"):
        if prefix + f".{norm}.weight" in sd:
            return {"k": k, "b": b,
                    "gn_w": leaf(sd[prefix + f".{norm}.weight"], device,
                                 dtype),
                    "gn_b": leaf(sd[prefix + f".{norm}.bias"], device,
                                 dtype)}
    raise KeyError(f"no norm weights under {prefix}")


def unet_params(sd: Mapping[str, Any], cfg, prefix: str = "mask_head.",
                device="cpu") -> dict:
    """An mmseg ``UNetHead`` state dict -> the port's U-Net tree.  Key layout
    (mmseg/models/backbones/unet.py): ``encoder.{i}`` is [MaxPool2d (i > 0,
    no params), BasicConvBlock] with convs at ``encoder.{i}.{b}.convs.{j}``;
    ``decoder.{d}`` an UpConvBlock with ``upsample.interp_upsample.1`` and
    ``conv_block.convs.{j}``; ``conv_seg`` the 1x1 logit conv."""
    sub = strip_prefix(dict(sd), prefix)
    dtype = cfg.dtype
    enc = []
    for i in range(cfg.num_stages):
        b = 0 if i == 0 else 1  # the MaxPool2d precedes the block for i > 0
        if i > 0 and f"encoder.{i}.{b}.convs.0.conv.weight" not in sub:
            b = 0  # the strided variant has no pool module
        enc.append([_conv_module(sub, f"encoder.{i}.{b}.convs.{j}", dtype,
                                 device)
                    for j in range(cfg.enc_num_convs[i])])
    dec = [{"up": _conv_module(sub, f"decoder.{d}.upsample.interp_upsample.1",
                               dtype, device),
            "convs": [_conv_module(sub, f"decoder.{d}.conv_block.convs.{j}",
                                   dtype, device)
                      for j in range(cfg.dec_num_convs[d])]}
           for d in range(cfg.num_stages - 1)]
    return {"enc": enc, "dec": dec,
            "seg_k": leaf(sub["conv_seg.weight"], device, dtype).permute(
                2, 3, 1, 0).contiguous(),
            "seg_b": leaf(sub["conv_seg.bias"], device, dtype)}


def reference_trained(path: str, cfg, device="cpu") -> dict:
    """A released F-LMM trained checkpoint -> the trainable tree.  The
    reference saves exactly its ``requires_grad`` parameters
    (flmm/runner.py:131-139): ``mask_head.*`` (mmseg UNetHead),
    ``text_proj.*``, ``text_layer_weights`` and the fine-tuned
    ``sam.model.prompt_encoder.*`` / ``sam.model.mask_decoder.*``."""
    base = _base(cfg)
    sd = load_state_dict(path)
    f32 = torch.float32
    return {
        "unet": unet_params(sd, base.unet, device=device),
        "text_proj": {"w": leaf(sd["text_proj.weight"], device,
                                f32).T.contiguous(),
                      "b": leaf(sd["text_proj.bias"], device, f32)},
        "text_layer_weights": leaf(sd["text_layer_weights"], device, f32),
        "sam": {
            "prompt": sam_weights.prompt_encoder_params(
                sd, base.sam.prompt, prefix="sam.model.prompt_encoder.",
                device=device),
            "decoder": sam_weights.mask_decoder_params(
                sd, base.sam.decoder, prefix="sam.model.mask_decoder.",
                device=device),
        },
    }
