"""Model-family registry (flmm_tpu/registry.py) for the families the port
has: config presets, model modules, batch builders, the prompt template,
image placeholder and caption prompt of each family, the host processors'
resize rule, the reduced-resolution SAM schedule, the coarse-mask frame,
the frozen-checkpoint loaders, ``resolve_family_setup`` (config, tokenised
prompt and batch-spec kwargs that agree with each other) and the all-plain
twin of a config."""

from __future__ import annotations

import dataclasses
import importlib

from flmm_tpu_torch.models.mask_head.unet import output_hw

# family -> (model module, {preset: "module:factory"}), as in the JAX
# registry; its mgm family is not ported
FAMILIES = {
    "deepseek_vl": ("flmm_tpu_torch.models.frozen.deepseek_vl", {
        "1_3b": "flmm_tpu_torch.configs.deepseek_vl:deepseek_vl_1_3b",
        "7b": "flmm_tpu_torch.configs.deepseek_vl:deepseek_vl_7b",
        "tiny": "flmm_tpu_torch.configs.deepseek_vl:tiny",
        "tiny_hybrid": "flmm_tpu_torch.configs.deepseek_vl:tiny_hybrid",
    }),
    "llava": ("flmm_tpu_torch.models.frozen.grounding", {
        "1_5_7b": "flmm_tpu_torch.configs.llava:llava_1_5_7b",
        "tiny": "flmm_tpu_torch.configs.llava:tiny_llava",
    }),
    "llava_next": ("flmm_tpu_torch.models.frozen.llava_next", {
        "vicuna_7b": "flmm_tpu_torch.configs.llava_next:llava_next_vicuna_7b",
        "mistral_7b":
            "flmm_tpu_torch.configs.llava_next:llava_next_mistral_7b",
        "tiny": "flmm_tpu_torch.configs.llava_next:tiny_llava_next",
    }),
    "hpt": ("flmm_tpu_torch.models.frozen.grounding", {
        "air": "flmm_tpu_torch.configs.hpt:hpt_air",
        "air_1_5": "flmm_tpu_torch.configs.hpt:hpt_air_1_5",
        "tiny": "flmm_tpu_torch.configs.hpt:tiny_hpt",
    }),
}


# prompt template per family (data/tokenization.TEMPLATES; the LLaVA-NeXT
# mistral preset and the MGM vicuna presets override it)
FAMILY_TEMPLATES = {
    "deepseek_vl": "deepseek",
    "llava": "vicuna",
    "llava_next": "vicuna",
    "mgm": "gemma",
    "hpt": "internlm2_chat",
}

# image placeholder per family: DeepSeek-VL's is a token of its tokenizer;
# the others split the prompt on '<image>' and splice the image ids
FAMILY_IMAGE_TOKENS = {
    "deepseek_vl": "<image_placeholder>",
    "llava": "<image>",
    "llava_next": "<image>",
    "mgm": "<image>",
    "hpt": "<image>",
}

# host-processor resize rule per family (data/processors._target_hw)
FAMILY_SIZE_RULES = {
    "deepseek_vl": "deepseek",
    "llava": "llava",
    "llava_next": "llava",
    "mgm": "llava",
    "hpt": "hpt15",
}
# the released configs' caption prompt (reference configs/*/*.py:48-55):
# one image placeholder, expanded to n_img ids at encode time
FAMILY_PROMPTS = {
    "deepseek_vl": ("<image_placeholder>"
                    "Please give me a description of the image."),
    "llava": "<image>\nPlease give me a description of the image.",
    "llava_next": "<image>\nPlease give me a description of the image.",
    "mgm": "<image>\nPlease give me a description of the image.",
    "hpt": "<image>\nPlease give me a description of the image.",
}
# family -> kind of batch builder, as in the JAX registry
BATCH_BUILDERS = {"deepseek_vl": "standard", "llava": "standard",
                  "llava_next": "anyres", "mgm": "mgm", "hpt": "standard"}


def _family(family: str):
    if family not in FAMILIES:
        raise NotImplementedError(
            f"family {family!r} is not ported to flmm_tpu_torch (ported: "
            f"{', '.join(FAMILIES)})")
    return FAMILIES[family]


def get_model(family: str):
    """The model module of a family (``init_params``, ``forward`` and, where
    ported, ``loss_fn``)."""
    return importlib.import_module(_family(family)[0])


def get_config(family: str, preset: str, **kwargs):
    presets = _family(family)[1]
    if preset not in presets:
        raise NotImplementedError(
            f"preset {preset!r} of family {family!r} is not ported (ported: "
            f"{', '.join(presets)})")
    mod, _, attr = presets[preset].partition(":")
    return getattr(importlib.import_module(mod), attr)(**kwargs)


def get_batch_builder(family: str):
    """The family's ``(samples, batch_spec) -> batch`` builder: the standard
    ``collate.build_batch``; the anyres and MGM builders are not ported."""
    kind = BATCH_BUILDERS.get(family)
    if kind == "standard":
        from flmm_tpu_torch.data.collate import build_batch

        return build_batch
    if kind is None:
        _family(family)  # raises by name
    raise NotImplementedError(
        f"the {kind} batch builder of family {family!r} is not ported to "
        "flmm_tpu_torch (ported: the standard build_batch; "
        "data/llava_next.py has only the synthetic anyres batch)")


def build_prompt(family: str, tokenizer, n_img: int,
                 template: str | None = None, prompt: str | None = None,
                 image_token_id: int | None = None):
    """The family's tokenised prompt (``tokenization.encode_multimodal_
    prompt``); ``template`` / ``prompt`` override the released configs'.
    The returned RenderedPrompt's ``img_start`` comes from the tokenizer."""
    from flmm_tpu_torch.data import tokenization as tok

    tpl = tok.TEMPLATES[template or FAMILY_TEMPLATES[family]]
    return tok.encode_multimodal_prompt(
        tokenizer, tpl, prompt or FAMILY_PROMPTS[family],
        FAMILY_IMAGE_TOKENS[family], n_img, image_token_id=image_token_id)


def _flash_align(base):
    return 128 if getattr(base.llm, "use_flash_capture", False) else None


def resolve_family_setup(family: str, preset: str, tokenizer,
                         template: str | None = None,
                         prompt: str | None = None,
                         sam_size: int | None = None, **cfg_kwargs):
    """``(config, RenderedPrompt, batch-spec kwargs)`` that agree: the
    image block's start is taken from the real tokenisation of the family
    prompt (rounded up to 128 when the preset captures through the flash
    kernel), the config is rebuilt with it, and the kwargs every batch
    builder needs (``align_image_block``, ``expected_img_start``, the SAM
    sizes, the processor and, for a hybrid tower, ``hires_size``) come from
    that config.  The JAX registry leaves ``hires_size`` out
    (flmm_tpu/registry.py:181-187), so its batches of a hybrid config lack
    the high-resolution pixels; the port passes it."""
    from flmm_tpu_torch.data.processors import ProcessorConfig

    cfg = get_config(family, preset, **cfg_kwargs)
    base = cfg.base if hasattr(cfg, "base") else cfg
    rp = build_prompt(family, tokenizer, base.num_img_tokens,
                      template=template, prompt=prompt)
    align = _flash_align(base)
    derived = rp.img_start
    if align:
        derived += (align - derived % align) % align
    if derived != base.img_start:
        cfg = get_config(family, preset, img_start=derived, **cfg_kwargs)
        base = cfg.base if hasattr(cfg, "base") else cfg
        align = _flash_align(base)
    if sam_size is not None and sam_size != base.sam.encoder.img_size:
        cfg = with_sam_size(cfg, sam_size)
        base = cfg.base if hasattr(cfg, "base") else cfg
    spec_kwargs = {"align_image_block": align,
                   "expected_img_start": base.img_start,
                   "sam_size": base.sam.encoder.img_size,
                   "prompt_size": base.sam.prompt_size,
                   "processor": ProcessorConfig(
                       size=base.input_size,
                       size_rule=FAMILY_SIZE_RULES[family])}
    if getattr(base, "hybrid_high", None) is not None:
        spec_kwargs["hires_size"] = base.hybrid_high.encoder.img_size
    return cfg, rp, spec_kwargs


def get_loader(family: str):
    """The frozen-checkpoint loader of a family:
    ``loader(checkpoint_dir, cfg, sam_checkpoint=None, device="cpu")``."""
    from flmm_tpu_torch.convert import load as load_mod

    if family == "mgm":
        raise NotImplementedError(
            "the MGM loaders (convnext_params, mgm_frozen) are not ported: "
            "ROADMAP queue 1 item 8")
    _family(family)  # raises by name

    def llava_next(checkpoint_dir, cfg, sam_checkpoint=None, device="cpu"):
        return load_mod.llava_frozen(checkpoint_dir, cfg, sam_checkpoint,
                                     next_variant=True, device=device)

    return {"deepseek_vl": load_mod.deepseek_vl_frozen,
            "llava": load_mod.llava_frozen, "llava_next": llava_next,
            "hpt": load_mod.hpt_frozen}[family]


def with_sam_size(cfg, img_size: int):
    """The config with the SAM refiner at another input resolution (the
    reduced-resolution deployment schedule, e.g. 448: a 28 x 28 grid in 2 x 2
    windows of 14), threading the grid through the prompt-encoder geometry
    and the dense-prompt resolution."""
    base = cfg.base if hasattr(cfg, "base") else cfg
    sam = base.sam
    if img_size % sam.encoder.patch_size:
        raise ValueError(f"SAM size {img_size} is not a multiple of the "
                         f"patch size {sam.encoder.patch_size}")
    grid = img_size // sam.encoder.patch_size
    new_sam = dataclasses.replace(
        sam,
        encoder=dataclasses.replace(sam.encoder, img_size=img_size),
        prompt=dataclasses.replace(sam.prompt, image_embedding_size=grid,
                                   input_image_size=img_size),
        prompt_size=4 * grid)
    new_base = dataclasses.replace(base, sam=new_sam)
    if hasattr(cfg, "base"):
        return dataclasses.replace(cfg, base=new_base)
    return new_base


def get_coarse_hw(cfg) -> tuple:
    """Canonical coarse-mask frame of a family config: LLaVA-NeXT's fixed
    square frame, else the U-Net's upsample rule over the attention grid of
    a contiguous image block."""
    if hasattr(cfg, "coarse_frame"):  # LlavaNextConfig
        return tuple(cfg.coarse_frame)
    return output_hw(cfg.unet, (cfg.clip_shape, cfg.clip_shape))


def plain_config(cfg):
    """The same model with every kernel gate off: the port's own unfused
    path, which every kernel path is compared with and timed against."""
    if hasattr(cfg, "base"):  # LlavaNextConfig
        return dataclasses.replace(cfg, base=plain_config(cfg.base))
    enc = dataclasses.replace(cfg.sam.encoder, flash_global=False,
                              flash_window=False, window_block_fused=False,
                              global_block_fused=False, fused_mlp=False)
    return dataclasses.replace(
        cfg, llm=dataclasses.replace(cfg.llm, use_flash_capture=False),
        vision=dataclasses.replace(cfg.vision, fused_mlp=False, flash=False),
        sam=dataclasses.replace(cfg.sam, encoder=enc))
