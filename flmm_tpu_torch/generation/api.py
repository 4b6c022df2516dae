"""High-level grounding / generation API (flmm_tpu/generation/api.py).

The reference's interactive surface on the port:

* ``answer``: free-form generation caching per-step text->image attention
  and layer-weighted hidden states (reference frozen_deepseek_vl.py:514);
* ``ground``: masks of arbitrary token spans of a finished generation
  (frozen_deepseek_vl.py:568);
* ``visual_cot_v1/v2/v3``: think -> ground -> crop -> re-answer pipelines
  (frozen_deepseek_vl.py:271,374,478);
* ``mask2box_scaled``: a mask's box with scale expansion
  (frozen_deepseek_vl.py:458-475).

An image is an ``(H, W, 3)`` uint8 numpy array (no PIL); a crop is a slice
of it.  The grounder runs on ``device`` (the card unless the caller passes
a CPU device), where its params must live: the tower, decoder, U-Net, SAM
encoder and refiner are the port's modules, so on a CUDA tensor they launch
the same kernels as the grounding forward.  An answer keeps its attention
maps and hidden states as tensors on the device; ids, text, masks and
boxes are host values.  ``MGMGrounder`` serves the MGM family (its two
towers, the HD crop grid and the stitched maps); a hybrid-tower config
(DeepSeek-VL-7B) is refused, as the JAX grounder cannot run one.
"""

from __future__ import annotations

import dataclasses
import warnings
from typing import Any

import numpy as np
import torch

from flmm_tpu_torch.data import geometry
from flmm_tpu_torch.data import tokenization as tok
from flmm_tpu_torch.data.llava_next import anyres_process, block_layout
from flmm_tpu_torch.data.mgm import mgm_process
from flmm_tpu_torch.data.processors import ProcessorConfig, sam_preprocess, \
    square_pad_preprocess
from flmm_tpu_torch.evalsuite.runner import sam_logits_to_masks
from flmm_tpu_torch.generation import decode as dec
from flmm_tpu_torch.models.frozen import llava_next as mln
from flmm_tpu_torch.models.frozen import mgm as mgm_model
from flmm_tpu_torch.models.frozen.grounding import GroundingConfig, _project
from flmm_tpu_torch.models.llm import decoder as llm
from flmm_tpu_torch.models.mask_head import refiner as sam_refiner
from flmm_tpu_torch.models.mask_head import unet
from flmm_tpu_torch.models.sam import image_encoder as sam_encoder
from flmm_tpu_torch.models.vision import vit
from flmm_tpu_torch.registry import FAMILY_IMAGE_TOKENS, FAMILY_SIZE_RULES, \
    FAMILY_TEMPLATES


def make_grounder(family: str, cfg, params, tokenizer, **kw):
    """Family-correct grounder with the family's registry template and
    image token: ``AnyresGrounder`` for llava_next, ``MGMGrounder`` for mgm,
    the base ``Grounder`` otherwise.  Extra kwargs are filtered to the
    fields the selected class supports (e.g. ``max_thought_tokens`` only
    exists on the base and MGM CoT surface)."""
    template = tok.TEMPLATES[FAMILY_TEMPLATES[family]]
    image_token = FAMILY_IMAGE_TOKENS[family]
    cls = grounder_class(family)
    if cls is AnyresGrounder:
        cfg_arg = cfg
    elif cls is MGMGrounder:
        cfg_arg = cfg
        kw.setdefault("processor", ProcessorConfig(
            size=cfg.base.input_size, size_rule=FAMILY_SIZE_RULES[family]))
    else:
        cfg_arg = cfg.base if hasattr(cfg, "base") else cfg
        kw.setdefault("processor", ProcessorConfig(
            size=cfg_arg.input_size, size_rule=FAMILY_SIZE_RULES[family]))
    fields = {f.name for f in dataclasses.fields(cls)}
    dropped = sorted(k for k in kw if k not in fields)
    if dropped:
        warnings.warn(
            f"make_grounder: {cls.__name__} (family {family!r}) does not "
            f"support {dropped}; these arguments are ignored", stacklevel=2)
    kw = {k: v for k, v in kw.items() if k in fields}
    return cls(cfg=cfg_arg, params=params, tokenizer=tokenizer,
               prompt_template=template, image_token=image_token, **kw)


def grounder_class(family: str) -> type:
    """The grounder class ``make_grounder`` builds for a family."""
    return {"llava_next": AnyresGrounder, "mgm": MGMGrounder}.get(family,
                                                                   Grounder)


def _sentinel_image_token_id(tokenizer, image_token: str) -> int:
    """The id spliced into the prompt at image slots: the token's own id
    when the tokenizer maps it to a single token (DeepSeek-VL's
    ``<image_placeholder>``), else the 0 sentinel (the spliced embeddings
    are overwritten by the image features anyway)."""
    enc = tokenizer.encode(image_token, add_special_tokens=False)
    return enc[-1] if len(enc) == 1 else 0


def encode_with_images(tokenizer, template: dict, content: str,
                       image_token: str, n_img: int, image_token_id: int,
                       suffix: str = "", n_markers: int | None = 1
                       ) -> tuple[np.ndarray, list[int]]:
    """Tokenise a template-rendered prompt containing one ``image_token``
    marker per image, splicing ``n_img`` sentinel ids at each marker (the
    reference's ``tokenizer_image_token`` split-splice for any marker
    count: the placeholder string never reaches the tokenizer).
    ``suffix`` is appended after the rendered template (forced generation
    prefixes); ``n_markers`` bounds the split (None: unbounded), so a
    question holding the literal marker stays text.  Returns ``(ids,
    starts)`` with one block start per marker."""
    rendered = tok.PromptSpec(template, content).render() + suffix
    parts = (rendered.split(image_token) if n_markers is None
             else rendered.split(image_token, n_markers))
    if len(parts) < 2:
        raise ValueError(f"prompt does not contain {image_token!r}")
    ids: list[int] = list(tokenizer.encode(parts[0], add_special_tokens=True))
    starts: list[int] = []
    for part in parts[1:]:
        starts.append(len(ids))
        ids += [image_token_id] * n_img
        ids += list(tokenizer.encode(part, add_special_tokens=False))
    return np.asarray(ids, np.int32), starts


def mask2box_scaled(mask: np.ndarray, scale: float = 1.0) -> tuple:
    """Box ``(x0, y0, x1, y1)`` of a binary mask with centre-scale expansion,
    clamped inside the image (so ``image[y0:y1, x0:x1]`` is PIL's crop of
    the box); the full image box if the mask is empty."""
    h, w = mask.shape
    ys, xs = np.where(mask)
    if len(ys) == 0:
        return 0, 0, w, h
    y0, y1 = ys.min(), ys.max()
    x0, x1 = xs.min(), xs.max()
    yd, xd = max((y1 - y0) / 2, 8), max((x1 - x0) / 2, 8)
    yc, xc = (y1 + y0) / 2, (x1 + x0) / 2
    x0, x1 = max(0, xc - xd * scale), min(w, xc + xd * scale)
    y0, y1 = max(0, yc - yd * scale), min(h, yc + yd * scale)
    return int(x0), int(y0), int(x1), int(y1)


def _crop(image: np.ndarray, bbox: tuple) -> np.ndarray:
    x0, y0, x1, y1 = bbox
    return image[y0:y1, x0:x1]


def _stop_ids(tokenizer, template: dict) -> tuple:
    return tuple(tokenizer.encode(w, add_special_tokens=False)[-1]
                 for w in template.get("STOP_WORDS", []))


def _answer_rows(out: dict, n_valid: int) -> dict:
    """The first ``n_valid`` generated rows: ``(L, H, T, n)`` attention
    maps and ``(T, D)`` hidden states."""
    return {"attention_maps": out["attn"][:n_valid].permute(1, 2, 0, 3),
            "hidden_states": out["hidden"][:n_valid]}


def _image_extras(image: np.ndarray, proc: dict, sam: dict) -> dict:
    """What ``ground`` needs of an answer's image: the LMM frame's meta, the
    SAM input and the original size."""
    return {"meta_data": proc["meta"], "sam_pixels": sam["sam_pixel_values"],
            "sam_input_size": sam["sam_input_size"],
            "orig_size": tuple(image.shape[:2])}


def _valid_tokens(out: dict) -> np.ndarray:
    n = int(out["valid"].sum())
    return out["tokens"][:n].cpu().numpy().astype(np.int32)


def _span_prompts(attn: torch.Tensor, hidden: torch.Tensor, spans: list,
                  merge: str, text_proj: dict, max_text: int) -> tuple:
    """Per span: the ``(L, H, n)`` attention rows merged over its tokens,
    and its hidden states through ``text_proj`` padded to ``max_text``
    prompt tokens; ``(M, L, H, n)``, ``(M, max_text, d)``, ``(M,
    max_text)`` bool."""
    d = text_proj["w"].shape[1]
    texts = torch.zeros((len(spans), max_text, d), dtype=torch.float32,
                        device=hidden.device)
    tvalid = torch.zeros((len(spans), max_text), dtype=torch.bool,
                         device=hidden.device)
    merged = []
    for m, (lo, hi) in enumerate(spans):
        if hi <= lo:
            raise ValueError(f"empty token span {(lo, hi)}")
        rows = attn[:, :, lo:hi].float()
        merged.append(rows.mean(dim=2) if merge == "mean"
                      else rows.amax(dim=2))
        proj = hidden[lo:hi].float() @ text_proj["w"] + text_proj["b"]
        k = min(len(proj), max_text)
        texts[m, :k] = proj[:k]
        tvalid[m, :k] = True
    return torch.stack(merged), texts, tvalid


def _refine(params: dict, base: GroundingConfig, coarse: torch.Tensor,
            answer_out: dict, texts: torch.Tensor,
            tvalid: torch.Tensor) -> torch.Tensor:
    """SAM over the answer's image, prompted by the coarse logits ``(M, hc,
    wc)`` and the span texts; the ``(M, P, P)`` low-res logits."""
    device = coarse.device
    cc = geometry.coarse_crop(answer_out["meta_data"],
                              tuple(coarse.shape[-2:]))
    nh, nw = answer_out["sam_input_size"]
    geom = {k: torch.tensor(float(v), dtype=torch.float32, device=device)
            for k, v in {**cc, "sam_h": nh, "sam_w": nw}.items()}
    sam_px = torch.as_tensor(answer_out["sam_pixels"], device=device)
    img_emb = sam_encoder.forward(params["frozen"]["sam_encoder"],
                                  base.sam.encoder, sam_px[None])[0]
    refined = sam_refiner.refine(params["trainable"]["sam"], base.sam,
                                 img_emb, coarse, geom, texts, tvalid)
    return refined["low_res_logits"]


def _to_masks(base: GroundingConfig, low_res: torch.Tensor,
              answer_out: dict) -> np.ndarray:
    return sam_logits_to_masks(
        low_res, answer_out["sam_input_size"], answer_out["orig_size"],
        sam_size=base.sam.encoder.img_size, prompt_size=base.sam.prompt_size)


@dataclasses.dataclass
class Grounder:
    cfg: GroundingConfig
    params: dict
    tokenizer: Any
    prompt_template: dict
    image_token: str = "<image_placeholder>"
    processor: ProcessorConfig = dataclasses.field(
        default_factory=ProcessorConfig)
    max_new_tokens: int = 64
    max_thought_tokens: int = 16
    box_scale: float = 1.0
    additional_prompt: str = " Please briefly answer the question."
    device: Any = "cuda"

    def __post_init__(self):
        if getattr(self.cfg, "hybrid_high", None) is not None:
            raise NotImplementedError(
                "Grounder: the hybrid tower of DeepSeek-VL-7B is not ported "
                "to generation: flmm_tpu's Grounder._tower calls _project on "
                "the split projector's dict and fails "
                "(flmm_tpu/generation/api.py:186-192), so it has no hybrid "
                "grounder to hold one to (ROADMAP queue 1, the hybrid "
                "Grounder)")
        self.device = torch.device(self.device)
        self.image_token_id = _sentinel_image_token_id(
            self.tokenizer, self.image_token)
        self.stop_ids = _stop_ids(self.tokenizer, self.prompt_template)
        # thought generation also stops at '.' (reference :252)
        dot = self.tokenizer.encode(".", add_special_tokens=False)
        self.thought_stop_ids = self.stop_ids + ((dot[-1],) if dot else ())

    # -- building blocks ----------------------------------------------------

    def _embed_tokens_with_image(self, input_ids: np.ndarray,
                                 pixel_list: list[np.ndarray],
                                 starts: list[int]) -> torch.Tensor:
        """Token embeddings with the image features written at the block
        starts (one block per image: the two-image round of the CoT)."""
        cfg, fro = self.cfg, self.params["frozen"]
        if len(starts) != len(pixel_list):
            raise ValueError(f"{len(starts)} image blocks for "
                             f"{len(pixel_list)} images")
        ids = torch.as_tensor(input_ids, device=self.device).long()
        embeds = llm.embed_tokens(fro["llm"], cfg.llm, ids).to(cfg.dtype)
        feats = self._image_features(pixel_list)
        for i, start in enumerate(starts):
            embeds[start:start + feats.shape[1]] = feats[i].to(cfg.dtype)
        return embeds

    def _image_features(self, pixel_list: list[np.ndarray]) -> torch.Tensor:
        """The images' ``(n, n_img, D)`` features, the tower over them in one
        batch."""
        cfg, fro = self.cfg, self.params["frozen"]
        pixels = torch.as_tensor(np.stack(pixel_list), device=self.device)
        feats = vit.forward(fro["vision"], cfg.vision, pixels,
                            select_layer=cfg.vision_select_layer)
        if cfg.vision_drop_cls:
            feats = feats[:, 1:]
        return _project(feats, fro["projector"])

    def _generate(self, embeds: torch.Tensor, img_start: int, max_new: int,
                  stop_ids: tuple) -> dict:
        """Prefill and greedy decode: the prompt capture ('prompt_attn'
        ``(L, H, S, n)``, 'prompt_hidden', 'last_hidden': the post-final-norm
        state whose logits pick the first token), then 'tokens', 'valid',
        'attn' ``(T, L, H, n)`` and 'hidden' of the generated steps."""
        cfg, llm_p = self.cfg, self.params["frozen"]["llm"]
        lw = torch.softmax(self.params["trainable"]["text_layer_weights"],
                           dim=0)
        state = dec.prefill(llm_p, cfg.llm, embeds, img_start,
                            cfg.num_img_tokens, max_new, layer_weights=lw)
        out = dec.decode(llm_p, cfg.llm, state,
                         dec.DecodeConfig(max_new_tokens=max_new,
                                          stop_token_ids=stop_ids),
                         img_start, cfg.num_img_tokens, layer_weights=lw)
        return {"prompt_attn": state["attn"],
                "prompt_hidden": state["hidden"],
                "last_hidden": state["last_hidden"], **out}

    def _prepare_image(self, image: np.ndarray) -> tuple:
        proc = square_pad_preprocess(image, self.processor)
        sam = sam_preprocess(image, self.cfg.sam.encoder.img_size)
        return proc, sam

    def _pixels(self, image: np.ndarray):
        """The tower's input of one image (no SAM input)."""
        return square_pad_preprocess(image, self.processor)["pixel_values"]

    def _encode_content(self, content: str, suffix: str = "",
                        n_markers: int = 1) -> tuple[np.ndarray, list[int]]:
        """Tokenise template-rendered ``content`` (one ``image_token``
        marker per image) via the split-splice convention; ``n_markers``
        is the number of images the caller supplies."""
        return encode_with_images(
            self.tokenizer, self.prompt_template, content, self.image_token,
            self.cfg.num_img_tokens, self.image_token_id, suffix=suffix,
            n_markers=n_markers)

    # -- public API ---------------------------------------------------------

    @torch.no_grad()
    def answer(self, image: np.ndarray, question: str,
               max_new_tokens: int | None = None,
               history: list | None = None) -> dict:
        """Generate an answer while caching attention / hidden per step.

        ``history``: optional completed ``(question, answer)`` turns (the
        reference's ``_conversation``, frozen_deepseek_vl.py:492-512): the
        image rides the first user turn, follow-ups are text-only, each
        past turn closes with the template suffix."""
        if history:
            tpl = self.prompt_template
            rendered = tok.PromptSpec(
                tpl, self.image_token + history[0][0]).render()
            rendered += " " + history[0][1] + tpl.get("SUFFIX", "")
            for q, a in history[1:]:
                rendered += tpl["INSTRUCTION"].format(input=q)
                rendered += " " + a + tpl.get("SUFFIX", "")
            rendered += tpl["INSTRUCTION"].format(input=question)
            parts = rendered.split(self.image_token, 1)
            ids_l = list(self.tokenizer.encode(parts[0],
                                               add_special_tokens=True))
            starts = [len(ids_l)]
            ids_l += [self.image_token_id] * self.cfg.num_img_tokens
            ids_l += list(self.tokenizer.encode(parts[1],
                                                add_special_tokens=False))
            ids = np.asarray(ids_l, np.int32)
        else:
            ids, starts = self._encode_content(self.image_token + question)
        proc, sam = self._prepare_image(image)
        embeds = self._embed_tokens_with_image(ids, [proc["pixel_values"]],
                                               starts)
        out = self._generate(embeds, starts[0],
                             max_new_tokens or self.max_new_tokens,
                             self.stop_ids)
        tokens = _valid_tokens(out)
        # the reference drops the final (stop) token from the text
        # (answer:562)
        text = self.tokenizer.decode(tokens[:-1]) if len(tokens) else ""
        return {"output_ids": tokens, "output_text": text,
                **_answer_rows(out, len(tokens)),
                **_image_extras(image, proc, sam)}

    def _span_maps(self, merged: torch.Tensor) -> torch.Tensor:
        """The spans' merged rows ``(M, L, H, n_img)`` as ``(M, h, w, C)``
        attention images."""
        M, L, H, _ = merged.shape
        g = self.cfg.clip_shape
        return merged.reshape(M, L * H, g, g).permute(0, 2, 3, 1)

    @torch.no_grad()
    def ground_logits(self, answer_out: dict, positive_spans: list[tuple],
                      max_text: int = 16) -> tuple:
        """Coarse ``(M, hc, wc)`` and SAM low-res ``(M, P, P)`` logits of
        token spans of a generation, as device tensors."""
        cfg, tra = self.cfg, self.params["trainable"]
        merged, texts, tvalid = _span_prompts(
            answer_out["attention_maps"], answer_out["hidden_states"],
            positive_spans, cfg.merge, tra["text_proj"], max_text)
        maps = self._span_maps(merged)
        coarse = unet.forward(tra["unet"], cfg.unet, maps).float()
        return coarse, _refine(self.params, cfg, coarse, answer_out, texts,
                               tvalid)

    def ground(self, answer_out: dict, positive_spans: list[tuple],
               max_text: int = 16) -> tuple:
        """Ground token spans of a generation; returns the coarse logits and
        the ``(M, oh, ow)`` uint8 masks."""
        coarse, low_res = self.ground_logits(answer_out, positive_spans,
                                             max_text)
        return coarse, _to_masks(self.cfg, low_res, answer_out)

    # -- visual chain-of-thought --------------------------------------------

    @torch.no_grad()
    def visual_cot_v1(self, image: np.ndarray, question: str) -> tuple:
        """Think (<= max_thought_tokens) -> ground the thought -> crop ->
        re-answer over the image and the crop."""
        thought_q = (question + "First think which object in this image is "
                     "most relevant to the question.")
        ids, starts = self._encode_content(
            self.image_token + thought_q,
            suffix=" The object most relevant to the question is")
        proc, sam = self._prepare_image(image)
        embeds = self._embed_tokens_with_image(ids, [proc["pixel_values"]],
                                               starts)
        out = self._generate(embeds, starts[0], self.max_thought_tokens,
                             self.thought_stop_ids)
        tvalid = max(1, int(out["valid"].sum()))
        tokens = out["tokens"][:tvalid].cpu().numpy().astype(np.int32)
        thought = self.tokenizer.decode(tokens[:-1]) if len(tokens) > 1 \
            else ""
        answer_out = {**_answer_rows(out, tvalid),
                      **_image_extras(image, proc, sam)}
        _, masks = self.ground(answer_out, [(0, tvalid)])
        mask = masks[0] > 0
        bbox = mask2box_scaled(mask, self.box_scale)
        final = self._two_image_answer(image, _crop(image, bbox), question)
        return thought, bbox, final, mask

    @torch.no_grad()
    def visual_cot_v2(self, image: np.ndarray, question: str) -> tuple:
        """Ground the question tokens from the prompt capture, then crop
        and re-answer."""
        ids, starts = self._encode_content(self.image_token + question)
        q_start = starts[0] + self.cfg.num_img_tokens
        proc, sam = self._prepare_image(image)
        embeds = self._embed_tokens_with_image(ids, [proc["pixel_values"]],
                                               starts)
        # prefill-only pass: the question's rows come from the prompt
        state = self._generate(embeds, starts[0], 1, self.stop_ids)
        answer_out = {"attention_maps": state["prompt_attn"],
                      "hidden_states": state["prompt_hidden"],
                      **_image_extras(image, proc, sam)}
        _, masks = self.ground(answer_out, [(q_start, len(ids))])
        mask = masks[0] > 0
        bbox = mask2box_scaled(mask, self.box_scale)
        final = self._two_image_answer(image, _crop(image, bbox), question)
        return "", bbox, final, mask

    def visual_cot_v3(self, image: np.ndarray, question: str) -> tuple:
        """No-CoT baseline: answer on the image directly."""
        out = self.answer(image, question + self.additional_prompt)
        h, w = image.shape[:2]
        return "", (0, 0, w, h), out["output_text"], None

    def _two_image_answer(self, image: np.ndarray, crop: np.ndarray,
                          question: str) -> str:
        """Round-2 conversation over [full image, crop] (reference
        visual_cot_v1:357-371)."""
        content = (
            f"{self.image_token}the whole image, "
            f"{self.image_token}the image region that "
            f"might help you answer the question: "
            f"{question}{self.additional_prompt}"
        )
        ids, starts = self._encode_content(content, n_markers=2)
        embeds = self._embed_tokens_with_image(
            ids, [self._pixels(im) for im in (image, crop)], starts)
        out = self._generate(embeds, starts[0], self.max_new_tokens,
                             self.stop_ids)
        tokens = _valid_tokens(out)
        return self.tokenizer.decode(tokens[:-1]) if len(tokens) else ""


@dataclasses.dataclass
class MGMGrounder(Grounder):
    """Grounded conversation for the MGM(-HD) family.  MGM's image block is
    contiguous in the prompt, so the base prefill / decode capture applies;
    the image encoding (CLIP crops and the ConvNeXt aux tower through the
    patch-info mining, the HD crop grid) and the grounding maps (the HD
    tiles stitched, the global map upsampled beside them) are MGM's.
    ``cfg`` is the ``MGMConfig``; after construction ``self.cfg`` is its
    ``base`` and ``self.mgm_cfg`` the whole."""

    mgm_cfg: Any = None  # set in __post_init__ from cfg

    def __post_init__(self):
        self.mgm_cfg = self.cfg
        self.cfg = self.cfg.base
        super().__post_init__()
        self.spec = self.mgm_cfg.process_spec()

    def _prepare_image(self, image: np.ndarray) -> tuple:
        proc = mgm_process(image, self.spec)
        sam = sam_preprocess(image, self.cfg.sam.encoder.img_size)
        return {"pixel_values": proc, "meta": proc["meta"]}, sam

    def _pixels(self, image: np.ndarray) -> dict:
        return mgm_process(image, self.spec)

    def _image_features(self, pixel_list: list[dict]) -> torch.Tensor:
        """Both towers and the patch-info mining over the images' crops and
        aux pixels, in one batch."""
        return mgm_model.encode_images(
            self.params, self.mgm_cfg,
            *(torch.as_tensor(np.stack([px[k] for px in pixel_list]),
                              device=self.device) for k in ("crops", "aux")))

    def _span_maps(self, merged: torch.Tensor) -> torch.Tensor:
        """The spans' rows re-assembled as the forward's maps (the HD tiles
        stitched, the global map upsampled beside them)."""
        return mgm_model.assemble_attention(
            self.mgm_cfg, merged.permute(1, 2, 0, 3)[None])


@dataclasses.dataclass
class AnyresGrounder:
    """Grounded conversation for the anyres (LLaVA-NeXT) family: the packed
    prompt's image block has masked pad slots and pad-skipping RoPE
    positions, which prefill and decode honour, and ``ground`` re-assembles
    the coarse and fine maps into the square frame."""

    cfg: Any  # LlavaNextConfig (with .base and .anyres_spec())
    params: dict
    tokenizer: Any
    prompt_template: dict
    image_token: str = "<image_placeholder>"
    max_new_tokens: int = 64
    device: Any = "cuda"

    def __post_init__(self):
        self.device = torch.device(self.device)
        self.base = self.cfg.base
        self.image_token_id = _sentinel_image_token_id(
            self.tokenizer, self.image_token)
        self.stop_ids = _stop_ids(self.tokenizer, self.prompt_template)

    def _generate(self, pk: dict, max_new: int) -> dict:
        base, llm_p = self.base, self.params["frozen"]["llm"]
        n_img = self.cfg.n_img_max
        lw = torch.softmax(self.params["trainable"]["text_layer_weights"],
                           dim=0)
        state = dec.prefill(
            llm_p, base.llm, pk["embeds"], base.img_start, n_img, max_new,
            layer_weights=lw,
            attn_mask=torch.as_tensor(pk["attn_mask"], device=self.device),
            position_ids=torch.as_tensor(pk["position_ids"],
                                         device=self.device))
        out = dec.decode(llm_p, base.llm, state,
                         dec.DecodeConfig(max_new_tokens=max_new,
                                          stop_token_ids=self.stop_ids),
                         base.img_start, n_img, layer_weights=lw)
        return {"prompt_attn": state["attn"],
                "prompt_hidden": state["hidden"],
                "last_hidden": state["last_hidden"], **out}

    def _pack_prompt(self, image: np.ndarray, question: str) -> dict:
        """The packed anyres prompt of one image and question: aligned ids,
        key mask, positions, packed embeddings and the grounding extras
        (layout, meta, SAM input)."""
        cfg, base = self.cfg, self.base
        anyres = cfg.anyres_spec()
        n_img = cfg.n_img_max
        ids, starts = encode_with_images(
            self.tokenizer, self.prompt_template,
            self.image_token + question, self.image_token, n_img,
            self.image_token_id)
        pad_n = base.img_start - starts[0]
        if pad_n < 0:
            raise ValueError(
                f"the prompt's image block starts at {starts[0]}, after the "
                f"config's img_start {base.img_start}")
        pad_id = int(ids[-1])  # any id works: the slots are masked
        ids = np.concatenate([ids[:starts[0]],
                              np.full((pad_n,), pad_id, np.int32),
                              ids[starts[0]:]])
        img_start = base.img_start

        proc = anyres_process(image, anyres)
        layout = block_layout(anyres, proc["grid"], proc["fine_hw"],
                              proc["fine_pad"])
        attn_mask = np.ones((len(ids),), bool)
        attn_mask[img_start - pad_n:img_start] = False
        attn_mask[img_start:img_start + n_img] = layout["block_valid"]
        position_ids = np.maximum(np.cumsum(attn_mask) - 1, 0).astype(
            np.int32)

        g = anyres.tile_size
        nt = proc["tiles"].shape[0]
        tiles = np.zeros((1, 1 + anyres.max_tiles, g, g, 3), np.float32)
        tiles[0, 0] = proc["base"]
        tiles[0, 1:1 + nt] = proc["tiles"]
        batch1 = {k: torch.as_tensor(v, device=self.device) for k, v in {
            "input_ids": ids[None], "tiles": tiles,
            "block_index": layout["block_index"][None],
            "block_valid": layout["block_valid"][None]}.items()}
        embeds = mln.pack_embeds(self.params, cfg, batch1)[0]
        sam = sam_preprocess(image, base.sam.encoder.img_size)
        h, w = image.shape[:2]
        return {
            "ids": ids, "img_start": img_start, "attn_mask": attn_mask,
            "position_ids": position_ids, "embeds": embeds,
            "extras": {
                "fine_gather": layout["fine_gather"],
                "fine_valid": layout["fine_valid"],
                "fine_hw": np.asarray(proc["fine_hw"], np.float32),
                "meta_data": geometry.lmm_meta(h, w, g),
                "sam_pixels": sam["sam_pixel_values"],
                "sam_input_size": sam["sam_input_size"],
                "orig_size": (h, w),
            },
        }

    @torch.no_grad()
    def answer(self, image: np.ndarray, question: str,
               max_new_tokens: int | None = None) -> dict:
        """Generate an answer over the anyres-packed prompt, caching the
        per-step attention rows over the padded image block (zero at its
        pad slots)."""
        pk = self._pack_prompt(image, question)
        out = self._generate(pk, max_new_tokens or self.max_new_tokens)
        tokens = _valid_tokens(out)
        text = self.tokenizer.decode(tokens[:-1]) if len(tokens) else ""
        return {"output_ids": tokens, "output_text": text,
                **_answer_rows(out, len(tokens)), **pk["extras"]}

    @torch.no_grad()
    def visual_cot_v2(self, image: np.ndarray, question: str) -> tuple:
        """Ground the question tokens from the prompt capture, crop, then
        answer on the crop (the anyres packer is single-block, so the final
        answer sees the crop alone)."""
        pk = self._pack_prompt(image, question)
        out = self._generate(pk, 1)
        q_start = pk["img_start"] + self.cfg.n_img_max
        answer_out = {"attention_maps": out["prompt_attn"],
                      "hidden_states": out["prompt_hidden"], **pk["extras"]}
        _, masks = self.ground(answer_out, [(q_start, len(pk["ids"]))])
        mask = masks[0] > 0
        bbox = mask2box_scaled(mask, 1.0)
        final = self.answer(_crop(image, bbox), question)["output_text"]
        return "", bbox, final, mask

    def visual_cot_v3(self, image: np.ndarray, question: str) -> tuple:
        """No-CoT baseline: answer on the full image directly."""
        out = self.answer(image, question)
        h, w = image.shape[:2]
        return "", (0, 0, w, h), out["output_text"], None

    @torch.no_grad()
    def ground_logits(self, answer_out: dict, positive_spans: list[tuple],
                      max_text: int = 16) -> tuple:
        """Coarse and SAM low-res logits of token spans of a generation, the
        maps of each span re-assembled into the square frame."""
        cfg, base, tra = self.cfg, self.base, self.params["trainable"]
        merged, texts, tvalid = _span_prompts(
            answer_out["attention_maps"], answer_out["hidden_states"],
            positive_spans, base.merge, tra["text_proj"], max_text)
        # (1, L, H, M, n_img) -> canonical square dual-stream frames
        attn_b = merged.permute(1, 2, 0, 3)[None]
        geom = geometry.batch_geom([answer_out["meta_data"]],
                                   cfg.coarse_frame,
                                   [answer_out["sam_input_size"]])
        gbatch = {k: torch.as_tensor(answer_out[k][None], device=self.device)
                  for k in ("fine_gather", "fine_valid", "fine_hw")}
        gbatch["geom"] = {k: torch.as_tensor(v, device=self.device)
                          for k, v in geom.items()}
        maps = mln.assemble_frames(cfg, attn_b, gbatch)  # (M, Hc, Wc, 2LH)
        coarse = unet.forward(tra["unet"], base.unet, maps).float()
        return coarse, _refine(self.params, base, coarse, answer_out, texts,
                               tvalid)

    def ground(self, answer_out: dict, positive_spans: list[tuple],
               max_text: int = 16) -> tuple:
        """Ground token spans of a generation; returns the coarse logits and
        the ``(M, oh, ow)`` uint8 masks."""
        coarse, low_res = self.ground_logits(answer_out, positive_spans,
                                             max_text)
        return coarse, _to_masks(self.base, low_res, answer_out)
