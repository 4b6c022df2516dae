"""Prompt templating and caption/mask-id token streams
(flmm_tpu/data/tokenization.py, carried over unchanged: plain Python).

Reproduces the reference's parallel ``input_ids``/``mask_ids`` construction
(flmm/datasets/png.py:114-141, 186-188) and the prompt templates
(configs/deepseek_vl/...py:47-55, xtuner PROMPT_TEMPLATE) without xtuner.

A tokenizer here is any object with ``encode(text, add_special_tokens=...)``
returning a list of ids (HF tokenizers qualify; tests use a fake).
"""

from __future__ import annotations

import dataclasses

IGNORE_INDEX = -100

# Prompt templates the released configs use (xtuner PROMPT_TEMPLATE values).
TEMPLATES = {
    "deepseek": {
        "SYSTEM": "",
        "INSTRUCTION": "User: {input}\n\nAssistant:",
        "SUFFIX": "<｜end▁of▁sentence｜>",
        "STOP_WORDS": ["<｜end▁of▁sentence｜>"],
    },
    "vicuna": {
        "SYSTEM": ("A chat between a curious user and an artificial "
                   "intelligence assistant. The assistant gives helpful, "
                   "detailed, and polite answers to the user's questions. "),
        "INSTRUCTION": "USER: {input} ASSISTANT:",
        "SUFFIX": "</s>",
        "STOP_WORDS": ["</s>"],
    },
    "mistral": {
        "SYSTEM": "",
        "INSTRUCTION": "[INST] {input} [/INST]",
        "SUFFIX": "</s>",
        "STOP_WORDS": ["</s>"],
    },
    "internlm2_chat": {
        "SYSTEM": "<|im_start|>system\n{system}<|im_end|>\n",
        "INSTRUCTION": ("<|im_start|>user\n{input}<|im_end|>\n"
                        "<|im_start|>assistant\n"),
        "SUFFIX": "<|im_end|>",
        "STOP_WORDS": ["<|im_end|>"],
    },
    "gemma": {
        "SYSTEM": "",
        "INSTRUCTION": ("<start_of_turn>user\n{input}<end_of_turn>\n"
                        "<start_of_turn>model\n"),
        "SUFFIX": "<end_of_turn>",
        "STOP_WORDS": ["<end_of_turn>"],
    },
}


@dataclasses.dataclass(frozen=True)
class PromptSpec:
    template: dict
    prompt: str  # e.g. '<image_placeholder>'*576 + 'Please give me ...'
    system: str | None = None

    def render(self) -> str:
        sys_t = self.template.get("SYSTEM", "")
        if "{system}" in sys_t:
            out = sys_t.format(system=self.system) if self.system else ""
        else:
            out = sys_t
        return out + self.template["INSTRUCTION"].format(input=self.prompt)


def encode_prompt(tokenizer, spec: PromptSpec) -> list[int]:
    """Tokenise the instruction-formatted prompt with special tokens
    (reference png.py:84-87)."""
    return list(tokenizer.encode(spec.render(), add_special_tokens=True))


@dataclasses.dataclass(frozen=True)
class RenderedPrompt:
    """A fully-tokenised multimodal prompt with a located image block."""
    ids: list
    img_start: int
    n_img: int
    image_token_id: int
    template: dict


def encode_multimodal_prompt(
    tokenizer,
    template: dict,
    prompt: str,
    image_token: str,
    n_img: int,
    image_token_id: int | None = None,
    system: str | None = None,
) -> RenderedPrompt:
    """Tokenise an instruction prompt containing ONE ``image_token``
    occurrence, expanding it to ``n_img`` placeholder ids.

    Mirrors the reference's two conventions at once:

    * DeepSeek-VL repeats a literal tokenizer token 576 times in the prompt
      string (configs/deepseek_vl/...py:55) -- for tokenizers where
      ``image_token`` maps to a single id this produces identical ids;
    * LLaVA/MGM/HPT use ``<image>`` + ``tokenizer_image_token`` which
      *splits the text on the placeholder* and splices an out-of-vocab
      index (reference mgm/mm_utils.py, constants.py:8
      IMAGE_TOKEN_INDEX=-200).  Here the spliced id defaults to 0 (its
      embedding is overwritten by projected image features at
      ``img_start``), so vicuna-style tokenizers never see the placeholder
      string and cannot fragment it.

    Returns a :class:`RenderedPrompt` whose ``img_start`` is derived from
    the actual tokenisation -- the single source of truth the batch
    builders assert against the model config.
    """
    spec = PromptSpec(template, prompt, system=system)
    rendered = spec.render()
    if image_token not in rendered:
        raise ValueError(f"prompt does not contain {image_token!r}")
    pre, _, post = rendered.partition(image_token)
    pre_ids = list(tokenizer.encode(pre, add_special_tokens=True))
    post_ids = list(tokenizer.encode(post, add_special_tokens=False))
    if image_token_id is None:
        enc = tokenizer.encode(image_token, add_special_tokens=False)
        image_token_id = enc[-1] if len(enc) == 1 else 0
    ids = pre_ids + [image_token_id] * n_img + post_ids
    return RenderedPrompt(
        ids=ids, img_start=len(pre_ids), n_img=n_img,
        image_token_id=image_token_id, template=template,
    )


def caption_stream(
    tokenizer,
    segments: list[dict],
    prompt_len: int,
) -> dict:
    """Build caption ids + aligned mask ids from PNG-style segments.

    Each segment: ``{'utterance': str, 'has_mask': bool}``.  Mirrors
    png.py:123-141: tokens of segments with masks get the running mask
    index; others -1.  The prompt positions are all -1.
    """
    caption_ids: list[int] = []
    mask_ids: list[int] = [-1] * prompt_len
    spans: list[tuple[int, int]] = []  # token spans per mask in seq coords
    mask_cnt = 0
    for seg in segments:
        ids = list(tokenizer.encode(seg["utterance"], add_special_tokens=False))
        start = prompt_len + len(caption_ids)
        caption_ids += ids
        if seg.get("has_mask"):
            mask_ids += [mask_cnt] * len(ids)
            spans.append((start, start + len(ids)))
            mask_cnt += 1
        else:
            mask_ids += [-1] * len(ids)
    return {
        "caption_ids": caption_ids,
        "mask_ids": mask_ids,
        "spans": spans,
        "num_masks": mask_cnt,
    }


def find_image_block(input_ids: list[int], image_token_id: int) -> tuple[int, int]:
    """Locate the contiguous image-token block; returns (start, length)."""
    start = None
    n = 0
    for i, t in enumerate(input_ids):
        if t == image_token_id:
            if start is None:
                start = i
            elif i != start + n:
                raise ValueError("image tokens are not contiguous")
            n += 1
    if start is None:
        raise ValueError("no image tokens found")
    return start, n
