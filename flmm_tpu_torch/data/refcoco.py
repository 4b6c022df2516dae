"""RefCOCO / RefCOCO+ / RefCOCOg referring-expression datasets
(flmm_tpu/data/refcoco.py): refs from the ``refs(unc).p`` / ``refs(umd).p``
pickles and COCO ``instances.json``, grouped per image and split; the
expressions of one image joined with '.' separators sharing per-expression
mask ids (``concat``) or one sample per expression.  Masks come from the
host library's polygon fill and RLE decode, images from the PIL-free
decoder as ``(H, W, 3)`` uint8 arrays.

The split pickles are read with ``pickle``: open only annotation files from
a source you trust, as with the reference's mmdet reader."""

from __future__ import annotations

import json
import pickle
from collections import defaultdict
from typing import Callable

import numpy as np

from flmm_tpu_torch import runtime
from flmm_tpu_torch.data import io as remote_io
from flmm_tpu_torch.data import tokenization as tok


def polygons_to_mask(polygons: list, h: int, w: int) -> np.ndarray:
    """Rasterise a COCO polygon segmentation (list of flat coord lists)."""
    return runtime.polygons_fill(polygons, h, w)


def rle_to_mask(rle: dict) -> np.ndarray:
    """Decode an uncompressed COCO RLE {'counts': [...], 'size': [h, w]}."""
    h, w = rle["size"]
    return runtime.rle_decode(rle["counts"], h, w)


class RefCocoDataset:
    """Iterates (image, expressions, masks) grouped per image and split."""

    def __init__(self, ann_file: str, split_file: str, image_path: str,
                 split: str = "train",
                 open_fn: Callable = remote_io.open_any):
        with open_fn(split_file, "rb") as f:
            refs = pickle.load(f)
        with open_fn(ann_file, "r") as f:
            inst = json.load(f)
        self.image_path = image_path
        self.images = {img["id"]: img for img in inst["images"]}
        self.anns = {a["id"]: a for a in inst["annotations"]}
        grouped = defaultdict(list)
        for ref in refs:
            if ref["split"] == split:
                grouped[ref["image_id"]].append(ref)
        self.items = sorted(grouped.items())

    def __len__(self) -> int:
        return len(self.items)

    def _mask_for(self, ann: dict) -> np.ndarray:
        img = self.images[ann["image_id"]]
        seg = ann["segmentation"]
        if isinstance(seg, dict):
            return rle_to_mask(seg)
        return polygons_to_mask(seg, img["height"], img["width"])

    def __getitem__(self, index: int) -> dict:
        image_id, refs = self.items[index]
        img_info = self.images[image_id]
        expressions, masks = [], []
        for ref in refs:
            mask = self._mask_for(self.anns[ref["ann_id"]])
            for sent in ref["sentences"]:
                expressions.append(sent["sent"])
                masks.append(mask)
        image = remote_io.open_image(
            f"{self.image_path}/{img_info['file_name']}")
        return {"image": image, "expressions": expressions,
                "masks": np.stack(masks), "file_name": img_info["file_name"]}


def refcoco_to_sample(
    item: dict,
    tokenizer,
    prompt_spec: "tok.PromptSpec | tok.RenderedPrompt",
    image_token_id: int | None = None,
    concat: bool = True,
    rng: np.random.Generator | None = None,
    max_expressions: int | None = None,
    subsample: bool = False,
) -> list[dict]:
    """A grouped RefCOCO item -> PNG-style samples.

    ``concat=True`` joins all expressions with '.' separators, one sample
    an image; with ``max_expressions`` it chunks them (the image repeated
    with the next group) so that every expression is scored once.
    ``subsample=True`` keeps a random ``max_expressions`` of them instead,
    as in training.  ``concat=False`` gives one sample an expression.
    """
    if isinstance(prompt_spec, tok.RenderedPrompt):
        prompt_ids = list(prompt_spec.ids)
        img_start, n_img = prompt_spec.img_start, prompt_spec.n_img
    else:
        prompt_ids = tok.encode_prompt(tokenizer, prompt_spec)
        img_start, n_img = tok.find_image_block(prompt_ids, image_token_id)

    exprs = list(item["expressions"])
    masks = list(item["masks"])
    if subsample and max_expressions is not None \
            and len(exprs) > max_expressions:
        idx = (rng or np.random.default_rng()).choice(
            len(exprs), max_expressions, replace=False)
        exprs = [exprs[i] for i in idx]
        masks = [masks[i] for i in idx]

    if concat:
        pairs = list(zip(exprs, masks))
        chunk = max_expressions or len(pairs) or 1
        groups = [pairs[i:i + chunk] for i in range(0, len(pairs), chunk)]
    else:
        groups = [[(e, m)] for e, m in zip(exprs, masks)]
    out = []
    for group in groups:
        segments, gmasks = [], []
        for i, (expr, mask) in enumerate(group):
            if i > 0:
                segments.append({"utterance": ". ", "has_mask": False})
            segments.append({"utterance": expr, "has_mask": True})
            gmasks.append(mask)
        stream = tok.caption_stream(tokenizer, segments, len(prompt_ids))
        out.append({
            "input_ids": np.asarray(prompt_ids + stream["caption_ids"],
                                    np.int32),
            "mask_ids": np.asarray(stream["mask_ids"], np.int32),
            "spans": stream["spans"],
            "masks": np.stack(gmasks),
            "mask_infos": [{"plural": False, "isthing": True}] * len(gmasks),
            "image": item["image"],
            "file_name": item["file_name"],
            "img_start": img_start,
            "num_img_tokens": n_img,
        })
    return out
