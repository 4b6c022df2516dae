"""Panoptic Narrative Grounding dataset (flmm_tpu/data/png.py): the PNG
narrative JSON and the COCO panoptic annotations give parallel
input_ids / mask_ids streams per utterance segment and the union masks of
each segment's panoptic ids; a narrative without a mask is replaced by
another index drawn with Python's ``random`` (the reference's resample, the
same draw in the same order, so a seeded run picks the same index).
Samples are numpy dicts with the image as a ``(H, W, 3)`` uint8 array;
padding and bucketing happen in the batch builder."""

from __future__ import annotations

import json
import random
from typing import Callable

import numpy as np

from flmm_tpu_torch.data import io as remote_io
from flmm_tpu_torch.data import tokenization as tok
from flmm_tpu_torch.data.panoptic import rgb2id, segment_union_mask


class PNGDataset:
    def __init__(
        self,
        json_file: str,
        panoptic_json_file: str,
        panoptic_png_path: str,
        image_path: str,
        tokenizer,
        prompt_spec: "tok.PromptSpec | tok.RenderedPrompt",
        image_token_id: int | None = None,
        open_fn: Callable = remote_io.open_any,
    ):
        with open_fn(json_file, "r") as f:
            self.data = json.load(f)
        with open_fn(panoptic_json_file, "r") as f:
            pan = json.load(f)
        self.images = {img["id"]: img for img in pan["images"]}
        self.annotations = {ann["image_id"]: ann
                            for ann in pan["annotations"]}
        self.categories = {c["id"]: c for c in pan["categories"]}
        self.panoptic_png_path = panoptic_png_path
        self.image_path = image_path
        self.tokenizer = tokenizer
        if isinstance(prompt_spec, tok.RenderedPrompt):
            self.prompt_ids = list(prompt_spec.ids)
            self.image_token_id = prompt_spec.image_token_id
            self.img_start = prompt_spec.img_start
            self.num_img_tokens = prompt_spec.n_img
        else:
            self.prompt_ids = tok.encode_prompt(tokenizer, prompt_spec)
            self.image_token_id = image_token_id
            self.img_start, self.num_img_tokens = tok.find_image_block(
                self.prompt_ids, image_token_id)

    def __len__(self) -> int:
        return len(self.data)

    def __getitem__(self, index: int) -> dict:
        sample = self.data[index]
        image_id = int(sample["image_id"])
        ann = self.annotations[image_id]
        seg_infos = {s["id"]: s for s in ann["segments_info"]}

        segments, mask_segment_ids, mask_infos = [], [], []
        for seg in sample["segments"]:
            has_mask = len(seg["segment_ids"]) > 0
            segments.append({"utterance": seg["utterance"],
                             "has_mask": has_mask})
            if has_mask:
                mask_segment_ids.append([int(s) for s in seg["segment_ids"]])
                if not seg["plural"]:
                    sid = int(seg["segment_ids"][0])
                    cat = self.categories[seg_infos[sid]["category_id"]]
                    isthing = bool(cat.get("isthing", 1))
                else:
                    isthing = True
                mask_infos.append({"plural": bool(seg["plural"]),
                                   "isthing": isthing})

        stream = tok.caption_stream(self.tokenizer, segments,
                                    len(self.prompt_ids))
        if stream["num_masks"] == 0:
            # the reference's resample of another index
            return self.__getitem__(random.randrange(len(self)))

        segm_map = rgb2id(remote_io.open_image(
            f"{self.panoptic_png_path}/{ann['file_name']}"))
        masks = np.stack([segment_union_mask(segm_map, sids)
                          for sids in mask_segment_ids])
        img_info = self.images[image_id]
        image = remote_io.open_image(
            f"{self.image_path}/{img_info['file_name']}")
        return {
            "input_ids": np.asarray(self.prompt_ids + stream["caption_ids"],
                                    np.int32),
            "mask_ids": np.asarray(stream["mask_ids"], np.int32),
            "spans": stream["spans"],
            "masks": masks,
            "mask_infos": mask_infos,
            "image": image,
            "file_name": img_info["file_name"],
            "img_start": self.img_start,
            "num_img_tokens": self.num_img_tokens,
        }
