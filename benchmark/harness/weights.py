"""Seeded weights, made by the benchmark on the device in a few large calls.

The program gives only the tree's schema: its ``init_params`` on the
``meta`` device (keys, shapes, dtypes; nothing is drawn).  The values are
the benchmark's own: one normal draw per dtype from a ``torch.Generator``
on the device, cut into the leaves and scaled by the rule of each leaf,
and constants where a released checkpoint's leaf starts at one.  The rules
follow the spreads of the port's initialisers, with the SAM rel-pos tables
non-zero as a released checkpoint has them (``bench.randomize_frozen``).
A leaf no rule names stops the run: a renamed leaf must not get values by
accident.  ``lm_head`` is left out: grounding never projects to the
vocabulary.  The same seed gives the same tree on the same device, so the
reference is handed a fresh copy after the program's has been freed."""

from __future__ import annotations

import math
import re

import torch

REL_POS_STD = 0.05
NEWLINE_STD = 0.02
DROPPED = ("lm_head",)
ALIGN = 256  # elements

# (pattern on the leaf's path, kind); kinds: "one", "zero", or a spread
# "fan_in" (1/sqrt(rows of the last two dims)), "conv" (1/sqrt of all but
# the output dim), "he_conv" (sqrt(2/that)), "width" (1/sqrt(last dim)),
# "rel_pos", "newline", "unit"; the first pattern that matches decides
RULES = (
    (r"(^|/)(ln\d?|final_norm|text_layer_weights)$", "one"),
    (r"_w$", "one"),
    (r"(^|/)(b|b\d|bo|bqkv|bq|bk|bv|seg_b|patch_bias|cls_token)$", "zero"),
    (r"_b$", "zero"),
    (r"sam_encoder/pos_embed$", "zero"),
    (r"rel_pos_[hw]$", "rel_pos"),
    (r"image_newline$", "newline"),
    (r"pe_gaussian$", "unit"),
    (r"unet/.*(/k|seg_k)$", "he_conv"),
    (r"decoder/upscale/k\d$", "fan_in"),
    (r"(patch_kernel|neck\d_kernel|mask_down/k\d)$", "conv"),
    (r"(embed|pos_embed|point_embeddings|not_a_point|no_mask|iou_token|"
     r"mask_tokens)$", "width"),
    (r"(^|/)(w|wq|wk|wv|wo|wqkv|w1|w2|w_gate|w_up|w_down|router)$", "fan_in"),
)


def leaves(tree, prefix: str = ""):
    if isinstance(tree, dict):
        for k, v in tree.items():
            yield from leaves(v, f"{prefix}/{k}" if prefix else str(k))
    elif isinstance(tree, (list, tuple)):
        for i, v in enumerate(tree):
            yield from leaves(v, f"{prefix}/{i}" if prefix else str(i))
    else:
        yield prefix, tree


def kind_of(path: str) -> str:
    for pattern, kind in RULES:
        if re.search(pattern, path):
            return kind
    raise KeyError(f"no weight rule names the leaf {path!r}")


def spread_of(kind: str, shape) -> float:
    if kind == "fan_in":
        return 1.0 / math.sqrt(shape[-2])
    fan = math.prod(shape[:-1])
    return {"conv": 1.0 / math.sqrt(fan), "he_conv": math.sqrt(2.0 / fan),
            "width": 1.0 / math.sqrt(shape[-1]), "rel_pos": REL_POS_STD,
            "newline": NEWLINE_STD, "unit": 1.0}[kind]


def map_tree(tree, fn, prefix: str = ""):
    if isinstance(tree, dict):
        return {k: map_tree(v, fn, f"{prefix}/{k}" if prefix else str(k))
                for k, v in tree.items() if k not in DROPPED}
    if isinstance(tree, list):
        return [map_tree(v, fn, f"{prefix}/{i}" if prefix else str(i))
                for i, v in enumerate(tree)]
    return fn(prefix, tree)


def make(schema: dict, seed: int, device) -> dict:
    """The tree of ``schema`` (meta tensors) filled from ``seed`` on
    ``device``: one draw per dtype, then a scale or a constant per leaf."""
    device = torch.device(device)
    shaped = [(p, t) for p, t in leaves(schema)
              if not any(d in p.split("/") for d in DROPPED)]
    random = {}
    for p, t in shaped:
        if kind_of(p) not in ("one", "zero"):
            random.setdefault(t.dtype, []).append((p, t))
    g = torch.Generator(device=device).manual_seed(seed)
    cut = {}
    for dtype in sorted(random, key=str):
        group = random[dtype]
        # each leaf starts ALIGN elements apart: the kernels' tensor maps
        # take 16-byte aligned addresses only
        starts, total = [], 0
        for _, t in group:
            starts.append(total)
            total += -(-t.numel() // ALIGN) * ALIGN
        flat = torch.randn(total, generator=g, device=device, dtype=dtype)
        for (p, t), offset in zip(group, starts):
            view = flat[offset:offset + t.numel()].view(t.shape)
            view.mul_(spread_of(kind_of(p), t.shape))
            # the trained leaves get storage of their own: the optimizer
            # and autograd take them one by one
            cut[p] = view.clone() if p.startswith("trainable/") else view

    def fill(path, t):
        if path in cut:
            return cut[path]
        return torch.full(t.shape, 1.0 if kind_of(path) == "one" else 0.0,
                          dtype=t.dtype, device=device)

    return map_tree(schema, fill)


def to_float32(tree):
    """A float32 copy of a tree, leaf by leaf (the reference's weights)."""
    return map_tree(tree, lambda _, t: t.detach().float().clone())
