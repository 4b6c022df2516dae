"""Grounded conversation (scripts/demo/grounded_conversation.py): generate
an answer with per-step attention capture, extract its noun phrases, map
them to token spans, ground each span and save a colour overlay as a PNG.

Example:
  python -m flmm_tpu_torch.demo.grounded_conversation --family deepseek_vl \\
      --preset 1_3b --checkpoint ... --sam-checkpoint ... --trained ... \\
      --tokenizer deepseek-ai/deepseek-vl-1.3b-chat \\
      --image images/dog.jpg --text "What is the dog doing?" --out out.png \\
      [--interactive] [--device cpu]
"""

from __future__ import annotations

import argparse
import pathlib

import numpy as np
import torch

from flmm_tpu_torch import registry
from flmm_tpu_torch.data.image_io import open_image, write_png
from flmm_tpu_torch.evalsuite import cli
from flmm_tpu_torch.generation.api import make_grounder
from flmm_tpu_torch.generation.noun_chunks import char_span_to_token_span, \
    noun_chunks

PALETTE = [(255, 80, 80), (80, 200, 120), (90, 140, 255), (250, 200, 60),
           (200, 100, 255), (70, 220, 220), (250, 140, 50), (160, 255, 80)]


def overlay(image: np.ndarray, masks, labels) -> np.ndarray:
    """The masks blended half and half with the palette's colours over an
    ``(H, W, 3)`` uint8 image, in f32, truncated to uint8."""
    arr = np.asarray(image).astype(np.float32)
    for i, m in enumerate(masks):
        color = np.asarray(PALETTE[i % len(PALETTE)], np.float32)
        mm = m.astype(bool)
        arr[mm] = 0.5 * arr[mm] + 0.5 * color
    return arr.astype(np.uint8)


def parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(
        description=__doc__,
        formatter_class=argparse.RawDescriptionHelpFormatter)
    p.add_argument("--family", default="deepseek_vl")
    p.add_argument("--preset", default="1_3b")
    p.add_argument("--checkpoint", required=True)
    p.add_argument("--sam-checkpoint", default=None)
    p.add_argument("--trained", default=None)
    p.add_argument("--tokenizer", default=None,
                   help="tokenizer name or directory for "
                        "transformers.AutoTokenizer (required unless a "
                        "tokenizer is passed to main)")
    p.add_argument("--image", required=True)
    p.add_argument("--text", default=None,
                   help="single-shot question (omit with --interactive)")
    p.add_argument("--out", default="grounded.png")
    p.add_argument("--max-new-tokens", type=int, default=128)
    p.add_argument("--interactive", action="store_true",
                   help="multi-turn conversation on stdin with per-chunk "
                        "grounding confirmation (reference "
                        "grounded_conversation.py:48 asks 'Ground X?' per "
                        "noun chunk; conversation memory per "
                        "frozen_deepseek_vl.py:492-512)")
    cli.add_device_flag(p)
    return p


def parse(p: argparse.ArgumentParser, argv, tokenizer):
    """Parse ``argv``: ``--tokenizer`` unless a tokenizer is passed, and a
    card unless ``--device cpu``."""
    args = p.parse_args(argv)
    if tokenizer is None and args.tokenizer is None:
        p.error("--tokenizer is required")
    cli.check_device(args)
    return args


def load_grounder(args, tokenizer, **kw) -> tuple:
    """The model the flags name on ``--device``: ``(tokenizer, grounder)``;
    ``kw`` goes to ``make_grounder``."""
    device = torch.device(args.device)
    cfg = registry.get_config(args.family, args.preset)
    params = cli.load_params(args, cfg, registry.get_model(args.family),
                             device)
    tokenizer = cli.load_tokenizer(args, tokenizer)
    return tokenizer, make_grounder(
        args.family, cfg, params, tokenizer,
        max_new_tokens=args.max_new_tokens, device=device, **kw)


def main(argv=None, tokenizer=None) -> None:
    """Run the demo; ``tokenizer`` replaces ``--tokenizer``'s
    AutoTokenizer."""
    p = parser()
    args = parse(p, argv, tokenizer)
    if args.text is None and not args.interactive:
        p.error("--text is required unless --interactive")
    tokenizer, grounder = load_grounder(args, tokenizer)
    image = open_image(args.image)

    def ground_turn(out, out_path, confirm: bool):
        spans, labels = [], []
        for s_char, e_char, phrase in noun_chunks(out["output_text"]):
            if confirm:
                try:
                    resp = input(f"Ground {phrase!r}? [y/N] ").strip().lower()
                except EOFError:
                    resp = "n"
                if resp not in ("y", "yes", "1"):
                    continue
            span = char_span_to_token_span(
                tokenizer, list(out["output_ids"]), (s_char, e_char))
            if span:
                spans.append(span)
                labels.append(phrase)
        if not spans:
            print("no noun phrases found to ground")
            return
        _, masks = grounder.ground(out, spans)
        for phrase, m in zip(labels, masks):
            print(f"  {phrase}: {int(m.sum())} px")
        write_png(out_path, overlay(image, masks, labels))
        print(f"saved {out_path}")

    if not args.interactive:
        out = grounder.answer(image, args.text)
        print("Answer:", out["output_text"])
        ground_turn(out, args.out, confirm=False)
        return

    # multi-turn loop: conversation memory threads through
    # Grounder.answer(history=...); per-chunk confirmation on stdin
    history = []
    stem = pathlib.Path(args.out)
    while True:
        try:
            q = input("user> ").strip()
        except EOFError:
            break
        if not q or q in ("exit", "quit"):
            break
        out = grounder.answer(image, q, history=history or None)
        print("Answer:", out["output_text"])
        turn_out = stem.with_name(
            f"{stem.stem}_turn{len(history)}{stem.suffix}")
        ground_turn(out, turn_out, confirm=True)
        history.append((q, out["output_text"]))


if __name__ == "__main__":
    main()
