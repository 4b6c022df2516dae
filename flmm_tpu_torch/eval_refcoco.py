"""RefCOCO / RefCOCO+ / RefCOCOg referring-segmentation evaluation
(scripts/eval_refcoco.py): batched forwards on the card, scoring at the
original resolution (cIoU / mIoU) over the 8 standard splits.  One JSON
line a split, then all splits as indented JSON.

Example:
  python -m flmm_tpu_torch.eval_refcoco --family deepseek_vl --preset 1_3b \\
      --checkpoint /ckpts/deepseek-vl-1.3b-chat \\
      --sam-checkpoint /ckpts/sam_vit_l.pth --trained /ckpts/flmm.pth \\
      --tokenizer deepseek-ai/deepseek-vl-1.3b-chat \\
      --data-root data/coco [--concat] [--debug] [--device cpu]
"""

from __future__ import annotations

import json
import pathlib

from flmm_tpu_torch.data.refcoco import RefCocoDataset, refcoco_to_sample
from flmm_tpu_torch.evalsuite import cli
from flmm_tpu_torch.evalsuite.metrics import RefSegAccumulator
from flmm_tpu_torch.evalsuite.runner import refcoco_score

SPLITS = [
    ("refcoco", "refs(unc).p", "val"),
    ("refcoco", "refs(unc).p", "testA"),
    ("refcoco", "refs(unc).p", "testB"),
    ("refcoco+", "refs(unc).p", "val"),
    ("refcoco+", "refs(unc).p", "testA"),
    ("refcoco+", "refs(unc).p", "testB"),
    ("refcocog", "refs(umd).p", "val"),
    ("refcocog", "refs(umd).p", "test"),
]


def main(argv=None, tokenizer=None) -> dict:
    """Run the evaluation; ``tokenizer`` replaces ``--tokenizer``'s
    AutoTokenizer.  Returns the results by split."""
    p = cli.parser(__doc__, max_masks=8)
    p.add_argument("--image-dir", default=None)
    p.add_argument("--concat", action="store_true",
                   help="one pass per image instead of per expression")
    args = cli.parse(p, argv, tokenizer)
    with cli.ranks(args):
        return _evaluate(args, cli.load_tokenizer(args, tokenizer))


def _evaluate(args, tokenizer) -> dict:
    s = cli.setup(args, tokenizer)
    evaluate = cli.evaluator(args, s)
    results = {}
    root = pathlib.Path(args.data_root)
    for name, split_file, split in SPLITS:
        ds = RefCocoDataset(
            ann_file=str(root / name / "instances.json"),
            split_file=str(root / name / split_file),
            image_path=args.image_dir or str(root / "train2014"),
            split=split)
        n = min(len(ds), 100) if args.debug else len(ds)

        def samples():
            for i in range(n):
                yield from refcoco_to_sample(
                    ds[i], tokenizer, s["prompt"], concat=args.concat,
                    max_expressions=args.max_masks if args.concat else None)

        key = f"{name}/{split}"
        results[key] = evaluate(samples(), RefSegAccumulator, refcoco_score)
        if cli.prints():
            print(json.dumps({key: results[key]}), flush=True)
    if cli.prints():
        print(json.dumps(results, indent=2))
    return results


if __name__ == "__main__":
    main()
