"""Panoptic Narrative Grounding evaluation (scripts/eval_png.py): average
recall (AA) over the IoU thresholds, pixel accuracy at 0.5 and the
thing / stuff / singular / plural splits, printed as indented JSON.

Example:
  python -m flmm_tpu_torch.eval_png --family deepseek_vl --preset 1_3b \\
      --checkpoint ... --sam-checkpoint ... --trained ... \\
      --tokenizer ... --data-root data/coco [--debug] [--device cpu]
"""

from __future__ import annotations

import json
import pathlib

from flmm_tpu_torch.data.png import PNGDataset
from flmm_tpu_torch.evalsuite import cli
from flmm_tpu_torch.evalsuite.metrics import PNGAccumulator
from flmm_tpu_torch.evalsuite.runner import png_score


def main(argv=None, tokenizer=None) -> dict:
    """Run the evaluation; ``tokenizer`` replaces ``--tokenizer``'s
    AutoTokenizer.  Returns the results."""
    args = cli.parse(cli.parser(__doc__, max_masks=16), argv, tokenizer)
    with cli.ranks(args):
        return _evaluate(args, cli.load_tokenizer(args, tokenizer))


def _evaluate(args, tokenizer) -> dict:
    s = cli.setup(args, tokenizer)
    root = pathlib.Path(args.data_root)
    ds = PNGDataset(
        json_file=str(root / "annotations/png_coco_val2017.json"),
        panoptic_json_file=str(root / "annotations/panoptic_val2017.json"),
        panoptic_png_path=str(root / "annotations/panoptic_val2017"),
        image_path=str(root / "val2017"),
        tokenizer=tokenizer, prompt_spec=s["prompt"])
    n = min(len(ds), 100) if args.debug else len(ds)
    results = cli.evaluator(args, s)((ds[i] for i in range(n)),
                                     PNGAccumulator, png_score)
    if cli.prints():
        print(json.dumps(results, indent=2))
    return results


if __name__ == "__main__":
    main()
