"""Visual Chain-of-Thought benchmark runner
(scripts/visual_cot/visual_cot_inference.py): iterates the VisCoT benchmark
JSONs under ``--benchmark-dir``, runs ``visual_cot_{v1,v2,v3}`` of the
family's grounder on each item and writes the answers and boxes, one JSON
per benchmark file, for the GPT scorer.

Example:
  python -m flmm_tpu_torch.visual_cot.visual_cot_inference \\
      --family deepseek_vl --preset 1_3b --version v1 \\
      --checkpoint ... --sam-checkpoint ... --trained ... \\
      --tokenizer deepseek-ai/deepseek-vl-1.3b-chat \\
      --benchmark-dir benchmarks/viscot --image-root data \\
      --out results/viscot_v1 [--device cpu]
"""

from __future__ import annotations

import argparse
import json
import pathlib

from flmm_tpu_torch.data.image_io import open_image
from flmm_tpu_torch.demo.grounded_conversation import load_grounder, parse
from flmm_tpu_torch.evalsuite import cli
from flmm_tpu_torch.generation.api import grounder_class


def parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(
        description=__doc__,
        formatter_class=argparse.RawDescriptionHelpFormatter)
    p.add_argument("--family", default="deepseek_vl")
    p.add_argument("--preset", default="1_3b")
    p.add_argument("--version", choices=["v1", "v2", "v3"], default="v1")
    p.add_argument("--checkpoint", required=True)
    p.add_argument("--sam-checkpoint", default=None)
    p.add_argument("--trained", default=None)
    p.add_argument("--tokenizer", default=None,
                   help="tokenizer name or directory for "
                        "transformers.AutoTokenizer (required unless a "
                        "tokenizer is passed to main)")
    p.add_argument("--benchmark-dir", required=True)
    p.add_argument("--image-root", required=True)
    p.add_argument("--out", required=True)
    p.add_argument("--max-thought-tokens", type=int, default=16)
    p.add_argument("--max-new-tokens", type=int, default=512)
    p.add_argument("--box-scale", type=float, default=1.0)
    p.add_argument("--no-sam", action="store_true",
                   help="not wired: refused")
    p.add_argument("--limit", type=int, default=None)
    cli.add_device_flag(p)
    return p


def main(argv=None, tokenizer=None) -> None:
    """Run the benchmark; ``tokenizer`` replaces ``--tokenizer``'s
    AutoTokenizer."""
    p = parser()
    args = parse(p, argv, tokenizer)
    if args.no_sam:
        # flmm_tpu parses it into Grounder.use_sam, which nothing reads
        # (flmm_tpu/generation/api.py:152), so it changes nothing there
        raise NotImplementedError(
            "--no-sam is not wired in flmm_tpu or in flmm_tpu_torch: the "
            "grounders always refine with SAM")
    cls = grounder_class(args.family)
    if not hasattr(cls, f"visual_cot_{args.version}"):
        p.error(f"--version {args.version} is not available for "
                f"--family {args.family} ({cls.__name__} has no visual_cot_"
                f"{args.version})")
    tokenizer, grounder = load_grounder(
        args, tokenizer, max_thought_tokens=args.max_thought_tokens,
        box_scale=args.box_scale)
    run = getattr(grounder, f"visual_cot_{args.version}")

    out_dir = pathlib.Path(args.out)
    out_dir.mkdir(parents=True, exist_ok=True)
    root = pathlib.Path(args.image_root)
    for bench_file in sorted(pathlib.Path(args.benchmark_dir).glob("*.json")):
        data = json.loads(bench_file.read_text())
        if args.limit:
            data = data[:args.limit]
        results = []
        for item in data:
            name = (item["image"][0] if isinstance(item["image"], list)
                    else item["image"])
            question = item["conversations"][0]["value"].replace(
                "<image>", "").strip()
            thought, bbox, answer, _ = run(open_image(str(root / name)),
                                           question)
            results.append({
                "question": question,
                "thought": thought,
                "bbox": list(bbox),
                "answer": answer,
                "gt": item["conversations"][-1]["value"],
                "image": item["image"],
            })
        out_file = out_dir / bench_file.name
        out_file.write_text(json.dumps(results, indent=1))
        print(f"{bench_file.name}: {len(results)} items -> {out_file}",
              flush=True)


if __name__ == "__main__":
    main()
