"""The per-family throughput matrix on one GPU (scripts/bench_families.py of
the JAX package, flag for flag).

    python -m flmm_tpu_torch.bench_families [--families a,b,c] [--out f]

Runs ``python -m flmm_tpu_torch.bench`` once per serving point of each
family's flagship preset at reference-exact SAM-1024 (``--sam-size``) and
collects the rows into ``BENCH_FAMILIES_TORCH.json`` at the root of the
checkout (``--out``; never the JAX package's ``BENCH_FAMILIES.json``).  Each
point is a subprocess, so a point that runs out of device memory or fails
cannot poison the next one's device state, and the points run one after the
other, so at most one of them ever builds the kernel library.

A point is a tag and the environment it adds over the caller's: the child
gets ``os.environ``, then ``BENCH_FAMILY`` and ``BENCH_SAM_SIZE``, then the
point's own variables.  ``BENCH_PRESET``, ``BENCH_GLOBAL_KERNEL``,
``BENCH_GLOBAL_BLOCK``, ``BENCH_ITERS``, ``BENCH_SEQ`` set by the caller
therefore reach every row, as in the JAX script.  The row is the last JSON
line of the child's standard output plus ``family`` and ``mode``; a child
that fails or prints none gives ``{"family", "mode", "error"}`` with the last
line of its standard error (200 characters), a child that outlives
``--timeout`` gives ``"error": "timeout"``.  The first point of a family
without ``error`` is its headline and ends the family.

``PLAN`` keeps the JAX script's families, tags and order.  Its points were
picked as "the serving mode that fits one chip" for a chip with 16 GB, where
a 7B or 8B decoder does not fit in bf16 beside a batch of 2.  One 80 GB card
holds every family in bf16 at the bench's batch sizes, so here each
family's first point is ``("bf16", {})`` and the JAX script's points follow
it in their order.  Those that set ``BENCH_QUANT_LLM=1`` (``int8_llm``)
run the W8A8 int8 decoder; since the bf16 point comes first and ends its
family on one 80 GB card, they run only when it fails.

``--device`` (default ``cuda``) and ``--seed`` are handed to the children;
without a card every child exits non-zero and every row is an ``error``.
``--device cpu`` with ``BENCH_PRESET=tiny`` runs the plain versions on host
clocks, for the tests.  The run exits non-zero when a family that the port
has ends without a headline row.
"""

from __future__ import annotations

import argparse
import json
import os
import pathlib
import subprocess
import sys

from flmm_tpu_torch import registry

REPO = pathlib.Path(__file__).resolve().parent.parent
DEFAULT_OUT = REPO / "BENCH_FAMILIES_TORCH.json"
INT8 = {"BENCH_QUANT_LLM": "1", "BENCH_BS": "4,2,1"}

# family -> list of (tag, extra env) serving points to try in order;
# the first successful row per family is the headline
PLAN = {
    "deepseek_vl": [("bf16", {})],
    "mgm": [("bf16", {})],
    "llava": [("bf16", {}), ("bf16_bs1", {"BENCH_BS": "1"}),
              ("int8_llm", INT8)],
    "llava_next": [("bf16", {}), ("int8_llm", INT8),
                   ("bf16_bs1", {"BENCH_BS": "1"})],
    "hpt": [("bf16", {}), ("int8_llm", INT8)],
}


def run_one(family: str, tag: str, extra: dict, sam_size: int, timeout: int,
            device: str = "cuda", seed: int = 0) -> dict:
    """One serving point in a child process; its row, or its error row."""
    env = dict(os.environ, BENCH_FAMILY=family, BENCH_SAM_SIZE=str(sam_size),
               **extra)
    cmd = [sys.executable, "-m", "flmm_tpu_torch.bench", "--device", device,
           "--seed", str(seed)]
    try:
        proc = subprocess.run(cmd, cwd=str(REPO), env=env,
                              capture_output=True, text=True, timeout=timeout)
    except subprocess.TimeoutExpired:
        return {"family": family, "mode": tag, "error": "timeout"}
    line = next((ln for ln in proc.stdout.splitlines()[::-1]
                 if ln.startswith("{")), None)
    if proc.returncode != 0 or line is None:
        return {"family": family, "mode": tag,
                "error": (proc.stderr.strip().splitlines() or ["?"])[-1][:200]}
    out = json.loads(line)
    out.update({"family": family, "mode": tag})
    return out


def main(argv=None) -> dict:
    ap = argparse.ArgumentParser(
        prog="python -m flmm_tpu_torch.bench_families",
        description=__doc__.split("\n\n")[0],
        epilog="The BENCH_* environment variables of flmm_tpu_torch.bench "
        "reach every child.")
    ap.add_argument("--families", default=",".join(PLAN))
    ap.add_argument("--sam-size", type=int, default=1024)
    ap.add_argument("--timeout", type=int, default=4200)
    ap.add_argument("--out", default=str(DEFAULT_OUT))
    ap.add_argument("--device", default="cuda", choices=("cuda", "cpu"))
    ap.add_argument("--seed", type=int, default=0)
    args = ap.parse_args(argv)

    out_path = pathlib.Path(args.out)
    results = (json.loads(out_path.read_text())
               if out_path.exists() else {"sam_size": args.sam_size,
                                          "rows": []})
    without_headline = []
    for family in args.families.split(","):
        for tag, extra in PLAN[family]:
            print(f"== {family} [{tag}] ==", flush=True)
            row = run_one(family, tag, extra, args.sam_size, args.timeout,
                          args.device, args.seed)
            print(json.dumps(row), flush=True)
            results["rows"] = [r for r in results["rows"]
                               if not (r.get("family") == family
                                       and r.get("mode") == tag)]
            results["rows"].append(row)
            out_path.write_text(json.dumps(results, indent=1))
            if "error" not in row:
                break  # headline point found for this family
        else:
            if family in registry.FAMILIES:
                without_headline.append(family)
    if without_headline:
        raise SystemExit(
            f"bench_families: no serving point of {without_headline} ran; "
            f"the error rows are in {out_path}")
    return results


if __name__ == "__main__":
    main()
