"""The reduced-resolution SAM schedule under one clock on one GPU
(scripts/schedule_bench.py of the JAX package, flag for flag).

    python -m flmm_tpu_torch.schedule_bench \\
        [--sizes 1024 768 640 448] [--batch-sizes 4 8] [--iters 6]

Measures every (sam_size, batch_size) point in ONE process through
``flmm_tpu_torch.bench.run`` (the end-to-end grounding forward at real
released-model geometry, random weights from ``--seed``), so the table is
internally comparable.  At 1024 the SAM encoder's window layers go through
the whole-block kernel K1; at the reduced sizes the grid has fewer than 25
windows an image and they take the split path K3 -> K6 -> K4, at 768 and 640
on a grid padded to whole windows (48 -> 56, 40 -> 42).

``--family`` and each size replace ``BENCH_FAMILY`` and ``BENCH_SAM_SIZE`` of
``bench.Knobs.from_env()`` (the JAX script writes them to ``os.environ``);
the other ``BENCH_*`` knobs still come from the environment, so
``BENCH_PRESET=tiny`` gives a run for the CPU.  ``--device`` defaults to
``cuda`` and the run exits non-zero without a card; ``--device cpu`` runs
the plain versions on host clocks, for the tests.

One JSON line per point: ``sam_size``, ``bs``, ``img_per_s``,
``wall_incl_compile_s`` (the JAX script's keys; here the wall time includes
the parameters, the kernel build at first use and the warm-up forwards), then
the rest of ``bench.run``'s row (ms mean / min / max, peak GB, the all-plain
path, ``vs_baseline``, launches per forward, the card line).  A point that
runs out of device memory gives ``{"sam_size", "bs", "oom": true}`` and the
sweep goes on; any other failure ends the run (the JAX script turns every
exception into an ``error`` row).  The last line is the summary:
``schedule_best_img_per_s`` (best batch size per SAM size), ``clock``,
``iters``.  Each point's parameters are freed before the next, so
``peak_gb`` is the point's own.
"""

from __future__ import annotations

import argparse
import dataclasses
import json
import time

import torch

from flmm_tpu_torch import bench
from flmm_tpu_torch.kernel_bench import device_of

CLOCK = ("CUDA events per forward, host clock around the timed loop "
         "(bench.run)")


def run(sizes, batch_sizes, iters: int, knobs: bench.Knobs, device,
        seed: int = 0, emit=None) -> list:
    """Every (size, bs) point in order, then the summary; ``emit`` is called
    with each row as it is ready.  Returns all rows."""
    rows, best = [], {}
    for size in sizes:
        point = dataclasses.replace(knobs, sam_size=size)
        best[str(size)] = 0.0
        for bs in batch_sizes:
            t0 = time.perf_counter()
            try:
                row = bench.run(bs, iters, point, device, seed)
            except torch.cuda.OutOfMemoryError:
                row = {"sam_size": size, "bs": bs, "oom": True}
            else:
                row = {"sam_size": size, "bs": bs, "img_per_s": row["value"],
                       "wall_incl_compile_s": round(
                           time.perf_counter() - t0, 1), **row}
                best[str(size)] = max(best[str(size)], row["value"])
            if device.type == "cuda":
                torch.cuda.empty_cache()
            rows.append(row)
            if emit is not None:
                emit(row)
    rows.append({"schedule_best_img_per_s": best, "clock": CLOCK,
                 "iters": iters})
    if emit is not None:
        emit(rows[-1])
    return rows


def main(argv=None) -> list:
    ap = argparse.ArgumentParser(
        prog="python -m flmm_tpu_torch.schedule_bench",
        description=__doc__.split("\n\n")[0],
        epilog="The preset, sequence length and encoder switches are set by "
        "the BENCH_* environment variables of flmm_tpu_torch.bench.")
    ap.add_argument("--sizes", type=int, nargs="*",
                    default=[1024, 768, 640, 448])
    ap.add_argument("--batch-sizes", type=int, nargs="*", default=[4, 8])
    ap.add_argument("--iters", type=int, default=6)
    ap.add_argument("--family", default="deepseek_vl")
    ap.add_argument("--device", default="cuda", choices=("cuda", "cpu"))
    ap.add_argument("--seed", type=int, default=0)
    args = ap.parse_args(argv)
    device = device_of(args.device, "schedule_bench")
    if device.type == "cuda":
        # full f32 products and convolutions in the plain versions
        torch.backends.cuda.matmul.allow_tf32 = False
        torch.backends.cudnn.allow_tf32 = False
    knobs = dataclasses.replace(bench.Knobs.from_env(), family=args.family)
    return run(args.sizes, args.batch_sizes, args.iters, knobs, device,
               args.seed, emit=lambda row: print(json.dumps(row), flush=True))


if __name__ == "__main__":
    main()
