"""Read the check's numbers over many seeds in one process: the program as
the configuration states it (the lower readings), the control (the
reference with its frozen weights in float8 e4m3, the nearest precision
below the configuration's bfloat16, in the program's place) and planted
faults: a serve cell's boxes halved where they are made, a training
cell's half batch.  The limits in ``workloads/<cell>.json`` are set from
these readings.

    python3 -m benchmark.calibrate --workload <cell> --sound 12 \
        --control 3 --faults 3 --seconds 4 --out cal.json

Each reading is one run of the cell (set-up, a short window at the cell's
own load, the check), seeds counting up from ``--first-seed``."""

from __future__ import annotations

import argparse
import contextlib
import gc
import json
import pathlib
import sys
import time

from benchmark import run as bench_run
from benchmark.harness import faults, spec

# the planted faults read on the card; a state left unchanged, or whose
# update is never written, reads 1 on the change by its definition and
# needs no run (the CPU tests plant every fault)
SERVE_FAULTS = ("halved_box",)
TRAIN_FAULTS = ("half_batch",)


def reading(cell, seed, seconds, device, around=contextlib.nullcontext,
            **plant) -> dict:
    import torch

    t0 = time.perf_counter()
    try:
        with around():
            result, numbers = bench_run.run_cell(cell, seed, seconds, False,
                                                 device, t0, **plant)
        out = {"seed": seed, **numbers,
               "metrics": {k: v["value"] for k, v in
                           result["metrics"].items()}}
    except Exception as e:  # a plant that crashes reads as failed
        out = {"seed": seed, "error": f"{type(e).__name__}: {e}"}
    gc.collect()
    torch.cuda.empty_cache()
    print(json.dumps(out), file=sys.stderr, flush=True)
    return out


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(prog="python3 -m benchmark.calibrate")
    ap.add_argument("--workload", required=True)
    ap.add_argument("--sound", type=int, default=12)
    ap.add_argument("--control", type=int, default=3,
                    help="readings of the float8 reference control")
    ap.add_argument("--faults", type=int, default=3)
    ap.add_argument("--seconds", type=float, default=4.0)
    ap.add_argument("--first-seed", type=int, default=4_100_000_001)
    ap.add_argument("--out", required=True)
    args = ap.parse_args(argv)
    manifest = spec.read_json(bench_run.ROOT / "BENCHMARK.json")
    cell = spec.load_cell(args.workload, manifest)
    device = "cuda:0"
    seed = args.first_seed
    out = {"workload": args.workload, "sound": [], "control": [],
           "faults": {}}
    path = pathlib.Path(args.out)
    path.parent.mkdir(parents=True, exist_ok=True)

    def save():
        path.write_text(json.dumps(out, indent=1))

    for _ in range(args.sound):
        out["sound"].append(reading(cell, seed, args.seconds, device))
        seed += 1
    save()
    for _ in range(args.control):
        out["control"].append(reading(cell, seed, args.seconds, device,
                                      control=True))
        seed += 1
    save()
    names = SERVE_FAULTS if cell.mode == "serve" else TRAIN_FAULTS
    for name in names:
        out["faults"][name] = []
        for _ in range(args.faults):
            if cell.mode == "serve":
                got = reading(cell, seed, args.seconds, device,
                              around=faults.SERVE_FAULTS[name])
            else:
                got = reading(cell, seed, args.seconds, device,
                              fault=faults.TRAIN_FAULTS[name])
            out["faults"][name].append(got)
            seed += 1
        save()
    return 0


if __name__ == "__main__":
    sys.exit(main())
