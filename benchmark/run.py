"""Run one cell of the benchmark once.

    python3 -m benchmark.run --workload <cell> --seed <n> --seconds <s> \
        --trace <0|1>

from the root of a checkout.  The cell, its configuration, traffic mix and
metrics are found by name from ``BENCHMARK.json`` (benchmark/harness/
spec.py).  The run makes the weights on the card from the seed, loads or
builds the program's kernels into ``build/`` in the checkout, builds the
cell's requests and warms up on their shapes, measures for ``--seconds``,
checks the window's outputs against the float32 reference
(benchmark/harness/check.py), and prints one JSON line last on standard
output.  ``--trace 0`` reports the cell's end-to-end metrics, ``--trace 1``
its per-layer metrics.  Without a card, with fewer cards than the cell
asks for, or with JAX or the JAX package loaded after the window, it
exits non-zero and prints no result.
"""

from __future__ import annotations

import time

T0 = time.perf_counter()

import argparse  # noqa: E402
import json  # noqa: E402
import os  # noqa: E402
import pathlib  # noqa: E402
import subprocess  # noqa: E402
import sys  # noqa: E402

ROOT = pathlib.Path(__file__).resolve().parents[1]
# every build and kernel cache inside the checkout, at fixed paths
for _var, _sub in (("TORCH_EXTENSIONS_DIR", "torch_extensions"),
                   ("TRITON_CACHE_DIR", "triton")):
    os.environ.setdefault(_var, str(ROOT / "build" / "bench_cache" / _sub))
os.environ.setdefault("USE_FLAX", "0")
os.environ.setdefault("USE_JAX", "0")

FORBIDDEN = ("jax", "jaxlib", "flax", "flmm_tpu")


def forbidden_modules() -> list:
    """Loaded modules whose top-level name is JAX's or the JAX package's,
    compared whole."""
    return sorted({m.split(".")[0] for m in sys.modules
                   if m.split(".")[0] in FORBIDDEN})


def card_line() -> str:
    try:
        out = subprocess.run(
            ["nvidia-smi", "--query-gpu=name,power.limit",
             "--format=csv,noheader"], capture_output=True, text=True,
            timeout=30)
        return out.stdout.strip() or "not read"
    except (OSError, subprocess.SubprocessError):
        return "not read"


def run_cell(cell, seed: int, seconds: float, trace: bool, device,
             t0: float, fault=None, control: bool = False) -> tuple:
    """One run: ``(result, check numbers)``; ``fault`` plants a fault under
    a training cell's step, ``control`` checks the reference with float8
    weights in the program's place (the calibration and the tests)."""
    import torch

    from benchmark.harness import check, core

    # float32 as the configuration states it, as the port's entry points
    # (bench.py, train/__main__.py) run it: no TF32
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    targets, trace_n = [], 0
    if trace:
        for m in cell.per_layer:
            targets += list(getattr(cell.readers[m["name"]], "WRAPS", {}))
        trace_n = cell.spec["trace_requests"]
    if cell.mode == "serve":
        run = core.serve(cell, seed, seconds, device, t0, targets, trace_n)
    else:
        run = core.train(cell, seed, seconds, device, t0, targets, trace_n,
                         fault=fault)
    metrics = {}
    for m in cell.metrics(trace):
        value = cell.readers[m["name"]].read(run)
        if value is None:
            print(f"{m['name']}: nothing to read "
                  f"{run.counts or ''}", file=sys.stderr)
            continue
        metrics[m["name"]] = {"value": float(value), "unit": m["unit"]}
    core.free_cached()
    dev = torch.device(device)
    t_check = time.perf_counter()
    if cell.mode == "serve":
        numbers = check.serve(run, cell.spec["check_requests"], control)
    else:
        numbers = check.train(run, core.CHECK_STEPS, control)
    core.log(f"check: {time.perf_counter() - t_check:.2f} s")
    correct, shown = check.verdict(numbers, cell.spec.get("limits", {}))
    result = {
        "correct": correct, "attempted": len(run.items), "failed": 0,
        "metrics": metrics,
        "device": {
            "platform": "gpu" if dev.type == "cuda" else dev.type,
            "kind": (torch.cuda.get_device_name(dev) if dev.type == "cuda"
                     else "cpu"),
            "count": cell.spec["chips"],
            "memory_peak_bytes": run.memory_peak}}
    if trace and run.profile is not None:
        result["device"]["busy_s"] = run.profile["busy_s"]
        result["device"]["window_s"] = run.profile["window_s"]
        result["breakdown"] = run.profile["breakdown"]
    result["check"] = shown
    return result, numbers


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(prog="python3 -m benchmark.run",
                                 description=__doc__.split("\n\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = ap.parse_args(argv)

    from benchmark.harness import spec

    manifest = spec.read_json(ROOT / "BENCHMARK.json")
    cell = spec.load_cell(args.workload, manifest)

    import torch

    if (not torch.cuda.is_available()
            or torch.cuda.device_count() < cell.spec["chips"]):
        print(f"{args.workload} needs {cell.spec['chips']} CUDA device(s); "
              f"found {torch.cuda.device_count()}", file=sys.stderr)
        return 2
    print(f"card: {card_line()}", file=sys.stderr)
    result, _ = run_cell(cell, args.seed, args.seconds, bool(args.trace),
                         "cuda:0", T0)
    found = forbidden_modules()
    if found:
        print(f"loaded after the window: {', '.join(found)}",
              file=sys.stderr)
        return 3
    for name, c in result["check"].items():
        print(f"check {name}: {c['value']!r} limit {c['limit']!r}",
              file=sys.stderr)
    print(json.dumps(result), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
