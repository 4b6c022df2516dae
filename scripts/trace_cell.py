"""One benchmark cell with the program's tracer (flmm_tpu_torch/trace.py)
off and on, on one GPU.

    python3 scripts/trace_cell.py --workload dsvl13b-serve-png --seed 7 \\
        --seconds 20

Sets the cell up as ``python3 -m benchmark.run`` does (benchmark/harness/
core.py: the seed's weights on the card, the pool of pinned batches, the
warm-up) and drives the same requests or training steps, in four stretches
of ``--seconds`` each, the tracer off, on, on, off: images a second in each.
From the stretches with the tracer on, each span's mean device ms a request
(or step) and the heads' valid share from the ``heads_slots`` and
``masks_valid`` counters beside the pool's own.  Then ``--requests`` more
with the benchmark's wraps of the same layers installed (benchmark/
harness/spans.py, the wrapped per-layer readers' ``WRAPS``), each span
beside its wrapped twin; then ``--requests`` under ``torch.profiler`` with
the tracer on: the stretch's busy share and its idle ms and kernel launches
a request, each put down to the innermost span open on the host
(``trace.profile_breakdown``, the stretch's host wall time as the window).
Prints one JSON line last on standard output.
"""

from __future__ import annotations

import argparse
import collections
import contextlib
import itertools
import json
import pathlib
import statistics
import sys
import time

import torch

ROOT = pathlib.Path(__file__).resolve().parent.parent
sys.path.insert(0, str(ROOT))

from benchmark.harness import core, program, spec, spans  # noqa: E402
from flmm_tpu_torch import trace  # noqa: E402

HEADS = ("unet", "refine")
# span -> the wrapped reader it stands beside
TWINS = {"tower": "tower_ms.serve", "capture": "capture_ms.serve",
         "sam_encoder": "sam_encoder_ms.serve", "heads": "heads_ms.serve",
         "backward": "backward_ms.train", "optimizer": "optimizer_ms.train"}


def per_request(spans_: list) -> dict:
    """Device ms a request of each span name, ``heads`` (U-Net + refine)
    and ``forward_self`` (the forward less its child spans)."""
    total, self_ms = {}, 0.0
    by_id = {s["id"]: s for s in spans_}
    for s in spans_:
        ms = s["device_ms"] or 0.0  # None off the card
        total[s["name"]] = total.get(s["name"], 0.0) + ms
        if s["name"] == "forward":
            self_ms += ms
        elif by_id.get(s["parent"], {}).get("name") == "forward":
            self_ms -= ms
    total["heads"] = sum(total.get(n, 0.0) for n in HEADS)
    total["forward_self"] = self_ms
    return total


def mean_of(items: list) -> dict:
    keys = sorted({k for it in items for k in it})
    return {k: statistics.fmean(it.get(k, 0.0) for it in items)
            for k in keys}


def measure(cell, seed: int, seconds: float, n_traced: int, dev) -> dict:
    """The cell's stretches, twins and profile (the module's docstring)."""
    cuda = dev.type == "cuda"

    def sync():
        if cuda:
            torch.cuda.synchronize(dev)

    run, params, pool, _ = core.setup(cell, seed, dev, time.perf_counter(),
                                      ())
    serve = cell.mode == "serve"
    trainers = []
    outs = {}

    def one(k, tr=0):
        batch = program.to_device(pool[k], dev)
        if serve:
            with torch.no_grad():
                out = program.forward(run.family, run.cfg, params, batch)
            if k not in outs:
                outs[k] = {n: torch.empty(out[n].shape, dtype=out[n].dtype,
                                          pin_memory=cuda)
                           for n in program.SERVED}
            for n in program.SERVED:
                outs[k][n].copy_(out[n], non_blocking=True)
        else:
            trainers[tr].step(batch)
        sync()
        return int(pool[k]["input_ids"].shape[0])

    order = itertools.count()

    def next_k():
        return next(order) % len(pool)

    if not serve:
        trainers.append(program.trainer(run.family, run.cfg, params,
                                        cell.spec["optim"]))
    for _ in range(core.WARMUP + 1):
        one(next_k())

    def stretch(on: bool):
        items, images = [], 0
        t = time.perf_counter()
        with trace.tracing() if on else contextlib.nullcontext():
            while time.perf_counter() < t + seconds:
                k = next_k()
                images += one(k)
                if on:
                    items.append((k, trace.collect()))
        return images / (time.perf_counter() - t), items

    rates = {"off": [], "on": []}
    traced = []
    for on in (False, True, True, False):
        rate, items = stretch(on)
        rates["on" if on else "off"].append(rate)
        traced += items
        core.log(f"tracer {'on' if on else 'off'}: {rate:.3f} img/s")
    slots = valid = pool_slots = pool_valid = 0
    for k, got in traced:
        c = {x["name"]: x["value"] for x in got["counters"]}
        slots += c.get("heads_slots", 0)
        valid += c.get("masks_valid", 0)
        mv = run.pool_batches[k]["mask_valid"]
        pool_slots += mv.size
        pool_valid += int(mv.sum())

    # the spans beside the benchmark's wraps of the same layers
    targets = {r: getattr(cell.readers[r], "WRAPS", {})
               for r in TWINS.values() if r in cell.readers}
    wraps = spans.Spans([t for w in targets.values() for t in w],
                        dev).install()
    twin_items = []
    try:
        if not serve:  # the optimizer's wrap takes a trainer built now
            trainers.append(program.trainer(run.family, run.cfg, params,
                                            cell.spec["optim"]))
        wraps.collect()
        with trace.tracing():
            for _ in range(n_traced):
                one(next_k(), len(trainers) - 1)
                twin_items.append((per_request(trace.collect()["spans"]),
                                   wraps.collect()))
    finally:
        wraps.remove()
    twins = {}
    for span_name, reader in TWINS.items():
        if reader in targets:
            mine = statistics.fmean(s.get(span_name, 0.0)
                                    for s, _ in twin_items)
            theirs = statistics.fmean(sum(w[t][0] for t in targets[reader])
                                      for _, w in twin_items)
            twins[span_name] = {"span_ms": mine, "wrap_ms": theirs}

    # a profiled stretch with the tracer on
    acts = [torch.profiler.ProfilerActivity.CPU]
    if cuda:
        acts.append(torch.profiler.ProfilerActivity.CUDA)
    with trace.tracing(), torch.profiler.profile(activities=acts) as prof:
        sync()
        t_start = time.time_ns()
        for _ in range(n_traced):
            one(next_k())
        t_stop = time.time_ns()
    trace.collect()
    t_trace = prof.profiler.kineto_results.trace_start_ns()
    parts = trace.profile_breakdown(prof.events(), (
        (t_start - t_trace) / 1e3, (t_stop - t_trace) / 1e3))
    idle_s = parts["window_s"] - parts["busy_s"]
    return {
        "img_per_s": rates,
        "tracing_cost_pct": 100.0 * (1.0 - statistics.fmean(rates["on"])
                                     / statistics.fmean(rates["off"])),
        "traced_requests": len(traced),
        "span_device_ms": mean_of([per_request(got["spans"])
                                   for _, got in traced]),
        "span_calls": mean_of([dict(collections.Counter(
            s["name"] for s in got["spans"])) for _, got in traced]),
        "heads_valid_share_pct": 100.0 * valid / slots if slots else None,
        "pool_valid_share_pct": 100.0 * pool_valid / pool_slots
        if pool_slots else None,
        "twins": twins,
        "profile": {
            "requests": n_traced, "window_ms": parts["window_s"] * 1e3,
            "idle_pct": 100.0 * idle_s / parts["window_s"],
            "idle_ms_per_request": {k: v * 1e3 / n_traced
                                    for k, v in parts["idle_s"].items()},
            "idle_partition_gap_ms": (sum(parts["idle_s"].values())
                                      - idle_s) * 1e3,
            "launches_per_request": {k: v / n_traced for k, v in
                                     parts["launches"].items()}},
    }


def main() -> None:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, default=20.0)
    ap.add_argument("--requests", type=int, default=4)
    args = ap.parse_args()
    if not torch.cuda.is_available():
        raise SystemExit("trace_cell.py needs a CUDA device")
    # float32 as the configuration states it, as benchmark/run.py runs it
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    cell = spec.load_cell(args.workload,
                          spec.read_json(ROOT / "BENCHMARK.json"))
    dev = torch.device("cuda:0")
    result = {"workload": args.workload, "seed": args.seed,
              "card": torch.cuda.get_device_name(dev),
              **measure(cell, args.seed, args.seconds, args.requests, dev)}
    print(json.dumps(result), flush=True)


if __name__ == "__main__":
    main()
