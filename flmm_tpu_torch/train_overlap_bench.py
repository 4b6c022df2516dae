"""A full-size training step: the device step against the host's batch
building, and how much the prefetching loader overlaps them
(scripts/train_overlap_bench.py of the JAX package, measurement for
measurement).

    python -m flmm_tpu_torch.train_overlap_bench [--batch-size 4] \\
        [--steps 6] [--family deepseek_vl] [--preset 1_3b] [--workers 4] \\
        [--device cuda] [--seed 0]

a) device only: ``--steps`` batches built and copied to the card first,
   the steps run back to back through the carried train state, one
   synchronise at the end (``device_step_s`` a step);
b) the host's cost of one ``synthetic_batch`` after a warm call
   (``host_batch_gen_s``);
c) the production shape: ``PrefetchLoader`` threads build the batches
   while the card steps (``overlapped_step_s``); ``overlap_factor`` =
   (a + b) / c, and ``data_wait_s`` the time a step of (c) spent blocked
   on the loader.

One JSON line with the JAX script's keys in its order, ``data_wait_s``
after ``overlap_factor``, times unrounded; the line before it is the
card's name and power limit.  Weights are random from ``--seed``, the
batches ``synthetic_batch``'s (seeds as the JAX script).  ``--device``
defaults to ``cuda`` and the run fails without a card; ``--device cpu``
(with ``--preset tiny``) is for the CPU tests and measures no device.
"""

from __future__ import annotations

import argparse
import json
import time

import torch

from flmm_tpu_torch import registry
from flmm_tpu_torch.convert.from_jax import from_jax
from flmm_tpu_torch.data.loader import EpochSampler, PrefetchLoader
from flmm_tpu_torch.data.synthetic import synthetic_batch
from flmm_tpu_torch.kernel_bench import card_line, device_of
from flmm_tpu_torch.train import loop as train_loop


def _sync(device: torch.device) -> None:
    if device.type == "cuda":
        torch.cuda.synchronize(device)


def run(family: str, preset: str, batch_size: int, steps: int, workers: int,
        device: torch.device, seed: int = 0) -> dict:
    """The three measurements; returns the JSON line's dict."""
    cfg = registry.get_config(family, preset)
    model = registry.get_model(family)
    params = model.init_params(
        cfg, torch.Generator(device=device).manual_seed(seed), device)
    params["frozen"]["llm"].pop("lm_head", None)  # the loss never reads it
    opt = train_loop.make_optimizer(train_loop.OptimConfig())
    state = train_loop.init_state(params["trainable"], opt)
    step = train_loop.make_train_step(
        lambda p, b: model.loss_fn(p, cfg, b), opt)
    frozen = params["frozen"]

    # b) host generation cost (one batch, after a warm call)
    synthetic_batch(cfg, batch_size=batch_size, seed=999)
    t0 = time.perf_counter()
    synthetic_batch(cfg, batch_size=batch_size, seed=998)
    host_s = time.perf_counter() - t0

    # a) device only: batches on the card first, steps chained through
    # the train state, one synchronise
    batches = [from_jax(synthetic_batch(cfg, batch_size=batch_size, seed=i),
                        device) for i in range(steps + 1)]
    state, _ = step(state, frozen, batches[0])  # warm
    _sync(device)
    t0 = time.perf_counter()
    for b in batches[1:]:
        state, _ = step(state, frozen, b)
    _sync(device)
    device_s = (time.perf_counter() - t0) / steps
    del batches

    # c) overlapped: the loader's workers build batches while the card
    # steps (batch_size 1 at the loader: each index is a whole batch)
    def sample_fn(i):
        return synthetic_batch(cfg, batch_size=batch_size, seed=1000 + i)

    loader = PrefetchLoader(
        sample_fn, lambda xs: xs[0], EpochSampler(steps + 1, seed=0),
        batch_size=1, num_workers=workers, prefetch=2)
    it = loader.epoch(0)
    state, _ = step(state, frozen, from_jax(next(it), device))
    _sync(device)
    n, wait = 0, 0.0
    t0 = time.perf_counter()
    while True:
        t_wait = time.perf_counter()
        b = next(it, None)
        wait += time.perf_counter() - t_wait
        if b is None:
            break
        state, _ = step(state, frozen, from_jax(b, device))
        n += 1
    _sync(device)
    overlapped_s = (time.perf_counter() - t0) / max(1, n)

    return {
        "preset": preset, "batch_size": batch_size,
        "device_step_s": device_s,
        "host_batch_gen_s": host_s,
        "overlapped_step_s": overlapped_s,
        "overlap_factor": (device_s + host_s) / max(overlapped_s, 1e-9),
        "data_wait_s": wait / max(1, n),
        "steps_per_s_overlapped": 1.0 / max(overlapped_s, 1e-9),
    }


def main(argv=None) -> dict:
    ap = argparse.ArgumentParser(description=__doc__)
    ap.add_argument("--batch-size", type=int, default=4)
    ap.add_argument("--steps", type=int, default=6)
    ap.add_argument("--family", default="deepseek_vl")
    ap.add_argument("--preset", default="1_3b")
    ap.add_argument("--workers", type=int, default=4)
    ap.add_argument("--device", default="cuda")
    ap.add_argument("--seed", type=int, default=0)
    args = ap.parse_args(argv)
    device = device_of(args.device, "train_overlap_bench")
    if device.type == "cuda":  # f32 products stay f32, as the trainer's
        torch.backends.cuda.matmul.allow_tf32 = False
        torch.backends.cudnn.allow_tf32 = False
    print(card_line(device), flush=True)
    out = run(args.family, args.preset, args.batch_size, args.steps,
              args.workers, device, args.seed)
    print(json.dumps(out), flush=True)
    return out


if __name__ == "__main__":
    main()
