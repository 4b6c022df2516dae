"""Train the grounding heads of a frozen-LMM stack on synthetic data (the
synthetic path of scripts/train.py, on PyTorch).

    # on the CPU, the toy config
    python -m flmm_tpu_torch.train --preset tiny --synthetic --steps 3 \
        --device cpu
    # on one GPU: DeepSeek-VL-1.3B at the SAM-448 schedule
    python -m flmm_tpu_torch.train --family deepseek_vl --preset 1_3b \
        --synthetic --sam-size 448 --batch-size 8 --steps 100

The frozen weights are random, from a seed; only the trainable tree (U-Net,
text projection, layer weights, SAM prompt encoder and mask decoder) is
trained and checkpointed (``<work-dir>/step_<n>``).  ``--resume`` restarts
from the newest checkpoint at the step it holds, so a resumed run repeats
the uninterrupted one.  Not ported: frozen checkpoints (``--checkpoint``,
``--sam-checkpoint``), the real-data stream, model parallelism
(``--n-model``), multi-host runs and ``--profile``.
"""

from __future__ import annotations

import argparse
import json
import pathlib
import time

import torch

from flmm_tpu_torch import registry
from flmm_tpu_torch.convert.from_jax import from_jax
from flmm_tpu_torch.data.synthetic import synthetic_batch, \
    synthetic_grounding_batch
from flmm_tpu_torch.train import checkpoint as ckpt
from flmm_tpu_torch.train import loop as train_loop
from flmm_tpu_torch.train.diagnostics import MetricLogger, StepTimer, \
    nonfinite_guard


def parse_args(argv=None):
    p = argparse.ArgumentParser(
        prog="python -m flmm_tpu_torch.train",
        description=__doc__.splitlines()[0],
        formatter_class=argparse.RawDescriptionHelpFormatter)
    p.add_argument("--family", default="deepseek_vl")
    p.add_argument("--preset", default="tiny")
    p.add_argument("--synthetic", action="store_true",
                   help="train on schema-exact synthetic data (required: "
                        "the real-data stream is not ported)")
    p.add_argument("--synthetic-task", default="random",
                   choices=["random", "grounding"],
                   help="'random' (schema smoke) or 'grounding' (the "
                        "derivable coloured-rectangles task)")
    p.add_argument("--sam-size", type=int, default=None,
                   help="SAM input resolution (the reduced-resolution "
                        "schedule, e.g. 448; default: the config's, 1024)")
    p.add_argument("--work-dir", default="work_dirs/run")
    p.add_argument("--batch-size", type=int, default=8)
    p.add_argument("--steps", type=int, default=None)
    p.add_argument("--lr", type=float, default=1e-4)
    p.add_argument("--save-steps", type=int, default=500)
    p.add_argument("--log-interval", type=int, default=10)
    p.add_argument("--resume", action="store_true")
    p.add_argument("--nonfinite-guard", action="store_true",
                   help="skip optimizer updates when grads are non-finite")
    p.add_argument("--metrics-file", default=None,
                   help="JSONL metric log (default <work-dir>/metrics.jsonl)")
    p.add_argument("--device", default="cuda",
                   help="torch device; 'cuda' fails without a card")
    return p.parse_args(argv)


def synthetic_stream(args, cfg, start: int, steps: int):
    """Batches ``start .. steps - 1``, batch ``i`` made from seed ``i``."""
    base = cfg.base if hasattr(cfg, "base") else cfg
    for i in range(start, steps):
        if args.synthetic_task == "grounding":
            yield synthetic_grounding_batch(base, batch_size=args.batch_size,
                                            seed=i)
        else:
            yield synthetic_batch(base, batch_size=args.batch_size, seed=i)


def main(argv=None) -> None:
    args = parse_args(argv)
    device = torch.device(args.device)
    if device.type == "cuda" and not torch.cuda.is_available():
        raise SystemExit("flmm_tpu_torch.train: no CUDA device; pass "
                         "--device cpu to train on the CPU")
    if not args.synthetic:
        raise SystemExit("flmm_tpu_torch.train: only --synthetic data is "
                         "ported")
    if device.type == "cuda":
        torch.backends.cuda.matmul.allow_tf32 = False
        torch.backends.cudnn.allow_tf32 = False
    if args.family == "mgm":
        raise SystemExit("flmm_tpu_torch.train: the synthetic stream of the "
                         "mgm family (its crops and aux pixels) is not "
                         "ported; ROADMAP queue 1 item 7")
    cfg = registry.get_config(args.family, args.preset)
    if args.sam_size:
        cfg = registry.with_sam_size(cfg, args.sam_size)
    model = registry.get_model(args.family)
    if not hasattr(model, "loss_fn"):
        raise SystemExit(f"flmm_tpu_torch.train: the {args.family} loss is "
                         "not ported")
    params = model.init_params(
        cfg, torch.Generator(device=device).manual_seed(0), device)
    params["frozen"]["llm"].pop("lm_head", None)  # the loss never reads it

    steps = args.steps or 10000
    opt = train_loop.make_optimizer(train_loop.OptimConfig(
        lr=args.lr, total_steps=steps))
    if args.nonfinite_guard:
        opt = nonfinite_guard(opt)
    state = train_loop.init_state(params["trainable"], opt)
    workdir = pathlib.Path(args.work_dir)
    workdir.mkdir(parents=True, exist_ok=True)
    if args.resume:
        latest = ckpt.latest(workdir)
        if latest is not None:
            state = ckpt.restore(latest, state)
            print(f"resumed from {latest} at step {state['step']}")

    step_fn = train_loop.make_train_step(
        lambda p, b: model.loss_fn(p, cfg, b), opt)
    mlog = MetricLogger(
        path=args.metrics_file or str(workdir / "metrics.jsonl"),
        interval=args.log_interval)
    timer = StepTimer(window=args.log_interval)
    t0 = time.time()
    for i, batch in enumerate(synthetic_stream(args, cfg, state["step"],
                                               steps), start=state["step"]):
        state, metrics = step_fn(state, params["frozen"],
                                 from_jax(batch, device))
        if device.type == "cuda":
            torch.cuda.synchronize()  # the timer measures device work
        timer.tick()
        if (i + 1) % args.log_interval == 0:
            m = {k: float(v) for k, v in metrics.items()}
            m["sec_per_step"] = timer.mean
            m["imgs_per_sec"] = args.batch_size / max(timer.mean, 1e-9)
            mlog.log(i + 1, m)
            m["step"] = i + 1
            m["wall"] = time.time() - t0
            print(json.dumps(m), flush=True)
        if (i + 1) % args.save_steps == 0 or i + 1 == steps:
            ckpt.save(workdir / f"step_{i + 1}", state)
            print(f"saved step_{i + 1}", flush=True)
    mlog.close()


if __name__ == "__main__":
    main()
