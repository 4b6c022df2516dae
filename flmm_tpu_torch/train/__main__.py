"""Train the grounding heads of a frozen-LMM stack (scripts/train.py on
PyTorch, one device).

    # on the CPU, the toy config on synthetic data
    python -m flmm_tpu_torch.train --preset tiny --synthetic --steps 3 \\
        --device cpu
    # on one GPU: DeepSeek-VL-1.3B from its released checkpoints on PNG +
    # RefCOCO/+/g under --data-root
    python -m flmm_tpu_torch.train --family deepseek_vl --preset 1_3b \\
        --checkpoint ckpts/deepseek-vl-1.3b-chat \\
        --sam-checkpoint ckpts/sam_vit_l_0b3195.pth \\
        --tokenizer ckpts/deepseek-vl-1.3b-chat --data-root data/coco \\
        --epochs 8 --batch-size 8

Without ``--synthetic`` the batches come from the PNG + RefCOCO/+/g joint
stream under ``--data-root`` (train/streams.py), tokenised with
``--tokenizer`` (or the tokenizer passed to :func:`main`) and the family's
prompt, the config's image block placed where that tokenisation puts it
(``registry.resolve_family_setup``).  ``--checkpoint`` loads the frozen
LMM through the family's loader (``--clip-checkpoint`` and
``--aux-checkpoint`` too for mgm), ``--sam-checkpoint`` the SAM encoder
into the frozen tree and its prompt encoder and mask decoder into the
trainable one; whatever no checkpoint holds is random from seed 0.  Only
the trainable tree (U-Net, text projection, layer weights, SAM prompt
encoder and mask decoder) is trained and checkpointed
(``<work-dir>/step_<n>``).  ``--resume`` restarts from the newest
checkpoint at the step it holds, and both streams start there, so a
resumed run repeats the uninterrupted one.  ``--profile N`` writes a
``torch.profiler`` Chrome trace of steps 3 .. N + 2 to
``<work-dir>/trace/``.  Not ported: model parallelism (``--n-model``) and
multi-host runs (``--multihost``).
"""

from __future__ import annotations

import argparse
import contextlib
import json
import pathlib
import time

import torch

from flmm_tpu_torch import registry
from flmm_tpu_torch.convert import load as load_mod
from flmm_tpu_torch.convert.from_jax import from_jax
from flmm_tpu_torch.data.collate import BatchSpec
from flmm_tpu_torch.evalsuite.cli import load_tokenizer
from flmm_tpu_torch.train import checkpoint as ckpt
from flmm_tpu_torch.train import loop as train_loop
from flmm_tpu_torch.train import streams
from flmm_tpu_torch.train.diagnostics import MetricLogger, StepTimer, \
    nonfinite_guard, profile

SYNTHETIC_STEPS = 10000  # --steps absent on the synthetic stream
PROFILE_FROM = 2  # the first profiled step's index in the run (step 3)


def parse_args(argv=None, tokenizer=None):
    """The flags; ``tokenizer`` stands in for ``--tokenizer``.  Refuses what
    the port does not do and flags that do not go together."""
    p = argparse.ArgumentParser(
        prog="python -m flmm_tpu_torch.train",
        description=__doc__.splitlines()[0],
        formatter_class=argparse.RawDescriptionHelpFormatter)
    p.add_argument("--family", default="deepseek_vl")
    p.add_argument("--preset", default="tiny")
    p.add_argument("--synthetic", action="store_true",
                   help="train on schema-exact synthetic data")
    p.add_argument("--synthetic-task", default="random",
                   choices=["random", "grounding"],
                   help="'random' (schema smoke) or 'grounding' (the "
                        "derivable coloured-rectangles task; standard "
                        "families only)")
    p.add_argument("--checkpoint", default=None,
                   help="frozen LMM checkpoint directory")
    p.add_argument("--sam-checkpoint", default=None,
                   help="official SAM .pth: the frozen encoder and the "
                        "trainable prompt encoder and mask decoder")
    p.add_argument("--sam-size", type=int, default=None,
                   help="SAM input resolution (the reduced-resolution "
                        "schedule, e.g. 448; default: the config's, 1024)")
    p.add_argument("--clip-checkpoint", default=None,
                   help="CLIP tower checkpoint (mgm)")
    p.add_argument("--aux-checkpoint", default=None,
                   help="open_clip ConvNeXt checkpoint (mgm)")
    p.add_argument("--tokenizer", default=None,
                   help="tokenizer name or directory for "
                        "transformers.AutoTokenizer (the real-data stream "
                        "needs one unless it is passed to main)")
    p.add_argument("--template", default=None,
                   help="prompt template override (see TEMPLATES)")
    p.add_argument("--data-root", default="data/coco")
    p.add_argument("--work-dir", default="work_dirs/run")
    p.add_argument("--batch-size", type=int, default=8)
    p.add_argument("--num-workers", type=int, default=4,
                   help="sample-reading threads of the real-data stream")
    p.add_argument("--seq-len", type=int, default=704)
    p.add_argument("--max-masks", type=int, default=8)
    p.add_argument("--steps", type=int, default=None,
                   help="default: --epochs of the real-data stream, "
                        f"{SYNTHETIC_STEPS} synthetic")
    p.add_argument("--epochs", type=int, default=8)
    p.add_argument("--lr", type=float, default=1e-4)
    p.add_argument("--save-steps", type=int, default=500)
    p.add_argument("--log-interval", type=int, default=10)
    p.add_argument("--n-model", type=int, default=1,
                   help="model-parallel axis size (not ported)")
    p.add_argument("--resume", action="store_true")
    p.add_argument("--profile", type=int, default=0, metavar="N",
                   help="a torch.profiler trace of N steps (from step 3) "
                        "into <work-dir>/trace/")
    p.add_argument("--nonfinite-guard", action="store_true",
                   help="skip optimizer updates when grads are non-finite")
    p.add_argument("--metrics-file", default=None,
                   help="JSONL metric log (default <work-dir>/metrics.jsonl)")
    p.add_argument("--multihost", action="store_true",
                   help="multi-host runs (not ported)")
    p.add_argument("--device", default="cuda",
                   help="torch device; 'cuda' fails without a card")
    args = p.parse_args(argv)
    if args.n_model != 1 or args.multihost:
        p.error("--n-model and --multihost are not ported: ROADMAP queue 1 "
                "item 11")
    if args.family != "mgm" and (args.clip_checkpoint or args.aux_checkpoint):
        p.error("--clip-checkpoint and --aux-checkpoint load MGM's towers; "
                f"the {args.family} family reads its tower from --checkpoint")
    if args.sam_checkpoint and not args.checkpoint:
        p.error("--sam-checkpoint is read with --checkpoint")
    if not args.synthetic and tokenizer is None and args.tokenizer is None:
        p.error("the real-data stream needs --tokenizer")
    if (args.synthetic_task == "grounding"
            and args.family not in streams.STANDARD):
        p.error(f"--synthetic-task grounding takes the families "
                f"{', '.join(streams.STANDARD)}")
    return args


def setup(args, device: torch.device, tokenizer=None) -> dict:
    """The config, the batch stream's makings and the parameters: ``cfg``,
    ``params`` and, for the real-data stream, ``prompt``, ``spec`` and
    ``build``."""
    out = {}
    if args.synthetic:
        cfg = registry.get_config(args.family, args.preset)
        if args.sam_size:
            cfg = registry.with_sam_size(cfg, args.sam_size)
    else:
        out["tokenizer"] = load_tokenizer(args, tokenizer)
        cfg, out["prompt"], spec_kwargs = registry.resolve_family_setup(
            args.family, args.preset, out["tokenizer"],
            template=args.template, sam_size=args.sam_size)
        out["spec"] = BatchSpec(seq_len=args.seq_len,
                                max_masks=args.max_masks,
                                coarse_hw=registry.get_coarse_hw(cfg),
                                **spec_kwargs)
        out["build"] = registry.get_batch_builder(args.family, cfg)
    model = registry.get_model(args.family)
    g = torch.Generator(device=device).manual_seed(0)
    frozen = {}
    if args.checkpoint:
        extra = ({"clip_checkpoint": args.clip_checkpoint,
                  "aux_checkpoint": args.aux_checkpoint}
                 if args.family == "mgm" else {})
        frozen = registry.get_loader(args.family)(
            args.checkpoint, cfg, args.sam_checkpoint, device=device,
            **extra)
    # what no checkpoint holds, as init_params draws it from seed 0
    frozen.update(model.init_frozen(cfg, g, device, skip=frozen))
    frozen["llm"].pop("lm_head", None)  # the loss never reads it
    trainable = model.init_trainable(cfg, g, device)
    if args.sam_checkpoint:
        base = cfg.base if hasattr(cfg, "base") else cfg
        trainable["sam"] = load_mod.sam_trainable(args.sam_checkpoint,
                                                  base.sam, device)
    out.update(cfg=cfg, model=model,
               params={"frozen": frozen, "trainable": trainable})
    return out


def main(argv=None, tokenizer=None) -> None:
    """The trainer; ``tokenizer`` stands in for ``--tokenizer``."""
    args = parse_args(argv, tokenizer)
    device = torch.device(args.device)
    if device.type == "cuda" and not torch.cuda.is_available():
        raise SystemExit("flmm_tpu_torch.train: no CUDA device; pass "
                         "--device cpu to train on the CPU")
    if device.type == "cuda":
        torch.backends.cuda.matmul.allow_tf32 = False
        torch.backends.cudnn.allow_tf32 = False
    run = setup(args, device, tokenizer)
    cfg, model, params = run["cfg"], run["model"], run["params"]

    joint = None
    if not args.synthetic:
        joint = streams.JointStream(
            args.data_root, run["tokenizer"], run["prompt"], run["build"],
            run["spec"], args.batch_size, args.num_workers)
    steps = args.steps or (args.epochs * joint.batches_per_epoch if joint
                           else SYNTHETIC_STEPS)
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

    start = state["step"]
    stream = (joint.batches(start, steps) if joint else
              streams.synthetic_stream(args.family, cfg, args.synthetic_task,
                                       args.batch_size, start, steps))
    step_fn = train_loop.make_train_step(
        lambda p, b: model.loss_fn(p, cfg, b), opt)
    mlog = MetricLogger(
        path=args.metrics_file or str(workdir / "metrics.jsonl"),
        interval=args.log_interval)
    timer = StepTimer(window=args.log_interval)
    waits = StepTimer(window=args.log_interval)  # a step waiting for data
    with contextlib.ExitStack() as profiling:
        t0 = time.time()
        t_wait = time.perf_counter()
        for n, batch in enumerate(stream):  # n: steps of this run
            waits.add(time.perf_counter() - t_wait)
            i = start + n
            if args.profile and n == PROFILE_FROM:
                profiling.enter_context(profile(workdir / "trace", device))
            state, metrics = step_fn(state, params["frozen"],
                                     from_jax(batch, device))
            if device.type == "cuda":
                torch.cuda.synchronize()  # the timer measures device work
            timer.tick()
            if args.profile and n == PROFILE_FROM + args.profile - 1:
                profiling.close()
                print(f"profile: wrote a trace to {workdir / 'trace'}",
                      flush=True)
            if (i + 1) % args.log_interval == 0:
                m = {k: float(v) for k, v in metrics.items()}
                m["sec_per_step"] = timer.mean
                m["imgs_per_sec"] = args.batch_size / max(timer.mean, 1e-9)
                m["data_wait_ms"] = waits.mean * 1e3
                mlog.log(i + 1, m)
                m["step"] = i + 1
                m["wall"] = time.time() - t0
                print(json.dumps(m), flush=True)
            if (i + 1) % args.save_steps == 0 or i + 1 == steps:
                ckpt.save(workdir / f"step_{i + 1}", state)
                print(f"saved step_{i + 1}", flush=True)
            t_wait = time.perf_counter()
    mlog.close()


if __name__ == "__main__":
    main()
