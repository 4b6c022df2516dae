"""What ``python -m flmm_tpu_torch.eval_refcoco`` and ``eval_png`` share
(scripts/eval_refcoco.py, scripts/eval_png.py): their common flags, the
model setup (config and prompt from the tokenizer, the frozen checkpoints,
``--trained``, a seeded random init of what they do not supply), the forward
that maps a numpy batch to SAM low-res logits on the device, and the loop
each split runs: on one device, or with ``--sharded-eval`` data-parallel
over the ranks of a process group (torchrun's, or a group of one), every
rank computing the results and rank 0 printing them."""

from __future__ import annotations

import argparse
import contextlib
from typing import Callable

import torch
import torch.distributed as dist

from flmm_tpu_torch import registry
from flmm_tpu_torch.convert.from_jax import from_jax
from flmm_tpu_torch.data.collate import BatchSpec
from flmm_tpu_torch.evalsuite.runner import run_eval
from flmm_tpu_torch.evalsuite.sharded import run_eval_sharded
from flmm_tpu_torch.models.frozen.grounding import quantize_frozen_sam
from flmm_tpu_torch.parallel import mesh as mesh_lib
from flmm_tpu_torch.train import checkpoint as ckpt


def parser(description: str, max_masks: int) -> argparse.ArgumentParser:
    """The flags both CLIs take, with the JAX scripts' defaults."""
    p = argparse.ArgumentParser(
        description=description,
        formatter_class=argparse.RawDescriptionHelpFormatter)
    p.add_argument("--family", default="deepseek_vl")
    p.add_argument("--preset", default="1_3b")
    p.add_argument("--checkpoint", required=True)
    p.add_argument("--sam-checkpoint", default=None)
    p.add_argument("--sam-size", type=int, default=None,
                   help="SAM input resolution override (the reduced-"
                        "resolution schedule; default: the config's, 1024)")
    p.add_argument("--clip-checkpoint", default=None,
                   help="CLIP tower checkpoint (mgm)")
    p.add_argument("--aux-checkpoint", default=None,
                   help="open_clip ConvNeXt checkpoint (mgm)")
    p.add_argument("--trained", default=None,
                   help="trainable params: a released F-LMM .pth / .bin / "
                        ".safetensors, a step_<n> directory of "
                        "python -m flmm_tpu_torch.train or an Orbax "
                        "directory of the JAX trainer")
    p.add_argument("--tokenizer", default=None,
                   help="tokenizer name or directory for "
                        "transformers.AutoTokenizer (required unless a "
                        "tokenizer is passed to main)")
    p.add_argument("--template", default=None,
                   help="prompt template override (see TEMPLATES)")
    p.add_argument("--data-root", default="data/coco")
    p.add_argument("--batch-size", type=int, default=8)
    p.add_argument("--seq-len", type=int, default=704)
    p.add_argument("--seq-buckets", type=int, nargs="*", default=None,
                   help="optional seq-length buckets (pad per batch)")
    p.add_argument("--max-masks", type=int, default=max_masks)
    p.add_argument("--debug", action="store_true",
                   help="first 100 samples")
    p.add_argument("--sharded-eval", action="store_true",
                   help="data-parallel forward over the ranks (run under "
                        "torchrun; alone, a group of one)")
    p.add_argument("--int8-sam", action="store_true",
                   help="W8A8-quantised SAM encoder (int8 weights and "
                        "activations around the attention kernels)")
    add_device_flag(p)
    return p


def add_device_flag(p: argparse.ArgumentParser) -> None:
    p.add_argument("--device", default="cuda", choices=("cuda", "cpu"),
                   help="cuda (default) runs the kernels; cpu their plain "
                        "versions")


def check_device(args) -> None:
    """Refuse ``--device cuda`` without a card: nothing falls back to the
    CPU."""
    if args.device == "cuda" and not torch.cuda.is_available():
        raise SystemExit("no CUDA device; pass --device cpu to run on the "
                         "CPU")


def parse(p: argparse.ArgumentParser, argv, tokenizer):
    """Parse ``argv`` and refuse what the port does not do."""
    args = p.parse_args(argv)
    if tokenizer is None and args.tokenizer is None:
        p.error("--tokenizer is required")
    if args.family != "mgm" and (args.clip_checkpoint
                                 or args.aux_checkpoint):
        p.error("--clip-checkpoint and --aux-checkpoint load MGM's towers; "
                f"the {args.family} family reads its tower from --checkpoint")
    check_device(args)
    return args


def load_tokenizer(args, tokenizer):
    if tokenizer is not None:
        return tokenizer
    from transformers import AutoTokenizer

    return AutoTokenizer.from_pretrained(args.tokenizer)


def setup(args, tokenizer) -> dict:
    """The model the CLI evaluates: ``cfg``, the rendered prompt ``prompt``,
    ``params`` (the frozen checkpoints, random from seed 0 only where they
    hold nothing, e.g. the SAM encoder without ``--sam-checkpoint``; the
    trainable tree from ``--trained``, else random), the batch spec
    ``spec``, the batch builder ``build``, the model module ``model`` and
    the ``device``.  MGM's loader also reads ``--clip-checkpoint`` and
    ``--aux-checkpoint``; the batch builder takes the config's processing
    spec (``registry.get_batch_builder``: MGM's crop grid and sizes,
    LLaVA-NeXT's tiles and pinpoints)."""
    device = torch.device(args.device)
    cfg, prompt, spec_kwargs = registry.resolve_family_setup(
        args.family, args.preset, tokenizer, template=args.template,
        sam_size=args.sam_size)
    model = registry.get_model(args.family)
    params = load_params(args, cfg, model, device)
    spec = BatchSpec(seq_len=args.seq_len, max_masks=args.max_masks,
                     coarse_hw=registry.get_coarse_hw(cfg), **spec_kwargs)
    return {"cfg": cfg, "prompt": prompt, "params": params, "spec": spec,
            "build": registry.get_batch_builder(args.family, cfg),
            "model": model, "device": device}


def load_params(args, cfg, model, device) -> dict:
    """``{'frozen', 'trainable'}`` on ``device``: the frozen leaves from
    ``--checkpoint`` and ``--sam-checkpoint`` (MGM's loader also reads
    ``--clip-checkpoint`` and ``--aux-checkpoint`` where the parser has
    them), the trainable tree from ``--trained``; whatever they do not
    hold drawn from seed 0.  ``--int8-sam`` then quantises the SAM image
    encoder (``quantize_frozen_sam``, as the JAX scripts do)."""
    g = torch.Generator(device=device).manual_seed(0)
    extra = {}
    if args.family == "mgm":
        extra = {"clip_checkpoint": getattr(args, "clip_checkpoint", None),
                 "aux_checkpoint": getattr(args, "aux_checkpoint", None)}
    frozen = registry.get_loader(args.family)(
        args.checkpoint, cfg, args.sam_checkpoint, device=device, **extra)
    frozen.update(model.init_frozen(cfg, g, device, skip=frozen))
    # also the template restore_trainable reads a step_<n> directory into
    # (12 M parameters at DeepSeek-VL-1.3B)
    trainable = model.init_trainable(cfg, g, device)
    if args.trained:
        trainable = ckpt.restore_trainable(args.trained, cfg, trainable)
    params = {"frozen": frozen, "trainable": trainable}
    if getattr(args, "int8_sam", False):
        params = quantize_frozen_sam(params)
    return params


def make_predict(model, params: dict, cfg, device) -> Callable:
    """``numpy batch (without infos) -> (B, M, P, P) SAM low-res logits`` on
    ``device``."""
    def predict(batch: dict) -> torch.Tensor:
        with torch.no_grad():
            return model.forward(params, cfg,
                                 from_jax(batch, device))["sam_logits"]

    return predict


def seq_buckets(args) -> tuple | None:
    return tuple(args.seq_buckets) if args.seq_buckets else None


@contextlib.contextmanager
def ranks(args):
    """With ``--sharded-eval``, the process group of the run and
    ``args.device`` this rank's device; else nothing."""
    if not args.sharded_eval:
        yield
        return
    with mesh_lib.process_group(args.device) as device:
        args.device = str(device)
        yield


def prints() -> bool:
    """Whether this process prints the results (rank 0, or no group)."""
    return not dist.is_initialized() or dist.get_rank() == 0


def evaluator(args, s: dict) -> Callable:
    """``(samples, accumulator_factory, score_fn) -> results``: the host
    loop over this device's forward, or with ``--sharded-eval``
    :func:`run_eval_sharded` over a data axis of the largest size that
    divides the batch and fits the world (scripts/eval_refcoco.py:155-158;
    a rank beyond it runs the host loop, whose results are the same)."""
    model, params, cfg = s["model"], s["params"], s["cfg"]
    if args.sharded_eval:
        mesh = mesh_lib.make_mesh(mesh_lib.pick_n_data(args.batch_size), 1,
                                  s["device"].type)
        if mesh.get_coordinate() is not None:
            def sharded(samples, accumulator_factory, score_fn):
                return run_eval_sharded(
                    samples, params, lambda p, b: model.forward(p, cfg, b),
                    s["spec"], args.batch_size, mesh,
                    batch_builder=s["build"],
                    accumulator_factory=accumulator_factory,
                    score_fn=score_fn, device=s["device"])
            return sharded
    predict = make_predict(model, params, cfg, s["device"])

    def host(samples, accumulator_factory, score_fn):
        return run_eval(samples, predict, s["spec"], args.batch_size,
                        accumulator_factory, score_fn,
                        seq_len_buckets=seq_buckets(args),
                        batch_builder=s["build"]).results()
    return host
