"""An accuracy proxy for the reduced-resolution SAM schedule
(scripts/sam_size_accuracy_proxy.py of the JAX package, flag for flag):
the tiny twin trained on the derivable coloured-rectangles grounding task
(``synthetic_grounding_batch``) at the native SAM size and at fractions of
it, through ``with_sam_size`` as the deployment knob, the same seeds and
step budget at each size.

    python -m flmm_tpu_torch.sam_size_accuracy_proxy [--steps 400] \\
        [--lr 5e-3] [--tail 40] [--sizes 1.0 0.75 0.625 0.5 0.375] \\
        [--seeds 3] [--device cuda] [--seed 0]

:func:`run` returns the means over the last ``tail`` steps of ``aiou``,
``sam_aiou`` and ``loss`` (the JAX script's keys, rounded as it rounds
them) and, beside them, ``head_loss`` and ``head_aiou``, the means over
the first ``tail`` steps: the heads learn where the tail's loss is below
the head's and its aiou above.  The lines are the JAX script's: one a
(size, seed), one a size with the mean and spread over the seeds, and the
``curve`` at the end; the first line is the card's name and power limit.
Seeds ``--seed`` to ``--seed + --seeds - 1`` draw the weights (a CPU
``torch.Generator``, so the same weights on every device and not the JAX
package's numbers) and the batches.
``--device`` defaults to ``cuda`` and the run fails without a card;
``--device cpu`` trains on the CPU.
"""

from __future__ import annotations

import argparse
import json

import torch

from flmm_tpu_torch.convert.from_jax import from_jax
from flmm_tpu_torch.kernel_bench import card_line, device_of

KEYS = ("aiou", "sam_aiou", "loss")


def run(cfg, steps: int, lr: float, tail: int, seed: int = 0,
        device="cpu") -> dict:
    """Train the heads of ``cfg`` for ``steps`` bs-8 steps from ``seed``;
    the tail's and the head's metric means."""
    from flmm_tpu_torch.data.synthetic import synthetic_grounding_batch
    from flmm_tpu_torch.models.frozen import grounding as model
    from flmm_tpu_torch.train import loop as train_loop

    # drawn on the host and copied, so that a seed gives one trajectory on
    # every device
    params = from_jax(model.init_params(
        cfg, torch.Generator().manual_seed(seed), "cpu"), device)
    opt = train_loop.make_optimizer(train_loop.OptimConfig(
        lr=lr, total_steps=steps, warmup_ratio=0.05))
    state = train_loop.init_state(params["trainable"], opt)
    step = train_loop.make_train_step(
        lambda p, b: model.loss_fn(p, cfg, b), opt)
    head_m: list[dict] = []
    tail_m: list[dict] = []
    for i in range(steps):
        batch = from_jax(synthetic_grounding_batch(
            cfg, 8, seed=i + 100000 * seed), device)
        state, m = step(state, params["frozen"], batch)
        if i < tail:
            head_m.append({k: float(m[k]) for k in ("aiou", "loss")})
        if i >= steps - tail:
            tail_m.append({k: float(m[k]) for k in KEYS})
    out = {k: round(sum(m[k] for m in tail_m) / len(tail_m), 4)
           for k in KEYS}
    for k in ("loss", "aiou"):
        out[f"head_{k}"] = round(sum(m[k] for m in head_m) / len(head_m), 4)
    return out


def main(argv=None) -> dict:
    ap = argparse.ArgumentParser(description=__doc__)
    ap.add_argument("--steps", type=int, default=400)
    ap.add_argument("--lr", type=float, default=5e-3)
    ap.add_argument("--tail", type=int, default=40,
                    help="steps averaged for the final metrics")
    ap.add_argument("--sizes", type=float, nargs="*",
                    default=[1.0, 0.75, 0.625, 0.5, 0.375],
                    help="SAM-size fractions of native (tiny twin native "
                         "128 ~ deployment 1024; 0.75~768, 0.625~640, "
                         "0.5~512, 0.375~384; 448 is not patch-divisible "
                         "at tiny scale)")
    ap.add_argument("--seeds", type=int, default=3,
                    help="independent init+data seeds per size")
    ap.add_argument("--device", default="cuda")
    ap.add_argument("--seed", type=int, default=0,
                    help="the first of the --seeds seeds")
    args = ap.parse_args(argv)
    device = device_of(args.device, "sam_size_accuracy_proxy")
    if device.type == "cuda":  # f32 products stay f32, as the trainer's
        torch.backends.cuda.matmul.allow_tf32 = False
        torch.backends.cudnn.allow_tf32 = False
    print(card_line(device), flush=True)

    from flmm_tpu_torch.configs.deepseek_vl import tiny
    from flmm_tpu_torch.registry import with_sam_size

    native_size = tiny().sam.encoder.img_size
    patch = tiny().sam.encoder.patch_size
    results = {}
    for frac in args.sizes:
        size = int(round(native_size * frac / patch)) * patch
        cfg = with_sam_size(tiny(), size)
        per_seed = []
        for s in range(args.seed, args.seed + args.seeds):
            m = run(cfg, args.steps, args.lr, args.tail, seed=s,
                    device=device)
            per_seed.append(m)
            print(json.dumps({"frac": frac, "sam_size": size, "seed": s,
                              **m}), flush=True)
        keys = per_seed[0].keys()
        mean = {k: round(sum(m[k] for m in per_seed) / len(per_seed), 4)
                for k in keys}
        spread = {k: round(max(m[k] for m in per_seed)
                           - min(m[k] for m in per_seed), 4) for k in keys}
        results[f"{frac}"] = {"sam_size": size, "mean": mean,
                              "spread": spread}
        print(json.dumps({f"{frac}": results[f"{frac}"]}), flush=True)
    out = {"proxy": "tiny-twin derivable grounding task",
           "steps": args.steps, "seeds": args.seeds, "curve": results}
    print(json.dumps(out), flush=True)
    return out


if __name__ == "__main__":
    main()
