"""Qualitative PNG visualisation dumps (scripts/demo/infer_png.py).

``--synthetic`` runs the family's grounding forward on a synthetic batch
of 2 and writes ``synthetic_{b}.png``: white where any of a sample's masks
has ``sigmoid(sam_logits) > 0.5``.  ``kmeans2`` is the paper's
no-learning baseline, 2-means clustering of attention maps
(reference multiprocess_infer_png.py:24-38), in numpy.

flmm_tpu's script parses ``--kmeans``, ``--checkpoint``,
``--sam-checkpoint``, ``--tokenizer``, ``--data-root`` and ``--limit`` and
reads none of them, and refuses the real-data path; here those flags are
refused by name, and the real-data path is refused the same way.

Example:
  python -m flmm_tpu_torch.demo.infer_png --synthetic --preset 1_3b \\
      --out png_vis [--trained ...] [--device cpu]
"""

from __future__ import annotations

import argparse
import pathlib

import numpy as np
import torch

from flmm_tpu_torch import registry
from flmm_tpu_torch.convert.from_jax import from_jax
from flmm_tpu_torch.data.image_io import write_png
from flmm_tpu_torch.data.synthetic import synthetic_batch
from flmm_tpu_torch.evalsuite import cli
from flmm_tpu_torch.train import checkpoint as ckpt

UNREAD = ("kmeans", "checkpoint", "sam_checkpoint", "tokenizer", "data_root",
          "limit")


def kmeans2(x: np.ndarray, iters: int = 20, seed: int = 0) -> np.ndarray:
    """2-means over flattened attention features -> binary assignment."""
    rng = np.random.default_rng(seed)
    flat = x.reshape(x.shape[0], -1).T  # (pixels, C)
    c = flat[rng.choice(len(flat), 2, replace=False)]
    for _ in range(iters):
        d = ((flat[:, None] - c[None]) ** 2).sum(-1)
        a = d.argmin(1)
        for k in range(2):
            if (a == k).any():
                c[k] = flat[a == k].mean(0)
    # the foreground cluster is the one with higher mean attention
    fg = int(flat[a == 1].mean() > flat[a == 0].mean())
    return (a == fg).reshape(x.shape[1:])


def parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(
        description=__doc__,
        formatter_class=argparse.RawDescriptionHelpFormatter)
    p.add_argument("--family", default="deepseek_vl")
    p.add_argument("--preset", default="tiny")
    p.add_argument("--synthetic", action="store_true")
    p.add_argument("--checkpoint", default=None, help="not read: refused")
    p.add_argument("--sam-checkpoint", default=None, help="not read: refused")
    p.add_argument("--trained", default=None)
    p.add_argument("--tokenizer", default=None, help="not read: refused")
    p.add_argument("--data-root", default="data/coco",
                   help="not read: refused")
    p.add_argument("--out", default="png_vis")
    p.add_argument("--limit", type=int, default=20, help="not read: refused")
    p.add_argument("--kmeans", action="store_true", help="not read: refused")
    cli.add_device_flag(p)
    return p


def main(argv=None) -> None:
    p = parser()
    args = p.parse_args(argv)
    given = [f"--{k.replace('_', '-')}" for k in UNREAD
             if getattr(args, k) != p.get_default(k)]
    if given:
        p.error(f"{', '.join(given)}: parsed but never read by flmm_tpu's "
                "infer_png.py; refused rather than ignored")
    if not args.synthetic:
        raise SystemExit("real-data visualisation requires --checkpoint "
                         "etc.; see flmm_tpu_torch.eval_png for the data "
                         "plumbing")
    cli.check_device(args)
    device = torch.device(args.device)

    out_dir = pathlib.Path(args.out)
    out_dir.mkdir(parents=True, exist_ok=True)
    cfg = registry.get_config(args.family, args.preset)
    base = cfg.base if hasattr(cfg, "base") else cfg
    model = registry.get_model(args.family)
    params = model.init_params(
        cfg, torch.Generator(device=device).manual_seed(0), device)
    if args.trained:
        params["trainable"] = ckpt.restore_trainable(
            args.trained, cfg, params["trainable"])

    batch = from_jax(synthetic_batch(base, batch_size=2), device)
    with torch.no_grad():
        out = model.forward(params, cfg, batch)
    pred = (torch.sigmoid(out["sam_logits"].float()) > 0.5).cpu().numpy()
    for b in range(pred.shape[0]):
        vis = (pred[b].any(0) * 255).astype(np.uint8)
        write_png(out_dir / f"synthetic_{b}.png", vis)
    print(f"dumped {pred.shape[0]} synthetic visualisations to {out_dir}")


if __name__ == "__main__":
    main()
