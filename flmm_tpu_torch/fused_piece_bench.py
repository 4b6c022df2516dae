"""The SAM encoder block's fused pieces against their unfused ones at the
bs-8 ViT-L geometry (scripts/fused_piece_bench.py of the JAX package, case
for case): K3 ``fused_ln_qkv``, K4 ``fused_proj_ln_mlp`` and K8
``fused_ln_mlp`` beside their plain PyTorch twins.

    python -m flmm_tpu_torch.fused_piece_bench [--device cuda] [--seed 0]

N = 8 x 64 x 64 = 32768 tokens, C = 1024, F = 4096, bf16, random weights
from a seeded generator (x 0.02, unit LayerNorm, zero biases, as the JAX
script).  One JSON line per case in the JAX script's order: ``op``, ``ms``
(the mean of 10 calls between CUDA events after the warm-up calls,
kernel_bench.timeit, as the JAX script's 10 iterations) and ``launches`` (the wrapper's kernel
launches over the warm-up and timed calls; 0 for a plain case and on the
CPU); a fused case also carries ``vs_plain``,
its max |difference| over the largest |plain| on the same inputs.  The
JAX script's ``*_xla`` cases are the ``*_plain`` ones here.  The first line
is the card's name and power limit.

``--device`` defaults to ``cuda`` and the run fails without a card;
``--device cpu`` runs the plain twins on the host clock (for the CPU
tests, with ``--tokens`` cut), which is no device time.  A kernel that
fails to build or launch ends the run.
"""

from __future__ import annotations

import argparse
import json

import torch

from flmm_tpu_torch.kernel_bench import card_line, device_of, timeit
from flmm_tpu_torch.ops import fused_block as fb

N, C, F = 8 * 64 * 64, 1024, 4096
EPS = 1e-6


def make_inputs(n: int, c: int, f: int, device, seed: int = 0,
                dtype=torch.bfloat16) -> tuple:
    """``(x, attn, p)``: the ``(n, c)`` tokens and attention output and
    the block's weights, as the JAX script draws them."""
    g = torch.Generator(device=device).manual_seed(seed)

    def randn(shape, scale=1.0):
        return (torch.randn(shape, generator=g, device=device)
                * scale).to(dtype)

    x, attn = randn((n, c)), randn((n, c))
    p = {"ln_w": torch.ones((c,), dtype=dtype, device=device),
         "ln_b": torch.zeros((c,), dtype=dtype, device=device),
         "wqkv": randn((c, 3 * c), 0.02),
         "bqkv": torch.zeros((3 * c,), dtype=dtype, device=device),
         "wo": randn((c, c), 0.02),
         "bo": torch.zeros((c,), dtype=dtype, device=device),
         "w1": randn((c, f), 0.02),
         "b1": torch.zeros((f,), dtype=dtype, device=device),
         "w2": randn((f, c), 0.02),
         "b2": torch.zeros((c,), dtype=dtype, device=device)}
    return x, attn, p


def cases(attn: torch.Tensor) -> dict:
    """``name -> (fn(x, p), wrapper whose launches count or None)`` in the
    JAX script's order."""
    def ln_qkv(fn):
        return lambda x, p: fn(x, p["ln_w"], p["ln_b"], p["wqkv"],
                               p["bqkv"], EPS)

    def proj_ln_mlp(fn):
        return lambda x, p: fn(x, attn, p["wo"], p["bo"], p["ln_w"],
                               p["ln_b"], p["w1"], p["b1"], p["w2"],
                               p["b2"], EPS)

    def ln_mlp(fn):
        return lambda x, p: fn(x, p["ln_w"], p["ln_b"], p["w1"], p["b1"],
                               p["w2"], p["b2"], EPS)

    return {
        "ln_qkv_fused": (ln_qkv(fb.fused_ln_qkv), fb.fused_ln_qkv),
        "ln_qkv_plain": (ln_qkv(fb.fused_ln_qkv_plain), None),
        "proj_ln_mlp_fused": (proj_ln_mlp(fb.fused_proj_ln_mlp),
                              fb.fused_proj_ln_mlp),
        "proj_ln_mlp_plain": (proj_ln_mlp(fb.fused_proj_ln_mlp_plain), None),
        "ln_mlp_fused": (ln_mlp(fb.fused_ln_mlp), fb.fused_ln_mlp),
        "ln_mlp_plain": (ln_mlp(fb.fused_ln_mlp_plain), None),
    }


def run(device, n: int = N, iters: int = 10, seed: int = 0) -> list[dict]:
    """One row per case (see the module docstring)."""
    x, attn, p = make_inputs(n, C, F, device, seed)
    rows, outs = [], {}
    for name, (fn, wrapper) in cases(attn).items():
        before = wrapper.launches if wrapper is not None else 0
        stats, outs[name] = timeit(fn, x, p, iters=iters)
        row = {"op": name, "ms": stats["ms"],
               "launches": (wrapper.launches - before
                            if wrapper is not None else 0)}
        rows.append(row)
    for row in rows:
        if row["op"].endswith("_fused"):
            got = outs[row["op"]].float()
            want = outs[row["op"].replace("_fused", "_plain")].float()
            row["vs_plain"] = float((got - want).abs().max()
                                    / want.abs().max())
    return rows


def main(argv=None) -> list[dict]:
    ap = argparse.ArgumentParser(description=__doc__)
    ap.add_argument("--device", default="cuda")
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--tokens", type=int, default=N,
                    help="rows N (the bs-8 ViT-L grid: 32768)")
    args = ap.parse_args(argv)
    device = device_of(args.device, "fused_piece_bench")
    print(card_line(device), flush=True)
    rows = run(device, args.tokens, seed=args.seed)
    for row in rows:
        print(json.dumps(row), flush=True)
    return rows


if __name__ == "__main__":
    main()
