"""Where the time goes in one forward or training step of the PyTorch port
on one GPU.

    python3 scripts/torch_profile.py                  # DeepSeek-VL-1.3B, bs 4
    python3 scripts/torch_profile.py --path llava_next  # LLaVA-NeXT, bs 2
    python3 scripts/torch_profile.py --path train     # DeepSeek-VL training
                                                      # at SAM-448, bs 8
    python3 scripts/torch_profile.py --path hpt       # HPT-Air-1.5, bs 4
    python3 scripts/torch_profile.py --path schedule --sam-size 768
                                  # one point of the SAM size sweep, bs 4
                                  # (1024: bench_torch.py's default point)
    python3 scripts/torch_profile.py --path bench --family llava
                                  # one point of the family matrix, bs 4: the
                                  # BENCH_* environment of flmm_tpu_torch.bench
                                  # (BENCH_PRESET=air --family hpt: HPT-Air)
    python3 scripts/torch_profile.py --path eval  # one batch of chip_smoke's
                                  # eval loop, bs 8, and its host side

Builds the full-width model from a seed (as chip_smoke.py does), then for
the kernel path and the all-plain path prints the device time by kernel
from torch.profiler over one forward (or step), the device's busy and idle
time, and the program's spans (flmm_tpu_torch/trace.py): the device's idle
and the kernel launches of that profiled forward or step put down to the
innermost span open on the host, and each span's device ms (CUDA events)
and host ms and the heads' counters from one more forward or step with the
tracer on and the profiler off (the profiler's cost a launch would swell
the launch-bound spans' times); the spans are the vision
tower, the LLM capture, LLaVA-NeXT's frame assembly, the SAM encoder, the
U-Net, the refiner's loop and the whole forward, and for training the step,
its backward and its optimizer update.  For DeepSeek-VL serving
it (and ``--path bench`` at bench.py's default point) then times the three
stages of K1 (window block) separately at the SAM-1024 window shape and K2's
kernel beside its wrapper, for HPT the three stages of K10 (the attention
half of a global block) at the SAM-1024 global-layer shape.  For the eval
loop it first splits the batch builder's host time by step over chip_smoke.py
phase 22's samples and times the batch's copy to the card from pageable and
from pinned memory.
"""

from __future__ import annotations

import argparse
import dataclasses
import pathlib
import sys
import time

import torch
from torch.profiler import ProfilerActivity, profile

sys.path.insert(0, str(pathlib.Path(__file__).resolve().parent.parent))

import chip_smoke  # noqa: E402
from flmm_tpu_torch import bench, registry, trace  # noqa: E402
from flmm_tpu_torch.configs import deepseek_vl, llava_next  # noqa: E402
from flmm_tpu_torch.convert.from_jax import from_jax  # noqa: E402
from flmm_tpu_torch.data import collate, processors  # noqa: E402
from flmm_tpu_torch.data.synthetic import synthetic_batch, \
    synthetic_samples  # noqa: E402
from flmm_tpu_torch.models.frozen import grounding  # noqa: E402
from flmm_tpu_torch.models.frozen import llava_next as llava_next_model  # noqa: E402
from flmm_tpu_torch.models.sam import image_encoder  # noqa: E402
from flmm_tpu_torch.ops import fused_block, global_block, sam_flash, \
    window_block  # noqa: E402
from flmm_tpu_torch.train import loop  # noqa: E402


def deepseek_setup(g: torch.Generator):
    cfg = deepseek_vl.deepseek_vl_1_3b()
    params = grounding.init_params(cfg, g, "cuda")
    params["frozen"]["llm"].pop("lm_head")
    batch = from_jax(synthetic_batch(
        cfg, batch_size=chip_smoke.BS, seq_len=chip_smoke.SEQ,
        max_masks=chip_smoke.MASKS,
        text_tokens_per_mask=chip_smoke.TEXT, seed=1), "cuda")

    def forward(c):
        return grounding.forward(params, c, batch)
    return cfg, forward


def llava_next_setup(g: torch.Generator):
    cfg = llava_next.llava_next_vicuna_7b(img_start=chip_smoke.ANYRES_IMG_START)
    params = llava_next_model.init_params(cfg, g, "cuda")
    params["frozen"]["llm"].pop("lm_head")
    chip_smoke.randomize_rel_pos(params, g)
    batch = chip_smoke.anyres_batches(cfg, "cuda")[1]

    def forward(c):
        return llava_next_model.forward(params, c, batch)
    return cfg, forward


def hpt_setup(g: torch.Generator):
    cfg = chip_smoke.hpt_config()
    params = grounding.init_params(cfg, g, "cuda")
    params["frozen"]["llm"].pop("lm_head")
    chip_smoke.randomize_rel_pos(params, g)
    batch = chip_smoke.hpt_batches(cfg, 2, "cuda")[1]

    def forward(c):
        return grounding.forward(params, c, batch)
    return cfg, forward


def schedule_setup(sam_size: int):
    """One point of the size sweep: the model, weights and batch of
    ``flmm_tpu_torch.bench.build`` at ``sam_size``, bs 4."""
    _, cfg, params, batch = bench.build(
        chip_smoke.BS, bench.Knobs(sam_size=sam_size), "cuda")

    def forward(c):
        return grounding.forward(params, c, batch)
    return cfg, forward


def bench_setup(knobs: bench.Knobs):
    """One point of ``flmm_tpu_torch.bench`` for a family with a contiguous
    image block: the model, weights and batch of ``bench.build`` at bs 4."""
    model, cfg, params, batch = bench.build(chip_smoke.BS, knobs, "cuda")
    if hasattr(cfg, "base"):
        raise SystemExit("--path bench: llava_next has --path llava_next")

    def forward(c):
        return model.forward(params, c, batch)
    return cfg, forward


def eval_setup(g: torch.Generator):
    """One batch of chip_smoke.py phase 22 (DeepSeek-VL-1.3B, SAM-1024, bs
    8 at the 640 bucket); first the batch builder's host time split by step
    over the phase's 32 samples (host clock, ms a batch of 8) and the
    batch's copy to the card from pageable and from pinned memory (CUDA
    events)."""
    cfg = deepseek_vl.deepseek_vl_1_3b()
    bs = chip_smoke.EVAL_BS
    samples = synthetic_samples(
        cfg, n=chip_smoke.EVAL_N, seed=chip_smoke.EVAL_SEED,
        max_masks=chip_smoke.EVAL_MASKS,
        caption_tokens=chip_smoke.EVAL_CAPTION)
    spec = dataclasses.replace(chip_smoke.eval_spec(cfg), seq_len=640)
    steps = {
        "sam_preprocess (bilinear to 1024)": lambda s: processors.
        sam_preprocess(s["image"], spec.sam_size),
        "square_pad_preprocess (bicubic to 384)": lambda s: processors.
        square_pad_preprocess(s["image"], spec.processor),
    }
    for name, fn in steps.items():
        t0 = time.perf_counter()
        for s in samples:
            fn(s)
        ms = (time.perf_counter() - t0) * 1e3 * bs / len(samples)
        print(f"eval host {name}: {ms:.1f} ms a batch of {bs}")
    t0 = time.perf_counter()
    for i in range(0, len(samples), bs):
        batch = collate.build_batch(samples[i:i + bs], spec)
    ms = (time.perf_counter() - t0) * 1e3 * bs / len(samples)
    print(f"eval host build_batch in all: {ms:.1f} ms a batch of {bs}")
    batch.pop("infos")
    print(f"eval copy, pageable: "
          f"{chip_smoke.cuda_ms(lambda: from_jax(batch, 'cuda'), 3):.1f} ms")
    pinned = {k: from_jax(v) for k, v in batch.items()}
    pinned = {k: ({n: t.pin_memory() for n, t in v.items()}
                  if isinstance(v, dict) else v.pin_memory())
              for k, v in pinned.items()}

    def copy_pinned():
        return {k: ({n: t.to("cuda", non_blocking=True) for n, t in v.items()}
                    if isinstance(v, dict)
                    else v.to("cuda", non_blocking=True))
                for k, v in pinned.items()}

    print(f"eval copy, pinned: {chip_smoke.cuda_ms(copy_pinned, 3):.1f} ms")
    params = grounding.init_params(cfg, g, "cuda")
    params["frozen"]["llm"].pop("lm_head")
    batch = from_jax(batch, "cuda")

    def forward(c):
        return grounding.forward(params, c, batch)
    return cfg, forward


def profiled(run) -> tuple:
    """``run()`` under ``torch.profiler`` with the tracer on, then once
    more with the tracer on and the profiler off: the profile, and the
    second run's spans and counters."""
    with trace.tracing(), profile(activities=[ProfilerActivity.CPU,
                                              ProfilerActivity.CUDA]) as prof:
        run()
        torch.cuda.synchronize()
    trace.collect()
    with trace.tracing():
        run()
        torch.cuda.synchronize()
    return prof, trace.collect()


def report(name: str, what: str, prof, got: dict, rows: int) -> None:
    """The device time by kernel, the busy share and the spans: device and
    host ms (``got``, unprofiled), idle and launches begun in each as the
    innermost span (``prof``)."""
    print(f"== {name} path: device time by kernel, {what}")
    print(prof.key_averages().table(sort_by="cuda_time_total",
                                    row_limit=rows,
                                    max_name_column_width=70))
    parts = trace.profile_breakdown(prof.events())
    busy, window = parts["busy_s"] * 1e3, parts["window_s"] * 1e3
    print(f"{name} device busy {busy:.3f} ms of a {window:.3f} ms "
          f"device window ({1 - busy / window:.1%} idle)")
    spans = {}
    for rec in got["spans"]:
        calls, dev, host = spans.get(rec["name"], (0, 0.0, 0.0))
        spans[rec["name"]] = (calls + 1, dev + rec["device_ms"],
                              host + rec["host_ms"])
    for span, (calls, dev, host) in spans.items():
        print(f"{name} span {span}: {dev:.3f} ms device, {host:.3f} ms "
              f"host, {calls} call(s); idle begun in it "
              f"{parts['idle_s'].get(span, 0.0) * 1e3:.3f} ms, "
              f"{parts['launches'].get(span, 0)} launches")
    print(f"{name} outside any span: idle "
          f"{parts['idle_s'].get(trace.OUTSIDE, 0.0) * 1e3:.3f} ms, "
          f"{parts['launches'].get(trace.OUTSIDE, 0)} launches")
    counters = {c["name"]: c["value"] for c in got["counters"]}
    if counters:
        print(f"{name} counters {counters}")


def profile_paths(cfg, forward) -> None:
    for name, c in (("kernel", cfg), ("plain", registry.plain_config(cfg))):
        with torch.no_grad():
            forward(c)
            torch.cuda.synchronize()
            prof, got = profiled(lambda: forward(c))
        report(name, "one forward", prof, got, 25)


def profile_window_block(g: torch.Generator) -> None:
    C, F, hd, ws, nh = 1024, 4096, 64, 14, 16
    xw, geom = image_encoder._windowize(
        chip_smoke._randn(g, (chip_smoke.BS, 64, 64, C)), ws)
    xw = xw.contiguous()
    NW, T = xw.shape[:2]
    valid = image_encoder._window_valid_tokens(geom, ws, xw.device)

    def r(*shape):
        return chip_smoke._randn(g, shape, 0.03)

    lw, lb, w_s, b_s = r(C), r(C), r(C, 3 * C), r(3 * C)
    wo, bo, w1, b1, w2, b2 = r(C, C), r(C), r(C, F), r(F), r(F, C), r(C)
    xf = xw.reshape(NW * T, C)
    qkv = torch.empty((NW * T, 3 * C), dtype=xw.dtype, device=xw.device)
    attn = torch.empty_like(xf)
    out = torch.empty_like(xf)
    bias = r(NW, nh, T, 2 * ws)
    rph, rpw = r(2 * ws - 1, hd), r(2 * ws - 1, hd)
    parts = {
        "qkv ln_gemm": lambda: fused_block.ln_gemm(
            xf, lw, lb, 1e-6, valid.reshape(-1), w_s, b_s, qkv),
        "window attention": lambda: sam_flash.relpos_attention_sm90(
            qkv, (T * 3 * C, hd, 3 * C), qkv[:, C:], qkv[:, 2 * C:],
            (T * 3 * C, hd, 3 * C), nh, ws, NW * nh, T, attn,
            (T * C, hd, C), bias=bias),
        "block_tail": lambda: fused_block.block_tail(
            xf, attn, wo, bo, lw, lb, 1e-6, w1, b1, w2, b2, "gelu", out),
        "rel-pos bias rows (plain)": lambda: window_block.window_rel_bias_from_x(
            xw, valid, lw, lb, w_s[:, :C], b_s[:C], rph, rpw, ws, nh, hd),
    }
    for part, fn in parts.items():
        print(f"K1 {part} (NW={NW}): {chip_smoke.cuda_ms(fn):.3f} ms")
    print(f"K1 whole wrapper (NW={NW}): " + str(chip_smoke.cuda_ms(
        lambda: window_block.window_block(
            xw, bias, valid, lw, lb, w_s, b_s, wo, bo, lw, lb, w1, b1, w2, b2,
            ws, nh))) + " ms")


def profile_global_attention(g: torch.Generator) -> None:
    """K2 at the bs-4 SAM-1024 global layer: the wrapper, and the kernel
    alone on the same tables."""
    hd, side, G = 64, 64, 16 * chip_smoke.BS
    S = side * side
    q, k, v = (chip_smoke._randn(g, (G, S, hd)) for _ in range(3))
    rph, rpw = (chip_smoke._randn(g, (2 * side - 1, hd), 0.1)
                for _ in range(2))
    out = torch.empty_like(q)
    strides = (S * hd, 0, hd)
    parts = {
        "whole wrapper": lambda: sam_flash.sam_global_attention_v8(
            q, k, v, rph, rpw, side),
        "kernel alone": lambda: sam_flash.relpos_attention_sm90(
            q, strides, k, v, strides, 1, side, G, S, out, strides,
            tables=(rph, rpw), alpha=sam_flash.LOG2E / 8),
    }
    for part, fn in parts.items():
        print(f"K2 {part} (G={G}, S={S}): {chip_smoke.cuda_ms(fn):.3f} ms")


def profile_global_block(g: torch.Generator) -> None:
    C, hd, side, nh, B = 1024, 64, 64, 16, chip_smoke.BS
    S = side * side

    def r(*shape):
        return chip_smoke._randn(g, shape, 0.03)

    x = chip_smoke._randn(g, (B, S, C))
    lw, lb, w_s, b_s, wo, bo = r(C), r(C), r(C, 3 * C), r(3 * C), r(C, C), r(C)
    rph, rpw = r(2 * side - 1, hd), r(2 * side - 1, hd)
    xf = x.reshape(B * S, C)
    qkv = torch.empty((B * S, 3 * C), dtype=x.dtype, device=x.device)
    attn = torch.empty_like(xf)
    out = torch.empty((B * S, C), dtype=torch.float32, device=x.device)
    bias = r(B, nh, S, 2 * side)
    strides = (S * 3 * C, hd, 3 * C)
    parts = {
        "qkv ln_gemm": lambda: fused_block.ln_gemm(
            xf, lw, lb, 1e-6, None, w_s, b_s, qkv),
        "global attention": lambda: sam_flash.relpos_attention_sm90(
            qkv, strides, qkv[:, C:], qkv[:, 2 * C:], strides, nh, side,
            B * nh, S, attn, (S * C, hd, C), bias=bias),
        "out-proj + residual, f32": lambda: fused_block.gemm_residual_f32(
            attn, wo, bo, xf, out),
        "rel-pos bias rows (plain)":
            lambda: global_block.global_rel_bias_from_x(
                x, lw, lb, w_s[:, :C], b_s[:C], rph, rpw, side, nh, hd),
    }
    for part, fn in parts.items():
        print(f"K10 {part} (B={B}, S={S}): {chip_smoke.cuda_ms(fn):.3f} ms")


def profile_train(g: torch.Generator) -> None:
    """One training step of DeepSeek-VL-1.3B at SAM-448 (chip_smoke phase
    8's configuration and stream) per path, after a warm-up step: the
    profiler's device time by kernel and busy share, and the step's spans
    (the step, its forward with the frozen towers', its backward and its
    optimizer update; a third step gives their times, the profiler
    off)."""
    cfg = registry.with_sam_size(deepseek_vl.deepseek_vl_1_3b(),
                                 chip_smoke.TRAIN_SAM)
    params = grounding.init_params(cfg, g, "cuda")
    params["frozen"]["llm"].pop("lm_head")
    chip_smoke.randomize_rel_pos(params, g)
    batch = from_jax(synthetic_batch(cfg, batch_size=chip_smoke.TRAIN_BS,
                                     seed=1), "cuda")
    opt = loop.make_optimizer(loop.OptimConfig(total_steps=100))
    state = loop.init_state(params["trainable"], opt)
    for name, c in (("kernel", cfg), ("plain", registry.plain_config(cfg))):
        step = loop.make_train_step(
            lambda p, b, c=c: grounding.loss_fn(p, c, b), opt)
        step(state, params["frozen"], batch)
        torch.cuda.synchronize()
        prof, got = profiled(lambda: step(state, params["frozen"], batch))
        report(name, "one training step", prof, got, 30)


def main() -> None:
    parser = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    parser.add_argument("--path", choices=("deepseek", "llava_next", "train",
                                           "hpt", "schedule", "bench",
                                           "eval"),
                        default="deepseek")
    parser.add_argument("--sam-size", type=int, default=768,
                        help="SAM resolution of --path schedule")
    parser.add_argument("--family", default=None,
                        help="family of --path bench (default: BENCH_FAMILY)")
    args = parser.parse_args()
    print(chip_smoke.phase_card())
    g = torch.Generator(device="cuda").manual_seed(0)
    if args.path == "train":
        profile_train(g)
        return
    if args.path == "schedule":
        profile_paths(*schedule_setup(args.sam_size))
        return
    if args.path == "bench":
        knobs = dataclasses.replace(bench.Knobs.from_env(),
                                    family=args.family or None)
        knobs = dataclasses.replace(
            knobs, family=knobs.family or bench.Knobs.from_env().family)
        profile_paths(*bench_setup(knobs))
        if knobs == bench.Knobs():  # bench.py's default point
            profile_window_block(g)
            profile_global_attention(g)
        return
    setup = {"deepseek": deepseek_setup, "llava_next": llava_next_setup,
             "hpt": hpt_setup, "eval": eval_setup}[args.path]
    profile_paths(*setup(g))
    if args.path == "deepseek":
        profile_window_block(g)
        profile_global_attention(g)
    elif args.path == "hpt":
        profile_global_block(g)


if __name__ == "__main__":
    main()
