"""Microbenchmark of the SAM encoder kernels and the pipeline's stages
(scripts/kernel_bench.py of the JAX package, flag for flag and op for op).

    python -m flmm_tpu_torch.kernel_bench [--bs 8] \\
        [--what window,global,encoder,wb,gb,boundary,tower,decoder,heads,window_path,rtt]

Times each op at the bs-8 SAM ViT-L / SigLIP-L/384 / DeepSeek-LLM-1.3B
geometry on random weights from a seeded generator and prints one JSON line
per measurement: ``op``, ``variant``, ``ms`` (the mean), ``ms_min``,
``ms_max``, ``iters``, ``device``, and ``ms_per_layer``, ``depth``, ``bs``,
``corr``, ``max_abs_diff``, ``scale`` and ``max_err_vs_v1`` where the JAX
script prints them.  The first line is the card's name and power limit.

Every call is timed on its own with CUDA events on the current stream after
the warm-up calls (the JAX script chains calls inside one jitted graph and
fetches a checksum because its backend returns early; nothing of that
carries over).  ``rtt`` is the launch + synchronise floor of a trivial op.

``--device`` defaults to ``cuda`` and the run fails without a card;
``--device cpu`` runs the plain versions on host clocks and ``--tiny``
takes the presets' tiny configurations: both are for the CPU tests, and a
``cpu`` row is no device time.  A kernel that fails to build or launch ends
the run: no row reports an error and goes on.

``--window-variants`` (``v1,v6,v7``), ``--global-variants`` (``v3,v6``),
``--window-kernel`` (``v6``) and ``--global-kernel`` (``v6``) default as in
the JAX script; every name of the JAX package resolves, the window variants
``v9, v1, v2, v3, v4, v5, v6, v7, v8`` and the global variants ``v8, v1, v2,
v3, v4, v6, v7, v11`` (``UNPORTED`` is empty), and a name it does not have
raises before anything is timed.  The
first variant of ``window`` / ``global`` is the reference of the others'
``max_err_vs_v1``.  At SAM-1024 the preset sets ``window_block_fused``, so
every window layer of the ``encoder`` and ``heads`` ops is the whole-block
kernel K1 and the window kernel named by ``w=`` is launched 0 times, as in
the JAX script: ``w=v6`` there is a label, not a measurement of v6.
"""

from __future__ import annotations

import argparse
import dataclasses
import json
import math
import subprocess
import time

import torch

from flmm_tpu_torch.configs import deepseek_vl
from flmm_tpu_torch.convert.from_jax import from_jax
from flmm_tpu_torch.data.synthetic import synthetic_batch
from flmm_tpu_torch.models.frozen import grounding
from flmm_tpu_torch.models.llm import decoder
from flmm_tpu_torch.models.sam import image_encoder
from flmm_tpu_torch.models.vision import vit
from flmm_tpu_torch.ops import boundary
from flmm_tpu_torch.ops import sam_flash_experiments as sfx
from flmm_tpu_torch.ops._matmul import matmul_f32

WARMUP = 2  # untimed calls before each measurement
OPS = ("window", "global", "encoder", "wb", "gb", "boundary", "tower",
       "decoder", "window_path", "heads", "rtt")
# variant name -> wrapper, per kernel contract; a name of the JAX package
# with no Hopper kernel would be listed in UNPORTED to fail by name (none is)
KERNELS = {
    "sam_window_attention": image_encoder.WINDOW_KERNELS,
    "sam_global_attention": image_encoder.GLOBAL_KERNELS,
}
UNPORTED = {
    "sam_window_attention": (),
    "sam_global_attention": (),
}


@dataclasses.dataclass(frozen=True)
class Geometry:
    """The sizes the ops run at: ``full()`` is the JAX script's."""
    cfg: grounding.GroundingConfig
    window_side: int      # window: side of a window
    window_grid: int      # window, window_path: the token grid's side
    global_side: int      # global: side of the global grid
    seq_len: int          # decoder (raw prompt layout) and heads
    aligned: tuple        # decoder: (S, img_start) of the 128-aligned layout
    masks: int = 8
    text_tokens: int = 12

    @property
    def sam(self) -> image_encoder.SamEncoderConfig:
        return self.cfg.sam.encoder


def full() -> Geometry:
    return Geometry(deepseek_vl.deepseek_vl_1_3b(), 14, 64, 64, 672,
                    (768, 128))


def tiny() -> Geometry:
    """The tiny preset's widths (f32), for runs on the CPU."""
    return Geometry(deepseek_vl.tiny(), 2, 7, 8, 96, (256, 128), masks=2,
                    text_tokens=3)


def kernel_fn(stem: str, name: str):
    """Resolve a kernel variant of ``stem`` (``sam_window_attention`` or
    ``sam_global_attention``) to its wrapper."""
    if name in KERNELS[stem]:
        return KERNELS[stem][name]
    if name in UNPORTED[stem]:
        raise NotImplementedError(
            f"{stem} {name} has no Hopper kernel yet: it is queued in "
            "ROADMAP.md (queue 2, K12)")
    raise ValueError(
        f"{stem} has no variant {name!r} with the (q, k, v, rel_pos_h, "
        f"rel_pos_w, side) contract; ported: {sorted(KERNELS[stem])} (the "
        "spatial window attention v10 is timed by --what window_path)")


def device_of(name: str, who: str = "kernel_bench") -> torch.device:
    if name == "cuda" and not torch.cuda.is_available():
        raise SystemExit(f"{who}: no CUDA device; this benchmark needs "
                         "a GPU (--device cpu runs the plain versions)")
    return torch.device(name)


def card_line(device: torch.device) -> str:
    """The card's name and power limit as nvidia-smi gives them."""
    if device.type != "cuda":
        return "cpu (no card: plain versions, host-clock times)"
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True, check=True)
    return smi.stdout.strip().splitlines()[0]


def timeit(fn, *args, iters: int = 10, warmup: int = WARMUP):
    """Time ``fn(*args)``: ``warmup`` calls, then ``iters`` calls each
    between two CUDA events on the current stream, one synchronise at the
    end.  Returns ``({"ms", "ms_min", "ms_max", "iters", "device"}, out)``
    with the last call's result.  CPU tensors are timed on the host clock
    and the row says so."""
    tensors = [a for a in args if isinstance(a, torch.Tensor)]
    on_card = bool(tensors) and tensors[0].is_cuda
    with torch.no_grad():
        for _ in range(warmup):
            out = fn(*args)
        if on_card:
            events = [(torch.cuda.Event(enable_timing=True),
                       torch.cuda.Event(enable_timing=True))
                      for _ in range(iters)]
            torch.cuda.synchronize()
            for start, end in events:
                start.record()
                out = fn(*args)
                end.record()
            torch.cuda.synchronize()
            times = [start.elapsed_time(end) for start, end in events]
        else:
            times = []
            for _ in range(iters):
                t0 = time.perf_counter()
                out = fn(*args)
                times.append((time.perf_counter() - t0) * 1e3)
    stats = {"ms": round(sum(times) / len(times), 4),
             "ms_min": round(min(times), 4), "ms_max": round(max(times), 4),
             "iters": iters,
             "device": (torch.cuda.get_device_name(tensors[0].device)
                        if on_card else "cpu")}
    return stats, out


def _randn(g, shape, device, dtype, scale=1.0):
    return (torch.randn(shape, generator=g, device=device) * scale).to(dtype)


def _agreement(op: str, a: torch.Tensor, b: torch.Tensor) -> dict:
    a, b = a.float().flatten(), b.float().flatten()
    corr = torch.corrcoef(torch.stack([a, b]))[0, 1].item()
    return {"op": op, "variant": "agreement", "corr": round(corr, 6),
            "max_abs_diff": (a - b).abs().max().item(),
            "scale": a.std().item()}


def _attention_variants(op, stem, variants, q, k, v, rh, rw, side, iters):
    rows, ref = [], None
    for name in variants:
        fn = kernel_fn(stem, name)
        stats, out = timeit(fn, q, k, v, rh, rw, side, iters=iters)
        ref = out.float() if ref is None else ref
        rows.append({"op": op, "variant": name, **stats,
                     "max_err_vs_v1": (out.float() - ref).abs().max().item()})
    return rows


def bench_window(bs, device, g, iters=10, variants=("v1", "v6", "v7"),
                 geo=None):
    """Window attention variants over the window-heads of ``bs`` images."""
    geo = geo or full()
    side, hd, nh = geo.window_side, geo.sam.head_dim, geo.sam.num_heads
    G = bs * (-(-geo.window_grid // side)) ** 2 * nh
    q, k, v = (_randn(g, (G, side * side, hd), device, geo.sam.dtype)
               for _ in range(3))
    rh, rw = (_randn(g, (2 * side - 1, hd), device, geo.sam.dtype, 0.02)
              for _ in range(2))
    return _attention_variants("window", "sam_window_attention", variants, q,
                               k, v, rh, rw, side, iters)


def bench_global(bs, device, g, iters=5, variants=("v3", "v6"), geo=None):
    """Global attention variants over the image-heads of ``bs`` images."""
    geo = geo or full()
    side, hd, nh = geo.global_side, geo.sam.head_dim, geo.sam.num_heads
    q, k, v = (_randn(g, (bs * nh, side * side, hd), device, geo.sam.dtype)
               for _ in range(3))
    rh, rw = (_randn(g, (2 * side - 1, hd), device, geo.sam.dtype, 0.02)
              for _ in range(2))
    return _attention_variants("global", "sam_global_attention", variants, q,
                               k, v, rh, rw, side, iters)


def _encoder_run(cfg, bs, device, g, iters, pixel_scale=1.0):
    params = image_encoder.init_params(cfg, g, device)
    pixels = _randn(g, (bs, cfg.img_size, cfg.img_size, 3), device, cfg.dtype,
                    pixel_scale)
    return timeit(lambda px: image_encoder.forward(params, cfg, px), pixels,
                  iters=iters)


def bench_encoder(bs, device, g, iters=5, window_kernel="v6",
                  global_kernel="v6", geo=None):
    """The whole SAM encoder with the given kernel variants."""
    geo = geo or full()
    kernel_fn("sam_window_attention", window_kernel)
    kernel_fn("sam_global_attention", global_kernel)
    cfg = dataclasses.replace(geo.sam, window_kernel=window_kernel,
                              global_kernel=global_kernel)
    stats, _ = _encoder_run(cfg, bs, device, g, iters)
    return [{"op": "encoder",
             "variant": f"w={window_kernel},g={global_kernel}", **stats}]


def _two_paths(op, bs, device, g, iters, depth, variants, extra):
    """Time two settings of a depth-limited encoder on the same weights and
    pixels (the generator is re-seeded per variant) and add their
    agreement."""
    rows, outs = [], []
    state = g.get_state()
    for name, cfg in variants:
        g.set_state(state)
        stats, out = _encoder_run(cfg, bs, device, g, iters, pixel_scale=0.5)
        outs.append(out)
        rows.append({"op": op, "variant": name, "depth": depth, **extra,
                     **stats, "ms_per_layer": round(stats["ms"] / depth, 4)})
    rows.append(_agreement(op, *outs))
    return rows


def bench_wb(bs, device, g, iters=5, depth=12, geo=None):
    """Window-only depth-limited SAM encoder: the split flash path (K3 +
    K6 + K4) against the whole-block window path (K1).  Per-layer in-situ
    cost = ms / depth; the last row is the two paths' agreement."""
    geo = geo or full()
    variants = [(name, dataclasses.replace(
        geo.sam, depth=depth, global_attn_indexes=(),
        window_block_fused=fused))
        for name, fused in (("flash", False), ("whole_block", True))]
    return _two_paths("wb", bs, device, g, iters, depth, variants, {})


def bench_gb(bs, device, g, iters=5, depth=4, geo=None):
    """Global-only depth-limited SAM encoder: the split global blocks (K3 +
    K2 + K4, the JAX script's ``dense`` setting) against the whole-block
    global path (K10 + K8), which needs both fused flags."""
    geo = geo or full()
    variants = [(name, dataclasses.replace(
        geo.sam, depth=depth, global_attn_indexes=tuple(range(depth)),
        window_block_fused=fused, global_block_fused=fused))
        for name, fused in (("dense", False), ("whole_block", True))]
    return _two_paths("gb", bs, device, g, iters, depth, variants,
                      {"bs": bs})


def bench_boundary(bs, device, g, iters=20, geo=None):
    """One windowize + dewindowize round trip at the encoder's geometry (the
    relayout around every global layer): the plain pair against the K11
    pair; the round trip preserves the values, so the diff must be 0."""
    geo = geo or full()
    C, ws, side = geo.sam.embed_dim, geo.sam.window_size, geo.sam.grid
    x = _randn(g, (bs, side, side, C), device, geo.sam.dtype)

    def pair_plain(x):
        xw, geom = boundary.windowize_plain(x, ws)
        return boundary.dewindowize_plain(xw, geom, ws).contiguous()

    def pair(x):
        xw, geom = boundary.windowize(x, ws)
        return boundary.dewindowize(xw, geom, ws)

    plain_stats, a = timeit(pair_plain, x, iters=iters)
    stats, b = timeit(pair, x, iters=iters)
    return [{"op": "boundary", "variant": "plain dewin+win pair", "bs": bs,
             **plain_stats},
            {"op": "boundary", "variant": "kernel dewin+win pair", "bs": bs,
             **stats,
             "max_abs_diff": (a.float() - b.float()).abs().max().item()}]


def bench_tower(bs, device, g, iters=5, geo=None):
    """The vision tower's total time, and its attention sub-graph alone at
    the tower's geometry, also padded to a 128-multiple sequence."""
    geo = geo or full()
    cfg = geo.cfg.vision
    params = vit.init_params(cfg, g, device)
    pixels = _randn(g, (bs, cfg.image_size, cfg.image_size, 3), device,
                    cfg.dtype)
    stats, _ = timeit(lambda px: vit.forward(params, cfg, px), pixels,
                      iters=iters)
    rows = [{"op": "tower", "variant": "total", **stats}]

    S, nh, hd = cfg.seq_len, cfg.num_heads, cfg.head_dim
    q, k, v = (_randn(g, (bs, nh, S, hd), device, cfg.dtype)
               for _ in range(3))

    def attn(q, k, v):
        s = matmul_f32(q, k.transpose(-1, -2)) / math.sqrt(hd)
        return torch.softmax(s, dim=-1).to(v.dtype) @ v

    stats, _ = timeit(attn, q, k, v, iters=iters)
    rows.append({"op": "tower_attn", "variant": "plain", **stats})
    pad = (0, 0, 0, -S % 128)
    stats, _ = timeit(attn, *(torch.nn.functional.pad(t, pad)
                              for t in (q, k, v)), iters=iters)
    rows.append({"op": "tower_attn", "variant": "pad128", **stats})
    return rows


def bench_decoder(bs, device, g, iters=5, geo=None):
    """The frozen decoder with capture-merge: the eager capture at the raw
    prompt layout and at the 128-aligned layout, and the flash-capture
    kernel (K5) at the aligned layout."""
    geo = geo or full()
    cfg, M = geo.cfg.llm, geo.masks
    params = decoder.init_params(cfg, g, device)
    rows = []
    S_al, start_al = geo.aligned
    for flash, S, img_start, label in (
            (False, geo.seq_len, geo.cfg.img_start,
             f"eager S={geo.seq_len}"),
            (False, S_al, start_al, f"eager S={S_al} aligned"),
            (True, S_al, start_al, f"flash S={S_al} aligned")):
        c = dataclasses.replace(cfg, use_flash_capture=flash)
        h = _randn(g, (bs, S, c.hidden_size), device, c.dtype)
        mask = torch.ones((bs, S), dtype=torch.bool, device=device)
        pos = torch.arange(S, device=device).expand(bs, S)
        merge = torch.nn.functional.one_hot(
            torch.arange(S, device=device) % M, M).float() / (S / M)
        merge = merge.expand(bs, S, M)

        def fn(h, c=c, mask=mask, pos=pos, merge=merge, img_start=img_start):
            return decoder.forward_capture(
                params, c, h, mask, img_start=img_start,
                n_img=geo.cfg.num_img_tokens, merge_matrix=merge,
                merge="mean", position_ids=pos)["attn"]

        stats, _ = timeit(fn, h, iters=iters)
        rows.append({"op": "decoder", "variant": label, **stats})
    return rows


def bench_window_path(bs, device, g, iters=10, geo=None):
    """The window-attention sub-path from the ``(B, H, W, 3C)`` qkv tensor:
    pad + window partition + K6 over strided views (the encoder's
    ``_flash_window_core``) against the spatial kernel K12 v10 on the
    head-major permuted qkv."""
    geo = geo or full()
    grid_hw, side = geo.window_grid, geo.window_side
    nh, hd = geo.sam.num_heads, geo.sam.head_dim
    C, dtype = nh * hd, geo.sam.dtype
    cfg = dataclasses.replace(geo.sam, window_size=side)
    qkv = _randn(g, (bs, grid_hw, grid_hw, 3 * C), device, dtype, 0.3)
    bp = {"rel_pos_h": _randn(g, (2 * side - 1, hd), device, dtype, 0.02),
          "rel_pos_w": _randn(g, (2 * side - 1, hd), device, dtype, 0.02),
          "bqkv": torch.zeros((3 * C,), dtype=dtype, device=device)}
    perm = sfx.qkv_head_major_perm(nh, hd, device)
    pad = -grid_hw % side

    def v9_path(qkv):
        return image_encoder._flash_window_core(qkv, bp, cfg).contiguous()

    def v10_path(qkv):
        # the head-major relayout rides the pad; in an encoder the wqkv
        # columns would be permuted instead, making it free
        qkvp = torch.nn.functional.pad(qkv[..., perm],
                                       (0, 0, 0, pad, 0, pad))
        out = sfx.sam_window_attention_v10(qkvp, bp["rel_pos_h"],
                                           bp["rel_pos_w"], side, grid_hw)
        return out[:, :grid_hw, :grid_hw].contiguous()

    rows = []
    for name, fn in (("v9_path", v9_path), ("v10_path", v10_path)):
        stats, _ = timeit(fn, qkv, iters=iters)
        rows.append({"op": "window_path", "variant": name, **stats})
    return rows


def bench_heads(bs, device, g, iters=5, window_kernel="v6",
                global_kernel="v6", geo=None):
    """U-Net + SAM refiner heads at bench geometry (``heads_forward``:
    coarse maps -> U-Net -> SAM encoder -> prompt encoder + mask decoder),
    the encoder with the given kernel variants."""
    geo = geo or full()
    kernel_fn("sam_window_attention", window_kernel)
    kernel_fn("sam_global_attention", global_kernel)
    cfg, M = geo.cfg, geo.masks
    cfg = dataclasses.replace(cfg, sam=dataclasses.replace(
        cfg.sam, encoder=dataclasses.replace(
            cfg.sam.encoder, window_kernel=window_kernel,
            global_kernel=global_kernel)))
    params = grounding.init_params(cfg, g, device)
    for unused in ("llm", "vision", "projector"):
        params["frozen"].pop(unused)
    batch = from_jax(synthetic_batch(
        cfg, batch_size=bs, seq_len=geo.seq_len, max_masks=M,
        text_tokens_per_mask=geo.text_tokens), device)
    c = cfg.clip_shape
    maps = _randn(g, (bs * M, c, c, cfg.unet.in_channels), device,
                  torch.float32, 0.1)
    hidden = _randn(g, (bs, geo.seq_len, cfg.llm.hidden_size), device,
                    torch.float32)
    stats, _ = timeit(
        lambda maps: grounding.heads_forward(params, cfg, maps, hidden,
                                             batch)["sam_logits"],
        maps, iters=iters)
    return [{"op": "heads", "variant": "unet+sam", **stats}]


def bench_rtt(device, iters=10):
    """The launch + synchronise floor: a trivial op timed the same way."""
    x = torch.ones((8, 8), device=device)
    stats, _ = timeit(lambda x: x * 2.0, x, iters=iters)
    return [{"op": "rtt_floor", **stats}]


def run(what, bs, device, g, *, depth=12, iters=None,
        window_variants=("v1", "v6", "v7"), global_variants=("v3", "v6"),
        window_kernel="v6", global_kernel="v6", geo=None, emit=None) -> list:
    """Run the ops named in ``what`` in the JAX script's order; ``emit`` is
    called with each op's rows as they are ready."""
    unknown = sorted(set(what) - set(OPS))
    if unknown:
        raise ValueError(f"unknown ops {unknown}; choose from {OPS}")
    for name in window_variants:
        kernel_fn("sam_window_attention", name)
    for name in global_variants:
        kernel_fn("sam_global_attention", name)
    kernel_fn("sam_window_attention", window_kernel)
    kernel_fn("sam_global_attention", global_kernel)
    it = {} if iters is None else {"iters": iters}
    calls = {
        "window": lambda: bench_window(bs, device, g, variants=window_variants,
                                       geo=geo, **it),
        "global": lambda: bench_global(bs, device, g, variants=global_variants,
                                       geo=geo, **it),
        "encoder": lambda: bench_encoder(
            bs, device, g, window_kernel=window_kernel,
            global_kernel=global_kernel, geo=geo, **it),
        "wb": lambda: bench_wb(bs, device, g, depth=depth, geo=geo, **it),
        "gb": lambda: bench_gb(bs, device, g, depth=min(depth, 6), geo=geo,
                               **it),
        "boundary": lambda: bench_boundary(bs, device, g, geo=geo, **it),
        "tower": lambda: bench_tower(bs, device, g, geo=geo, **it),
        "decoder": lambda: bench_decoder(bs, device, g, geo=geo, **it),
        "window_path": lambda: bench_window_path(bs, device, g, geo=geo,
                                                 **it),
        "heads": lambda: bench_heads(
            bs, device, g, window_kernel=window_kernel,
            global_kernel=global_kernel, geo=geo, **it),
        "rtt": lambda: bench_rtt(device, **it),
    }
    rows = []
    for op in OPS:
        if op in what:
            new = calls[op]()
            if emit is not None:
                emit(op, new)
            rows += new
            if device.type == "cuda":
                torch.cuda.empty_cache()
    return rows


def print_rows(op: str, rows: list) -> None:
    for row in rows:
        print(json.dumps(row), flush=True)


def main(argv=None) -> list:
    ap = argparse.ArgumentParser(
        description=__doc__.split("\n\n")[0],
        formatter_class=argparse.ArgumentDefaultsHelpFormatter)
    ap.add_argument("--what", default="window,global",
                    help="comma list of ops: " + ",".join(OPS))
    ap.add_argument("--bs", type=int, default=8, help="images per call")
    ap.add_argument("--depth", type=int, default=12,
                    help="layers of the wb encoder (gb: at most 6)")
    ap.add_argument("--window-variants", default="v1,v6,v7",
                    help="window attention variants the window op times")
    ap.add_argument("--global-variants", default="v3,v6",
                    help="global attention variants the global op times")
    ap.add_argument("--window-kernel", default="v6",
                    help="window kernel of the encoder and heads ops")
    ap.add_argument("--global-kernel", default="v6",
                    help="global kernel of the encoder and heads ops")
    ap.add_argument("--device", default="cuda", choices=("cuda", "cpu"),
                    help="cpu runs the plain versions on host clocks")
    ap.add_argument("--seed", type=int, default=0, help="weights and inputs")
    ap.add_argument("--iters", type=int, default=None,
                    help="timed calls per measurement; unset: per op as the "
                    "JAX script (5, 10 or 20)")
    ap.add_argument("--tiny", action="store_true",
                    help="the presets' tiny configurations, for the CPU "
                    "tests: their rows are not measurements")
    args = ap.parse_args(argv)
    device = device_of(args.device)
    g = torch.Generator(device=device).manual_seed(args.seed)
    if device.type == "cuda":
        # full f32 products and convolutions in the plain versions
        torch.backends.cuda.matmul.allow_tf32 = False
        torch.backends.cudnn.allow_tf32 = False
    print(card_line(device), flush=True)
    return run(
        args.what.split(","), args.bs, device, g, depth=args.depth, iters=args.iters,
        window_variants=tuple(args.window_variants.split(",")),
        global_variants=tuple(args.global_variants.split(",")),
        window_kernel=args.window_kernel, global_kernel=args.global_kernel,
        geo=tiny() if args.tiny else None,
        emit=print_rows)


if __name__ == "__main__":
    main()
