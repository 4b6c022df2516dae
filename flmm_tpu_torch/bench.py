"""End-to-end grounding throughput on one GPU (bench.py of the JAX package,
function for function).

    python -m flmm_tpu_torch.bench          # or: python bench_torch.py

Measures the full F-LMM predict path at real released-model geometry with
random weights from a seed.  Default: the flagship DeepSeek-VL-1.3B
(SigLIP-L/384 tower -> aligner -> frozen 1.3B decoder with attention capture
-> U-Net -> SAM ViT-L encoder at 1024 -> prompt / mask decoder), bs 4,
S=672.  Metric: grounded images per second, end to end, for the kernel path
and, on the same weights and inputs, for the all-plain path
(``registry.plain_config``).

Env knobs, with the JAX script's names and defaults:
  BENCH_FAMILY        deepseek_vl (default) | llava | llava_next | mgm | hpt
  BENCH_PRESET        family preset (default: the flagship per family;
                      deepseek_vl's 7b runs the hybrid SAM-B tower, mgm's
                      vicuna_7b_hd the HD crop grid with its image block
                      at 128 through the flash capture)
  BENCH_SAM_SIZE      SAM encoder resolution (default 1024; the
                      reduced-resolution deployment schedule)
  BENCH_BS            comma list of batch sizes to try (default "4,8,2,1")
  BENCH_ITERS         timed forwards (default 6)
  BENCH_SEQ           sequence length (default 672; raised to fit the image
                      block where it must)
  BENCH_GLOBAL_BLOCK  1: the whole-block global SAM layer (K10 + K8)
  BENCH_GLOBAL_KERNEL the global attention kernel of the split path: v8
                      (default), v1, v2, v3, v4, v6, v7 or v11
  BENCH_QUANT_LLM     1 raises: the int8 decoder is not ported (ROADMAP.md)
``--device`` (default ``cuda``; without a card the run exits non-zero;
``--device cpu`` runs the plain versions on host clocks, for the tests).

Timing: two warm-up forwards, then ``iters`` forwards on distinct inputs
(pixel offset ``0.001 * (i + 1)``), each between two CUDA events, one
synchronise at the end and the host clock around the whole timed loop, under
``torch.no_grad()``.  ``value`` is ``bs * iters`` over the wall seconds of
that loop: what a server pays, host gaps included.  (The JAX script chains
a checksum through its iterations because its backend returns early;
nothing of that carries over.)

Prints ONE JSON line: ``metric``, ``value``, ``unit``, ``vs_baseline``
(kernel img/s over plain img/s), ``bs``, then ``ms_mean``, ``ms_min``,
``ms_max``, ``iters``, ``peak_gb``, ``plain`` (the same keys for the plain
path), ``family``, ``preset``, ``sam_size``, ``global_kernel``, ``launches``
(per forward, every counted kernel wrapper) and ``device`` (the card's name
and power limit).  The batch-size sweep falls through on an out-of-memory
error only; any other failure ends the run.

``llava_next`` batches come from the port's synthetic anyres builder
(``data.llava_next.synthetic_anyres_batch``, images of 600 x 640 and 900 x
280 in turn); the JAX script goes through its host data pipeline
(``data/collate``), which is not ported.  ``mgm`` batches go through the
host pipeline as in the JAX script: ``synthetic_samples`` into
``build_mgm_batch`` (the crops, the aux image and SAM's input of each
sample), the sequence the longest sample + 8, to a multiple of 128 when the
decoder captures through the flash kernel.
"""

from __future__ import annotations

import argparse
import dataclasses
import json
import os
import sys
import time

import torch

from flmm_tpu_torch import registry
from flmm_tpu_torch.convert.from_jax import from_jax
from flmm_tpu_torch.data.collate import BatchSpec
from flmm_tpu_torch.data.llava_next import synthetic_anyres_batch
from flmm_tpu_torch.data.processors import ProcessorConfig
from flmm_tpu_torch.data.synthetic import synthetic_batch, synthetic_samples
from flmm_tpu_torch.kernel_bench import card_line, device_of
from flmm_tpu_torch.ops import boundary, flash_attention, fused_block, \
    global_block, sam_flash, sam_flash_experiments, window_block

FLAGSHIP = {
    "deepseek_vl": "1_3b",
    "llava": "1_5_7b",
    "llava_next": "vicuna_7b",
    "mgm": "gemma_2b",
    "hpt": "air_1_5",
}
WARMUP = 2
ANYRES_SIZES = ((600, 640), (900, 280))  # (h, w): a 2x2 and a 3x1 tile grid
REL_POS_STD = 0.05
HD_ALPHA = 0.5
# every wrapper that counts its kernel launches, by name
WRAPPERS = {
    "window_block": window_block.window_block,
    "sam_global_attention_v8": sam_flash.sam_global_attention_v8,
    "fused_ln_qkv": fused_block.fused_ln_qkv,
    "fused_proj_ln_mlp": fused_block.fused_proj_ln_mlp,
    "flash_attention_with_merged_capture":
        flash_attention.flash_attention_with_merged_capture,
    "sam_window_attention_v9": sam_flash.sam_window_attention_v9,
    "plain_flash_attention": sam_flash.plain_flash_attention,
    "fused_ln_mlp": fused_block.fused_ln_mlp,
    "global_attn_block": global_block.global_attn_block,
    "flash_attention_with_capture":
        flash_attention.flash_attention_with_capture,
    "dewindowize": boundary.dewindowize,
    "windowize": boundary.windowize,
    "sam_window_attention_v10":
        sam_flash_experiments.sam_window_attention_v10,
    "sam_global_attention_v11":
        sam_flash_experiments.sam_global_attention_v11,
    "sam_global_attention_v3": sam_flash_experiments.sam_global_attention_v3,
    "sam_global_attention_v6": sam_flash_experiments.sam_global_attention_v6,
    "sam_global_attention_v7": sam_flash_experiments.sam_global_attention_v7,
    "sam_window_attention": sam_flash_experiments.sam_window_attention,
    "sam_window_attention_v6": sam_flash_experiments.sam_window_attention_v6,
    "sam_window_attention_v7": sam_flash_experiments.sam_window_attention_v7,
    "sam_window_attention_v8": sam_flash_experiments.sam_window_attention_v8,
    "sam_global_attention": sam_flash_experiments.sam_global_attention,
    "sam_global_attention_v2": sam_flash_experiments.sam_global_attention_v2,
    "sam_global_attention_v4": sam_flash_experiments.sam_global_attention_v4,
    "sam_window_attention_v2": sam_flash_experiments.sam_window_attention_v2,
    "sam_window_attention_v3": sam_flash_experiments.sam_window_attention_v3,
    "sam_window_attention_v4": sam_flash_experiments.sam_window_attention_v4,
    "sam_window_attention_v5": sam_flash_experiments.sam_window_attention_v5,
}


@dataclasses.dataclass(frozen=True)
class Knobs:
    """The env knobs that shape the model and its batch."""
    family: str = "deepseek_vl"
    preset: str | None = None
    sam_size: int = 1024
    seq_len: int = 672
    global_block: bool = False
    global_kernel: str | None = None
    quant_llm: bool = False

    @classmethod
    def from_env(cls, env=os.environ) -> "Knobs":
        return cls(
            family=env.get("BENCH_FAMILY", "deepseek_vl"),
            preset=env.get("BENCH_PRESET") or None,
            sam_size=int(env.get("BENCH_SAM_SIZE", "1024")),
            seq_len=int(env.get("BENCH_SEQ", "672")),
            global_block=env.get("BENCH_GLOBAL_BLOCK") == "1",
            global_kernel=env.get("BENCH_GLOBAL_KERNEL") or None,
            quant_llm=env.get("BENCH_QUANT_LLM") == "1")


def _base(cfg):
    return cfg.base if hasattr(cfg, "base") else cfg


def resolve_config(knobs: Knobs):
    """``(cfg, preset, native img_start)`` of the knobs, without any
    parameter: the preset, its image block moved to a multiple of 128 where
    the decoder captures through the flash kernel or the block holds 1024
    tokens or more, the SAM size and the encoder overrides."""
    if knobs.quant_llm:
        raise NotImplementedError(
            "BENCH_QUANT_LLM=1: the int8 W8A8 decoder is not ported to "
            "flmm_tpu_torch yet (ROADMAP.md, queue 1, int8)")
    if knobs.family not in FLAGSHIP:
        raise ValueError(f"BENCH_FAMILY {knobs.family!r}: choose from "
                         f"{', '.join(FLAGSHIP)}")
    preset = knobs.preset or FLAGSHIP[knobs.family]
    cfg = registry.get_config(knobs.family, preset)
    base = _base(cfg)
    native_start = base.img_start
    if ((base.llm.use_flash_capture or base.num_img_tokens >= 1024)
            and base.img_start % 128):
        cfg = registry.get_config(knobs.family, preset,
                                  img_start=-(-base.img_start // 128) * 128)
        base = _base(cfg)
    if knobs.sam_size != base.sam.encoder.img_size:
        cfg = registry.with_sam_size(cfg, knobs.sam_size)
    enc_over = {}
    if knobs.global_block:
        enc_over["global_block_fused"] = True
    if knobs.global_kernel:
        enc_over["global_kernel"] = knobs.global_kernel
    if enc_over:
        base = _base(cfg)
        new_base = dataclasses.replace(base, sam=dataclasses.replace(
            base.sam, encoder=dataclasses.replace(
                base.sam.encoder, **enc_over)))
        cfg = (dataclasses.replace(cfg, base=new_base)
               if hasattr(cfg, "base") else new_base)
    return cfg, preset, native_start


def resolve_seq_len(cfg, family: str, seq_len: int) -> int:
    """``seq_len``, raised until the image block and some caption room fit
    (to a multiple of 128 when the image block is aligned)."""
    base = _base(cfg)
    need = (base.img_start + base.num_img_tokens + 40
            if family in ("deepseek_vl", "llava", "hpt") else 0)
    if seq_len < need:
        seq_len = (-(-need // 128) * 128 if base.img_start % 128 == 0
                   else need)
    return seq_len


def _family_batch(cfg, family: str, batch_size: int, seq_len: int,
                  prompt_len: int) -> dict:
    """Schema-exact synthetic batch (numpy) at the family's real geometry:
    8 masks of 12 text tokens."""
    if family in ("deepseek_vl", "llava", "hpt"):
        return synthetic_batch(cfg, batch_size=batch_size, seq_len=seq_len,
                               max_masks=8, text_tokens_per_mask=12)
    if family == "mgm":
        return mgm_batch(cfg, batch_size, seq_len)
    # llava_next: anyres tiles (~5x the image tokens); the builder sizes the
    # sequence itself (longest sample + 8, 128-aligned for flash capture)
    sizes = [ANYRES_SIZES[i % len(ANYRES_SIZES)] for i in range(batch_size)]
    return synthetic_anyres_batch(cfg, sizes, prompt_len=prompt_len,
                                  max_masks=8, caption_tokens=12)


def mgm_batch(cfg, batch_size: int, seq_len: int, seed: int = 0) -> dict:
    """The JAX script's MGM batch (bench.py:41-75): seeded samples through
    the family's batch builder (the JAX script's seed is 0)."""
    base = cfg.base
    build = registry.get_batch_builder("mgm", cfg)
    samples = synthetic_samples(cfg, batch_size, seed=seed, max_masks=8,
                                caption_tokens=12)
    S = max(seq_len, max(len(s["input_ids"]) for s in samples) + 8)
    align = 128 if base.llm.use_flash_capture else None
    if align:
        S = -(-S // align) * align
    spec = BatchSpec(
        seq_len=S, max_masks=8, text_per_mask=12,
        coarse_hw=registry.get_coarse_hw(cfg),
        sam_size=base.sam.encoder.img_size, prompt_size=base.sam.prompt_size,
        align_image_block=align, expected_img_start=base.img_start,
        processor=ProcessorConfig(size=base.input_size))
    batch = build(samples, spec)
    batch.pop("infos")
    return batch


def _noisy(t: torch.Tensor, g: torch.Generator, std) -> torch.Tensor:
    return (t.float() + torch.randn(t.shape, generator=g, device=t.device)
            * std).to(t.dtype)


def randomize_frozen(params: dict, g: torch.Generator) -> None:
    """What the init leaves trivial, made as a released checkpoint has it:
    non-zero rel-pos tables in every SAM trunk, so the bias term of the
    attention kernels and of the plain path does work; and in a hybrid
    tower (DeepSeek-VL-7B) an HD branch that adds something: ``hd_alpha``
    at ``HD_ALPHA`` (the init: 0) and ``neck_hd`` apart from the encoder
    neck (the init: a copy), each kernel moved by its own spread and each
    LayerNorm leaf by 0.1."""
    fro = params["frozen"]
    tower = fro.get("vision_high")
    trunks = [fro["sam_encoder"]] + ([tower["encoder"]] if tower else [])
    for bp in (bp for trunk in trunks for bp in trunk["blocks"]):
        for key in ("rel_pos_h", "rel_pos_w"):
            bp[key] = _noisy(torch.zeros_like(bp[key]), g, REL_POS_STD)
    if tower:
        tower["hd_alpha"] = torch.full_like(tower["hd_alpha"], HD_ALPHA)
        tower["neck_hd"] = {
            k: _noisy(t, g, t.float().std() if k.endswith("kernel") else 0.1)
            for k, t in tower["neck_hd"].items()}


def build(batch_size: int, knobs: Knobs = Knobs(), device="cuda",
          seed: int = 0):
    """``(model, cfg, params, batch)``: the family's model module, the
    resolved config, random parameters from ``seed`` on ``device`` (no
    ``lm_head``: the grounding forward never projects to the vocabulary) and
    one batch of tensors there."""
    cfg, _, native_start = resolve_config(knobs)
    model = registry.get_model(knobs.family)
    device = torch.device(device)
    g = torch.Generator(device=device).manual_seed(seed)
    params = model.init_params(cfg, g, device)
    params["frozen"]["llm"].pop("lm_head", None)
    randomize_frozen(params, g)
    seq_len = resolve_seq_len(cfg, knobs.family, knobs.seq_len)
    batch = from_jax(_family_batch(cfg, knobs.family, batch_size, seq_len,
                                   native_start), device)
    return model, cfg, params, batch


def distinct_batches(batch: dict, n: int) -> list:
    """``n`` copies of the batch with the pixels offset by ``0.001 * (i +
    1)``: no two forwards see the same input."""
    px_key = "pixel_values" if "pixel_values" in batch else "tiles"
    return [{**batch, px_key: batch[px_key] + 0.001 * (i + 1)}
            for i in range(n)]


def time_forwards(model, params, cfg, batches: list, warmup: int = WARMUP):
    """Forward every batch; the first ``warmup`` untimed.  Returns the
    stats of the timed ones (``ms_mean`` / ``ms_min`` / ``ms_max`` per
    forward from CUDA events, ``img_s`` from the host clock around the whole
    timed loop, ``peak_gb``, launches per forward) and the last output.  CPU
    tensors are timed on the host clock alone."""
    on_card = batches[0]["input_ids"].is_cuda
    timed = batches[warmup:]
    bs = timed[0]["input_ids"].shape[0]
    with torch.no_grad():
        for b in batches[:warmup]:
            out = model.forward(params, cfg, b)
        for fn in WRAPPERS.values():
            fn.launches = 0
        if on_card:
            events = [(torch.cuda.Event(enable_timing=True),
                       torch.cuda.Event(enable_timing=True)) for _ in timed]
            torch.cuda.synchronize()
            torch.cuda.reset_peak_memory_stats()
            t0 = time.perf_counter()
            for (start, end), b in zip(events, timed):
                start.record()
                out = model.forward(params, cfg, b)
                end.record()
            torch.cuda.synchronize()
            wall = time.perf_counter() - t0
            ms = [start.elapsed_time(end) for start, end in events]
            peak_gb = torch.cuda.max_memory_allocated() / 1e9
        else:
            ms, peak_gb = [], 0.0
            t0 = time.perf_counter()
            for b in timed:
                t1 = time.perf_counter()
                out = model.forward(params, cfg, b)
                ms.append((time.perf_counter() - t1) * 1e3)
            wall = time.perf_counter() - t0
    if not all(torch.isfinite(out[k]).all()
               for k in ("sam_logits", "coarse_logits", "iou_pred")):
        raise FloatingPointError("bench: the forward gave non-finite logits")
    launches = {name: fn.launches // len(timed)
                for name, fn in WRAPPERS.items()}
    if any(fn.launches % len(timed) for fn in WRAPPERS.values()):
        raise AssertionError("bench: launch counts differ between forwards")
    stats = {"img_s": bs * len(timed) / wall,
             "ms_mean": round(sum(ms) / len(ms), 3),
             "ms_min": round(min(ms), 3), "ms_max": round(max(ms), 3),
             "iters": len(timed), "peak_gb": round(peak_gb, 3)}
    return stats, launches, out


def run(batch_size: int, iters: int = 6, knobs: Knobs = Knobs(),
        device="cuda", seed: int = 0) -> dict:
    """Build the model, time the kernel path and then the all-plain path on
    the same parameters and inputs, and return the JSON row."""
    device = torch.device(device)
    model, cfg, params, batch = build(batch_size, knobs, device, seed)
    batches = distinct_batches(batch, WARMUP + iters)
    kernel, launches, _ = time_forwards(model, params, cfg, batches)
    plain, _, _ = time_forwards(model, params, registry.plain_config(cfg),
                                batches)
    enc = _base(cfg).sam.encoder
    for stats in (kernel, plain):
        stats["value"] = round(stats.pop("img_s"), 3)
    return {
        "metric": "grounded_images_per_sec_per_chip",
        "value": kernel["value"], "unit": "img/s",
        "vs_baseline": round(kernel["value"] / plain["value"], 3),
        "bs": batch_size,
        **{k: kernel[k] for k in ("ms_mean", "ms_min", "ms_max", "iters",
                                  "peak_gb")},
        "plain": {"value": plain.pop("value"), "unit": "img/s", **plain},
        "family": knobs.family,
        "preset": knobs.preset or FLAGSHIP[knobs.family],
        "sam_size": enc.img_size, "global_kernel": enc.global_kernel,
        "launches": launches, "device": card_line(device),
    }


def main(argv=None) -> dict:
    ap = argparse.ArgumentParser(
        prog="python -m flmm_tpu_torch.bench",
        description=__doc__.split("\n\n")[0],
        epilog="The model and the batch are set by the BENCH_* environment "
        "variables (see the module docstring).")
    ap.add_argument("--device", default="cuda", choices=("cuda", "cpu"))
    ap.add_argument("--seed", type=int, default=0)
    args = ap.parse_args(argv)
    device = device_of(args.device, "bench")
    knobs = Knobs.from_env()
    iters = int(os.environ.get("BENCH_ITERS", "6"))
    sizes = tuple(int(b) for b in os.environ.get(
        "BENCH_BS", "4,8,2,1").split(","))
    if device.type == "cuda":
        # full f32 products and convolutions in the plain versions
        torch.backends.cuda.matmul.allow_tf32 = False
        torch.backends.cudnn.allow_tf32 = False
    last_err = None
    for bs in sizes:
        try:
            row = run(bs, iters, knobs, device, args.seed)
        except torch.cuda.OutOfMemoryError as e:  # retry smaller
            last_err = e
            print(f"bench batch={bs} ran out of device memory: {e}",
                  file=sys.stderr)
            torch.cuda.empty_cache()
            continue
        print(json.dumps(row), flush=True)
        return row
    raise SystemExit(f"bench failed at all batch sizes: {last_err}")


if __name__ == "__main__":
    main()
