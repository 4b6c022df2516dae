"""Where the time goes in one forward or training step of the PyTorch port
on one GPU.

    python3 scripts/torch_profile.py                  # DeepSeek-VL-1.3B, bs 4
    python3 scripts/torch_profile.py --path llava_next  # LLaVA-NeXT, bs 2
    python3 scripts/torch_profile.py --path train     # DeepSeek-VL training
                                                      # at SAM-448, bs 8
    python3 scripts/torch_profile.py --path hpt       # HPT-Air-1.5, bs 4

Builds the full-width model from a seed (as chip_smoke.py does), then for
the kernel path and the all-plain path prints the device time by kernel
from torch.profiler over one forward (or step), the device's busy and idle
time, and stage times from CUDA events: vision tower, LLM capture for
LLaVA-NeXT and HPT, SAM encoder and whole forward; for training the step's
forward (the loss), backward and optimizer update.  For DeepSeek-VL serving
it then times the three stages of K1 (window block) separately at the
SAM-1024 window shape, for HPT the three stages of K10 (the attention half
of a global block) at the SAM-1024 global-layer shape.
"""

from __future__ import annotations

import argparse
import pathlib
import sys

import torch
from torch.autograd import DeviceType
from torch.profiler import ProfilerActivity, profile

sys.path.insert(0, str(pathlib.Path(__file__).resolve().parent.parent))

import chip_smoke  # noqa: E402
from flmm_tpu_torch import registry  # noqa: E402
from flmm_tpu_torch.configs import deepseek_vl, llava_next  # noqa: E402
from flmm_tpu_torch.convert.from_jax import from_jax  # noqa: E402
from flmm_tpu_torch.data.synthetic import synthetic_batch  # noqa: E402
from flmm_tpu_torch.models.frozen import grounding  # noqa: E402
from flmm_tpu_torch.models.frozen import llava_next as llava_next_model  # noqa: E402
from flmm_tpu_torch.models.llm import decoder  # noqa: E402
from flmm_tpu_torch.models.sam import image_encoder  # noqa: E402
from flmm_tpu_torch.models.vision import vit  # noqa: E402
from flmm_tpu_torch.ops import fused_block, global_block, masks, sam_flash, \
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
    fro = params["frozen"]

    def stages(c):
        return {
            "siglip tower": lambda: vit.forward(
                fro["vision"], c.vision, batch["pixel_values"]),
            "sam encoder": lambda: image_encoder.forward(
                fro["sam_encoder"], c.sam.encoder,
                batch["sam_pixel_values"]),
            "forward": lambda: grounding.forward(params, c, batch),
        }
    return cfg, stages


def llava_next_setup(g: torch.Generator):
    cfg = llava_next.llava_next_vicuna_7b(img_start=chip_smoke.ANYRES_IMG_START)
    params = llava_next_model.init_params(cfg, g, "cuda")
    params["frozen"]["llm"].pop("lm_head")
    chip_smoke.randomize_rel_pos(params, g)
    batch = chip_smoke.anyres_batches(cfg, "cuda")[1]
    fro = params["frozen"]
    tiles = batch["tiles"].reshape(-1, *batch["tiles"].shape[2:])

    def stages(c):
        b = c.base
        return {
            "clip tower (base + 4 tile slots)": lambda: vit.forward(
                fro["vision"], b.vision, tiles,
                select_layer=b.vision_select_layer),
            "llm capture (pack + decoder)": lambda: llava_next_model.capture(
                params, c, batch),
            "sam encoder": lambda: image_encoder.forward(
                fro["sam_encoder"], b.sam.encoder,
                batch["sam_pixel_values"]),
            "forward": lambda: llava_next_model.forward(params, c, batch),
        }
    return cfg, stages


def hpt_setup(g: torch.Generator):
    cfg = chip_smoke.hpt_config()
    params = grounding.init_params(cfg, g, "cuda")
    params["frozen"]["llm"].pop("lm_head")
    chip_smoke.randomize_rel_pos(params, g)
    batch = chip_smoke.hpt_batches(cfg, 2, "cuda")[1]
    fro = params["frozen"]
    embeds = chip_smoke._randn(
        g, (chip_smoke.BS, chip_smoke.HPT_SEQ, cfg.llm.hidden_size))
    mm = masks.mean_merge_matrix(batch["mask_ids"], chip_smoke.MASKS)
    lw = torch.softmax(params["trainable"]["text_layer_weights"], dim=0)

    def stages(c):
        return {
            "siglip-so400m tower (26 layers)": lambda: vit.forward(
                fro["vision"], c.vision, batch["pixel_values"],
                select_layer=c.vision_select_layer),
            "llm capture (decoder on random embeddings)":
                lambda: decoder.forward_capture(
                    fro["llm"], c.llm, embeds, batch["attn_mask"],
                    img_start=c.img_start, n_img=c.num_img_tokens,
                    merge_matrix=mm, merge=c.merge, layer_weights=lw),
            "sam encoder": lambda: image_encoder.forward(
                fro["sam_encoder"], c.sam.encoder,
                batch["sam_pixel_values"]),
            "forward": lambda: grounding.forward(params, c, batch),
        }
    return cfg, stages


def device_busy_ms(prof) -> tuple[float, float]:
    """(busy, window) in ms over the traced forward: the union of the
    device events' intervals, and the span from the first one's start to
    the last one's end.  CUPTI's "Command Buffer Full" records (host time
    blocked on a full launch queue) are no device work and are left out."""
    spans = sorted((e.time_range.start, e.time_range.end)
                   for e in prof.events()
                   if e.device_type == DeviceType.CUDA
                   and e.name != "Command Buffer Full")
    busy, lo, hi = 0.0, *spans[0]
    for start, end in spans[1:]:
        if start > hi:
            busy, lo = busy + hi - lo, start
        hi = max(hi, end)
    busy += hi - lo
    return busy / 1e3, (hi - spans[0][0]) / 1e3


def profile_paths(cfg, stages) -> None:
    for name, c in (("kernel", cfg), ("plain", chip_smoke._plain_config(cfg))):
        forward = stages(c)["forward"]
        with torch.no_grad():
            forward()
            torch.cuda.synchronize()
            with profile(activities=[ProfilerActivity.CPU,
                                     ProfilerActivity.CUDA]) as prof:
                forward()
                torch.cuda.synchronize()
            print(f"== {name} path: device time by kernel, one forward")
            print(prof.key_averages().table(sort_by="cuda_time_total",
                                            row_limit=25,
                                            max_name_column_width=70))
            busy, window = device_busy_ms(prof)
            print(f"{name} device busy {busy:.3f} ms of a {window:.3f} ms "
                  f"device window ({1 - busy / window:.1%} idle)")
            for stage, fn in stages(c).items():
                print(f"{name} {stage}: {chip_smoke.cuda_ms(fn, 3):.3f} ms")


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
        "window attention": lambda: sam_flash.relpos_attention(
            qkv, (T * 3 * C, hd, 3 * C), qkv[:, C:], qkv[:, 2 * C:],
            (T * 3 * C, hd, 3 * C), nh, bias, ws, NW * nh, T, attn,
            (T * C, hd, C)),
        "block_tail": lambda: fused_block.block_tail(
            xf, attn, wo, bo, lw, lb, 1e-6, w1, b1, w2, b2, "gelu", out),
        "rel-pos bias rows (plain)": lambda: window_block.window_rel_bias_from_x(
            xw, valid, lw, lb, w_s[:, :C], b_s[:C], rph, rpw, ws, nh, hd),
    }
    for part, fn in parts.items():
        print(f"K1 {part} (NW={NW}): {chip_smoke.cuda_ms(fn):.3f} ms")


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
        "global attention": lambda: sam_flash.relpos_attention(
            qkv, strides, qkv[:, C:], qkv[:, 2 * C:], strides, nh, bias,
            side, B * nh, S, attn, (S * C, hd, C)),
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
    8's configuration and stream) per path: the profiler's device time by
    kernel and busy share, then forward / backward / optimizer times from
    CUDA events, mean of 3 steps after a warm-up, and the frozen towers'
    forwards alone."""
    cfg = registry.with_sam_size(deepseek_vl.deepseek_vl_1_3b(),
                                 chip_smoke.TRAIN_SAM)
    params = grounding.init_params(cfg, g, "cuda")
    params["frozen"]["llm"].pop("lm_head")
    chip_smoke.randomize_rel_pos(params, g)
    fro = params["frozen"]
    batch = from_jax(synthetic_batch(cfg, batch_size=chip_smoke.TRAIN_BS,
                                     seed=1), "cuda")
    opt = loop.make_optimizer(loop.OptimConfig(total_steps=100))
    state = loop.init_state(params["trainable"], opt)
    for name, c in (("kernel", cfg), ("plain", chip_smoke._plain_config(cfg))):
        def step() -> list:
            """One step; CUDA events before and after its three parts."""
            events = [torch.cuda.Event(enable_timing=True) for _ in range(4)]
            events[0].record()
            loss, _ = grounding.loss_fn(
                {"frozen": fro, "trainable": state["params"]}, c, batch)
            events[1].record()
            grads = loop.gradients(loss, state["params"])
            events[2].record()
            state["opt_state"] = opt.update(grads, state["opt_state"],
                                            state["params"])
            events[3].record()
            return events

        step()
        torch.cuda.synchronize()
        with profile(activities=[ProfilerActivity.CPU,
                                 ProfilerActivity.CUDA]) as prof:
            step()
            torch.cuda.synchronize()
        print(f"== {name} path: device time by kernel, one training step")
        print(prof.key_averages().table(sort_by="cuda_time_total",
                                        row_limit=30,
                                        max_name_column_width=70))
        busy, window = device_busy_ms(prof)
        print(f"{name} device busy {busy:.3f} ms of a {window:.3f} ms "
              f"device window ({1 - busy / window:.1%} idle)")
        parts = torch.zeros(3)
        for _ in range(3):
            events = step()
            torch.cuda.synchronize()
            parts += torch.tensor([events[i].elapsed_time(events[i + 1])
                                   for i in range(3)])
        fwd, bwd, upd = (parts / 3).tolist()
        print(f"{name} step: forward {fwd:.3f} ms, backward {bwd:.3f} ms, "
              f"optimizer {upd:.3f} ms, step {fwd + bwd + upd:.3f} ms")
        with torch.no_grad():
            for stage, fn in {
                    "siglip tower": lambda: vit.forward(
                        fro["vision"], c.vision, batch["pixel_values"]),
                    "sam encoder": lambda: image_encoder.forward(
                        fro["sam_encoder"], c.sam.encoder,
                        batch["sam_pixel_values"])}.items():
                print(f"{name} {stage}: {chip_smoke.cuda_ms(fn, 3):.3f} ms")


def main() -> None:
    parser = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    parser.add_argument("--path", choices=("deepseek", "llava_next", "train",
                                           "hpt"), default="deepseek")
    args = parser.parse_args()
    print(chip_smoke.phase_card())
    g = torch.Generator(device="cuda").manual_seed(0)
    if args.path == "train":
        profile_train(g)
        return
    setup = {"deepseek": deepseek_setup, "llava_next": llava_next_setup,
             "hpt": hpt_setup}[args.path]
    profile_paths(*setup(g))
    if args.path == "deepseek":
        profile_window_block(g)
    elif args.path == "hpt":
        profile_global_block(g)


if __name__ == "__main__":
    main()
