"""Where the time goes in one bs-4 DeepSeek-VL-1.3B forward of the PyTorch
port on one GPU.

    python3 scripts/torch_profile.py

Builds the full-width model from a seed (as chip_smoke.py does), then for
the kernel path and the all-plain path prints the device time by kernel
from torch.profiler over one forward, and stage times (SigLIP tower, SAM
encoder, whole forward) from CUDA events.  Last, it times the three stages
of K1 (window block) separately at the SAM-1024 window shape.
"""

from __future__ import annotations

import pathlib
import sys

import torch
from torch.profiler import ProfilerActivity, profile

sys.path.insert(0, str(pathlib.Path(__file__).resolve().parent.parent))

import chip_smoke  # noqa: E402
from flmm_tpu_torch.configs import deepseek_vl  # noqa: E402
from flmm_tpu_torch.convert.from_jax import from_jax  # noqa: E402
from flmm_tpu_torch.data.synthetic import synthetic_batch  # noqa: E402
from flmm_tpu_torch.models.frozen import grounding  # noqa: E402
from flmm_tpu_torch.models.sam import image_encoder  # noqa: E402
from flmm_tpu_torch.models.vision import vit  # noqa: E402
from flmm_tpu_torch.ops import fused_block, sam_flash, window_block  # noqa: E402


def profile_paths(g: torch.Generator) -> None:
    cfg = deepseek_vl.deepseek_vl_1_3b()
    params = grounding.init_params(cfg, g, "cuda")
    params["frozen"]["llm"].pop("lm_head")
    batch = from_jax(synthetic_batch(
        cfg, batch_size=chip_smoke.BS, seq_len=chip_smoke.SEQ,
        max_masks=chip_smoke.MASKS,
        text_tokens_per_mask=chip_smoke.TEXT, seed=1), "cuda")
    fro = params["frozen"]
    for name, c in (("kernel", cfg), ("plain", chip_smoke._plain_config(cfg))):
        with torch.no_grad():
            grounding.forward(params, c, batch)
            torch.cuda.synchronize()
            with profile(activities=[ProfilerActivity.CPU,
                                     ProfilerActivity.CUDA]) as prof:
                grounding.forward(params, c, batch)
                torch.cuda.synchronize()
            print(f"== {name} path: device time by kernel, one forward")
            print(prof.key_averages().table(sort_by="cuda_time_total",
                                            row_limit=25,
                                            max_name_column_width=70))
            stages = {
                "siglip tower": lambda: vit.forward(
                    fro["vision"], c.vision, batch["pixel_values"]),
                "sam encoder": lambda: image_encoder.forward(
                    fro["sam_encoder"], c.sam.encoder,
                    batch["sam_pixel_values"]),
                "forward": lambda: grounding.forward(params, c, batch),
            }
            for stage, fn in stages.items():
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
            qkv, qkv[:, C:], qkv[:, 2 * C:], (T * 3 * C, hd, 3 * C), nh,
            bias, ws, NW * nh, T, attn, (T * C, hd, C)),
        "block_tail": lambda: fused_block.block_tail(
            xf, attn, wo, bo, lw, lb, 1e-6, w1, b1, w2, b2, "gelu", out),
        "rel-pos bias rows (plain)": lambda: window_block.window_rel_bias_from_x(
            xw, valid, lw, lb, w_s[:, :C], b_s[:C], rph, rpw, ws, nh, hd),
    }
    for part, fn in parts.items():
        print(f"K1 {part} (NW={NW}): {chip_smoke.cuda_ms(fn):.3f} ms")


def main() -> None:
    print(chip_smoke.phase_card())
    g = torch.Generator(device="cuda").manual_seed(0)
    profile_paths(g)
    profile_window_block(g)


if __name__ == "__main__":
    main()
