"""Smoke test of the PyTorch + CUDA port (flmm_tpu_torch) on one Hopper GPU.

    python3 chip_smoke.py

Phases; any failure raises and the script exits non-zero:

1. check the card (CUDA available; name and power limit from nvidia-smi);
2. build the kernel library from flmm_tpu_torch/csrc with nvcc (sm_90a),
   one nvcc per source, all started together;
3. hold each main-path kernel against its plain PyTorch version at the
   shapes the paths below give it, and time both: K1 window block, K2
   global attention, K3 LN + qkv and K4 proj + LN + MLP at the
   DeepSeek-VL-1.3B serving shapes, K3 and K4 again at the CLIP-L/336 shape
   of the anyres tower (quick_gelu) and at the SAM-448 training rows, K5
   flash capture at the LLaVA-NeXT decoder shape, K2 at the SAM-448 grid
   (side 28) and K6 window attention at the SAM-448 training shape; K7
   tower flash attention at the HPT tower shape (head dim 72, read in place
   from the qkv rows) and at the CLIP shape (S = 577, head dim 64), K8 LN2 +
   MLP and K10 the attention half of a global SAM block at the SAM-1024
   global-layer shape (K10's f32 result also bit for bit equal across two
   runs), K5 again at the HPT decoder shape (GQA 32/8).  Each kernel's time
   stands beside its bound (the larger of its operations over the card's
   peak bf16 rate and its operand bytes over the peak memory rate) and,
   where one PyTorch call computes the same function, that call's time;
4. serve 3 distinct synthetic bs-4 requests through the DeepSeek-VL-1.3B
   grounding forward at full width (DeepSeek-LLM-1.3B + SigLIP-L/384 + SAM
   ViT-L at 1024, bf16, random weights from a seed): output shapes, finite
   values and the exact kernel launch counts;
5. compare that forward with the all-plain forward on the same batch;
6. serve 3 distinct synthetic bs-2 anyres requests through the LLaVA-NeXT
   (Vicuna-7B) grounding forward at full width (CLIP-L/336 over a base view
   and up to 4 tiles, Vicuna-7B over S=3200 with the image block at 128,
   SAM ViT-L at 1024), one 2x2 and one 3x1 pinpoint grid per batch, so the
   decoder's key holes differ per sample: shapes, finite values, launches;
7. compare that forward with the all-plain forward (eager S x S capture);
8. train the DeepSeek-VL-1.3B heads at the SAM-448 schedule at full width
   through the port's train step (flmm_tpu_torch.train.loop) on the
   trainer's random synthetic stream at bs 8: one warm-up and 5 timed
   steps with finite losses and gradient norms and the exact launch counts
   per step, every trainable subtree changed and the frozen tree bit for
   bit unchanged, and a checkpoint save / restore round trip;
9. compare one training step's loss and gradients with the all-plain
   path's on the same state and batch, and time the plain path's steps;
10. check that 10 steps on one repeated batch lower its loss;
11. serve 3 distinct synthetic bs-4 requests through the HPT-Air-1.5
    grounding forward at full width and depth (Llama-3-8B with GQA 32/8
    over S=1280 with the 1024-token image block at 128, SigLIP-SO400M/14 at
    448 with the flash switch on, SAM ViT-L at 1024 with the whole-block
    global switch on): shapes, finite values, launches;
12. compare that forward, its tower features and its SAM embedding with the
    all-plain forward;
13. report times.

The last line of standard output is one JSON object with the device; the
line before it is the card's name and power limit, and the one before that
holds the per-kernel results.
"""

from __future__ import annotations

import dataclasses
import json
import math
import pathlib
import subprocess
import tempfile
import time

import torch

from flmm_tpu_torch import registry
from flmm_tpu_torch.configs import deepseek_vl, llava_next
from flmm_tpu_torch.convert.from_jax import from_jax
from flmm_tpu_torch.data.llava_next import synthetic_anyres_batch
from flmm_tpu_torch.data.synthetic import synthetic_batch
from flmm_tpu_torch.models.frozen import grounding
from flmm_tpu_torch.models.frozen import llava_next as llava_next_model
from flmm_tpu_torch.models.mask_head import unet
from flmm_tpu_torch.models.sam import image_encoder as sam_encoder
from flmm_tpu_torch.models.vision import vit
from flmm_tpu_torch.ops import _cuda
from flmm_tpu_torch.ops import flash_attention, fused_block, global_block, \
    masks, sam_flash, window_block
from flmm_tpu_torch.train import checkpoint as ckpt
from flmm_tpu_torch.train import loop as train_loop

BS, SEQ, MASKS, TEXT = 4, 672, 8, 12
# LLaVA-NeXT requests: bs 2, the vicuna template's 35 prompt tokens padded
# to an image block at 128, (h, w) of the two images: 2x2 and 3x1 grids
ANYRES_BS, ANYRES_IMG_START, ANYRES_PROMPT = 2, 128, 35
ANYRES_SIZES = ((600, 640), (900, 280))
# HPT-Air-1.5 requests: the image block of 1024 tokens at 128, S = 128 + 1024
# + 40 rounded up to 128
HPT_IMG_START, HPT_SEQ = 128, 1280
# published dense peaks of one H100 SXM: bf16 tensor-core rate, memory rate
PEAK_FLOPS, PEAK_BYTES = 989e12, 3.35e12
# kernel vs plain version, both bf16: max |diff| over max |plain| and the
# correlation of the flattened outputs
KERNEL_REL_ERR, KERNEL_CORR = 2e-2, 0.999
# kernel forward vs all-plain forward (bf16 differences compound through
# 24 SAM blocks, the 23-24 tower blocks and the decoder)
FORWARD_CORR = {"sam_embedding": 0.999, "attn": 0.999,
                "vision_features": 0.999, "hidden": 0.999,
                "coarse_logits": 0.99, "sam_logits": 0.99}
# training: bs 8 at the SAM-448 schedule, scripts/train.py's random stream
# (synthetic_batch defaults: S = 613, up to 3 masks of up to 4 tokens)
TRAIN_BS, TRAIN_SAM, TRAIN_STEPS, REPEATED_STEPS = 8, 448, 5, 10
TRAIN_LR = 1e-4  # the recipe's, also for the repeated batch
# kernel step vs all-plain step: relative loss difference, and the
# correlation of each trainable subtree's flattened gradient
STEP_LOSS_REL, STEP_GRAD_CORR = 0.01, 0.99
SUBTREES = ("unet", "text_proj", "text_layer_weights", "sam/prompt",
            "sam/decoder")
EXPECTED_LAUNCHES = {  # per forward when serving, per step when training
    "deepseek_vl_1_3b": {
        "window_block": 20, "sam_global_attention_v8": 4,
        "fused_ln_qkv": 28, "fused_proj_ln_mlp": 28,
        "flash_attention_with_merged_capture": 0,
        "sam_window_attention_v9": 0, "plain_flash_attention": 0,
        "fused_ln_mlp": 0, "global_attn_block": 0},
    "llava_next_vicuna_7b": {
        "window_block": 20, "sam_global_attention_v8": 4,
        "fused_ln_qkv": 27, "fused_proj_ln_mlp": 27,
        "flash_attention_with_merged_capture": 32,
        "sam_window_attention_v9": 0, "plain_flash_attention": 0,
        "fused_ln_mlp": 0, "global_attn_block": 0},
    "deepseek_vl_1_3b_train_sam448": {
        "window_block": 0, "sam_global_attention_v8": 4,
        "fused_ln_qkv": 48, "fused_proj_ln_mlp": 48,
        "flash_attention_with_merged_capture": 0,
        "sam_window_attention_v9": 20, "plain_flash_attention": 0,
        "fused_ln_mlp": 0, "global_attn_block": 0},
    # the tower's K3 / K4 gate is closed (mlp_dim 4304 % 512 != 0), 26 of its
    # 27 layers run (features at layer -2), and the 4 global SAM layers go
    # K10 + K8 instead of K3 + K2 + K4
    "hpt_air_1_5": {
        "window_block": 20, "sam_global_attention_v8": 0,
        "fused_ln_qkv": 0, "fused_proj_ln_mlp": 0,
        "flash_attention_with_merged_capture": 32,
        "sam_window_attention_v9": 0, "plain_flash_attention": 26,
        "fused_ln_mlp": 4, "global_attn_block": 4},
}
WRAPPERS = {"window_block": window_block.window_block,
            "sam_global_attention_v8": sam_flash.sam_global_attention_v8,
            "fused_ln_qkv": fused_block.fused_ln_qkv,
            "fused_proj_ln_mlp": fused_block.fused_proj_ln_mlp,
            "flash_attention_with_merged_capture":
                flash_attention.flash_attention_with_merged_capture,
            "sam_window_attention_v9": sam_flash.sam_window_attention_v9,
            "plain_flash_attention": sam_flash.plain_flash_attention,
            "fused_ln_mlp": fused_block.fused_ln_mlp,
            "global_attn_block": global_block.global_attn_block}
SOURCES = {
    "window_block": ("flmm_tpu_torch/ops/window_block.py",
                     "flmm_tpu/ops/window_block.py:293"),
    "sam_global_attention_v8": ("flmm_tpu_torch/csrc/relpos_attention.cu",
                                "flmm_tpu/ops/sam_flash.py:292"),
    "fused_ln_qkv": ("flmm_tpu_torch/csrc/ln_gemm.cu",
                     "flmm_tpu/ops/fused_block.py:220"),
    "fused_proj_ln_mlp": ("flmm_tpu_torch/csrc/block_tail.cu",
                          "flmm_tpu/ops/fused_block.py:154"),
    "flash_attention_with_merged_capture": (
        "flmm_tpu_torch/csrc/flash_capture.cu",
        "flmm_tpu/ops/flash_attention.py:246"),
    "sam_window_attention_v9": ("flmm_tpu_torch/csrc/relpos_attention.cu",
                                "flmm_tpu/ops/sam_flash.py:122"),
    "plain_flash_attention": ("flmm_tpu_torch/csrc/plain_flash.cu",
                              "flmm_tpu/ops/sam_flash.py:185"),
    "fused_ln_mlp": ("flmm_tpu_torch/csrc/block_tail.cu",
                     "flmm_tpu/ops/fused_block.py:264"),
    "global_attn_block": ("flmm_tpu_torch/ops/global_block.py",
                          "flmm_tpu/ops/global_block.py:243"),
}


def log(msg: str) -> None:
    print(msg, flush=True)


def cuda_ms(fn, iters: int = 5) -> float:
    """Mean device time of ``fn()`` over ``iters`` calls after one warm-up,
    from CUDA events."""
    fn()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    torch.cuda.synchronize()
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / iters


def agreement(got: torch.Tensor, want: torch.Tensor) -> tuple[float, float]:
    """(max |got - want| / max |want|, correlation), after a finite check."""
    g, w = got.float().flatten(), want.float().flatten()
    if not (torch.isfinite(g).all() and torch.isfinite(w).all()):
        raise AssertionError("non-finite values")
    rel = ((g - w).abs().max() / w.abs().max().clamp_min(1e-30)).item()
    corr = torch.corrcoef(torch.stack([g, w]))[0, 1].item()
    return rel, corr


def phase_card() -> str:
    if not torch.cuda.is_available():
        raise SystemExit("chip_smoke: no CUDA device; this test needs a GPU")
    # the plain versions are the reference: full f32 products and convs
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True, check=True)
    card = smi.stdout.strip().splitlines()[0]
    log(f"phase 1 card: {card} ({torch.cuda.get_device_name(0)}, "
        f"torch {torch.__version__}, CUDA {torch.version.cuda})")
    return card


def phase_build() -> None:
    t0 = time.perf_counter()
    _cuda.library()
    log(f"phase 2 build: kernel library ready in "
        f"{time.perf_counter() - t0:.1f} s")


def _randn(g, shape, scale=1.0, shift=0.0):
    return (torch.randn(shape, generator=g, device="cuda") * scale
            + shift).to(torch.bfloat16)


def anyres_batches(cfg, device=None) -> list:
    """The warm-up batch and 3 distinct requests of the LLaVA-NeXT phase
    (numpy, or tensors on ``device``)."""
    out = []
    for seed in range(4):
        b = synthetic_anyres_batch(cfg, ANYRES_SIZES,
                                   prompt_len=ANYRES_PROMPT,
                                   max_masks=MASKS, caption_tokens=TEXT,
                                   seed=seed)
        out.append(b if device is None else from_jax(b, device))
    return out


def _tensor_bytes(*items) -> int:
    return sum(t.numel() * t.element_size() for t in items
               if isinstance(t, torch.Tensor))


def _attention_mask(q, rel_pos_h, rel_pos_w, side: int) -> torch.Tensor:
    """The decomposed rel-pos bias of ``(G, S, hd)`` heads expanded to an
    additive ``(1, G, S, S)`` mask in natural base, for the library call's
    timing only."""
    rows = sam_flash.global_bias_rows(q, rel_pos_h, rel_pos_w, side)
    G, S, _ = rows.shape
    mask = torch.empty((1, G, S, S), dtype=q.dtype, device=q.device)
    for g0 in range(0, G, 8):  # the f32 sum of 8 heads at a time
        r = rows[g0:g0 + 8].float() * sam_flash.LN2
        mask[0, g0:g0 + 8] = (r[..., :side, None] + r[..., None, side:]
                              ).reshape(-1, S, S)
    return mask


def _sdpa(q, k, v, mask=None):
    """``F.scaled_dot_product_attention`` over ``(G, S, hd)`` heads or ``(B,
    H, S, hd)`` views: the yardstick of K2, K6 and K7, called nowhere in the
    port."""
    if q.dim() == 3:
        q, k, v = q[None], k[None], v[None]
    return torch.nn.functional.scaled_dot_product_attention(
        q, k, v, attn_mask=mask)


def hpt_config():
    """HPT-Air-1.5 with the image block at 128 and the two kernel switches a
    user sets on top of the preset: the tower's flash attention (K7) and the
    whole-block global SAM layer (K10 + K8)."""
    cfg = registry.get_config("hpt", "air_1_5", img_start=HPT_IMG_START)
    return dataclasses.replace(
        cfg, vision=dataclasses.replace(cfg.vision, flash=True),
        sam=dataclasses.replace(cfg.sam, encoder=dataclasses.replace(
            cfg.sam.encoder, global_block_fused=True)))


def hpt_batches(cfg, n: int, device=None) -> list:
    """``n`` distinct bs-4 requests of the HPT-Air-1.5 phase (numpy, or
    tensors on ``device``)."""
    out = []
    for seed in range(n):
        b = synthetic_batch(cfg, batch_size=BS, seq_len=HPT_SEQ,
                            max_masks=MASKS, text_tokens_per_mask=TEXT,
                            seed=seed)
        out.append(b if device is None else from_jax(b, device))
    return out


def phase_kernels(g: torch.Generator, g_hpt: torch.Generator) -> dict:
    """Each kernel against its plain version at the main paths' shapes.
    The checks that came with the HPT path draw from ``g_hpt``, so that the
    three earlier paths keep the weights and inputs ``g`` has always given
    them (phase 9's U-Net gradient comparison is sensitive to the state the
    training steps reach)."""
    C, F, hd = 1024, 4096, 64
    results = {}

    def check(name, label, wrapper, plain, args, flop, library_fn=None):
        """Compare, time and bound one kernel: ``flop`` is the operations of
        its products at this shape, the bytes are those of its operands and
        results, each moved once."""
        def kernel_fn():
            return wrapper(*args)

        def plain_fn():
            return plain(*args)

        got, want = kernel_fn(), plain_fn()
        torch.cuda.synchronize()
        pairs = (list(zip(got, want)) if isinstance(got, tuple)
                 else [(got, want)])
        rels, corrs = zip(*(agreement(a, b) for a, b in pairs))
        rel, corr = max(rels), min(corrs)
        moved = _tensor_bytes(*args, *(a for a, _ in pairs))
        del want
        ms, plain_ms = cuda_ms(kernel_fn), cuda_ms(plain_fn)
        library_ms = None
        if library_fn is not None:
            lib_rel, _ = agreement(library_fn().reshape(pairs[0][0].shape),
                                   pairs[0][0])
            library_ms = cuda_ms(library_fn)
        by_ops, by_bytes = flop / PEAK_FLOPS * 1e3, moved / PEAK_BYTES * 1e3
        bound_ms = max(by_ops, by_bytes)
        ok = rel <= KERNEL_REL_ERR and corr >= KERNEL_CORR
        library = ("none" if library_ms is None else
                   f"{library_ms:.3f} ms (kernel vs library max_rel_err "
                   f"{lib_rel:.3e})")
        log(f"phase 3 {name} [{label}]: max_rel_err {rel:.3e} (bound "
            f"{KERNEL_REL_ERR}) corr {corr:.6f} (bound {KERNEL_CORR}) "
            f"kernel {ms:.3f} ms ({flop / ms / 1e9:.1f} TFLOP/s) plain "
            f"{plain_ms:.3f} ms library {library}; {flop / 1e9:.1f} GFLOP, "
            f"{moved / 1e6:.1f} MB, least {bound_ms:.4f} ms")
        if not ok:
            raise AssertionError(f"{name} [{label}] disagrees with its "
                                 "plain version")
        if name not in results:  # the first shape listed is reported
            results[name] = {
                "shape": label, "max_abs_err": max(
                    (a.float() - b.float()).abs().max().item()
                    for a, b in pairs),
                "ms": ms, "plain_ms": plain_ms, "bound_ms": bound_ms,
                "bound_by": "operations" if by_ops >= by_bytes else "bytes",
                "library_ms": library_ms}

    def ln_params(gen=g):
        return _randn(gen, (C,), 0.1, 1.0), _randn(gen, (C,), 0.1)

    # K3 / K4 / K8: SAM global layers (N = 4096 * bs); K3 / K4 also at the
    # SigLIP layers (576 * bs), the CLIP-L/336 layers over base + 4 tile
    # slots (577 * 5 * 2, quick_gelu) and the SAM-448 training rows
    train_grid = TRAIN_SAM // 16
    for label, N, act, eps in (
            ("SAM global, N=16384", 4096 * BS, "gelu", 1e-6),
            ("SigLIP, N=2304", 576 * BS, "gelu", 1e-6),
            ("CLIP, N=5770, quick_gelu", 577 * 5 * ANYRES_BS, "quick_gelu",
             1e-5),
            ("SAM-448 training, N=6272", train_grid ** 2 * TRAIN_BS, "gelu",
             1e-6)):
        x, a = _randn(g, (N, C)), _randn(g, (N, C))
        lw, lb = ln_params()
        wqkv, bqkv = _randn(g, (C, 3 * C), C ** -0.5), _randn(g, (3 * C,), .1)
        wo, bo = _randn(g, (C, C), C ** -0.5), _randn(g, (C,), 0.1)
        w1, b1 = _randn(g, (C, F), C ** -0.5), _randn(g, (F,), 0.1)
        w2, b2 = _randn(g, (F, C), F ** -0.5), _randn(g, (C,), 0.1)
        check("fused_ln_qkv", label, fused_block.fused_ln_qkv,
              fused_block.fused_ln_qkv_plain, (x, lw, lb, wqkv, bqkv, eps),
              flop=2 * N * C * 3 * C)
        check("fused_proj_ln_mlp", label, fused_block.fused_proj_ln_mlp,
              fused_block.fused_proj_ln_mlp_plain,
              (x, a, wo, bo, lw, lb, w1, b1, w2, b2, eps, act),
              flop=2 * N * C * C + 4 * N * C * F)
        if N == 4096 * BS:
            check("fused_ln_mlp", label, fused_block.fused_ln_mlp,
                  fused_block.fused_ln_mlp_plain,
                  (x, lw, lb, w1, b1, w2, b2, eps, act), flop=4 * N * C * F)

    # K2: 4 images x 16 heads over the 64 x 64 grid; each (query, key) pair
    # of a head is 2 products of 2 * hd FLOP
    side = 64
    q, k, v = (_randn(g, (16 * BS, side * side, hd)) for _ in range(3))
    rph, rpw = _randn(g, (2 * side - 1, hd), 0.1), _randn(g, (2 * side - 1, hd), 0.1)
    mask = _attention_mask(q, rph, rpw, side)  # 2.1 GB, outside the timing
    check("sam_global_attention_v8", "G=64, S=4096",
          sam_flash.sam_global_attention_v8,
          sam_flash.sam_global_attention_v8_plain, (q, k, v, rph, rpw, side),
          flop=4 * 16 * BS * side ** 4 * hd,
          library_fn=lambda: _sdpa(q, k, v, mask))
    del mask

    # K10: the attention half of a global block over the same grid, from
    # the residual stream, with non-zero rel-pos tables; its f32 result is
    # compared as f32 and must repeat bit for bit
    nh = 16
    S = side * side
    x = _randn(g_hpt, (BS, S, C))
    lw, lb = ln_params(g_hpt)
    w_s, b_s = window_block.scaled_qkv_weights(
        _randn(g_hpt, (C, 3 * C), C ** -0.5), _randn(g_hpt, (3 * C,), 0.1),
        nh, hd)
    wo, bo = _randn(g_hpt, (C, C), C ** -0.5), _randn(g_hpt, (C,), 0.1)
    bias = global_block.global_rel_bias_from_x(
        x, lw, lb, w_s[:, :C], b_s[:C], rph, rpw, side, nh, hd)
    args = (x, bias, lw, lb, w_s, b_s, wo, bo, side, nh)
    check("global_attn_block", f"B={BS}, S={S}, C={C}, f32 result",
          global_block.global_attn_block,
          global_block.global_attn_block_plain, args,
          flop=2 * BS * S * C * 3 * C + 4 * BS * nh * S * S * hd
          + 2 * BS * S * C * C)
    first, second = (global_block.global_attn_block(*args) for _ in range(2))
    torch.cuda.synchronize()
    if first.dtype != torch.float32 or not torch.equal(first, second):
        raise AssertionError("global_attn_block: the result is not f32 or "
                             "differs between two runs on one input")
    log("phase 3 global_attn_block: f32 result, bit for bit equal across "
        "two runs")
    del first, second, bias, args

    # K1: the 64 x 64 grid padded to 70 x 70 = 25 windows per image
    ws = 14
    x = _randn(g, (BS, 64, 64, C))
    xw, geom = sam_encoder._windowize(x, ws)
    xw = xw.contiguous()
    valid = sam_encoder._window_valid_tokens(geom, ws, x.device)
    lw, lb = ln_params()
    l2w, l2b = ln_params()
    w_s, b_s = window_block.scaled_qkv_weights(
        _randn(g, (C, 3 * C), C ** -0.5), _randn(g, (3 * C,), 0.1), nh, hd)
    wo, bo = _randn(g, (C, C), C ** -0.5), _randn(g, (C,), 0.1)
    w1, b1 = _randn(g, (C, F), C ** -0.5), _randn(g, (F,), 0.1)
    w2, b2 = _randn(g, (F, C), F ** -0.5), _randn(g, (C,), 0.1)
    rph, rpw = _randn(g, (2 * ws - 1, hd), 0.1), _randn(g, (2 * ws - 1, hd), 0.1)
    bias = window_block.window_rel_bias_from_x(
        xw, valid, lw, lb, w_s[:, :C], b_s[:C], rph, rpw, ws, nh, hd)
    NW, T = xw.shape[:2]
    check("window_block", f"NW={NW}, T=196, padded grid",
          window_block.window_block, window_block.window_block_plain,
          (xw, bias, valid, lw, lb, w_s, b_s, wo, bo, l2w, l2b, w1, b1, w2,
           b2, ws, nh),
          flop=NW * T * (2 * C * 3 * C + 2 * C * C + 4 * C * F)
          + 4 * NW * nh * T * T * hd)

    # K5: one decoder layer of each serving path that captures through it,
    # with the path's key holes and merge matrix; q, k, v as (B, H, S, hd)
    # views of the decoder's (B, S, H, hd) projections
    def check_capture(gen, label, batch, H, KV, img_start, n_img):
        valid = torch.from_numpy(batch["attn_mask"]).cuda()
        mm = masks.mean_merge_matrix(
            torch.from_numpy(batch["mask_ids"]).cuda(), MASKS)
        B, S = valid.shape
        hd = 128
        q = _randn(gen, (B, S, H, hd)).transpose(1, 2)
        k, v = (_randn(gen, (B, S, KV, hd)).transpose(1, 2) for _ in range(2))
        # what this batch needs: 4 * hd FLOP per visible (query, key) pair
        # and head, and the merge of its text rows' image-block
        # probabilities, 2 * M * n_img FLOP per row and head
        pairs = int(valid.cumsum(1).sum())
        text_rows = int((mm != 0).any(dim=-1).sum())
        check("flash_attention_with_merged_capture",
              f"{label}: B={B}, H={H}, KV={KV}, S={S}, n_img={n_img}, "
              f"M={MASKS}",
              flash_attention.flash_attention_with_merged_capture,
              flash_attention.flash_attention_with_merged_capture_plain,
              (q, k, v, valid, mm, img_start, n_img),
              flop=4 * H * hd * pairs + 2 * H * MASKS * n_img * text_rows)

    check_capture(g, "LLaVA-NeXT", anyres_batches(
        llava_next.llava_next_vicuna_7b(img_start=ANYRES_IMG_START))[0],
        32, 32, ANYRES_IMG_START, 2928)
    check_capture(g_hpt, "HPT-Air-1.5", hpt_batches(hpt_config(), 1)[0], 32,
                  8, HPT_IMG_START, 1024)

    # K2 over the SAM-448 grid: 8 images x 16 heads, side 28 (S = 784)
    hd = 64
    q, k, v = (_randn(g, (16 * TRAIN_BS, train_grid ** 2, hd))
               for _ in range(3))
    rph, rpw = (_randn(g, (2 * train_grid - 1, hd), 0.1) for _ in range(2))
    check("sam_global_attention_v8", "SAM-448, G=128, S=784",
          sam_flash.sam_global_attention_v8,
          sam_flash.sam_global_attention_v8_plain,
          (q, k, v, rph, rpw, train_grid),
          flop=4 * 16 * TRAIN_BS * train_grid ** 4 * hd)

    # K6: the 2 x 2 windows of 14 x 14 of 8 SAM-448 images, 16 heads, read
    # as (NW, nh, T, hd) views of the windowised qkv as the encoder passes
    # them: G = 512 window-heads, T = 196
    NW, T = 4 * TRAIN_BS, ws * ws
    qkvw = _randn(g, (NW, T, 3 * C))
    heads = [qkvw[..., i * C:(i + 1) * C].reshape(NW, T, nh, hd).transpose(
        1, 2) for i in range(3)]
    rph, rpw = (_randn(g, (2 * ws - 1, hd), 0.1) for _ in range(2))
    mask = _attention_mask(heads[0].reshape(NW * nh, T, hd), rph, rpw,
                           ws).reshape(NW, nh, T, T)
    check("sam_window_attention_v9", f"G={NW * nh}, T={T}, (NW, nh, T, hd) "
          "views", sam_flash.sam_window_attention_v9,
          sam_flash.sam_window_attention_v9_plain, (*heads, rph, rpw, ws),
          flop=4 * NW * nh * T * T * hd,
          library_fn=lambda: _sdpa(*heads, mask))

    # K7: the SigLIP-SO400M/448 tower's attention, 4 images x 16 heads of 72
    # over 1024 tokens, as (B, H, S, hd) views of a layer's qkv rows; then
    # the CLIP-L/336 shape, contiguous heads of 64 over S = 577
    H, hd, S = 16, 72, 1024
    qkv = _randn(g_hpt, (BS, S, 3 * H * hd))
    heads = [t.reshape(BS, S, H, hd).transpose(1, 2)
             for t in qkv.split(H * hd, dim=-1)]
    check("plain_flash_attention", f"G={BS * H}, S={S}, hd={hd}, (B, H, S, "
          "hd) views", sam_flash.plain_flash_attention,
          sam_flash.plain_flash_attention_plain, heads,
          flop=4 * BS * H * S * S * hd, library_fn=lambda: _sdpa(*heads))
    q, k, v = (_randn(g_hpt, (BS * H, 577, 64)) for _ in range(3))
    check("plain_flash_attention", f"G={BS * H}, S=577, hd=64",
          sam_flash.plain_flash_attention,
          sam_flash.plain_flash_attention_plain, (q, k, v),
          flop=4 * BS * H * 577 * 577 * 64, library_fn=lambda: _sdpa(q, k, v))
    return results


def _plain_config(cfg):
    """The same model with every kernel gate off."""
    if isinstance(cfg, llava_next_model.LlavaNextConfig):
        return dataclasses.replace(cfg, base=_plain_config(cfg.base))
    enc = dataclasses.replace(cfg.sam.encoder, flash_global=False,
                              flash_window=False, window_block_fused=False,
                              global_block_fused=False, fused_mlp=False)
    return dataclasses.replace(
        cfg, llm=dataclasses.replace(cfg.llm, use_flash_capture=False),
        vision=dataclasses.replace(cfg.vision, fused_mlp=False, flash=False),
        sam=dataclasses.replace(cfg.sam, encoder=enc))


def run_requests(forward, params, cfg, batches) -> tuple[list, float]:
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    outs = [forward(params, cfg, b) for b in batches]
    torch.cuda.synchronize()
    return outs, (time.perf_counter() - t0) * 1e3 / len(batches)


def randomize_rel_pos(params, g) -> None:
    """Non-zero SAM rel-pos tables, so the bias terms of K1 and K2 work."""
    for bp in params["frozen"]["sam_encoder"]["blocks"]:
        for key in ("rel_pos_h", "rel_pos_w"):
            bp[key] = _randn(g, bp[key].shape, 0.05)


def phase_serve(phase, path, forward, params, cfg, batches, shapes) -> dict:
    """Warm up, then serve the requests with every launch count at 0 just
    before and read just after; check shapes, finite values and counts."""
    warm, requests = batches[0], batches[1:]
    with torch.no_grad():
        forward(params, cfg, warm)  # warm-up
        for fn in WRAPPERS.values():
            fn.launches = 0
        torch.cuda.reset_peak_memory_stats()
        outs, ms = run_requests(forward, params, cfg, requests)
        launches = {name: fn.launches for name, fn in WRAPPERS.items()}
        peak_gb = torch.cuda.max_memory_allocated() / 1e9
    for out in outs:
        for key, shape in shapes.items():
            if tuple(out[key].shape) != shape:
                raise AssertionError(f"{key} shape {tuple(out[key].shape)}"
                                     f" != {shape}")
            if not torch.isfinite(out[key]).all():
                raise AssertionError(f"{key} has non-finite values")
    want = {k: n * len(requests) for k, n in EXPECTED_LAUNCHES[path].items()}
    bs = shapes["iou_pred"][0]
    log(f"phase {phase} serve {path}: {len(requests)} requests at bs {bs}, "
        f"outputs finite with the expected shapes; launches {launches} "
        f"(expected {want}); peak memory {peak_gb:.2f} GB")
    if launches != want:
        raise AssertionError("kernel launch counts differ from the main path")
    return {"requests": requests, "outs": outs, "ms": ms,
            "launches": launches, "peak_gb": peak_gb, "bs": bs}


def phase_compare(phase, path, forward, params, cfg, served,
                  pairs_fn) -> None:
    """The kernel forward against the all-plain forward on one batch, then
    the plain path's time and peak memory over the same requests."""
    plain = _plain_config(cfg)
    batch = served["requests"][0]
    with torch.no_grad():
        pairs = pairs_fn(cfg, plain, batch)
        ref = forward(params, plain, batch)
        pairs.update({k: (served["outs"][0][k], ref[k]) for k in
                      ("hidden", "coarse_logits", "sam_logits")})
        for key, (got, want) in pairs.items():
            rel, corr = agreement(got, want)
            log(f"phase {phase} {path} {key}: kernel vs plain forward "
                f"max_rel_err {rel:.3e} corr {corr:.6f} (bound "
                f"{FORWARD_CORR[key]})")
            if corr < FORWARD_CORR[key]:
                raise AssertionError(f"{path} {key}: kernel forward "
                                     "disagrees with the plain forward")
        del pairs, ref
        torch.cuda.reset_peak_memory_stats()
        _, served["plain_ms"] = run_requests(forward, params, plain,
                                             served["requests"])
        served["plain_peak_gb"] = torch.cuda.max_memory_allocated() / 1e9


def run_deepseek(g: torch.Generator) -> dict:
    cfg = deepseek_vl.deepseek_vl_1_3b()
    params = grounding.init_params(cfg, g, "cuda")
    params["frozen"]["llm"].pop("lm_head")  # the forward never uses it
    randomize_rel_pos(params, g)
    batches = [from_jax(synthetic_batch(
        cfg, batch_size=BS, seq_len=SEQ, max_masks=MASKS,
        text_tokens_per_mask=TEXT, seed=seed), "cuda") for seed in range(4)]
    Hc, Wc = unet.output_hw(cfg.unet, (cfg.clip_shape, cfg.clip_shape))
    shapes = {"sam_logits": (BS, MASKS, 256, 256),
              "coarse_logits": (BS, MASKS, Hc, Wc),
              "iou_pred": (BS, MASKS), "boxes": (BS, MASKS, 4),
              "hidden": (BS, SEQ, cfg.llm.hidden_size)}
    served = phase_serve(4, "deepseek_vl_1_3b", grounding.forward, params,
                         cfg, batches, shapes)

    def sam_embedding(cfg, plain, batch):
        emb = [sam_encoder.forward(params["frozen"]["sam_encoder"],
                                   c.sam.encoder, batch["sam_pixel_values"])
               for c in (cfg, plain)]
        return {"sam_embedding": tuple(emb)}

    phase_compare(5, "deepseek_vl_1_3b", grounding.forward, params, cfg,
                  served, sam_embedding)
    return served


def run_llava_next(g: torch.Generator) -> dict:
    cfg = llava_next.llava_next_vicuna_7b(img_start=ANYRES_IMG_START)
    params = llava_next_model.init_params(cfg, g, "cuda")
    params["frozen"]["llm"].pop("lm_head")
    randomize_rel_pos(params, g)
    batches = anyres_batches(cfg, "cuda")
    S = batches[0]["input_ids"].shape[1]
    Hc, Wc = cfg.coarse_frame
    shapes = {"sam_logits": (ANYRES_BS, MASKS, 256, 256),
              "coarse_logits": (ANYRES_BS, MASKS, Hc, Wc),
              "iou_pred": (ANYRES_BS, MASKS), "boxes": (ANYRES_BS, MASKS, 4),
              "hidden": (ANYRES_BS, S, cfg.base.llm.hidden_size)}
    served = phase_serve(6, "llava_next_vicuna_7b", llava_next_model.forward,
                         params, cfg, batches, shapes)

    def merged_maps(cfg, plain, batch):
        return {"attn": tuple(
            llava_next_model.capture(params, c, batch)["attn"]
            for c in (cfg, plain))}

    phase_compare(7, "llava_next_vicuna_7b", llava_next_model.forward,
                  params, cfg, served, merged_maps)
    served["seq_len"] = S
    return served


def run_hpt(g: torch.Generator) -> dict:
    """Phases 11-12: the HPT-Air-1.5 serving forward."""
    cfg = hpt_config()
    params = grounding.init_params(cfg, g, "cuda")
    params["frozen"]["llm"].pop("lm_head")
    randomize_rel_pos(params, g)
    batches = hpt_batches(cfg, 4, "cuda")
    Hc, Wc = unet.output_hw(cfg.unet, (cfg.clip_shape, cfg.clip_shape))
    shapes = {"sam_logits": (BS, MASKS, 256, 256),
              "coarse_logits": (BS, MASKS, Hc, Wc),
              "iou_pred": (BS, MASKS), "boxes": (BS, MASKS, 4),
              "hidden": (BS, HPT_SEQ, cfg.llm.hidden_size)}
    served = phase_serve(11, "hpt_air_1_5", grounding.forward, params, cfg,
                         batches, shapes)

    def tower_and_sam(cfg, plain, batch):
        fro = params["frozen"]
        return {
            "vision_features": tuple(vit.forward(
                fro["vision"], c.vision, batch["pixel_values"],
                select_layer=c.vision_select_layer) for c in (cfg, plain)),
            "sam_embedding": tuple(sam_encoder.forward(
                fro["sam_encoder"], c.sam.encoder, batch["sam_pixel_values"])
                for c in (cfg, plain))}

    phase_compare(12, "hpt_air_1_5", grounding.forward, params, cfg, served,
                  tower_and_sam)
    served["seq_len"] = HPT_SEQ
    return served


def _flat_grads(grads: dict, path: str) -> torch.Tensor:
    """One subtree's gradients as one f32 vector; leaves without one (the
    frozen pe_gaussian, heads the loss never reads) are left out."""
    return torch.cat([g.float().flatten() for p, g in grads.items()
                      if (p == path or p.startswith(path + "/"))
                      and g is not None])


def _zeros_like(tree):
    """A tree of zeros shaped like ``tree`` (a restore template)."""
    if isinstance(tree, dict):
        return {k: _zeros_like(v) for k, v in tree.items()}
    if isinstance(tree, list):
        return [_zeros_like(v) for v in tree]
    return torch.zeros_like(tree)


def _clone_tree(tree: dict, device=None) -> dict:
    return {p: t.detach().to(device or t.device, copy=True)
            for p, t in train_loop.tree_leaves(tree)}


def _run_steps(step, state, frozen, batches) -> tuple[list, float]:
    """Steps over ``batches``; (per-step metrics as floats, ms per step)."""
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    metrics = [step(state, frozen, b)[1] for b in batches]
    torch.cuda.synchronize()
    ms = (time.perf_counter() - t0) * 1e3 / len(batches)
    metrics = [{k: float(v) for k, v in m.items()} for m in metrics]
    for i, m in enumerate(metrics):
        if not (math.isfinite(m["loss"]) and math.isfinite(m["grad_norm"])):
            raise AssertionError(f"step {i}: non-finite loss or grad_norm "
                                 f"{m['loss']} {m['grad_norm']}")
    return metrics, ms


def run_train(g: torch.Generator) -> dict:
    """Phases 8-10: the DeepSeek-VL-1.3B heads trained at the SAM-448
    schedule through the port's train step."""
    path = "deepseek_vl_1_3b_train_sam448"
    cfg = registry.with_sam_size(deepseek_vl.deepseek_vl_1_3b(), TRAIN_SAM)
    params = grounding.init_params(cfg, g, "cuda")
    params["frozen"]["llm"].pop("lm_head")  # the loss never reads it
    randomize_rel_pos(params, g)
    frozen = params["frozen"]
    batches = [from_jax(synthetic_batch(cfg, batch_size=TRAIN_BS, seed=i),
                        "cuda") for i in range(1 + TRAIN_STEPS)]
    opt = train_loop.make_optimizer(train_loop.OptimConfig(
        lr=TRAIN_LR, total_steps=2 * (1 + TRAIN_STEPS)))
    state = train_loop.init_state(params["trainable"], opt)
    result = train_phase(path, cfg, opt, state, frozen, batches)
    result.update(compare_train_phase(path, cfg, opt, state, frozen,
                                      batches))
    repeated_batch_phase(path, cfg, state, frozen, batches[1])
    return result


def train_phase(path, cfg, opt, state, frozen, batches) -> dict:
    """Phase 8: a warm-up and the timed steps with their launch counts,
    every trainable subtree changed, the frozen tree untouched, and a
    checkpoint round trip."""
    step = train_loop.make_train_step(
        lambda p, b: grounding.loss_fn(p, cfg, b), opt)
    # on the host, so the copy does not count in the steps' peak memory
    frozen_before = _clone_tree(frozen, "cpu")
    trainable_before = _clone_tree(state["params"])
    warm, _ = _run_steps(step, state, frozen, batches[:1])
    for fn in WRAPPERS.values():
        fn.launches = 0
    torch.cuda.reset_peak_memory_stats()
    metrics, ms = _run_steps(step, state, frozen, batches[1:])
    launches = {name: fn.launches for name, fn in WRAPPERS.items()}
    peak_gb = torch.cuda.max_memory_allocated() / 1e9
    want = {k: n * TRAIN_STEPS for k, n in EXPECTED_LAUNCHES[path].items()}
    log(f"phase 8 train {path}: {TRAIN_STEPS} steps at bs {TRAIN_BS} after "
        f"one warm-up, loss {[round(m['loss'], 4) for m in warm + metrics]} "
        f"grad_norm {[round(m['grad_norm'], 4) for m in warm + metrics]}; "
        f"launches {launches} (expected {want}); peak memory "
        f"{peak_gb:.2f} GB")
    if launches != want:
        raise AssertionError("kernel launch counts differ from the main path")
    after = _clone_tree(state["params"])
    for sub in SUBTREES:
        if all(torch.equal(t, trainable_before[p]) for p, t in after.items()
               if p == sub or p.startswith(sub + "/")):
            raise AssertionError(f"trainable subtree {sub} did not change")
    for p, t in train_loop.tree_leaves(frozen):
        if t.requires_grad or not torch.equal(t.cpu(), frozen_before[p]):
            raise AssertionError(f"frozen leaf {p} changed or needs grad")
    log(f"phase 8 train {path}: every trainable subtree {SUBTREES} changed, "
        "the frozen tree is bit for bit unchanged")

    with tempfile.TemporaryDirectory() as tmp:
        ckpt.save(pathlib.Path(tmp) / f"step_{state['step']}", state)
        template = train_loop.init_state(_zeros_like(state["params"]), opt)
        restored = ckpt.restore(ckpt.latest(tmp), template)
    for (p, a), (_, b) in zip(train_loop.tree_leaves(state),
                              train_loop.tree_leaves(restored)):
        same = torch.equal(a, b) if isinstance(a, torch.Tensor) else a == b
        if not same:
            raise AssertionError(f"checkpoint round trip changed {p}")
    log(f"phase 8 train {path}: checkpoint save / restore round trip of "
        f"step {state['step']} holds")
    return {"ms": ms, "launches": launches, "peak_gb": peak_gb,
            "bs": TRAIN_BS, "n": TRAIN_STEPS, "unit": "step"}


def compare_train_phase(path, cfg, opt, state, frozen, batches) -> dict:
    """Phase 9: the loss and gradients of one step from the trained state
    on the kernel path and the all-plain path, then the plain path's step
    time.  The U-Net's gradient through the SAM loss is ill-conditioned
    where coarse logits sit near 0 (the mask downscaler's LayerNorm over 4
    channels of a locally flat dense prompt), so it is compared at the
    state the timed steps leave, not after the repeated-batch phase."""
    plain = _plain_config(cfg)
    batch = batches[1]
    (loss_k, _), grads_k = train_loop.value_and_grad(
        lambda p, b: grounding.loss_fn(p, cfg, b), frozen, state["params"],
        batch)
    (loss_p, _), grads_p = train_loop.value_and_grad(
        lambda p, b: grounding.loss_fn(p, plain, b), frozen, state["params"],
        batch)
    rel = abs(float(loss_k) - float(loss_p)) / abs(float(loss_p))
    log(f"phase 9 {path}: kernel vs plain step loss {float(loss_k):.6f} vs "
        f"{float(loss_p):.6f}, rel diff {rel:.3e} (bound {STEP_LOSS_REL})")
    if rel > STEP_LOSS_REL:
        raise AssertionError("the kernel step's loss disagrees with the "
                             "plain step's")
    for sub in SUBTREES:
        _, corr = agreement(_flat_grads(grads_k, sub),
                            _flat_grads(grads_p, sub))
        log(f"phase 9 {path}: gradient of {sub}: corr {corr:.6f} (bound "
            f"{STEP_GRAD_CORR})")
        if corr < STEP_GRAD_CORR:
            raise AssertionError(f"the kernel step's gradient of {sub} "
                                 "disagrees with the plain step's")
    del grads_k, grads_p
    plain_step = train_loop.make_train_step(
        lambda p, b: grounding.loss_fn(p, plain, b), opt)
    _run_steps(plain_step, state, frozen, batches[:1])
    torch.cuda.reset_peak_memory_stats()
    _, plain_ms = _run_steps(plain_step, state, frozen, batches[1:])
    return {"plain_ms": plain_ms,
            "plain_peak_gb": torch.cuda.max_memory_allocated() / 1e9}


def repeated_batch_phase(path, cfg, state, frozen, batch) -> None:
    """Phase 10: steps on one repeated batch (the recipe's lr, no warmup)
    lower its loss."""
    opt = train_loop.make_optimizer(train_loop.OptimConfig(
        lr=TRAIN_LR, total_steps=REPEATED_STEPS, warmup_ratio=0.0))
    step = train_loop.make_train_step(
        lambda p, b: grounding.loss_fn(p, cfg, b), opt)
    metrics, _ = _run_steps(step, train_loop.init_state(state["params"], opt),
                            frozen, [batch] * REPEATED_STEPS)
    losses = [m["loss"] for m in metrics]
    log(f"phase 10 train {path}: {REPEATED_STEPS} steps on one batch (lr "
        f"{TRAIN_LR}, no warmup): loss {[round(x, 4) for x in losses]}")
    if not losses[-1] < losses[0]:
        raise AssertionError("the repeated batch's loss did not fall")


def main() -> None:
    card = phase_card()
    phase_build()
    g = torch.Generator(device="cuda").manual_seed(0)
    g_hpt = torch.Generator(device="cuda").manual_seed(1)
    kernels = phase_kernels(g, g_hpt)
    paths = {"deepseek_vl_1_3b": run_deepseek(g)}
    torch.cuda.empty_cache()
    paths["llava_next_vicuna_7b"] = run_llava_next(g)
    torch.cuda.empty_cache()
    paths["deepseek_vl_1_3b_train_sam448"] = run_train(g)
    torch.cuda.empty_cache()
    paths["hpt_air_1_5"] = run_hpt(g_hpt)
    for path, r in paths.items():
        unit = r.get("unit", "forward")
        what = (f"{r['n']} steps" if unit == "step"
                else f"{len(r['requests'])} requests")
        log(f"phase 13 timing {path} ({card}): kernel path {r['ms']:.1f} "
            f"ms/{unit}, {r['bs'] * 1e3 / r['ms']:.2f} img/s, peak "
            f"{r['peak_gb']:.2f} GB; plain path {r['plain_ms']:.1f} "
            f"ms/{unit}, {r['bs'] * 1e3 / r['plain_ms']:.2f} img/s, peak "
            f"{r['plain_peak_gb']:.2f} GB (bs {r['bs']}, mean of {what} "
            "after one warm-up)")
    log(json.dumps({"kernels": [
        {"name": name, "route": "cuda", "source": SOURCES[name][0],
         "replaces": SOURCES[name][1],
         "launches": sum(r["launches"][name] for r in paths.values()),
         "launches_by_path": {p: r["launches"][name]
                              for p, r in paths.items()},
         **kernels[name]} for name in WRAPPERS]}))
    log(card)
    log(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))


if __name__ == "__main__":
    main()
