"""The plain versions of the port's four main-path kernels against the JAX
package's Pallas kernels run through the Pallas interpreter on the CPU (as
tests/test_fused_block.py, test_sam_flash.py and test_window_block.py run
them), in f32, inputs from a seeded numpy generator.

The CUDA kernels themselves run only on the card: chip_smoke.py holds each
one against these plain versions at the main path's shapes.  Here every
wrapper is also called with CPU tensors, where it must return its plain
version's result and launch nothing.

Tolerances: f32 with different summation orders; the TPU kernels compute
GELU through a rational erf (|error| <= 1.5e-7) and the attention kernels a
base-2 softmax over log2(e)-scaled operands, which the plain versions
compute in natural base -- atol 1e-4 / rtol 1e-4 covers both at these
magnitudes.
"""

import math

import numpy as np
import jax.numpy as jnp
import pytest
import torch

from flmm_tpu.ops import fused_block as jfb
from flmm_tpu.ops import sam_flash as jsf
from flmm_tpu.ops import window_block as jwb
from flmm_tpu_torch.ops import fused_block, sam_flash, window_block
from flmm_tpu_torch.ops import flash_attention

ATOL = RTOL = 1e-4


def _r(rng, *shape, scale=1.0, shift=0.0):
    return (rng.standard_normal(shape) * scale + shift).astype(np.float32)


def _t(*arrays):
    return [torch.from_numpy(a) for a in arrays]


def _close(got, want):
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=ATOL,
                               rtol=RTOL)


def _block_weights(rng, C, F):
    return dict(
        lw=_r(rng, C, scale=0.1, shift=1.0), lb=_r(rng, C, scale=0.1),
        wo=_r(rng, C, C, scale=C ** -0.5), bo=_r(rng, C, scale=0.1),
        w1=_r(rng, C, F, scale=C ** -0.5), b1=_r(rng, F, scale=0.1),
        w2=_r(rng, F, C, scale=F ** -0.5), b2=_r(rng, C, scale=0.1))


def test_fused_ln_qkv_plain_matches_pallas():
    rng = np.random.default_rng(0)
    C, P = 128, 384
    x = _r(rng, 2, 156, C)  # 312 rows: not a multiple of the TPU block
    lw, lb = _r(rng, C, scale=0.1, shift=1.0), _r(rng, C, scale=0.1)
    w, b = _r(rng, C, P, scale=C ** -0.5), _r(rng, P, scale=0.1)
    want = jfb.fused_ln_qkv(*map(jnp.asarray, (x, lw, lb, w, b)),
                            block_n=128, interpret=True)
    _close(fused_block.fused_ln_qkv_plain(*_t(x, lw, lb, w, b)), want)


@pytest.mark.parametrize("act", fused_block.ACTS)
def test_fused_proj_ln_mlp_plain_matches_pallas(act):
    rng = np.random.default_rng(1)
    C, F = 128, 512
    s, a = _r(rng, 312, C), _r(rng, 312, C)
    p = _block_weights(rng, C, F)
    args = (s, a, p["wo"], p["bo"], p["lw"], p["lb"], p["w1"], p["b1"],
            p["w2"], p["b2"])
    want = jfb.fused_proj_ln_mlp(*map(jnp.asarray, args), block_n=128,
                                 block_f=256, act=act, interpret=True)
    _close(fused_block.fused_proj_ln_mlp_plain(*_t(*args), act=act), want)


@pytest.mark.parametrize("side", [8, 10])  # 10: S = 100, keys lane-padded
def test_sam_global_attention_plain_matches_pallas_v8(side, monkeypatch):
    """Query rows in chunks of 16, as the full-size plain version chunks
    them at 256 rows."""
    rng = np.random.default_rng(2)
    G, hd = 4, 16
    S = side * side
    q, k, v = (_r(rng, G, S, hd) for _ in range(3))
    rph, rpw = (_r(rng, 2 * side - 1, hd, scale=0.3) for _ in range(2))
    want = jsf.sam_global_attention_v8(
        *map(jnp.asarray, (q, k, v, rph, rpw)), side, interpret=True,
        block_q=64, chunks=2)
    monkeypatch.setattr(sam_flash, "MAX_PLAIN_SCORES", G * S * 16)
    got = sam_flash.sam_global_attention_v8_plain(*_t(q, k, v, rph, rpw),
                                                  side)
    _close(got, want)


def test_global_bias_rows_match_jax_augmented_operands():
    rng = np.random.default_rng(3)
    side, G, hd = 6, 3, 8
    q = _r(rng, G, side * side, hd)
    rph, rpw = _r(rng, 2 * side - 1, hd), _r(rng, 2 * side - 1, hd)
    a, _, _ = jsf._global_augmented_operands(
        *map(jnp.asarray, (q, q, q, rph, rpw)), side, log2_domain=True)
    want = np.asarray(a)[..., hd:hd + 2 * side]
    _close(sam_flash.global_bias_rows(*_t(q, rph, rpw), side), want)


@pytest.mark.parametrize("padded", [False, True])
def test_window_block_plain_matches_pallas(padded):
    """The whole-block kernel in interpret mode at the size of
    tests/test_window_block.py; ``padded`` marks ~30% of the tokens as
    geometric pad slots (zeroed normed rows, kept in the softmax)."""
    rng = np.random.default_rng(4)
    side, nh, hd = 7, 4, 16
    T, C, F, NW = side * side, nh * hd, 128, 3
    x = _r(rng, NW, T, C, scale=0.5)
    wqkv, bqkv = _r(rng, C, 3 * C, scale=0.2), _r(rng, 3 * C, scale=0.1)
    p = _block_weights(rng, C, F)
    l2w, l2b = _r(rng, C, scale=0.1, shift=1.0), _r(rng, C, scale=0.1)
    rph, rpw = (_r(rng, 2 * side - 1, hd, scale=0.1) for _ in range(2))
    valid = rng.random((NW, T)) > 0.3 if padded else None

    jw_s, jb_s = jwb.scaled_qkv_weights(jnp.asarray(wqkv), jnp.asarray(bqkv),
                                        nh, hd)
    jvalid = None if valid is None else jnp.asarray(valid)
    jbias = jwb.window_rel_bias_from_x(
        jnp.asarray(x), jvalid, jnp.asarray(p["lw"]), jnp.asarray(p["lb"]),
        jw_s[:, :C], jb_s[:C], jnp.asarray(rph), jnp.asarray(rpw), side, nh,
        hd)
    want = jwb.window_block(
        jnp.asarray(x), jbias, jvalid, jnp.asarray(p["lw"]),
        jnp.asarray(p["lb"]), jw_s, jb_s,
        *map(jnp.asarray, (p["wo"], p["bo"], l2w, l2b, p["w1"], p["b1"],
                           p["w2"], p["b2"])),
        side, nh, n_f=2, group=1, interpret=True)

    w_s, b_s = window_block.scaled_qkv_weights(*_t(wqkv, bqkv), nh, hd)
    _close(w_s, jw_s)
    tvalid = None if valid is None else torch.from_numpy(valid)
    bias = window_block.window_rel_bias_from_x(
        torch.from_numpy(x), tvalid, *_t(p["lw"], p["lb"]), w_s[:, :C],
        b_s[:C], *_t(rph, rpw), side, nh, hd)
    _close(bias, jbias)
    got = window_block.window_block_plain(
        torch.from_numpy(x), bias, tvalid, *_t(p["lw"], p["lb"]), w_s, b_s,
        *_t(p["wo"], p["bo"], l2w, l2b, p["w1"], p["b1"], p["w2"], p["b2"]),
        side, nh)
    _close(got, want)


def _wrapper_cases(rng):
    C, F, side, nh = 64, 128, 4, 4
    hd = C // nh
    p = _block_weights(rng, C, F)
    x, a = _r(rng, 2, 16, C), _r(rng, 2, 16, C)
    q, k, v = (_r(rng, 8, 16, 16) for _ in range(3))
    rph = _r(rng, 2 * side - 1, hd, scale=0.1)
    wqkv, bqkv = _r(rng, C, 3 * C, scale=0.2), _r(rng, 3 * C, scale=0.1)
    xw = _r(rng, 2, side * side, C)
    xw3 = _r(rng, 2, side * side, 3 * C)
    bias = _r(rng, 2, nh, side * side, 2 * side, scale=0.1)
    valid = rng.random((2, side * side)) > 0.2
    fq, fkv = _r(rng, 2, 4, 256, 16), _r(rng, 2, 2, 256, 16)
    fvalid = rng.random((2, 256)) > 0.2
    fids = np.full((2, 256), -1)
    fids[:, 200:205] = 0
    fmm = torch.nn.functional.one_hot(torch.from_numpy(fids) + 1, 3)[
        ..., 1:].float() / 5
    t = {k_: torch.from_numpy(v_) for k_, v_ in p.items()}
    blk = (t["wo"], t["bo"], t["lw"], t["lb"], t["w1"], t["b1"], t["w2"],
           t["b2"])
    return {
        "fused_ln_qkv": (fused_block.fused_ln_qkv,
                         fused_block.fused_ln_qkv_plain,
                         (*_t(x, p["lw"], p["lb"], wqkv, bqkv),)),
        "fused_proj_ln_mlp": (fused_block.fused_proj_ln_mlp,
                              fused_block.fused_proj_ln_mlp_plain,
                              (*_t(x, a), *blk)),
        "sam_global_attention_v8": (
            sam_flash.sam_global_attention_v8,
            sam_flash.sam_global_attention_v8_plain,
            (*_t(q, k, v, rph, rph), side)),
        "window_block": (
            window_block.window_block, window_block.window_block_plain,
            (*_t(xw, bias, valid, p["lw"], p["lb"], wqkv, bqkv), *blk[:2],
             t["lw"], t["lb"], *blk[4:], side, nh)),
        "flash_attention_with_merged_capture": (
            flash_attention.flash_attention_with_merged_capture,
            flash_attention.flash_attention_with_merged_capture_plain,
            (*_t(fq, fkv, fkv, fvalid), fmm, 128, 100)),
        # (NW, nh, T, hd) views of a windowised qkv, as the encoder calls it
        "sam_window_attention_v9": (
            sam_flash.sam_window_attention_v9,
            sam_flash.sam_window_attention_v9_plain,
            (*(t.reshape(2, side * side, nh, C // nh).transpose(1, 2)
               for t in torch.from_numpy(xw3).split(C, dim=-1)),
             *_t(rph, rph), side)),
    }


WRAPPERS = ["fused_ln_qkv", "fused_proj_ln_mlp", "sam_global_attention_v8",
            "window_block", "flash_attention_with_merged_capture",
            "sam_window_attention_v9"]


@pytest.mark.parametrize("name", WRAPPERS)
def test_wrapper_takes_plain_version_on_cpu_and_launches_nothing(name):
    wrapper, plain, args = _wrapper_cases(np.random.default_rng(5))[name]
    before = wrapper.launches
    got = wrapper(*args)
    assert wrapper.launches == before
    torch.testing.assert_close(got, plain(*args), rtol=0, atol=0)
    for out in got if isinstance(got, tuple) else (got,):
        assert torch.isfinite(out).all()


def test_scaled_qkv_weights_fold_scale_and_log2e_into_q_only():
    rng = np.random.default_rng(6)
    nh, hd = 2, 8
    C = nh * hd
    w, b = _r(rng, C, 3 * C), _r(rng, 3 * C)
    w_s, b_s = window_block.scaled_qkv_weights(*_t(w, b), nh, hd)
    f = math.log2(math.e) / math.sqrt(hd)
    np.testing.assert_allclose(w_s[:, :C].numpy(), w[:, :C] * f, rtol=1e-6)
    np.testing.assert_array_equal(w_s[:, C:].numpy(), w[:, C:])
    np.testing.assert_allclose(b_s[:C].numpy(), b[:C] * f, rtol=1e-6)


@pytest.mark.parametrize("name", WRAPPERS)
def test_wrapper_refuses_inputs_that_require_grad(name):
    """The kernels have no backward, so no wrapper may be differentiated
    through -- on the CPU too, where the plain version would differentiate
    and hide what the CUDA launch would cut."""
    wrapper, _, args = _wrapper_cases(np.random.default_rng(7))[name]
    args = list(args)
    args[0] = args[0].clone().requires_grad_(True)
    with pytest.raises(RuntimeError, match="requires grad"):
        wrapper(*args)
    with torch.no_grad():
        wrapper(*args)
    assert wrapper.launches == 0
