"""The port's global attention variants v1, v2, v3, v4, v6, v7 and v11 (K12)
against the JAX package's Pallas kernels in interpret mode on the CPU, and
the SAM encoder's ``global_kernel`` switch.

Inputs come from seeded numpy generators and go to both sides.  On CPU
tensors each wrapper takes its plain version and launches nothing; the CUDA
kernel (csrc/relpos_attention_sm90.cu in a ``SOFTMAX_*`` mode) runs only on
the card, where chip_smoke.py holds it against these plain versions.

Tolerances: 2e-4 in f32 (other summation orders; the TPU kernels take the
bias out of one augmented product, the plain versions add it to the f32
scores); 2e-2 in bf16 (q, the bias rows and the probabilities are rounded to
8 bits of mantissa on both sides, at the same places); 1e-3 for the encoder.
v1 and v2 round their bias rows to bf16 for f32 inputs too, on both sides;
through the encoder the two sides compute those rows from a q that differs
in its last f32 bits, so now and then a row lands one bf16 step apart: 1e-2
there.  v4 rounds its scores, their distance to the row max and ``p`` to
bf16 by contract, but for f32 inputs the CPU compiler behind interpret mode
drops the rounding of ``p`` (an f32 -> bf16 -> f32 conversion pair in front
of an f32 product), which the port's plain version keeps: 5e-3 in f32
(measured 2.5e-3 on outputs of magnitude 3), 2e-2 in bf16 like the others
(measured 2e-3, one bf16 step), where both sides round ``p``.
"""

import dataclasses
import functools

import numpy as np
import jax
import jax.numpy as jnp
import pytest
import torch

from flmm_tpu.models.sam import image_encoder as jencoder
from flmm_tpu.ops import sam_flash as jsf
from flmm_tpu.ops import sam_flash_experiments as jsfx
from flmm_tpu_torch.convert.from_jax import from_jax
from flmm_tpu_torch.models.sam import image_encoder as encoder
from flmm_tpu_torch.ops import sam_flash
from flmm_tpu_torch.ops import sam_flash_experiments as sfx

F32_TOL, BF16_TOL, ENCODER_TOL = 2e-4, 2e-2, 1e-3
NAMES = ("v1", "v2", "v3", "v4", "v6", "v7", "v11")
F32_TOLS = {"v4": 5e-3}  # the others: F32_TOL
ENCODER_TOLS = {"v1": 1e-2, "v2": 1e-2, "v4": 1e-2}  # the others: ENCODER_TOL


def _r(rng, *shape, scale=1.0):
    return (rng.standard_normal(shape) * scale).astype(np.float32)


def _inputs(seed, G, side, hd, scale=0.3):
    rng = np.random.default_rng(seed)
    q, k, v = (_r(rng, G, side * side, hd) for _ in range(3))
    rph, rpw = (_r(rng, 2 * side - 1, hd, scale=scale) for _ in range(2))
    return q, k, v, rph, rpw


def _stem(name):
    return "sam_global_attention" + ("" if name == "v1" else f"_{name}")


def _pair(name):
    return (getattr(sfx, _stem(name)), getattr(sfx, _stem(name) + "_plain"),
            getattr(jsfx, _stem(name)))


@pytest.mark.parametrize("name, side", [(n, 16) for n in NAMES] + [
    ("v11", 14), ("v1", 14)])
def test_wrapper_on_cpu_matches_pallas_interpret_f32(name, side):
    """hd 64 as on the card; side 14 is v11's padded case (S = 196 keys,
    lane-padded to 256 and masked on the TPU) and one whole tile for v1."""
    wrapper, _, jfn = _pair(name)
    args = _inputs(0, 2, side, 64)
    want = jfn(*map(jnp.asarray, args), side, interpret=True)
    got = wrapper(*map(torch.from_numpy, args), side)
    assert got.dtype == torch.float32 and tuple(got.shape) == want.shape
    tol = F32_TOLS.get(name, F32_TOL)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=tol,
                               rtol=tol)
    assert wrapper.launches == 0


@pytest.mark.parametrize("name", NAMES)
def test_wrapper_on_cpu_matches_pallas_interpret_bf16(name):
    wrapper, _, jfn = _pair(name)
    args = _inputs(1, 2, 16, 64)
    want = jfn(*(jnp.asarray(a, jnp.bfloat16) for a in args), 16,
               interpret=True)
    got = wrapper(*(torch.from_numpy(a).bfloat16() for a in args), 16)
    assert got.dtype == torch.bfloat16
    np.testing.assert_allclose(got.float().numpy(),
                               np.asarray(want.astype(jnp.float32)),
                               atol=BF16_TOL, rtol=BF16_TOL)


@pytest.mark.parametrize("name", NAMES)
def test_wrapper_is_its_plain_version_on_cpu_whatever_the_chunking(
        name, monkeypatch):
    wrapper, plain, _ = _pair(name)
    args = [torch.from_numpy(a).bfloat16() for a in _inputs(2, 3, 8, 16)]
    whole = wrapper(*args, 8)
    assert torch.equal(whole, plain(*args, 8))
    monkeypatch.setattr(sam_flash, "MAX_PLAIN_SCORES", 3 * 64 * 16)
    assert torch.allclose(plain(*args, 8).float(), whole.float(), atol=1e-2)
    assert wrapper.launches == 0


def test_v3_and_v6_are_one_function_and_differ_from_v7_in_rounding():
    args = [torch.from_numpy(a).bfloat16() for a in _inputs(3, 2, 8, 64)]
    v3 = sfx.sam_global_attention_v3(*args, 8)
    assert torch.equal(v3, sfx.sam_global_attention_v6(*args, 8))
    v7 = sfx.sam_global_attention_v7(*args, 8)
    # natural vs log2-domain operands: q and the bias rows are rounded to
    # bf16 at other values, so the two differ by a few bf16 steps
    assert not torch.equal(v3, v7)
    assert torch.allclose(v3.float(), v7.float(), atol=2 * BF16_TOL,
                          rtol=2 * BF16_TOL)
    # with the max subtracted or not, the same function below the overflow
    assert torch.allclose(v7.float(), sfx.sam_global_attention_v11(
        *args, 8).float(), atol=BF16_TOL, rtol=BF16_TOL)


def test_v11_precondition_a_score_above_128_is_non_finite_in_both():
    """Row 0 of head 0 holds a log2-domain score of about 200 * log2(e):
    without the max, exp2 overflows, in the TPU kernel and in the port."""
    q, k, v, rph, rpw = _inputs(4, 2, 8, 64, scale=0.0)
    q[0, 0], k[0, 5] = 5.0, 5.0  # q . k * scale = 64 * 25 / 8 = 200 nats
    want = np.asarray(jsfx.sam_global_attention_v11(
        *map(jnp.asarray, (q, k, v, rph, rpw)), 8, interpret=True))
    got = sfx.sam_global_attention_v11(
        *map(torch.from_numpy, (q, k, v, rph, rpw)), 8).numpy()
    assert not np.isfinite(want[0, 0]).all()
    assert not np.isfinite(got[0, 0]).all()
    assert np.isfinite(want[1]).all() and np.isfinite(got[1]).all()
    # the max-subtracting variants stay finite on the same input
    assert torch.isfinite(sfx.sam_global_attention_v7(
        *map(torch.from_numpy, (q, k, v, rph, rpw)), 8)).all()


@pytest.mark.parametrize("name", NAMES)
def test_wrong_shapes_and_inputs_that_require_grad_raise(name):
    wrapper, _, _ = _pair(name)
    q, k, v, rph, rpw = map(torch.from_numpy, _inputs(5, 2, 8, 16))
    with pytest.raises(ValueError, match="side"):
        wrapper(q, k, v, rph, rpw, 7)  # S != side ** 2
    with pytest.raises(ValueError):
        wrapper(q, k[:, :32], v, rph, rpw, 8)
    with pytest.raises(ValueError):
        wrapper(q[None], k[None], v[None], rph, rpw, 8)  # not (G, S, hd)
    # S = 36 is no multiple of 8: the TPU tiling of v3, v4, v6 and v7 refuses
    # it, v11 pads and masks, v1 and v2 take it as one whole tile
    small = [torch.from_numpy(a) for a in _inputs(6, 2, 6, 16)]
    if name in ("v11", "v1", "v2"):
        assert tuple(wrapper(*small, 6).shape) == (2, 36, 16)
    else:
        with pytest.raises(ValueError, match="S % 8"):
            wrapper(*small, 6)
    for i in range(5):
        bad = [q, k, v, rph, rpw]
        bad[i] = bad[i].clone().requires_grad_()
        with pytest.raises(RuntimeError, match="requires grad"):
            wrapper(*bad, 8)
        with torch.no_grad():
            wrapper(*bad, 8)
    assert wrapper.launches == 0


def test_v1_and_v2_mirror_the_tile_preconditions_of_their_jax_functions():
    """SAM-768's 48 x 48 grid: 2304 tokens are no multiple of v1's query
    tile of 512, and are 9 of v2's 256; 40 x 40 = 1600 tokens are no
    multiple of 256 either."""
    big = [torch.from_numpy(a) for a in _inputs(12, 1, 48, 8)]
    with pytest.raises(ValueError, match=r"min\(512, S\)"):
        sfx.sam_global_attention(*big, 48)
    with pytest.raises(AssertionError):
        jsfx.sam_global_attention(*(jnp.asarray(a.numpy()) for a in big), 48,
                                  interpret=True)
    assert tuple(sfx.sam_global_attention_v2(*big, 48).shape) == (1, 2304, 8)
    assert torch.isfinite(sfx.sam_global_attention_v4(*big, 48)).all()
    odd = [torch.from_numpy(a) for a in _inputs(13, 1, 40, 8)]
    with pytest.raises(ValueError, match=r"min\(256, S\)"):
        sfx.sam_global_attention_v2(*odd, 40)
    with pytest.raises(AssertionError):
        jsfx.sam_global_attention_v2(*(jnp.asarray(a.numpy()) for a in odd),
                                     40, interpret=True)
    # a key tile of 1024 that holds no whole number of grid rows: side 36
    with pytest.raises(ValueError, match="multiple of side"):
        sfx.sam_global_attention(
            *(torch.zeros(s) for s in ((1, 1296, 8),) * 3 + ((71, 8),) * 2),
            36)


def test_v1_v2_round_their_bias_rows_to_bf16_and_v4_its_scores():
    """For f32 inputs v3 is exact to f32, v1 and v2 carry the 8 bits of
    their bias rows (flmm_tpu/ops/sam_flash_experiments.py:1097-1098,
    :767-768) and v4 those of its scores and probabilities; on bf16 inputs
    at head_dim 64 (``scale`` = 2**-3) v1, v2 and v3 are one function."""
    args = [torch.from_numpy(a) for a in _inputs(14, 2, 8, 64, scale=1.0)]
    exact = sam_flash.sam_global_attention_v8_plain(*args, 8)
    dev = {n: (_pair(n)[0](*args, 8) - exact).abs().max().item()
           for n in ("v1", "v2", "v3", "v4")}
    assert dev["v3"] < 1e-5
    assert 1e-4 < dev["v1"] < 1e-1 and 1e-4 < dev["v2"] < 1e-1
    # bias terms of some 8 units make scores of some 30: a bf16 step of 0.1
    assert 1e-4 < dev["v4"] < 0.5
    bf16 = [torch.from_numpy(a).bfloat16() for a in _inputs(14, 2, 8, 64)]
    v3 = sfx.sam_global_attention_v3(*bf16, 8)
    assert torch.equal(sfx.sam_global_attention_v2(*bf16, 8), v3)
    assert torch.equal(sfx.sam_global_attention(*bf16, 8), v3)
    v4 = sfx.sam_global_attention_v4(*bf16, 8)
    assert not torch.equal(v4, v3)
    # a score of 10 moves by up to 0.02 when rounded to bf16, its weight by
    # 2%: measured 0.04 on outputs of magnitude 3 over these 64 keys
    assert torch.allclose(v4.float(), v3.float(), atol=0.1, rtol=0.1)


def test_natural_bias_rows_match_the_jax_v3_operands():
    """v3 / v6 hand their kernel the bias rows without log2(e)."""
    q, _, _, rph, rpw = _inputs(7, 3, 6, 8, scale=1.0)
    rows = sam_flash.global_bias_rows(*map(torch.from_numpy, (q, rph, rpw)),
                                      6, log2_domain=False)
    log2_rows = sam_flash.global_bias_rows(
        *map(torch.from_numpy, (q, rph, rpw)), 6)
    assert torch.allclose(rows * sam_flash.LOG2E, log2_rows, atol=1e-5)
    coords = np.arange(6)[:, None] - np.arange(6)[None, :] + 5
    qg = q.reshape(3, 6, 6, 8)
    want = np.concatenate([
        np.einsum("gyxd,ykd->gyxk", qg, rph[coords]),
        np.einsum("gyxd,xkd->gyxk", qg, rpw[coords])], -1).reshape(3, 36, 12)
    np.testing.assert_allclose(rows.numpy(), want, atol=1e-5)


# --- the encoder's global_kernel switch ------------------------------------

ENC = dict(img_size=128, patch_size=8, embed_dim=64, depth=2, num_heads=2,
           out_chans=16, window_size=8, global_attn_indexes=(1,))


class _TpuBackend:
    """The ``jax`` module as the JAX encoder sees it, claiming a TPU, so its
    gates take the kernel path; the kernels themselves are patched to
    interpret mode."""

    def __getattr__(self, name):
        return getattr(jax, name)

    @staticmethod
    def default_backend():
        return "tpu"


def _interpret_kernels(monkeypatch):
    for name in NAMES:
        fn = getattr(jsfx, _stem(name))
        monkeypatch.setattr(jsfx, _stem(name),
                            functools.partial(fn, interpret=True))


def _encoder_params(jcfg, seed):
    params = jax.device_get(jax.jit(lambda k: jencoder.init_params(
        jcfg, k))(jax.random.key(0)))
    rng = np.random.default_rng(seed)
    for bp in params["blocks"]:
        for key in ("rel_pos_h", "rel_pos_w"):
            bp[key] = _r(rng, *bp[key].shape, scale=0.1)
    return params


@pytest.mark.parametrize("name", NAMES)
def test_flash_global_core_matches_jax_kernel_in_interpret_mode(
        name, monkeypatch):
    _interpret_kernels(monkeypatch)
    jcfg = jencoder.SamEncoderConfig(dtype=jnp.float32, global_kernel=name,
                                     **ENC)
    tcfg = encoder.SamEncoderConfig(dtype=torch.float32, global_kernel=name,
                                    **ENC)
    bp = _encoder_params(jcfg, 8)["blocks"][1]
    qkv = _r(np.random.default_rng(9), 2, 16, 16, 3 * 64, scale=0.5)
    want = jencoder._flash_global_core(
        jnp.asarray(qkv), jax.tree.map(jnp.asarray, bp), jcfg)
    got = encoder._flash_global_core(torch.from_numpy(qkv), from_jax(bp),
                                     tcfg)
    tol = F32_TOLS.get(name, F32_TOL)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=tol,
                               rtol=tol)


@pytest.mark.parametrize("name", ("v8",) + NAMES)
def test_encoder_matches_jax_encoder_through_the_named_kernel(
        name, monkeypatch):
    """The JAX encoder with its global layer through the named Pallas kernel
    (interpret mode, the TPU gate forced open from here) against the port's
    encoder with the same ``global_kernel`` (plain path on CPU tensors)."""
    _interpret_kernels(monkeypatch)
    monkeypatch.setattr(jencoder, "jax", _TpuBackend())
    calls = []
    mod, attr = ((jsf, "sam_global_attention_v8") if name == "v8"
                 else (jsfx, _stem(name)))
    real = getattr(mod, attr)
    if name == "v8":
        real = functools.partial(real, interpret=True)
    monkeypatch.setattr(mod, attr,
                        lambda *a: (calls.append(1), real(*a))[1])
    jcfg = jencoder.SamEncoderConfig(dtype=jnp.float32, global_kernel=name,
                                     flash_global=True, **ENC)
    tcfg = encoder.SamEncoderConfig(dtype=torch.float32, global_kernel=name,
                                    flash_global=True, **ENC)
    params = _encoder_params(jcfg, 10)
    px = _r(np.random.default_rng(11), 2, 128, 128, 3, scale=0.5)
    want = jencoder.forward(jax.tree.map(jnp.asarray, params), jcfg,
                            jnp.asarray(px))
    assert calls == [1]  # the JAX side really took the kernel
    got = encoder.forward(from_jax(params), tcfg, torch.from_numpy(px))
    assert tuple(got.shape) == (2, 16, 16, 16)
    tol = ENCODER_TOLS.get(name, ENCODER_TOL)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=tol,
                               rtol=tol)


def test_global_layers_take_the_variants_only_on_a_multiple_of_128_tokens():
    """The JAX gate (flmm_tpu/models/sam/image_encoder.py, ``_block``): only
    v8 pads and masks, so at SAM-448 (28 x 28 = 784 tokens) the others run
    plain."""
    def gate(name, H, W, **kw):
        cfg = encoder.SamEncoderConfig(global_kernel=name, flash_global=True,
                                       **kw)
        return encoder.flash_gate(cfg, H, W, windowed=False)

    for name in ("v8",) + NAMES:
        assert gate(name, 64, 64) and gate(name, 16, 16)
        assert gate(name, 28, 28) == (name == "v8")
        assert not gate(name, 16, 8)  # not square
        cfg = encoder.SamEncoderConfig(global_kernel=name)
        assert not encoder.flash_gate(cfg, 64, 64, windowed=False)
    on = encoder.SamEncoderConfig(flash_window=True)
    assert encoder.flash_gate(on, 5, 7, windowed=True)
    assert not encoder.flash_gate(dataclasses.replace(on, flash_window=False),
                                  14, 14, windowed=True)


@pytest.mark.parametrize("field, name", [
    ("window_kernel", "v10"), ("window_kernel", "v11"),
    ("global_kernel", "v5"), ("global_kernel", "v9"),
    ("global_kernel", "v10")])
def test_unported_kernel_names_are_refused_by_name(field, name):
    """Every global and window name of the JAX package is ported; window
    v10 has another contract, and a name the JAX package does not have is
    refused as well."""
    with pytest.raises(NotImplementedError, match=f"{field} '{name}'"):
        encoder.SamEncoderConfig(**{field: name})
    for ok in ("v8",) + NAMES:
        assert encoder.SamEncoderConfig(global_kernel=ok).global_kernel == ok
    for ok in ("v1", "v2", "v3", "v4", "v5", "v6", "v7", "v8", "v9"):
        assert encoder.SamEncoderConfig(window_kernel=ok).window_kernel == ok


@pytest.mark.parametrize("name", ("v8",) + NAMES)
def test_ported_global_kernel_names_construct_and_resolve(name):
    cfg = encoder.SamEncoderConfig(global_kernel=name)
    assert cfg.global_kernel == name
    fn = encoder.GLOBAL_KERNELS[name]
    assert fn.launches == 0 and fn.__name__ == (
        "sam_global_attention_v8" if name == "v8" else _stem(name))
