"""The port's window attention variants v1, v2, v3, v4, v5, v6, v7 and v8 (K12)
against the JAX package's Pallas kernels in interpret mode on the CPU, and
the SAM encoder's ``window_kernel`` switch.

Inputs come from seeded numpy generators and go to both sides.  On CPU
tensors each wrapper takes its plain version and launches nothing; the CUDA
kernel (csrc/window_attention_sm90.cu with a ``MODE`` flag) runs only on the card,
where chip_smoke.py holds it against these plain versions.

Tolerances: 2e-4 in f32 (other summation orders; the TPU kernels expand the
bias by one-hot products or take it out of one augmented product, the plain
versions add it to the f32 scores; v1 and v6 round their bias rows to bf16
for f32 inputs too, and v2 its dense bias, on both sides); 2e-2 in bf16 (q,
the bias rows and the probabilities are rounded to 8 bits of mantissa on
both sides, at the same places); 1e-3 for the window core and the encoder.
v4 rounds every score to bf16 and takes ``exp`` in bf16 for f32 inputs too:
5e-3 in f32 (the compiler behind interpret mode may drop an f32 -> bf16 ->
f32 rounding pair in front of an f32 product; measured 2.1e-3), 2e-2 for
the encoder paths (the softmax weights carry about 0.4% of rounding).
"""

import copy
import dataclasses
import functools

import numpy as np
import jax
import jax.numpy as jnp
import pytest
import torch

from flmm_tpu.models.sam import image_encoder as jencoder
from flmm_tpu.ops import sam_flash_experiments as jsfx
from flmm_tpu_torch.convert.from_jax import from_jax
from flmm_tpu_torch.models.sam import image_encoder as encoder
from flmm_tpu_torch.ops import sam_flash
from flmm_tpu_torch.ops import sam_flash_experiments as sfx

F32_TOL, BF16_TOL, ENCODER_TOL = 2e-4, 2e-2, 1e-3
V4_F32_TOL, V4_ENCODER_TOL = 5e-3, 2e-2
NAMES = ("v1", "v2", "v6", "v7", "v8", "v3", "v4", "v5")
BF16_BIAS = ("v1", "v2", "v6")  # bias rounded to bf16 whatever q's dtype


def _r(rng, *shape, scale=1.0):
    return (rng.standard_normal(shape) * scale).astype(np.float32)


def _inputs(seed, G, side, hd, scale=0.3):
    rng = np.random.default_rng(seed)
    q, k, v = (_r(rng, G, side * side, hd) for _ in range(3))
    rph, rpw = (_r(rng, 2 * side - 1, hd, scale=scale) for _ in range(2))
    return q, k, v, rph, rpw


def _stem(name):
    return "sam_window_attention" + ("" if name == "v1" else f"_{name}")


def _pair(name):
    return (getattr(sfx, _stem(name)), getattr(sfx, _stem(name) + "_plain"),
            getattr(jsfx, _stem(name)))


@pytest.mark.parametrize("side, hd, G", [(7, 16, 3), (14, 64, 4)])
@pytest.mark.parametrize("name", NAMES)
def test_wrapper_on_cpu_matches_pallas_interpret_f32(name, side, hd, G):
    """The JAX tests' shape, and the card's window (T = 196 keys, padded to
    208 and masked on the TPU)."""
    wrapper, _, jfn = _pair(name)
    args = _inputs(0, G, side, hd)
    want = jfn(*map(jnp.asarray, args), side, interpret=True)
    got = wrapper(*map(torch.from_numpy, args), side)
    assert got.dtype == torch.float32 and tuple(got.shape) == want.shape
    tol = V4_F32_TOL if name == "v4" else F32_TOL
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=tol,
                               rtol=tol)
    assert wrapper.launches == 0


@pytest.mark.parametrize("name", NAMES)
def test_wrapper_on_cpu_matches_pallas_interpret_bf16(name):
    wrapper, _, jfn = _pair(name)
    args = _inputs(1, 4, 14, 64)
    want = jfn(*(jnp.asarray(a, jnp.bfloat16) for a in args), 14,
               interpret=True)
    got = wrapper(*(torch.from_numpy(a).bfloat16() for a in args), 14)
    assert got.dtype == torch.bfloat16
    np.testing.assert_allclose(got.float().numpy(),
                               np.asarray(want.astype(jnp.float32)),
                               atol=BF16_TOL, rtol=BF16_TOL)


def test_the_jax_kernels_pair_up_as_the_port_pairs_them():
    """What lets one Hopper kernel serve two names: the Pallas v7 and v8
    agree bit for bit, v1 and v6 to f32 rounding (the order of two
    additions); v1 and v7 are different functions."""
    args = [jnp.asarray(a) for a in _inputs(2, 4, 14, 64)]
    out = {n: np.asarray(_pair(n)[2](*args, 14, interpret=True))
           for n in NAMES}
    np.testing.assert_array_equal(out["v7"], out["v8"])
    # measured 1.1e-6 on outputs of magnitude 1.3: some ten f32 steps
    assert np.abs(out["v1"] - out["v6"]).max() <= 2e-6
    # f32 inputs: v1 rounds its bias rows to bf16, v7 keeps them f32
    assert np.abs(out["v1"] - out["v7"]).max() > 1e-5


def test_the_port_pairs_v7_with_v8_and_v1_with_v6_and_keeps_the_pairs_apart():
    f32 = [torch.from_numpy(a) for a in _inputs(3, 4, 14, 64)]
    assert torch.equal(sfx.sam_window_attention_v7(*f32, 14),
                       sfx.sam_window_attention_v8(*f32, 14))
    v1, v6 = (fn(*f32, 14) for fn in (sfx.sam_window_attention,
                                      sfx.sam_window_attention_v6))
    assert (v1 - v6).abs().max() <= 2e-6
    # f32 inputs: v1 rounds its bias rows to bf16, v7 keeps them f32
    assert (v1 - sfx.sam_window_attention_v7(*f32, 14)).abs().max() > 1e-5
    # bf16 inputs at head_dim 32: the scaled q is rounded to bf16 in v7 and
    # never in v1, so the two differ by a few bf16 steps
    bf16 = [torch.from_numpy(a).bfloat16() for a in _inputs(3, 4, 14, 32)]
    v1, v7 = (fn(*bf16, 14) for fn in (sfx.sam_window_attention,
                                       sfx.sam_window_attention_v7))
    assert not torch.equal(v1, v7)
    assert torch.allclose(v1.float(), v7.float(), atol=2 * BF16_TOL,
                          rtol=2 * BF16_TOL)


def test_at_head_dim_64_in_bf16_the_two_roundings_coincide():
    """``scale`` is 2**-3 at the card's head_dim, so scaling q commutes with
    rounding it to bf16 and with the f32 accumulation: v1 and v7 are then one
    function of bf16 inputs, and the port's plain versions agree bit for bit
    (the two Pallas kernels sum their scores in different orders and agree
    to a bf16 step).  What still separates the two Hopper instantiations is
    where q is read from, not what comes out."""
    args = _inputs(3, 4, 14, 64)
    bf16 = [torch.from_numpy(a).bfloat16() for a in args]
    assert torch.equal(sfx.sam_window_attention(*bf16, 14),
                       sfx.sam_window_attention_v7(*bf16, 14))
    jb = [jnp.asarray(a, jnp.bfloat16) for a in args]
    np.testing.assert_allclose(
        np.asarray(jsfx.sam_window_attention(*jb, 14, interpret=True)
                   .astype(jnp.float32)),
        np.asarray(jsfx.sam_window_attention_v7(*jb, 14, interpret=True)
                   .astype(jnp.float32)), atol=2 ** -8, rtol=2 ** -8)


def test_the_augmented_variants_are_v7s_function_but_where_they_round():
    """v3 is v7's function (the Pallas kernels sum the bias into the scores
    in another order; the plain versions agree bit for bit on bf16 inputs,
    where the pad keys' p is exactly 0); v5 rounds p before its denominator
    sums it, which only bf16 inputs see; v4 rounds scores and p to bf16
    whatever the inputs.  The -1e4 pad penalty of v4 / v5 is -9984 in
    bf16, on both sides."""
    args = _inputs(11, 4, 14, 64)
    jout = {n: np.asarray(_pair(n)[2](*map(jnp.asarray, args), 14,
                                      interpret=True)) for n in ("v3", "v7")}
    assert np.abs(jout["v3"] - jout["v7"]).max() <= 2e-6
    f32 = [torch.from_numpy(a) for a in args]
    out = {n: _pair(n)[0](*f32, 14) for n in ("v3", "v4", "v5", "v7")}
    assert (out["v3"] - out["v7"]).abs().max() <= 1e-6
    assert (out["v5"] - out["v3"]).abs().max() <= 1e-6
    # scores of up to ~10 rounded to 8 bits: a few % of a probability
    assert 1e-4 < (out["v4"] - out["v3"]).abs().max() < 0.1
    bf16 = [t.bfloat16() for t in f32]
    out = {n: _pair(n)[0](*bf16, 14) for n in ("v3", "v4", "v5", "v7")}
    assert torch.equal(out["v3"], out["v7"])
    for n, tol in (("v5", BF16_TOL), ("v4", 0.1)):
        assert not torch.equal(out[n], out["v3"])
        assert torch.allclose(out[n].float(), out["v3"].float(), atol=tol,
                              rtol=tol)
    assert torch.tensor(sfx.AUGMENTED_PAD["v4"], dtype=torch.bfloat16
                        ).item() == -9984.0
    assert float(jnp.asarray(-1e4, jnp.bfloat16)) == -9984.0


@pytest.mark.parametrize("name", NAMES)
def test_wrapper_is_its_plain_version_on_cpu_whatever_the_chunking(
        name, monkeypatch):
    wrapper, plain, _ = _pair(name)
    args = [torch.from_numpy(a).bfloat16() for a in _inputs(4, 5, 7, 16)]
    whole = wrapper(*args, 7)
    assert torch.equal(whole, plain(*args, 7))
    monkeypatch.setattr(sam_flash, "MAX_PLAIN_SCORES", 2 * 49 * 49)
    assert torch.equal(plain(*args, 7), whole)  # heads are independent
    assert wrapper.launches == 0


@pytest.mark.parametrize("name", NAMES)
def test_strided_views_of_a_windowised_qkv_give_what_contiguous_heads_give(
        name):
    """``(NW, nh, T, hd)`` views of ``(NW, T, 3C)``, as the encoder passes
    them; head ``g = w * nh + h``."""
    wrapper = _pair(name)[0]
    NW, nh, side, hd = 3, 2, 7, 16
    T, C = side * side, nh * hd
    rng = np.random.default_rng(5)
    qkvw = torch.from_numpy(_r(rng, NW, T, 3 * C))
    rph, rpw = (torch.from_numpy(_r(rng, 2 * side - 1, hd, scale=0.3))
                for _ in range(2))
    views = [qkvw[..., i * C:(i + 1) * C].reshape(NW, T, nh, hd).transpose(
        1, 2) for i in range(3)]
    got = wrapper(*views, rph, rpw, side)
    assert tuple(got.shape) == (NW, nh, T, hd)
    want = wrapper(*(t.reshape(NW * nh, T, hd) for t in views), rph, rpw,
                   side)
    np.testing.assert_array_equal(got.reshape(NW * nh, T, hd).numpy(),
                                  want.numpy())


@pytest.mark.parametrize("name", NAMES)
def test_wrong_shapes_and_inputs_that_require_grad_raise(name):
    wrapper = _pair(name)[0]
    q, k, v, rph, rpw = map(torch.from_numpy, _inputs(6, 2, 7, 16))
    with pytest.raises(ValueError, match="side"):
        wrapper(q, k, v, rph, rpw, 6)  # T != side ** 2
    with pytest.raises(ValueError):
        wrapper(q, k[:, :32], v, rph, rpw, 7)
    with pytest.raises(ValueError):
        wrapper(q[0], k[0], v[0], rph, rpw, 7)  # neither 3-D nor 4-D
    for i in range(5):
        bad = [q, k, v, rph, rpw]
        bad[i] = bad[i].clone().requires_grad_()
        with pytest.raises(RuntimeError, match="requires grad"):
            wrapper(*bad, 7)
        with torch.no_grad():
            wrapper(*bad, 7)
    assert wrapper.launches == 0


def test_v1_and_v6_round_their_bias_rows_to_bf16_for_f32_inputs_too():
    """flmm_tpu/ops/sam_flash_experiments.py:686-687 and :173; v2 rounds its
    dense bias (:409)."""
    q, k, v, rph, rpw = map(torch.from_numpy, _inputs(7, 2, 7, 16, scale=1.0))
    exact = sam_flash.sam_window_attention_v9_plain(q, k, v, rph, rpw, 7)
    for name in NAMES:
        dev = (_pair(name)[0](q, k, v, rph, rpw, 7) - exact).abs().max()
        if name in BF16_BIAS or name == "v4":  # 8 bits of bias or scores
            assert 1e-4 < dev < 1e-1, (name, dev)
        else:
            assert dev < 1e-5, (name, dev)


def test_v2_dense_bias_is_the_jax_wrappers():
    """``bias_h + bias_w`` summed in f32 and rounded to bf16 once, ``(G, tp,
    tp)`` with -1e30 (the nearest bf16) in the pad rows and columns
    (flmm_tpu/ops/sam_flash_experiments.py:395-409)."""
    q, _, _, rph, rpw = _inputs(8, 3, 7, 16, scale=1.0)
    dense = sfx.window_dense_bias(*map(torch.from_numpy, (q, rph, rpw)), 7)
    assert dense.dtype == torch.bfloat16 and tuple(dense.shape) == (3, 64, 64)
    coords = np.arange(7)[:, None] - np.arange(7)[None, :] + 6
    qg = q.reshape(3, 7, 7, 16)
    bh = np.einsum("gyxd,ykd->gyxk", qg, rph[coords])
    bw = np.einsum("gyxd,xkd->gyxk", qg, rpw[coords])
    want = np.asarray(jnp.pad(
        jnp.asarray((bh[..., :, None] + bw[..., None, :]).reshape(3, 49, 49)),
        ((0, 0), (0, 15), (0, 15)), constant_values=-1e30).astype(
            jnp.bfloat16).astype(jnp.float32))
    got = dense.float().numpy()
    assert (got[:, 49:] == want[:, 49:]).all()
    assert (got[:, :, 49:] == want[:, :, 49:]).all()
    assert np.isfinite(got).all() and got[0, 63, 63] < -9e29
    # the f32 sums differ in their last bits: at most one bf16 step apart
    np.testing.assert_allclose(got[:, :49, :49], want[:, :49, :49],
                               atol=2 ** -8, rtol=2 ** -8)


def test_v2_is_v7_up_to_the_rounding_of_the_summed_bias():
    """One function but for where the bias is rounded: v7 rounds the two
    rows to q's dtype, v2 their f32 sum to bf16."""
    f32 = [torch.from_numpy(a) for a in _inputs(9, 4, 14, 64)]
    dev = (sfx.sam_window_attention_v2(*f32, 14)
           - sfx.sam_window_attention_v7(*f32, 14)).abs().max()
    assert 1e-5 < dev < 1e-1  # 8 bits of a summed bias of up to 10 units
    bf16 = [t.bfloat16() for t in f32]
    v2, v7 = (fn(*bf16, 14) for fn in (sfx.sam_window_attention_v2,
                                       sfx.sam_window_attention_v7))
    assert not torch.equal(v2, v7)
    # each rounds bias terms of up to 10 units to 8 bits, at other places
    assert torch.allclose(v2.float(), v7.float(), atol=0.1, rtol=0.1)


# --- the encoder's window_kernel switch -------------------------------------

@functools.cache
def _init_params_np(jcfg, seed):
    return jax.device_get(jax.jit(lambda k: jencoder.init_params(jcfg, k))(
        jax.random.key(seed)))


def _jax_params(jcfg, seed):
    """The JAX encoder's init params as numpy, initialised once per config
    (the window kernel's name does not enter them); a copy to modify."""
    return copy.deepcopy(_init_params_np(
        dataclasses.replace(jcfg, window_kernel="v9"), seed))


def _interpret_kernels(monkeypatch):
    for name in NAMES:
        monkeypatch.setattr(jsfx, _stem(name), functools.partial(
            getattr(jsfx, _stem(name)), interpret=True))


def _block_setup(grid, name):
    """A ViT block at width 128 with two 64-wide heads, 14 x 14 windows,
    nonzero biases (``bqkv`` above all: the pad tokens' k and v) and rel-pos
    tables."""
    kw = dict(img_size=16 * grid, patch_size=16, embed_dim=128, depth=1,
              num_heads=2, mlp_ratio=4.0, out_chans=16, window_size=14,
              global_attn_indexes=(), window_kernel=name)
    jcfg = jencoder.SamEncoderConfig(dtype=jnp.float32, flash_window=True,
                                     **kw)
    tcfg = encoder.SamEncoderConfig(dtype=torch.float32, flash_window=True,
                                    **kw)
    bp = _jax_params(jcfg, 1)["blocks"][0]
    rng = np.random.default_rng(grid)
    for key in ("bqkv", "bo", "ln1_b", "ln2_b"):
        bp[key] = _r(rng, *bp[key].shape, scale=0.5)
    for key in ("rel_pos_h", "rel_pos_w"):
        bp[key] = _r(rng, *bp[key].shape, scale=0.1)
    return jcfg, tcfg, bp, _r(rng, 2, grid, grid, 3 * 128, scale=0.5)


@pytest.mark.parametrize("name", NAMES)
def test_flash_window_core_matches_jax_core_on_a_grid_without_pad(
        name, monkeypatch):
    _interpret_kernels(monkeypatch)
    jcfg, tcfg, bp, qkv = _block_setup(14, name)
    calls = []
    real = getattr(jsfx, _stem(name))
    monkeypatch.setattr(jsfx, _stem(name),
                        lambda *a: (calls.append(1), real(*a))[1])
    want = jencoder._flash_window_core(
        jnp.asarray(qkv), jax.tree.map(jnp.asarray, bp), jcfg)
    assert calls == [1]  # the JAX core dispatched on the name
    got = encoder._flash_window_core(torch.from_numpy(qkv), from_jax(bp),
                                     tcfg)
    np.testing.assert_allclose(got.numpy(), np.asarray(want),
                               atol=ENCODER_TOL, rtol=ENCODER_TOL)


@pytest.mark.parametrize("name", NAMES)
def test_flash_window_block_on_a_padded_grid_matches_the_plain_block(name):
    """16 x 16 padded to 28 x 28: pad tokens keep ``k = b_k`` and ``v =
    b_v`` under every name, as on the port's plain windowed block (the JAX
    core pads qkv with zeros there; tests/test_torch_sam_window.py records
    by how much that is off)."""
    _, tcfg, bp, _ = _block_setup(16, name)
    tbp = from_jax(bp)
    x = torch.from_numpy(_r(np.random.default_rng(9), 2, 16, 16, 128))
    wrapper = encoder.WINDOW_KERNELS[name]
    calls = []
    encoder.WINDOW_KERNELS[name] = lambda *a: (calls.append(1),
                                               wrapper(*a))[1]
    try:
        got = encoder._flash_block(x, tbp, tcfg, windowed=True)
    finally:
        encoder.WINDOW_KERNELS[name] = wrapper
    assert calls == [1] and wrapper.launches == 0
    want = encoder._block(x, tbp, tcfg, windowed=True)  # plain on the CPU
    # v1 / v6 round their bias rows to bf16: 8 bits of a bias of ~0.5; v4
    # its scores and probabilities (measured 1.4e-2 on outputs of ~3.4)
    tol = (1e-2 if name in BF16_BIAS else V4_ENCODER_TOL if name == "v4"
           else ENCODER_TOL)
    np.testing.assert_allclose(got.numpy(), want.numpy(), atol=tol, rtol=tol)


ENC = dict(img_size=112, patch_size=8, embed_dim=64, depth=2, num_heads=2,
           out_chans=16, window_size=7, global_attn_indexes=(1,))


class _TpuBackend:
    """The ``jax`` module as the JAX encoder sees it, claiming a TPU, so its
    gates take the kernel path; the kernels themselves are patched to
    interpret mode."""

    def __getattr__(self, name):
        return getattr(jax, name)

    @staticmethod
    def default_backend():
        return "tpu"


@pytest.mark.parametrize("name", NAMES)
def test_encoder_matches_jax_encoder_through_the_named_kernel(
        name, monkeypatch):
    """The JAX encoder with its window layer through the named Pallas kernel
    (interpret mode, the TPU gate forced open from here, a 14 x 14 grid in
    2 x 2 windows of 7 without pad, ``window_block_fused`` off) against the
    port's encoder with the same ``window_kernel`` (plain on CPU tensors)."""
    _interpret_kernels(monkeypatch)
    monkeypatch.setattr(jencoder, "jax", _TpuBackend())
    calls = []
    real = getattr(jsfx, _stem(name))
    monkeypatch.setattr(jsfx, _stem(name),
                        lambda *a: (calls.append(1), real(*a))[1])
    kw = dict(window_kernel=name, flash_window=True,
              window_block_fused=False, **ENC)
    jcfg = jencoder.SamEncoderConfig(dtype=jnp.float32, **kw)
    tcfg = encoder.SamEncoderConfig(dtype=torch.float32, **kw)
    params = _jax_params(jcfg, 0)
    rng = np.random.default_rng(10)
    for bp in params["blocks"]:
        bp["bqkv"] = _r(rng, *bp["bqkv"].shape, scale=0.5)
        for key in ("rel_pos_h", "rel_pos_w"):
            bp[key] = _r(rng, *bp[key].shape, scale=0.1)
    px = _r(rng, 2, 112, 112, 3, scale=0.5)
    want = jencoder.forward(jax.tree.map(jnp.asarray, params), jcfg,
                            jnp.asarray(px))
    assert calls == [1]  # the JAX side really took the kernel
    got = encoder.forward(from_jax(params), tcfg, torch.from_numpy(px))
    assert tuple(got.shape) == (2, 14, 14, 16)
    # v1 / v6 round bias rows to bf16 that the two sides computed from a q
    # differing in its last f32 bits: now and then a row lands one bf16 step
    # (2**-8 of its value) apart, which no f32 tolerance covers (measured
    # 2.5e-3 on 0.7% of the values); v7 / v8 / v3 / v5 keep f32 rows; v4
    # rounds its scores and probabilities to bf16 on both sides
    tol = (1e-2 if name in BF16_BIAS else V4_ENCODER_TOL if name == "v4"
           else ENCODER_TOL)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=tol,
                               rtol=tol)


@pytest.mark.parametrize("name", ("v9",) + NAMES)
def test_ported_window_kernel_names_construct_and_resolve(name):
    cfg = encoder.SamEncoderConfig(window_kernel=name)
    assert cfg.window_kernel == name
    fn = encoder.WINDOW_KERNELS[name]
    assert fn.launches == 0 and fn.__name__ == (
        "sam_window_attention_v9" if name == "v9" else _stem(name))
