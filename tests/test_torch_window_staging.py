"""The plain twins of what the window core (csrc/window_attention_sm90.cu)
and the grid sides of the rel-pos core (csrc/relpos_attention_sm90.cu)
stage, against the JAX package, on the CPU.

- ``sam_flash_experiments.window_table_bias``: the window core forms the
  bias itself, as the product of the unscaled q with each ``(2*side - 1,
  hd)`` table gathered at ``y - k + side - 1``, rounded as each mode rounds
  it: the natural rows rounded to bf16 (window v1, v6, v7, v8, v3, v4, v5),
  v2's per-score ``bf16(bias_h + bias_w)``, v10's log2-domain rows rounded
  to bf16.  Each is held to the bias the JAX wrapper itself hands its
  ``pallas_call`` (captured by replacing ``pl.pallas_call``): in f32 before
  the rounding at 1e-5 (the same products summed in another order), and
  after it to one bf16 step, where the two orders straddle a rounding
  boundary.
- The q-scale fold: at head_dim 64 the window core puts ``scale`` = 2^-3 on
  the f32 scores instead of rounding ``q * scale`` to bf16 first; for bf16
  q the two are the same bits, and so are the f32 products.
- v10's box order: a numpy walk of the 3D box the kernel reads (columns,
  then W, then H) gives, bit for bit, the windowisation of the port's plain
  v10 and of the JAX v10 BlockSpec and lane slices.
- The grid sides the rel-pos core now takes (K2, K6, global v7; K1 and K10
  through the same kernel), 1 to ``MAX_TABLE_SIDE``, and those the window
  core takes, 1 to ``MAX_WINDOW_SIDE``; ``table_bias_rows`` at sides 5 and
  80; the plain K2 at side 5 against the JAX kernel in interpret mode.
"""

import math

import numpy as np
import jax.numpy as jnp
import pytest
import torch

from flmm_tpu.ops import sam_flash as jsf
from flmm_tpu.ops import sam_flash_experiments as jsfx
from flmm_tpu_torch.ops import sam_flash
from flmm_tpu_torch.ops import sam_flash_experiments as sfx

F32_TOL = 1e-5


def _r(rng, *shape, scale=1.0):
    return (rng.standard_normal(shape) * scale).astype(np.float32)


def _bf16_grid(x):
    """f32 values that bf16 holds exactly, as the card's inputs are."""
    return torch.from_numpy(x).bfloat16().float().numpy()


def _one_bf16_step(got, want):
    """Every element of ``got`` within one bf16 step of ``want`` (the step
    at the larger magnitude of the two)."""
    got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
    mag = np.maximum(np.maximum(np.abs(got), np.abs(want)), 1e-30)
    step = 2.0 ** (np.floor(np.log2(mag)) - 7)
    assert np.all(np.abs(got - want) <= step), np.max(np.abs(got - want)
                                                      / step)


def _captured_inputs(monkeypatch, fn, *args, **kwargs):
    """The arrays a JAX wrapper hands its ``pallas_call``."""
    seen = []

    def fake_pallas_call(kernel, *, out_shape, **_):
        def call(*inputs):
            seen.extend(np.asarray(x) for x in inputs)
            return jnp.zeros(out_shape.shape, out_shape.dtype)
        return call

    monkeypatch.setattr(jsfx.pl, "pallas_call", fake_pallas_call)
    fn(*args, **kwargs)
    return seen


def _window_inputs(side, G=6, hd=16, seed=0):
    rng = np.random.default_rng(seed + side)
    q = _bf16_grid(_r(rng, G, side * side, hd))
    rph, rpw = (_bf16_grid(_r(rng, 2 * side - 1, hd, scale=0.3))
                for _ in range(2))
    return q, rph, rpw


@pytest.mark.parametrize("side", [5, 7, 14])
def test_natural_rows_match_jax_v1_bias(side, monkeypatch):
    q, rph, rpw = _window_inputs(side)
    T = side * side
    k = v = np.zeros_like(q)
    ins = _captured_inputs(monkeypatch, jsfx.sam_window_attention,
                           *map(jnp.asarray, (q, k, v, rph, rpw)), side)
    bh, bw = (x[:, :T].astype(np.float32) for x in ins[3:5])
    qt, th, tw = map(torch.from_numpy, (q, rph, rpw))
    f32 = sam_flash.table_bias_rows(qt, th, tw, side, log2_domain=False)
    np.testing.assert_allclose(
        f32.numpy(), sam_flash.global_bias_rows(
            qt, th, tw, side, log2_domain=False, dtype=torch.float32).numpy(),
        atol=F32_TOL, rtol=F32_TOL)
    got = sfx.window_table_bias(qt, th, tw, side, "v1")
    _one_bf16_step(got.numpy(), np.concatenate([bh, bw], axis=-1))
    for variant in ("v6", "v7", "v8", "v3", "v4", "v5"):
        assert torch.equal(sfx.window_table_bias(qt, th, tw, side, variant),
                           got)


@pytest.mark.parametrize("side", [5, 14])
def test_dense_sums_match_jax_v2_bias(side, monkeypatch):
    q, rph, rpw = _window_inputs(side)
    T = side * side
    k = v = np.zeros_like(q)
    ins = _captured_inputs(monkeypatch, jsfx.sam_window_attention_v2,
                           *map(jnp.asarray, (q, k, v, rph, rpw)), side)
    dense = ins[3].astype(np.float32)  # (G, tp, tp) bf16, -1e30 in the pad
    assert dense.shape[1] == -(-T // 16) * 16
    qt, th, tw = map(torch.from_numpy, (q, rph, rpw))
    rows = sam_flash.table_bias_rows(qt, th, tw, side, log2_domain=False)
    f32 = (rows[..., :side, None] + rows[..., None, side:]).reshape(-1, T, T)
    ref = sam_flash.global_bias_rows(qt, th, tw, side, log2_domain=False,
                                     dtype=torch.float32)
    ref = (ref[..., :side, None] + ref[..., None, side:]).reshape(-1, T, T)
    np.testing.assert_allclose(f32.numpy(), ref.numpy(), atol=F32_TOL,
                               rtol=F32_TOL)
    got = sfx.window_table_bias(qt, th, tw, side, "v2")
    assert got.shape == (q.shape[0], T, T)
    _one_bf16_step(got.numpy(), dense[:, :T, :T])
    # the plain v2 builds the same values as its dense tensor
    plain = sfx.window_dense_bias(qt.bfloat16(), th, tw, side)
    _one_bf16_step(got.numpy(), plain[:, :T, :T].float().numpy())


@pytest.mark.parametrize("side, grid_hw", [(5, 5), (7, 12), (14, 28)])
def test_log2_rows_match_jax_v10_bias(side, grid_hw, monkeypatch):
    rng = np.random.default_rng(side)
    B, nh, hd = 2, 2, 16 if side <= 8 else 32  # 2 side <= hd
    Hp = -(-grid_hw // side) * side
    qkv = _bf16_grid(_r(rng, B, Hp, Hp, 3 * nh * hd))
    rph, rpw = (_bf16_grid(_r(rng, 2 * side - 1, hd, scale=0.3))
                for _ in range(2))
    ins = _captured_inputs(monkeypatch, jsfx.sam_window_attention_v10,
                           *map(jnp.asarray, (qkv, rph, rpw)), side, grid_hw)
    want = np.array(ins[1]).reshape(-1, side * side, 2 * side)  # f32, log2
    q = sfx.spatial_heads(torch.from_numpy(qkv), side, nh, hd)[0]
    th, tw = torch.from_numpy(rph), torch.from_numpy(rpw)
    f32 = sam_flash.table_bias_rows(q, th, tw, side)
    np.testing.assert_allclose(f32.numpy(), want, atol=F32_TOL, rtol=F32_TOL)
    got = sfx.window_table_bias(q, th, tw, side, "v10")
    _one_bf16_step(got.numpy(),
                   torch.from_numpy(want).bfloat16().float().numpy())


def test_q_scale_fold_is_exact():
    rng = np.random.default_rng(7)
    # magnitudes from 2^-100 to 2^20, far above the subnormal range
    q = _r(rng, 64, 196, 64) * np.exp2(rng.uniform(-100, 20, (64, 196, 1)))
    q = torch.from_numpy(q.astype(np.float32)).bfloat16()
    k = torch.from_numpy(_r(rng, 64, 196, 64)).bfloat16()
    scale = 1.0 / math.sqrt(64)
    assert scale == 2.0 ** -3
    rounded = (q.float() * scale).bfloat16()
    assert torch.equal(rounded.float(), q.float() * scale)
    assert torch.equal(rounded.float() @ k.float().transpose(1, 2),
                       (q.float() @ k.float().transpose(1, 2)) * scale)


def _box_walk(qkv, side, col, hd):
    """A numpy walk of the 3D box read: for each (image, window) in
    row-major order, H outermost, then W, then the columns, written in
    order into a flat buffer of rows of ``hd``."""
    B, Hp, Wp, _ = qkv.shape
    boxes = []
    for b in range(B):
        for wy in range(Hp // side):
            for wx in range(Wp // side):
                flat = []
                for y in range(side):
                    for x in range(side):
                        for c in range(hd):
                            flat.append(qkv[b, wy * side + y, wx * side + x,
                                            col + c])
                boxes.append(np.array(flat, qkv.dtype).reshape(-1, hd))
    return np.stack(boxes)


def _jax_blockspec_heads(qkv, side, nh, hd, hg):
    """The JAX v10 kernel's operands: the block of (b, wy, g) is rows wy *
    side ... of image b and the lanes of head group g; window wx is a slice
    of its W, and head h of the group the lanes ``3 hd h`` on."""
    B, Hp, Wp, _ = qkv.shape
    x = jnp.asarray(qkv)
    out = [[], [], []]
    for b in range(B):
        for wy in range(Hp // side):
            for wx in range(Wp // side):
                for g in range(nh // hg):
                    row = x[b, wy * side:(wy + 1) * side, :,
                            g * hg * 3 * hd:(g + 1) * hg * 3 * hd]
                    tok = row[:, wx * side:(wx + 1) * side].reshape(
                        side * side, hg * 3 * hd)
                    for h in range(hg):
                        for i in range(3):
                            base = 3 * hd * h + i * hd
                            out[i].append(np.asarray(tok[:, base:base + hd]))
    return [np.stack(o) for o in out]


@pytest.mark.parametrize("side, Hp, nh, hg", [(3, 6, 2, 1), (5, 10, 4, 2)])
def test_v10_box_order(side, Hp, nh, hg):
    rng = np.random.default_rng(side)
    hd = 8
    qkv = _r(rng, 2, Hp, Hp, 3 * nh * hd)
    heads = sfx.spatial_heads(torch.from_numpy(qkv), side, nh, hd).numpy()
    jax_heads = _jax_blockspec_heads(qkv, side, nh, hd, hg)
    for i in range(3):  # q, k, v
        for h in range(nh):
            walk = _box_walk(qkv, side, h * 3 * hd + i * hd, hd)
            assert np.array_equal(walk, heads[i][h::nh])
            assert np.array_equal(walk, jax_heads[i][h::nh])


@pytest.mark.parametrize("side", [1, 5, 7, 8, 64, 80, 128,
                                  sam_flash.MAX_TABLE_SIDE])
def test_table_sides_taken(side):
    rng = np.random.default_rng(side)
    rows = 2 * side - 1 + 3  # tables may be longer than the grid needs
    th, tw = (torch.from_numpy(_r(rng, rows, 64)) for _ in range(2))
    tables = sam_flash.kernel_tables("k", th, tw, side,
                                     sam_flash.MAX_TABLE_SIDE)
    for t, src in zip(tables, (th, tw)):
        assert t.dtype == torch.bfloat16 and t.is_contiguous()
        assert torch.equal(t, src[:2 * side - 1].bfloat16())


@pytest.mark.parametrize("side, rows, max_side", [
    (0, 5, sam_flash.MAX_TABLE_SIDE),
    (sam_flash.MAX_TABLE_SIDE + 1, 2 * sam_flash.MAX_TABLE_SIDE + 1,
     sam_flash.MAX_TABLE_SIDE),
    (80, 158, sam_flash.MAX_TABLE_SIDE),  # one table row short
    (15, 29, sfx.MAX_WINDOW_SIDE),
])
def test_table_sides_refused(side, rows, max_side):
    th = tw = torch.zeros(rows, 64)
    with pytest.raises(ValueError, match="grid sides 1 to"):
        sam_flash.kernel_tables("k", th, tw, side, max_side)


def test_window_side_limit_fits_the_core():
    assert sfx.MAX_WINDOW_SIDE ** 2 <= sfx.MAX_WINDOW_TOKENS
    assert (sfx.MAX_WINDOW_SIDE + 1) ** 2 > sfx.MAX_WINDOW_TOKENS
    assert sam_flash.MAX_TABLE_SIDE >= 128  # SAM-2048


@pytest.mark.parametrize("side", [5, 80])
def test_table_bias_rows_at_new_sides(side):
    rng = np.random.default_rng(side)
    q = torch.from_numpy(_r(rng, 2, side * side, 16))
    th, tw = (torch.from_numpy(_r(rng, 2 * side - 1, 16)) for _ in range(2))
    for log2 in (True, False):
        got = sam_flash.table_bias_rows(q, th, tw, side, log2_domain=log2)
        want = sam_flash.global_bias_rows(q, th, tw, side, log2_domain=log2)
        np.testing.assert_allclose(got.numpy(), want.numpy(), atol=F32_TOL,
                                   rtol=F32_TOL)


def test_plain_k2_at_side_5_matches_pallas_v8():
    rng = np.random.default_rng(5)
    side, G, hd = 5, 4, 16
    S = side * side
    q, k, v = (_r(rng, G, S, hd) for _ in range(3))
    rph, rpw = (_r(rng, 2 * side - 1, hd, scale=0.3) for _ in range(2))
    want = jsf.sam_global_attention_v8(
        *map(jnp.asarray, (q, k, v, rph, rpw)), side, interpret=True,
        block_q=64, chunks=2)
    got = sam_flash.sam_global_attention_v8_plain(
        *map(torch.from_numpy, (q, k, v, rph, rpw)), side)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=1e-4,
                               rtol=1e-4)
