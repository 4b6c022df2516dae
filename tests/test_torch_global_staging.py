"""The plain twins of what the rel-pos core (csrc/relpos_attention_sm90.cu)
stages for the global variants v1, v2, v3, v4, v6 and v11 and of what the
tower flash kernel (csrc/plain_flash.cu, K7) stages, against the JAX
package, on the CPU.

- ``sam_flash_experiments.global_table_bias``: the core forms each
  variant's bias rows itself, the product of the unscaled q with each
  ``(2*side - 1, hd)`` table gathered at ``y - k + side - 1``, rounded to
  bf16 in natural base (v1, v2, v3, v4, v6) or in the log2 domain (v11).
  Each is held to the rows the JAX wrapper hands its ``pallas_call``
  (captured by replacing ``pl.pallas_call``): where the JAX rows are f32,
  in f32 before the rounding at 1e-5 (the same products summed in another
  order); after the rounding to one bf16 step, where the two orders
  straddle a rounding boundary.
- The key loop of v4 and v11 over 64-key tiles, as the core runs it (v4: a
  running max of the bf16-rounded scores, ``bf16(exp(bf16(s - max)))`` and
  the f32 sum of the rounded ``p``, the earlier tiles rescaled in f32; v11:
  ``exp2(s)`` with no max, plain sums), against the JAX kernels in
  interpret mode, whose one-shot softmax sees the whole row.  bf16 inputs,
  as on the card; 2e-2 of the largest output, chip_smoke.py's bound for the
  kernel against its plain version (measured 2.4e-3 for v4 and 5.4e-3 for
  v11, one and two bf16 steps of outputs near 3: the probabilities carry
  bf16 rounding on both sides at other values, a tile's ``p`` rounded
  against its running max; v11's q is scaled on the f32 scores, where the
  JAX wrapper rounds ``q * scale * log2(e)``).
- K7's staging: ``sam_flash.plain_flash_boxes`` (a head row as boxes of 64
  columns, zeros past hd = 72 and past S) against the first hd columns of
  the JAX wrapper's augmented operands, bit for bit; and a numpy model of
  the 128-byte swizzle and of ``ldmatrix.trans`` at the kernel's addresses,
  which must give the mma.sync B fragments of V's columns 64-71.
- The grid sides the variants take through the core (1 to
  ``MAX_TABLE_SIDE`` = 147, as K2) and refuse.
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

F32_TOL, LOOP_TOL = 1e-5, 2e-2
VARIANTS = ("v1", "v2", "v3", "v4", "v6", "v11")


def _r(rng, *shape, scale=1.0):
    return (rng.standard_normal(shape) * scale).astype(np.float32)


def _bf16_grid(x):
    """f32 values that bf16 holds exactly, as the card's inputs are."""
    return torch.from_numpy(x).bfloat16().float().numpy()


def _one_bf16_step(got, want):
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


def _stem(name):
    return "sam_global_attention" + ("" if name == "v1" else f"_{name}")


def _jax_rows(ins, name, side, hd):
    """The ``(G, S, 2 side)`` bias rows among a JAX wrapper's kernel
    inputs: v1 and v2 hand bias_h and bias_w apart (bf16); v3, v4, v6 and
    v11 as columns hd to hd + 2 side of the augmented operand (q's dtype),
    v11's padded to a multiple of 128 rows."""
    if name in ("v1", "v2"):
        return np.concatenate([ins[3], ins[4]], axis=-1)
    S = side * side
    return ins[0][:, :S, hd:hd + 2 * side]


@pytest.mark.parametrize("dtype", ["f32", "bf16"])
@pytest.mark.parametrize("name", VARIANTS)
def test_staged_rows_match_the_rows_each_jax_wrapper_hands_its_kernel(
        name, dtype, monkeypatch):
    side, hd, G = 8, 64, 3
    rng = np.random.default_rng(VARIANTS.index(name))
    q = _bf16_grid(_r(rng, G, side * side, hd))
    rph, rpw = (_bf16_grid(_r(rng, 2 * side - 1, hd, scale=0.3))
                for _ in range(2))
    jdt = jnp.float32 if dtype == "f32" else jnp.bfloat16
    ins = _captured_inputs(
        monkeypatch, getattr(jsfx, _stem(name)),
        *(jnp.asarray(a, jdt) for a in (q, q, q, rph, rpw)), side)
    want = _jax_rows(ins, name, side, hd)
    qt, th, tw = map(torch.from_numpy, (q, rph, rpw))
    if dtype == "bf16":
        qt = qt.bfloat16()
    got = sfx.global_table_bias(qt, th, tw, side, name)
    assert got.dtype == torch.float32
    assert tuple(got.shape) == (G, side * side, 2 * side)
    if want.dtype == np.float32:
        # the JAX rows are not rounded for f32 q: the unrounded twin in f32
        f32 = sam_flash.table_bias_rows(qt, th, tw, side,
                                        log2_domain=name == "v11")
        np.testing.assert_allclose(f32.numpy(), want, atol=F32_TOL,
                                   rtol=F32_TOL)
        want = torch.from_numpy(want.copy()).bfloat16().float().numpy()
    _one_bf16_step(got.numpy(), want.astype(np.float32))
    # what the core rounds to is bf16: the twin holds bf16 values
    assert torch.equal(got, got.bfloat16().float())


def test_v7_stages_k2s_unrounded_log2_rows():
    rng = np.random.default_rng(9)
    q, th, tw = (torch.from_numpy(_r(rng, *s)) for s in
                 ((2, 36, 64), (11, 64), (11, 64)))
    assert torch.equal(sfx.global_table_bias(q, th, tw, 6, "v7"),
                       sam_flash.table_bias_rows(q, th, tw, 6))


def _kernel_loop(q, k, v, rph, rpw, side, name, tile=64):
    """The core's key loop over ``tile``-key tiles in f32 on the CPU, for
    bf16 q, k, v: the scores ``(q . k) alpha + bias_h + bias_w`` from the
    staged rows, then v4's running bf16 softmax or v11's plain sums; p
    rounded to bf16 for P V."""
    G, S, hd = q.shape
    scale = 1.0 / math.sqrt(hd)
    rows = sfx.global_table_bias(q, rph, rpw, side, name)
    key = torch.arange(S)
    bias = rows[..., key // side] + rows[..., side + key % side]
    qk = q.float() @ k.float().transpose(1, 2)
    if name == "v11":
        s = qk * (scale * sam_flash.LOG2E) + bias
    else:
        s = qk * scale + bias
    o = torch.zeros(G, S, hd)
    m = torch.full((G, S, 1), -math.inf)
    lsum = torch.zeros(G, S, 1)
    for t0 in range(0, S, tile):
        st, vt = s[..., t0:t0 + tile], v[:, t0:t0 + tile].float()
        if name == "v11":
            p = torch.exp2(st)
            r = 1.0
            pr = p.bfloat16().float()
        else:
            sb = st.bfloat16().float()
            mn = torch.maximum(m, sb.amax(-1, keepdim=True))
            r = torch.exp(m - mn)
            m = mn
            p = pr = torch.exp((sb - mn).bfloat16().float()).bfloat16().float()
        lsum = lsum * r + p.sum(-1, keepdim=True)
        o = o * r + pr @ vt
    return (o / lsum.clamp_min(1e-30)).bfloat16()


@pytest.mark.parametrize("side", [12, 16])
@pytest.mark.parametrize("name", ["v4", "v11"])
def test_tiled_key_loop_matches_pallas_interpret(name, side):
    """S = 144 (two whole tiles and one of 16 keys) and 256 (four)."""
    rng = np.random.default_rng(side)
    G, hd = 2, 64
    q, k, v = (_r(rng, G, side * side, hd) for _ in range(3))
    rph, rpw = (_r(rng, 2 * side - 1, hd, scale=0.3) for _ in range(2))
    want = np.asarray(getattr(jsfx, _stem(name))(
        *(jnp.asarray(a, jnp.bfloat16) for a in (q, k, v, rph, rpw)), side,
        interpret=True).astype(jnp.float32))
    got = _kernel_loop(*(torch.from_numpy(a).bfloat16() for a in (q, k, v)),
                       *map(torch.from_numpy, (rph, rpw)), side, name)
    err = np.abs(got.float().numpy() - want).max() / np.abs(want).max()
    assert err <= LOOP_TOL, err


@pytest.mark.parametrize("hd, S", [(64, 577), (72, 577), (72, 64), (64, 37)])
def test_k7_boxes_match_the_jax_augmented_operands(hd, S, monkeypatch):
    rng = np.random.default_rng(hd + S)
    G = 3
    q, k, v = (_r(rng, G, S, hd) for _ in range(3))
    ins = _captured_inputs(monkeypatch, jsf.plain_flash_attention,
                           *(jnp.asarray(a, jnp.bfloat16) for a in (q, k, v)))
    a, b, va = (np.asarray(x.astype(np.float32)) for x in ins)
    qb, kb, vb = (sam_flash.plain_flash_boxes(torch.from_numpy(x).bfloat16())
                  for x in (q, k, v))
    width, rows = -(-hd // 64) * 64, -(-S // 64) * 64
    for box in (qb, kb, vb):
        assert tuple(box.shape) == (G, rows, width)
        # past hd and past S: zeros, whatever lies beside the head
        assert not box[:, :, hd:].any() and not box[:, S:].any()
    assert np.array_equal(kb[:, :S, :hd].float().numpy(),
                          b[:, :hd, :S].transpose(0, 2, 1))
    assert np.array_equal(vb[:, :S, :hd].float().numpy(), va[:, :S, :hd])
    # q: the JAX wrapper's bf16(q * scale); the kernel puts scale on the
    # f32 scores, which at hd 64 (scale = 2^-3) is the same product
    scale = 1.0 / math.sqrt(hd)
    qs = (qb[:, :S, :hd].float() * scale).bfloat16().float()
    assert np.array_equal(qs.numpy(), a[:, :S, :hd])
    if hd == 64:
        assert torch.equal(qs, qb[:, :S, :hd].float() * scale)


def _swizzled(tile):
    """A (64, 64) box as TMA's 128-byte swizzle lays it out: 16-byte chunk
    c of row r at chunk c ^ (r % 8); (row, physical chunk, element)."""
    out = np.zeros((64, 8, 8), tile.dtype)
    for r in range(64):
        for c in range(8):
            out[r, c ^ (r % 8)] = tile[r, 8 * c:8 * c + 8]
    return out


def test_k7_tail_fragments_from_the_swizzled_v_box():
    """V's second box at hd 72 (columns 64-71, then zeros): for each half
    of the 64 keys, lane i of ldmatrix.x4.trans gives the address key * 128
    + ((key & 7) << 4) of key 32 half + i; matrix m (lanes 8 m ... 8 m + 7)
    hands lane t the pair of rows 2 (t % 4), + 1 at column t / 4.  Those
    must be the B fragments of mma.sync m16n8k16 for k16 steps 2 half and 2
    half + 1: keys 16 kk + c2, + 1 (b0) and + 8, + 9 (b1) of column 64 + t /
    4, c2 = 2 (t % 4)."""
    rng = np.random.default_rng(0)
    v = rng.standard_normal((64, 72)).astype(np.float32)
    box = np.zeros((64, 64), np.float32)
    box[:, :8] = v[:, 64:]
    smem = _swizzled(box).reshape(-1)  # flat elements, 64 a row
    for half in range(2):
        addr = [(32 * half + i) * 128 + (((32 * half + i) & 7) << 4)
                for i in range(32)]
        rows = [smem[a // 2:a // 2 + 8] for a in addr]  # 8 elements a lane
        for t in range(32):
            c2, n = 2 * (t % 4), t // 4
            frag = [(rows[8 * mi + c2][n], rows[8 * mi + c2 + 1][n])
                    for mi in range(4)]
            for step in range(2):
                kk = 2 * half + step
                want_b0 = (v[16 * kk + c2, 64 + n], v[16 * kk + c2 + 1, 64 + n])
                want_b1 = (v[16 * kk + 8 + c2, 64 + n],
                           v[16 * kk + 9 + c2, 64 + n])
                assert frag[2 * step] == want_b0
                assert frag[2 * step + 1] == want_b1


@pytest.mark.parametrize("name", sorted(sfx.GLOBAL_VARIANTS))
@pytest.mark.parametrize("side", [sam_flash.MAX_TABLE_SIDE,
                                  sam_flash.MAX_TABLE_SIDE + 1])
def test_variant_sides_through_the_core(name, side):
    """Every variant's launch takes the core's grid sides 1 to 147 and
    refuses a wider grid before it touches the card (the first port's
    kernel launched up to side 418; no configuration goes above 147)."""
    S = side * side
    q = torch.zeros(1, S, 64)
    th = tw = torch.zeros(2 * side - 1, 64)
    softmax = sfx.GLOBAL_VARIANTS[name][0]
    match = ("grid sides 1 to 147" if side > sam_flash.MAX_TABLE_SIDE
             else "must be bf16 CUDA tensors")
    with pytest.raises(ValueError, match=match):
        sam_flash._launch(_stem(name), q, q, q, th, tw, side, softmax)
