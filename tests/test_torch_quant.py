"""The int8 W8A8 slice of flmm_tpu_torch against flmm_tpu on the CPU.

``ops/quant.py`` (weights, activations, the int32 product, the rescale),
the decoder's and the SAM encoder's ``quantize_params``, both
``quantize_frozen_*`` and the tiny DeepSeek-VL and HPT forwards on
quantised frozen trees.  The JAX package's own int8 tests are marked slow,
so these are what the fast suite checks.  Trees compare exactly; forwards
within 1e-3.
"""

import dataclasses

import numpy as np
import jax
import jax.numpy as jnp
import pytest
import torch

from flmm_tpu.configs import deepseek_vl as jax_configs
from flmm_tpu.configs import hpt as jax_hpt
from flmm_tpu.data.synthetic import synthetic_batch as jax_synthetic_batch
from flmm_tpu.models.frozen import grounding as jgrounding
from flmm_tpu.models.llm import decoder as jdecoder
from flmm_tpu.models.sam import image_encoder as jencoder
from flmm_tpu.ops import quant as jquant
from flmm_tpu_torch.configs import deepseek_vl as torch_configs
from flmm_tpu_torch.configs import hpt as torch_hpt
from flmm_tpu_torch.configs import mgm as torch_mgm
from flmm_tpu_torch.convert.from_jax import from_jax, to_tensor
from flmm_tpu_torch.data.synthetic import synthetic_batch
from flmm_tpu_torch.models.frozen import grounding
from flmm_tpu_torch.models.llm import decoder
from flmm_tpu_torch.models.sam import image_encoder as encoder
from flmm_tpu_torch.ops import fused_block, quant, sam_flash

SLICE_TOL = 1e-3


def _assert_trees_equal(got, want, where=""):
    """Same keys, shapes, dtypes and values, bit for bit."""
    if isinstance(want, dict):
        assert set(got) == set(want), where
        for k in want:
            _assert_trees_equal(got[k], want[k], f"{where}/{k}")
        return
    if isinstance(want, (list, tuple)):
        assert len(got) == len(want), where
        for i, (g, w) in enumerate(zip(got, want)):
            _assert_trees_equal(g, w, f"{where}/{i}")
        return
    w = to_tensor(np.asarray(want))
    assert got.dtype == w.dtype and got.shape == w.shape, where
    assert torch.equal(got, w), where


def _ties_matrix(rng, k=24, n=16):
    """An ``(k, n)`` f32 matrix whose column 0 has max 127 (scale 1: the
    values 0.5, 1.5, 2.5, -0.5, -2.5 fall on rounding ties), column 1 all
    zero, the rest normal."""
    w = rng.normal(size=(k, n)).astype(np.float32) * 0.1
    w[:, 0] = 0.0
    w[:6, 0] = [127.0, 0.5, 1.5, 2.5, -0.5, -2.5]
    w[:, 1] = 0.0
    return w


def test_quantize_weight_matches_jax_with_ties_and_a_zero_column():
    w = _ties_matrix(np.random.default_rng(0))
    jq, js = jax.device_get(jquant.quantize_weight(jnp.asarray(w)))
    tq, ts = quant.quantize_weight(torch.from_numpy(w))
    assert tq.dtype == torch.int8 and ts.dtype == torch.float32
    assert tq.stride() == (1, 24)  # column-major, as torch._int_mm runs it
    assert torch.equal(tq, to_tensor(jq)) and torch.equal(ts, to_tensor(js))
    # half to even, as jnp.round
    assert tq[:6, 0].tolist() == [127, 0, 2, 2, 0, -2]
    assert not tq[:, 1].any() and ts[1].item() == np.float32(1e-8) / 127


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("rows", [1, 5, 40])
def test_int8_matmul_matches_jax(dtype, rows):
    """The int32 product equals numpy's int64 product; the rescaled output
    is within one ulp of JAX's (bit for bit in practice)."""
    rng = np.random.default_rng(rows)
    x = rng.normal(size=(2, rows, 24)).astype(np.float32)
    x[0, 0, :3] = [127.0, 0.5, -1.5]  # ties in the activations too
    w = _ties_matrix(rng)
    jx = jnp.asarray(x, dtype)
    tx = from_jax(np.asarray(jx))
    jq, js = jquant.quantize_weight(jnp.asarray(w))
    tq, ts = from_jax(jax.device_get((jq, js)))
    x_q, x_s = quant.quantize_activations(tx)

    @jax.jit
    def jax_activations(jx):  # as int8_matmul computes them in a forward
        jxf = jx.astype(jnp.float32)
        jxs = jnp.maximum(jnp.abs(jxf).max(axis=-1, keepdims=True),
                          1e-8) / 127.0
        return jnp.clip(jnp.round(jxf / jxs), -127, 127).astype(jnp.int8), jxs

    jxq, jxs = jax_activations(jx)
    assert torch.equal(x_q, to_tensor(np.asarray(jxq)))
    assert torch.equal(x_s, to_tensor(np.asarray(jxs)))
    y = quant.int8_product(x_q.reshape(-1, 24), tq)
    want_y = np.asarray(jxq).reshape(-1, 24).astype(np.int64) @ np.asarray(
        jq).astype(np.int64)
    assert y.dtype == torch.int32
    np.testing.assert_array_equal(y.numpy(), want_y)
    got = quant.int8_matmul(tx, tq, ts)
    want = to_tensor(np.asarray(jax.jit(jquant.int8_matmul)(jx, jq, js)))
    assert got.dtype == want.dtype and got.shape == want.shape
    ulp = (got.float() - want.float()).abs() / torch.finfo(got.dtype).eps
    assert (ulp <= want.float().abs().clamp_min(1e-30)).all()
    assert torch.equal(quant.int8_matmul_plain(tx, tq, ts), got)


def test_dense_dispatches_on_the_quantised_keys():
    rng = np.random.default_rng(3)
    x = torch.from_numpy(rng.normal(size=(4, 24)).astype(np.float32))
    w = torch.from_numpy(_ties_matrix(rng))
    wq, ws = quant.quantize_weight(w)
    assert torch.equal(quant.dense(x, {"w": w}, "w"), x @ w)
    assert torch.equal(quant.dense(x, {"w_q": wq, "w_s": ws}, "w"),
                       quant.int8_matmul(x, wq, ws))


def test_int8_product_refuses_unaligned_shapes_on_a_card():
    """On a CUDA tensor the product is torch._int_mm or an error: K or N
    off a multiple of 8 raises before any launch (checked on meta-like
    stand-ins, since the suite runs without a card)."""

    class FakeCuda:
        is_cuda = True
        shape = (32, 20)

    with pytest.raises(ValueError, match="multiples of 8"):
        quant.int8_product(FakeCuda(), torch.zeros((20, 16),
                                                   dtype=torch.int8))


def _decoder_params(cfg, seed):
    return jax.device_get(jax.jit(lambda k: jdecoder.init_params(cfg, k))(
        jax.random.key(seed)))


@pytest.mark.parametrize("preset", ["tiny", "tiny_mgm_moe"])
def test_decoder_quantize_params_matches_jax(preset):
    """Every 3-D projection quantised per (layer, output channel) exactly as
    JAX; MoE expert stacks, embed, norms and lm_head untouched; the source
    tree unchanged with ``consume=False``."""
    if preset == "tiny":
        jcfg = jax_configs.tiny().llm
    else:
        from flmm_tpu.configs import mgm as jax_mgm

        jcfg = jax_mgm.tiny_mgm().base.llm
        jcfg = dataclasses.replace(jcfg, num_experts=4,
                                   num_experts_per_tok=2)
    jparams = _decoder_params(jcfg, 0)
    wq = np.array(jparams["layers"]["wq"])
    wq[0, :6, 0] = [127.0, 0.5, 1.5, 2.5, -0.5, -2.5]  # ties at scale 1
    wq[1, :, 1] = 0.0  # an all-zero column
    jparams["layers"]["wq"] = wq.astype(jparams["layers"]["wq"].dtype)
    src = from_jax(jparams)
    before = {k: v.clone() for k, v in src["layers"].items()}
    ids = {k: id(v) for k, v in src["layers"].items()}
    want = jax.device_get(jdecoder.quantize_params(
        jax.tree.map(jnp.asarray, jparams)))
    got = decoder.quantize_params(src)
    _assert_trees_equal(got, want)
    wq_q = got["layers"]["wq_q"]
    assert wq_q[0].stride() == (1, wq_q.shape[1])  # each layer column-major
    assert set(src["layers"]) == set(before)
    for k, v in src["layers"].items():
        assert id(v) == ids[k] and torch.equal(v, before[k]), k
    if preset != "tiny":
        assert got["layers"]["w_gate"].dim() == 4  # the expert stack
        assert got["layers"]["w_gate"] is src["layers"]["w_gate"]
    # consume=True frees each weight out of the caller's dict
    layers = src["layers"]
    out = decoder.quantize_params(src, consume=True)
    assert out is src and out["layers"] is layers
    assert "wq" not in layers and "wq_q" in layers
    _assert_trees_equal(out, want)


def _sam_params(cfg, seed):
    params = jax.device_get(jax.jit(lambda k: jencoder.init_params(cfg, k))(
        jax.random.key(seed)))
    rng = np.random.default_rng(seed)
    for bp in params["blocks"]:
        for key in ("rel_pos_h", "rel_pos_w"):
            bp[key] = (0.02 * rng.normal(size=bp[key].shape)).astype(
                bp[key].dtype)
    return params


def test_sam_quantize_params_matches_jax():
    jcfg = jax_configs.tiny().sam.encoder
    jparams = _sam_params(jcfg, 1)
    src = from_jax(jparams)
    got = encoder.quantize_params(src)
    want = jax.device_get(jencoder.quantize_params(
        jax.tree.map(jnp.asarray, jparams)))
    _assert_trees_equal(got, want)
    _assert_trees_equal(src, jparams)  # the source stays as it was
    assert all(encoder.quantized(bp) for bp in got["blocks"])
    assert not any(encoder.quantized(bp) for bp in src["blocks"])


def test_quantize_frozen_trees_match_jax():
    jcfg, tcfg = jax_configs.tiny(), torch_configs.tiny()
    jparams = jax.device_get(jax.jit(
        lambda k: jgrounding.init_params(jcfg, k))(jax.random.key(0)))
    tparams = from_jax(jparams)
    want_llm = jax.device_get(jgrounding.quantize_frozen_llm(
        jax.tree.map(jnp.asarray, jparams)))
    want_sam = jax.device_get(jgrounding.quantize_frozen_sam(
        jax.tree.map(jnp.asarray, jparams)))
    _assert_trees_equal(grounding.quantize_frozen_llm(tparams), want_llm)
    _assert_trees_equal(grounding.quantize_frozen_sam(tparams), want_sam)
    _assert_trees_equal(tparams, jparams)
    # and the quantised JAX trees carry across whole, int8 leaves included
    _assert_trees_equal(from_jax(want_sam), want_sam)


@pytest.mark.parametrize("windowed", [True, False], ids=["window", "global"])
def test_int8_block_takes_the_split_flash_route(windowed, monkeypatch):
    """A quantised block's flash route: the int8 products around the
    attention kernel's plain twin (K6 / K2 on a card), no K3 / K4 / K8, and
    the result equals the JAX plain block on the same int8 tree."""
    jcfg = jax_configs.tiny().sam.encoder
    tcfg = torch_configs.tiny().sam.encoder
    jparams = jax.device_get(jencoder.quantize_params(
        jax.tree.map(jnp.asarray, _sam_params(jcfg, 2))))
    i = [j for j in range(len(jparams["blocks"]))
         if (j in jcfg.global_attn_indexes) != windowed][0]
    jbp = jparams["blocks"][i]
    side = jcfg.img_size // jcfg.patch_size
    x = np.random.default_rng(4).normal(size=(2, side, side,
                                              jcfg.embed_dim)).astype(
        np.float32)
    want = jencoder._block(jnp.asarray(x), jax.tree.map(jnp.asarray, jbp),
                           jcfg, windowed=windowed)

    def refuse(*a, **k):
        raise AssertionError("a fused kernel's gate opened on int8 weights")

    for name in ("fused_ln_qkv", "fused_proj_ln_mlp", "fused_ln_mlp"):
        monkeypatch.setattr(encoder, name, refuse)
    tcfg = dataclasses.replace(tcfg, global_kernel="v8")
    for fn in (sam_flash.sam_window_attention_v9,
               sam_flash.sam_global_attention_v8):
        fn.launches = 0
    got = encoder._flash_block(torch.from_numpy(x), from_jax(jbp), tcfg,
                               windowed)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=1e-4,
                               rtol=1e-4)
    assert fused_block.fused_ln_qkv.launches == 0


class TieLedger:
    """The int8 activation codes of both forwards, product by product.

    The JAX forward's ``int8_matmul`` is wrapped to hand its codes and
    scales out of the jitted program (``jax.debug.callback``, in program
    order); the port's ``int8_matmul`` is wrapped to compare its own codes
    with the JAX ones of the same product (matched per ``(K, N)`` weight
    shape, in call order) and then to multiply the JAX codes.  So the port's
    forward runs on the int8 inputs of the JAX forward, and a code that the
    two sides round differently is counted, not carried on: such a code
    sits at a rounding tie that a last-bit difference upstream (an RMS or
    layer norm reduced in another order) moves."""

    def __init__(self):
        self.jax, self.products, self.codes = {}, 0, 0
        self.flips, self.far_flips = 0, 0

    def jax_int8_matmul(self, x, w_q, w_scale):
        xf = x.astype(jnp.float32)
        x_scale = jnp.maximum(jnp.abs(xf).max(axis=-1, keepdims=True),
                              1e-8) / 127.0
        x_q = jnp.clip(jnp.round(xf / x_scale), -127, 127).astype(jnp.int8)
        key = tuple(w_q.shape)
        jax.debug.callback(
            lambda q, sc: self.jax.setdefault(key, []).append(
                (np.asarray(q), np.asarray(sc))), x_q, x_scale, ordered=True)
        y = jax.lax.dot_general(x_q, w_q, (((x.ndim - 1,), (0,)), ((), ())),
                                preferred_element_type=jnp.int32)
        return (y.astype(jnp.float32) * x_scale * w_scale).astype(x.dtype)

    def port_int8_matmul(self, x, w_q, w_scale):
        jq, js = self.jax[tuple(w_q.shape)].pop(0)
        x_q, x_scale = quant.quantize_activations(x)
        jq, js = to_tensor(jq), to_tensor(js)
        assert jq.shape == x_q.shape
        diff = x_q.int() - jq.int()
        self.products += 1
        self.codes += diff.numel()
        self.flips += int((diff != 0).sum())
        # a flip at a tie moves a code by one; anything else is a fault
        self.far_flips += int((diff.abs() > 1).sum())
        y = quant.int8_product(jq.reshape(-1, x.shape[-1]), w_q)
        y = y.reshape(*x.shape[:-1], w_q.shape[1])
        return (y.float() * js * w_scale).to(x.dtype)


def _quantised_forwards(jcfg, tcfg, jparams, tparams, monkeypatch):
    ledger = TieLedger()
    monkeypatch.setattr(jquant, "int8_matmul", ledger.jax_int8_matmul)
    jq = jgrounding.quantize_frozen_sam(jgrounding.quantize_frozen_llm(
        jax.tree.map(jnp.asarray, jparams)))
    batch = jax_synthetic_batch(jcfg, batch_size=2, seed=0)
    want = jax.device_get(jax.jit(lambda p, b: jgrounding.forward(
        p, jcfg, b))(jq, jax.tree.map(jnp.asarray, batch)))
    jax.effects_barrier()
    tq = grounding.quantize_frozen_sam(grounding.quantize_frozen_llm(
        tparams))
    monkeypatch.setattr(quant, "int8_matmul", ledger.port_int8_matmul)
    with torch.no_grad():
        got = grounding.forward(tq, tcfg, from_jax(
            synthetic_batch(tcfg, batch_size=2, seed=0)))
    assert not any(ledger.jax.values()), "the JAX forward made more products"
    return got, want, ledger


@pytest.fixture(scope="module")
def quantised_outputs():
    cache = {}

    def outputs(preset):
        if preset not in cache:
            if preset == "tiny":
                jcfg, tcfg = jax_configs.tiny(), torch_configs.tiny()
            else:
                jcfg, tcfg = jax_hpt.tiny_hpt(), torch_hpt.tiny_hpt()
                jcfg = dataclasses.replace(jcfg, vision=dataclasses.replace(
                    jcfg.vision, flash=True))
                tcfg = dataclasses.replace(tcfg, vision=dataclasses.replace(
                    tcfg.vision, flash=True))
            jparams = jax.device_get(jax.jit(
                lambda k: jgrounding.init_params(jcfg, k))(jax.random.key(0)))
            for bp in jparams["frozen"]["sam_encoder"]["blocks"]:
                for key in ("rel_pos_h", "rel_pos_w"):
                    bp[key] = (0.02 * np.random.default_rng(7).normal(
                        size=bp[key].shape)).astype(bp[key].dtype)
            with pytest.MonkeyPatch.context() as mp:
                cache[preset] = _quantised_forwards(jcfg, tcfg, jparams,
                                                    from_jax(jparams), mp)
        return cache[preset]
    return outputs


@pytest.mark.parametrize("preset", ["tiny", "tiny_hpt"])
@pytest.mark.parametrize("key", ["coarse_logits", "sam_logits", "iou_pred",
                                 "hidden", "boxes"])
def test_quantised_forward_matches_jax(quantised_outputs, preset, key):
    """Both frozen trees quantised, on the tiny DeepSeek-VL and (its tower
    through the flash gate) HPT presets: 1e-3 of the JAX forward, the port
    multiplying the JAX forward's int8 activation codes (see
    :class:`TieLedger`)."""
    got, want, _ = quantised_outputs(preset)
    assert tuple(got[key].shape) == want[key].shape
    assert torch.isfinite(got[key]).all()
    np.testing.assert_allclose(got[key].numpy(), np.asarray(want[key]),
                               atol=SLICE_TOL, rtol=SLICE_TOL)


@pytest.mark.parametrize("preset", ["tiny", "tiny_hpt"])
def test_quantised_forward_codes_flip_only_at_ties(quantised_outputs, preset,
                                                   capsys):
    """The port's own activation codes against the JAX forward's: every
    product of both towers was made (decoder 7 a layer, SAM 4 a block), and
    a code that differs differs by one, at a rounding tie.  The count is
    printed."""
    _, _, ledger = quantised_outputs(preset)
    cfg = (jax_configs.tiny() if preset == "tiny" else jax_hpt.tiny_hpt())
    assert ledger.products == (7 * cfg.llm.num_layers
                               + 4 * cfg.sam.encoder.depth)
    assert ledger.far_flips == 0
    assert ledger.flips <= 1e-3 * ledger.codes
    with capsys.disabled():
        print(f"\n{preset}: {ledger.flips} of {ledger.codes} int8 activation "
              f"codes flipped at a rounding tie over {ledger.products} "
              "products")


def test_mgm_moe_forward_capture_on_a_quantised_decoder():
    """A MoE decoder: attention projections int8, expert stacks untouched,
    the capture forward within 1e-3 of JAX's on the same tree."""
    from flmm_tpu.configs import mgm as jax_mgm

    jcfg = dataclasses.replace(jax_mgm.tiny_mgm().base.llm, num_experts=4,
                               num_experts_per_tok=2)
    tcfg = dataclasses.replace(torch_mgm.tiny_mgm().base.llm, num_experts=4,
                               num_experts_per_tok=2)
    jparams = jdecoder.quantize_params(jax.tree.map(
        jnp.asarray, _decoder_params(jcfg, 3)))
    rng = np.random.default_rng(5)
    B, S, M = 2, 24, 2
    emb = (rng.normal(size=(B, S, jcfg.hidden_size)) * 0.3).astype(np.float32)
    mm = (rng.random((B, S, M)) > 0.7).astype(np.float32)
    lw = np.full((jcfg.num_layers,), 1.0 / jcfg.num_layers, np.float32)
    want = jax.device_get(jdecoder.forward_capture(
        jparams, jcfg, jnp.asarray(emb), jnp.ones((B, S), bool), img_start=3,
        n_img=8, merge_matrix=jnp.asarray(mm), layer_weights=jnp.asarray(lw)))
    got = decoder.forward_capture(
        from_jax(jax.device_get(jparams)), tcfg, torch.from_numpy(emb),
        torch.ones((B, S), dtype=torch.bool), 3, 8,
        merge_matrix=torch.from_numpy(mm), layer_weights=torch.from_numpy(lw))
    for k in ("attn", "hidden", "last_hidden"):
        np.testing.assert_allclose(got[k].numpy(), np.asarray(want[k]),
                                   atol=SLICE_TOL, rtol=SLICE_TOL)
