"""The port's MGM slice against the JAX package on the CPU: the presets, the
ConvNeXt aux tower, the patch-info mining ``unified_resampler``,
``encode_images``, ``assemble_attention``, the ``tiny_mgm`` forward (single
crop and HD) with the loss and every trainable gradient, and the Mixtral MoE
MLP.

Same weights on both sides: the port's seeded init, every constant ConvNeXt
and resampler leaf made random (the init's ``gamma`` of 1e-6, zero biases
and unit LayerNorms would hide most of the tower), non-zero SAM rel-pos
tables, as
numpy -> ``convert.from_jax`` for the port and ``jnp.asarray`` for JAX.
The HD forward runs in the port with the flash-capture gate open (the image
block at 128, K5's plain version on the CPU) and closed; the JAX forward it
is held to takes the XLA capture.

Tolerances: ConvNeXt 1e-4 in f32, ``unified_resampler`` 1e-5,
``assemble_attention`` 1e-6, ``encode_images`` 1e-4, the forward's coarse
and SAM logits 1e-3, the loss 1e-6 (relative), each trainable gradient 1e-3
of its largest magnitude (floored at 1e-5 of the largest gradient), the MoE
MLP 1e-5 in f32.

The gradient bound sits near the f32 noise of these weights: the tiny
SAM's mask downscaling normalises over 2 channels, which magnifies
rounding, so the JAX gradients of ``sam/prompt/mask_down`` move by up to
1.35e-3 between its jitted and its eager run at seed 0 (the port: 1.5e-3
there; on the same maps and hidden states the heads alone agree to 6e-4).
The weights come from seed 4, where the JAX runs agree with each other to
1.4e-4 (single crop) and 1.7e-4 (HD).  Seed 3's single-crop coarse logits
hold 891 exact zeros, where the JAX BCE's derivative is off by 1/2
(ROADMAP queue 3): ``test_bce_derivative_at_a_zero_logit`` pins both
packages there.
"""

import dataclasses

import numpy as np
import jax
import jax.numpy as jnp
import pytest
import torch

from flmm_tpu.configs import mgm as jconfigs
from flmm_tpu.models.frozen import mgm as jmgm
from flmm_tpu.models.llm import decoder as jdecoder
from flmm_tpu.models.vision import convnext as jconvnext
from flmm_tpu_torch import bench, registry
from flmm_tpu_torch.configs import mgm as tconfigs
from flmm_tpu_torch.convert.from_jax import from_jax
from flmm_tpu_torch.models.frozen import mgm
from flmm_tpu_torch.models.llm import decoder
from flmm_tpu_torch.models.vision import convnext
from flmm_tpu_torch.train import loop
from tests.test_torch_hybrid import _assert_same_fields, _jnp, _numpy

CONVNEXT_TOL, RESAMPLER_TOL, ASSEMBLE_TOL, ENCODE_TOL = 1e-4, 1e-5, 1e-6, 1e-4
SLICE_TOL, LOSS_TOL, MOE_TOL = 1e-3, 1e-6, 1e-5
IMG_START = 128  # the HD image block where the flash gate opens
OUT_KEYS = ("coarse_logits", "sam_logits", "iou_pred", "boxes", "hidden")
PRESETS = ("gemma_2b", "vicuna_7b", "vicuna_7b_hd", "mistral_7b",
           "mixtral_8x7b", "tiny")


def _randomize(tree, g, scale=0.1):
    """Every constant leaf of a subtree (biases, LayerNorms, ``gamma``)
    moved by noise of std ``scale``, as a trained checkpoint has them; the
    drawn kernels keep their 1 / sqrt(fan_in) spread."""
    if isinstance(tree, dict):
        return {k: _randomize(v, g, scale) for k, v in tree.items()}
    if isinstance(tree, list):
        return [_randomize(v, g, scale) for v in tree]
    if bool((tree != tree.flatten()[0]).any()):
        return tree
    return (tree.float() + torch.randn(tree.shape, generator=g) * scale
            ).to(tree.dtype)


SEED = 4


def seeded_params(cfg, seed: int = SEED) -> dict:
    """The port's init with the aux tower and the resampler projections
    random and non-zero SAM rel-pos tables, as numpy."""
    g = torch.Generator().manual_seed(seed)
    params = mgm.init_params(cfg, g, "cpu")
    fro = params["frozen"]
    for key in ("aux_tower", "uni_query", "uni_aux", "uni_val"):
        fro[key] = _randomize(fro[key], g)
    bench.randomize_frozen(params, g)
    return _numpy(params)


def _flash(cfg, on: bool):
    base = cfg.base
    return dataclasses.replace(cfg, base=dataclasses.replace(
        base, llm=dataclasses.replace(base.llm, use_flash_capture=on)))


# --- presets --------------------------------------------------------------

@pytest.mark.parametrize("preset", PRESETS)
def test_presets_are_the_jax_packages(preset):
    """Field by field through the registry, at the preset's own image block
    and at 128; an HD preset captures through the flash kernel exactly when
    its image block is 128-aligned, the single-crop ones never."""
    for kw in ({}, {"img_start": IMG_START}):
        want = jregistry_config(preset, **kw)
        got = registry.get_config("mgm", preset, **kw)
        _assert_same_fields(want, got)
        hd = got.num_crops > 1
        assert got.base.llm.use_flash_capture == (hd and bool(kw))
        plain = registry.plain_config(got)
        assert not plain.base.llm.use_flash_capture
        assert plain.aux == got.aux
    assert (got.map_hw, got.grid_tokens) == (
        (got.base.clip_shape * got.image_grid,) * 2, got.base.clip_shape ** 2)


def jregistry_config(preset, **kw):
    from flmm_tpu import registry as jregistry

    return jregistry.get_config("mgm", preset, **kw)


def test_decoder_and_tower_presets_are_the_jax_packages():
    """Gemma-2B, Mixtral-8x7B and the EVA-G/14 tower."""
    for name in ("gemma_2b", "mixtral_8x7b", "eva_g_14"):
        _assert_same_fields(getattr(jconfigs, name)(),
                            getattr(tconfigs, name)())
    cfg = tconfigs.mgm_vicuna_7b_hd()
    assert (cfg.num_crops, cfg.base.num_img_tokens, cfg.aux.out_channels,
            cfg.base.unet.in_channels) == (5, 2880, 2880, 2 * 32 * 32)
    assert registry.get_coarse_hw(cfg) == (64, 64)
    assert registry.get_coarse_hw(tconfigs.mgm_gemma_2b()) == (64, 64)


# --- modules ---------------------------------------------------------------

@pytest.mark.parametrize("which", ["tiny", "convnext_l_cut"])
def test_convnext_matches_jax(which):
    """The tiny tower at 64 px and ConvNeXt-L's widths (192 ... 1536, 2880
    channels out) cut to one block a stage at 64 px, in f32."""
    if which == "tiny":
        jcfg, tcfg = (jconfigs.tiny_mgm().aux, tconfigs.tiny_mgm().aux)
    else:
        jcfg = jconvnext.ConvNeXtConfig(depths=(1, 1, 1, 1), image_size=64)
        tcfg = convnext.ConvNeXtConfig(depths=(1, 1, 1, 1), image_size=64)
    g = torch.Generator().manual_seed(1)
    params = _numpy(_randomize(convnext.init_params(tcfg, g, "cpu"), g))
    px = np.random.default_rng(0).standard_normal(
        (2, 64, 64, 3)).astype(np.float32)
    want = jconvnext.forward(_jnp(params), jcfg, jnp.asarray(px))
    got = convnext.forward(from_jax(params), tcfg, torch.from_numpy(px))
    assert tuple(got.shape) == (2, 16, 16, tcfg.out_channels)
    np.testing.assert_allclose(got.numpy(), np.asarray(want),
                               atol=CONVNEXT_TOL, rtol=CONVNEXT_TOL)


@pytest.fixture(scope="module", params=[False, True], ids=["single", "hd"])
def tiny(request):
    """(JAX config, port config, weights as numpy, a batch) at
    ``tiny_mgm(hd=...)``, the image block at 128 for HD."""
    hd = request.param
    kw = {"hd": True, "img_start": IMG_START} if hd else {}
    jcfg, tcfg = jconfigs.tiny_mgm(**kw), tconfigs.tiny_mgm(**kw)
    params = seeded_params(tcfg)
    # built as for the gate open: S a multiple of 128 for HD
    batch = bench.samples_batch(_flash(tcfg, hd), "mgm", 2, 0)
    assert (batch["input_ids"].shape[1] % 128 == 0) == hd
    return jcfg, tcfg, params, batch


def test_tiny_mgm_tree_is_the_jax_init_tree(tiny):
    """The port's init has the JAX init's leaves, shapes and dtypes (the
    JAX tree traced, not built): the aux tower, the f32 resampler
    projections, Gemma's tied head (no ``lm_head``)."""
    jcfg, _, params, _ = tiny
    abstract = jax.eval_shape(lambda k: jmgm.init_params(jcfg, k),
                              jax.random.key(0))
    want = {jax.tree_util.keystr(p): (a.shape, np.dtype(a.dtype).name)
            for p, a in jax.tree_util.tree_leaves_with_path(abstract)}
    got = {jax.tree_util.keystr(p): (a.shape, a.dtype.name)
           for p, a in jax.tree_util.tree_leaves_with_path(params)}
    assert got == want
    assert "lm_head" not in params["frozen"]["llm"]
    assert params["frozen"]["uni_aux"]["w"].dtype == np.float32


def test_unified_resampler_matches_jax(tiny):
    """Both grids the presets give it (per crop window and global), and a
    NaN query whose scores ``nan_to_num`` zeroes (a uniform softmax)."""
    jcfg, tcfg, params, _ = tiny
    fro = params["frozen"]
    rng = np.random.default_rng(3)
    pn = tcfg.base.clip_shape
    for A in (pn * 2, pn * 4):
        feats = rng.standard_normal((3, pn * pn, 32)).astype(np.float32)
        feats[1, 2] = np.nan
        aux = rng.standard_normal((3, A, A, tcfg.aux.out_channels)).astype(
            np.float32)
        want = jmgm.unified_resampler(_jnp(fro), jnp.asarray(feats),
                                      jnp.asarray(aux), pn)
        got = mgm.unified_resampler(from_jax(fro), torch.from_numpy(feats),
                                    torch.from_numpy(aux), pn)
        assert got.dtype == torch.float32 and torch.isfinite(got).all()
        np.testing.assert_allclose(got.numpy(), np.asarray(want),
                                   atol=RESAMPLER_TOL, rtol=RESAMPLER_TOL)


def test_assemble_attention_matches_jax(tiny):
    jcfg, tcfg, _, _ = tiny
    attn = np.random.default_rng(2).random(
        (2, 3, 4, 3, tcfg.base.num_img_tokens)).astype(np.float32)
    want = jmgm.assemble_attention(jcfg, jnp.asarray(attn))
    got = mgm.assemble_attention(tcfg, torch.from_numpy(attn))
    mh, mw = tcfg.map_hw
    chans = 3 * 4 * (2 if tcfg.image_global else 1)
    assert tuple(got.shape) == (2 * 3, mh, mw, chans)
    np.testing.assert_allclose(got.numpy(), np.asarray(want),
                               atol=ASSEMBLE_TOL, rtol=ASSEMBLE_TOL)


def test_encode_images_matches_jax(tiny):
    """Token order ``[global | locals]`` for HD; the aux pixels reach the
    embeddings."""
    jcfg, tcfg, params, batch = tiny
    want = jmgm.encode_images(_jnp(params), jcfg,
                              jnp.asarray(batch["pixel_values"]),
                              jnp.asarray(batch["aux_pixel_values"]))
    tp = from_jax(params)
    got = mgm.encode_images(tp, tcfg, torch.from_numpy(batch["pixel_values"]),
                            torch.from_numpy(batch["aux_pixel_values"]))
    moved = mgm.encode_images(
        tp, tcfg, torch.from_numpy(batch["pixel_values"]),
        torch.from_numpy(batch["aux_pixel_values"] + 0.5))
    assert tuple(got.shape) == (2, tcfg.base.num_img_tokens,
                                tcfg.base.llm.hidden_size)
    np.testing.assert_allclose(got.numpy(), np.asarray(want),
                               atol=ENCODE_TOL, rtol=ENCODE_TOL)
    assert not torch.allclose(moved, got)


@pytest.fixture(scope="module")
def jax_forward(tiny):
    jcfg, _, params, batch = tiny
    return jax.device_get(jax.jit(lambda p, b: jmgm.forward(p, jcfg, b))(
        _jnp(params), _jnp(batch)))


@pytest.mark.parametrize("flash", [True, False], ids=["flash", "eager"])
def test_tiny_mgm_forward_matches_jax(tiny, jax_forward, flash):
    """The single-crop preset takes the eager capture either way (the gate
    needs a 128-aligned block); HD at 128 goes through K5's plain version
    with the gate open."""
    _, tcfg, params, batch = tiny
    tcfg = _flash(tcfg, flash)
    assert registry.get_model("mgm").forward is mgm.forward
    with torch.no_grad():
        got = mgm.forward(from_jax(params), tcfg, from_jax(batch))
    for key in OUT_KEYS:
        assert tuple(got[key].shape) == jax_forward[key].shape, key
        assert torch.isfinite(got[key]).all(), key
        np.testing.assert_allclose(got[key].numpy(),
                                   np.asarray(jax_forward[key]),
                                   atol=SLICE_TOL, rtol=SLICE_TOL,
                                   err_msg=key)


def test_tiny_mgm_loss_and_gradients_match_jax(tiny):
    """``mgm.loss_fn`` as tests/test_torch_train.py holds the tiny loss; the
    frozen tree -- aux tower and resampler included -- gets no gradient."""
    jcfg, tcfg, params, batch = tiny
    vg = jax.jit(jax.value_and_grad(
        lambda tr, fr, b: jmgm.loss_fn({"frozen": fr, "trainable": tr},
                                       jcfg, b), has_aux=True))
    (jloss, jmetrics), jgrads = jax.device_get(vg(
        _jnp(params["trainable"]), _jnp(params["frozen"]), _jnp(batch)))
    tp = from_jax(params)
    state = loop.init_state(tp["trainable"],
                            loop.make_optimizer(loop.OptimConfig()))
    (loss, metrics), grads = loop.value_and_grad(
        lambda p, b: registry.get_model("mgm").loss_fn(p, tcfg, b),
        tp["frozen"], state["params"], from_jax(batch))
    assert abs(float(loss) - float(jloss)) <= LOSS_TOL * abs(float(jloss))
    for key, want in jmetrics.items():
        np.testing.assert_allclose(metrics[key].numpy(), want,
                                   rtol=SLICE_TOL, atol=1e-6, err_msg=key)
    want = dict(loop.tree_leaves(jgrads))
    assert set(grads) == set(want)
    scale = max(np.abs(g).max() for g in want.values())
    for path, ref in want.items():
        got = (np.zeros_like(ref) if grads[path] is None
               else grads[path].numpy())
        err = np.abs(got - ref).max() / max(np.abs(ref).max(), 1e-5 * scale)
        assert err <= SLICE_TOL, (path, err)
    for path, leaf in loop.tree_leaves(tp["frozen"]):
        assert not leaf.requires_grad and leaf.grad is None, path


# --- the MoE MLP -------------------------------------------------------------

MOE = dict(vocab_size=64, hidden_size=32, num_layers=2, num_heads=4,
           num_kv_heads=2, head_dim=8, intermediate_size=48, num_experts=4,
           num_experts_per_tok=2)


@pytest.mark.parametrize("ties", [False, True], ids=["distinct", "tied"])
def test_moe_mlp_matches_jax(ties):
    """Mixtral's MLP computed densely, in f32.  ``tied``: experts 1 and 2
    have the same router column, so wherever they share the k-th largest
    logit both stay in the softmax -- the JAX threshold rule, which
    ``torch.topk``'s indices would not give."""
    jcfg = jdecoder.DecoderConfig(dtype=jnp.float32, **MOE)
    tcfg = decoder.DecoderConfig(dtype=torch.float32, **MOE)
    params = jax.device_get(jdecoder.init_params(jcfg, jax.random.key(3)))
    lp = {k: v[0] for k, v in params["layers"].items()}
    if ties:
        lp["router"] = lp["router"].copy()
        lp["router"][:, 2] = lp["router"][:, 1]
    x = np.random.default_rng(0).standard_normal((2, 7, 32)).astype(
        np.float32)
    want = jdecoder._mlp(jnp.asarray(x), _jnp(lp), jcfg)
    got = decoder.mlp(torch.from_numpy(x), from_jax(lp), tcfg)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=MOE_TOL,
                               rtol=MOE_TOL)
    gates = decoder.moe_gates(torch.from_numpy(x) @ from_jax(lp)["router"], 2)
    live = (gates > 0).sum(-1)
    if ties:  # a tie at the k-th place keeps three experts
        assert (live == 3).any() and (live >= 2).all()
    else:
        assert (live == 2).all()
    np.testing.assert_allclose(gates.sum(-1).numpy(), 1.0, rtol=1e-6)


def test_moe_tree_and_init():
    """The router ``(L, d, E)`` and the expert stacks ``(L, E, d, f)`` /
    ``(L, E, f, d)`` of the JAX tree; ``DecoderConfig`` takes experts."""
    jcfg = jdecoder.DecoderConfig(dtype=jnp.float32, **MOE)
    tcfg = decoder.DecoderConfig(dtype=torch.float32, **MOE)
    abstract = jax.eval_shape(lambda k: jdecoder.init_params(jcfg, k),
                              jax.random.key(0))
    got = decoder.init_params(tcfg, torch.Generator().manual_seed(0), "cpu")
    want = {jax.tree_util.keystr(p): a.shape
            for p, a in jax.tree_util.tree_leaves_with_path(abstract)}
    assert {jax.tree_util.keystr(p): tuple(a.shape) for p, a in
            jax.tree_util.tree_leaves_with_path(_numpy(got))} == want
    assert tuple(got["layers"]["router"].shape) == (2, 32, 4)


def test_bce_derivative_at_a_zero_logit():
    """The BCE term's derivative at a logit of exactly 0 is the reference's
    ``sigmoid(0) - t`` (PyTorch's ``binary_cross_entropy_with_logits``, what
    mmdet's loss calls).  The JAX package's ``maximum`` and ``abs`` give
    ``-t`` there, a fault of the reference package that the port does not
    copy: at init the U-Net's dead pixels give exact zeros (891 of 4096
    coarse logits of ``tiny_mgm`` at seed 3).  Elsewhere the two agree."""
    from flmm_tpu.models.frozen.base import grounding_losses as jgl
    from flmm_tpu_torch.models.frozen.base import grounding_losses as tgl
    from flmm_tpu_torch.ops import losses

    logits = np.array([[[[0.0, 0.0], [-1.5, 2.0]]]], np.float32)
    gt = np.array([[[[0.0, 1.0], [1.0, 0.0]]]], np.float32)
    zeros, ones = np.zeros_like(logits), np.ones((1, 2, 2), np.float32)
    valid = np.ones((1, 1), bool)

    x = torch.tensor(logits, requires_grad=True)
    losses.bce_terms(x, torch.tensor(gt)).sum().backward()
    xr = torch.tensor(logits, requires_grad=True)
    torch.nn.functional.binary_cross_entropy_with_logits(
        xr, torch.tensor(gt), reduction="sum").backward()
    torch.testing.assert_close(x.grad, xr.grad)
    assert x.grad.ravel()[:2].tolist() == [0.5, -0.5]

    def jloss(c):
        return jgl(c, gt, ones, jnp.asarray(zeros), zeros, ones,
                   valid)["loss_mask"]

    # loss_mask is the mean over the 4 valid pixels
    jgrad = np.asarray(jax.grad(jloss)(jnp.asarray(logits))).ravel() * 4
    c = torch.tensor(logits, requires_grad=True)
    tgl(c, torch.tensor(gt), torch.tensor(ones), torch.tensor(zeros),
        torch.tensor(zeros), torch.tensor(ones),
        torch.tensor(valid))["loss_mask"].backward()
    tgrad = c.grad.numpy().ravel() * 4
    np.testing.assert_allclose(tgrad, xr.grad.numpy().ravel(), rtol=1e-6)
    np.testing.assert_allclose(jgrad[:2], [0.0, -1.0], atol=1e-7)
    np.testing.assert_allclose(jgrad[2:], tgrad[2:], rtol=1e-6)
