"""The port's HPT slice against the JAX package on the CPU: the bicubic
resize and position-embedding resample, the plain versions of K7 (tower
flash attention), K8 (LN2 + MLP) and K10 (the attention half of a global SAM
block) against the Pallas kernels in interpret mode, the SAM encoder with
the whole-block global path, the ``tiny_hpt`` grounding forward (a 64 px
input over a native 32 px grid, so the resample runs), the synthetic batch
and the registry.

Inputs come from seeded numpy generators and go to both sides.  The CUDA
kernels run only on the card (chip_smoke.py holds each against these plain
versions); here every new wrapper is called on CPU tensors, where it must
take its plain version and launch nothing.

Tolerances: 1e-5 for the resize (f32, the same taps and weights; 4e-2 where
the input and result are rounded to bf16); 1e-4 for
single modules in f32 (other summation orders; the TPU kernels use a base-2
softmax and a rational erf); 2e-2 for bf16 attention (probabilities rounded
to 8 bits of mantissa before the value product on both sides); 1e-3 for the
whole forward and the encoder.
"""

import dataclasses

import numpy as np
import jax
import jax.numpy as jnp
import pytest
import torch

from flmm_tpu import registry as jregistry
from flmm_tpu.configs import hpt as jax_hpt
from flmm_tpu.data.synthetic import synthetic_batch as jax_synthetic_batch
from flmm_tpu.models.frozen import grounding as jgrounding
from flmm_tpu.models.sam import image_encoder as jencoder
from flmm_tpu.models.vision import vit as jvit
from flmm_tpu.ops import fused_block as jfb
from flmm_tpu.ops import global_block as jgb
from flmm_tpu.ops import resize as jresize
from flmm_tpu.ops import sam_flash as jsf
from flmm_tpu.ops import window_block as jwb
from flmm_tpu_torch import registry
from flmm_tpu_torch.configs import hpt as torch_hpt
from flmm_tpu_torch.convert.from_jax import from_jax
from flmm_tpu_torch.data.synthetic import synthetic_batch
from flmm_tpu_torch.models.frozen import grounding
from flmm_tpu_torch.models.sam import image_encoder as encoder
from flmm_tpu_torch.models.vision import vit
from flmm_tpu_torch.ops import fused_block, global_block, resize, sam_flash, \
    window_block

RESIZE_TOL = 1e-5
MODULE_TOL = 1e-4
BF16_ATTN_TOL = 2e-2
SLICE_TOL = 1e-3


def _r(rng, *shape, scale=1.0, shift=0.0):
    return (rng.standard_normal(shape) * scale + shift).astype(np.float32)


def _t(*arrays):
    return [torch.from_numpy(a) for a in arrays]


def _close(got, want, tol=MODULE_TOL):
    np.testing.assert_allclose(got.detach().float().numpy(),
                               np.asarray(want, dtype=np.float32), atol=tol,
                               rtol=tol)


@pytest.mark.parametrize("in_hw,out_hw", [
    ((16, 16), (25, 25)), ((16, 16), (9, 9)), ((12, 20), (30, 7)),
    ((4, 4), (8, 8))])
def test_resize_bicubic_matches_jax(in_hw, out_hw):
    x = _r(np.random.default_rng(0), 3, *in_hw)
    want = jresize.resize_bicubic(jnp.asarray(x), out_hw)
    got = resize.resize_bicubic(torch.from_numpy(x), out_hw)
    assert tuple(got.shape) == (3, *out_hw)
    _close(got, want, RESIZE_TOL)
    half = resize.resize_bicubic(torch.from_numpy(x).bfloat16(), out_hw)
    assert half.dtype == torch.bfloat16  # computed in f32, cast back
    _close(half, want, 4e-2)


@pytest.mark.parametrize("has_cls", [False, True])
@pytest.mark.parametrize("new_grid", [8, 3, 4])
def test_resample_pos_embed_matches_jax(has_cls, new_grid):
    old, d = 4, 24
    pos = _r(np.random.default_rng(1), old * old + has_cls, d)
    want = jvit.resample_pos_embed(jnp.asarray(pos), old, new_grid, has_cls)
    got = vit.resample_pos_embed(torch.from_numpy(pos), old, new_grid,
                                 has_cls)
    assert tuple(got.shape) == (new_grid * new_grid + has_cls, d)
    _close(got, want, RESIZE_TOL)
    if has_cls:  # the class token's row is kept aside
        np.testing.assert_array_equal(got[0].numpy(), pos[0])


@pytest.mark.parametrize("hd", [64, 72])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_plain_flash_attention_plain_matches_pallas(hd, dtype):
    """S = 75 is no multiple of 128: the TPU kernel pads and masks keys."""
    rng = np.random.default_rng(2)
    G, S = 3, 75
    q, k, v = (_r(rng, G, S, hd, scale=0.4) for _ in range(3))
    jdt, tdt = getattr(jnp, dtype), getattr(torch, dtype)
    want = jsf.plain_flash_attention(
        *(jnp.asarray(a).astype(jdt) for a in (q, k, v)), interpret=True,
        block_q=64)
    got = sam_flash.plain_flash_attention_plain(
        *(t.to(tdt) for t in _t(q, k, v)))
    assert got.dtype == tdt and tuple(got.shape) == (G, S, hd)
    _close(got, want.astype(jnp.float32),
           MODULE_TOL if dtype == "float32" else BF16_ATTN_TOL)


def _mlp_weights(rng, C, F):
    return (_r(rng, C, scale=0.1, shift=1.0), _r(rng, C, scale=0.1),
            _r(rng, C, F, scale=C ** -0.5), _r(rng, F, scale=0.1),
            _r(rng, F, C, scale=F ** -0.5), _r(rng, C, scale=0.1))


@pytest.mark.parametrize("act,shape", [
    ("gelu", (2, 16, 16, 128)), ("gelu", (312, 128)),
    ("gelu_tanh", (312, 128)), ("quick_gelu", (312, 128))])
def test_fused_ln_mlp_plain_matches_pallas(act, shape):
    """312 rows are no multiple of the TPU block: the kernel pads rows with
    zeros and slices them off."""
    rng = np.random.default_rng(3)
    x = _r(rng, *shape)
    w = _mlp_weights(rng, 128, 512)
    want = jfb.fused_ln_mlp(*map(jnp.asarray, (x, *w)), block_n=128,
                            block_f=256, act=act, interpret=True)
    got = fused_block.fused_ln_mlp_plain(*_t(x, *w), act=act)
    assert tuple(got.shape) == shape
    _close(got, want)


def _global_block_inputs(rng, B=2, side=8, nh=2, hd=16):
    C = nh * hd
    return dict(
        x=_r(rng, B, side * side, C, scale=0.3),
        wqkv=_r(rng, C, 3 * C, scale=0.2), bqkv=_r(rng, 3 * C, scale=0.1),
        wo=_r(rng, C, C, scale=0.2), bo=_r(rng, C, scale=0.1),
        lw=_r(rng, C, scale=0.1, shift=1.0), lb=_r(rng, C, scale=0.1),
        rph=_r(rng, 2 * side - 1, hd, scale=0.1),
        rpw=_r(rng, 2 * side - 1, hd, scale=0.1))


def test_global_attn_block_plain_matches_pallas(monkeypatch):
    """Bias rows and the half-block, f32 result, against the Pallas kernel
    in interpret mode at the size of tests/test_global_block.py; the plain
    version's query rows go in 4 chunks."""
    side, nh, hd = 8, 2, 16
    C = nh * hd
    p = _global_block_inputs(np.random.default_rng(4), 2, side, nh, hd)
    j = {k: jnp.asarray(v) for k, v in p.items()}
    jw_s, jb_s = jwb.scaled_qkv_weights(j["wqkv"], j["bqkv"], nh, hd)
    jbias = jgb.global_rel_bias_from_x(
        j["x"], j["lw"], j["lb"], jw_s[:, :C], jb_s[:C], j["rph"], j["rpw"],
        side, nh, hd)
    want = jgb.global_attn_block(j["x"], jbias, j["lw"], j["lb"], jw_s, jb_s,
                                 j["wo"], j["bo"], side, nh, interpret=True)

    t = {k: torch.from_numpy(v) for k, v in p.items()}
    w_s, b_s = window_block.scaled_qkv_weights(t["wqkv"], t["bqkv"], nh, hd)
    bias = global_block.global_rel_bias_from_x(
        t["x"], t["lw"], t["lb"], w_s[:, :C], b_s[:C], t["rph"], t["rpw"],
        side, nh, hd)
    assert tuple(bias.shape) == (2, nh, side * side, 2 * side)
    _close(bias, jbias)
    monkeypatch.setattr(sam_flash, "MAX_PLAIN_SCORES",
                        2 * nh * side * side * 16)
    got = global_block.global_attn_block_plain(
        t["x"], bias, t["lw"], t["lb"], w_s, b_s, t["wo"], t["bo"], side, nh)
    assert got.dtype == torch.float32 and want.dtype == jnp.float32
    _close(got, want)


def test_global_attn_block_result_is_f32_for_bf16_inputs():
    side, nh, hd = 4, 2, 8
    C = nh * hd
    p = {k: torch.from_numpy(v).bfloat16() for k, v in _global_block_inputs(
        np.random.default_rng(5), 1, side, nh, hd).items()}
    w_s, b_s = window_block.scaled_qkv_weights(p["wqkv"], p["bqkv"], nh, hd)
    bias = global_block.global_rel_bias_from_x(
        p["x"], p["lw"], p["lb"], w_s[:, :C], b_s[:C], p["rph"], p["rpw"],
        side, nh, hd)
    assert bias.dtype == torch.bfloat16
    out = global_block.global_attn_block(
        p["x"], bias, p["lw"], p["lb"], w_s, b_s, p["wo"], p["bo"], side, nh)
    assert out.dtype == torch.float32 and tuple(out.shape) == (1, 16, C)
    assert torch.isfinite(out).all()


def _global_encoder():
    """Side-16 global grid (S = 256, the % 256 gate), 3 x 3 windows of 7 on
    a padded grid, blocks 1 and 3 global."""
    kw = dict(img_size=128, patch_size=8, embed_dim=128, depth=4, num_heads=2,
              out_chans=32, window_size=7, global_attn_indexes=(1, 3))
    jcfg = jencoder.SamEncoderConfig(dtype=jnp.float32, **kw)
    tcfg = encoder.SamEncoderConfig(
        dtype=torch.float32, window_block_fused=True,
        global_block_fused=True, **kw)
    params = jax.device_get(jax.jit(lambda k: jencoder.init_params(
        jcfg, k))(jax.random.key(0)))
    rng = np.random.default_rng(6)
    for bp in params["blocks"]:
        for key in ("rel_pos_h", "rel_pos_w"):
            bp[key] = _r(rng, *bp[key].shape, scale=0.1)
    return jcfg, tcfg, params


def test_sam_encoder_global_block_fused_matches_jax_interpret(monkeypatch):
    """The JAX encoder through its whole-block window and global kernels in
    interpret mode against the port's encoder with the same switches (plain
    path on CPU tensors)."""
    jcfg, tcfg, params = _global_encoder()
    px = _r(np.random.default_rng(7), 2, 128, 128, 3, scale=0.5)
    monkeypatch.setattr(jwb, "INTERPRET", True)
    monkeypatch.setattr(jgb, "INTERPRET", True)
    want = jencoder.forward(
        jax.tree.map(jnp.asarray, params),
        dataclasses.replace(jcfg, window_block_fused=True,
                            global_block_fused=True), jnp.asarray(px))
    got = encoder.forward(from_jax(params), tcfg, torch.from_numpy(px))
    assert tuple(got.shape) == (2, 16, 16, 32)
    _close(got, want, SLICE_TOL)


def test_global_block_fused_route_matches_jax_plain_block():
    """``_global_block_fused`` (K10 then K8, plain versions on the CPU, one
    cast of the f32 half-block) against JAX's plain global ``_block``."""
    jcfg, tcfg, params = _global_encoder()
    bp = params["blocks"][1]
    x = _r(np.random.default_rng(8), 2, 16, 16, 128, scale=0.5)
    want = jencoder._block(jnp.asarray(x), jax.tree.map(jnp.asarray, bp),
                           jcfg, windowed=False)
    got = encoder._global_block_fused(torch.from_numpy(x), from_jax(bp), tcfg)
    _close(got, want)
    _close(encoder._ln_mlp_residual(torch.from_numpy(x), from_jax(bp), tcfg),
           jencoder._ln_mlp_residual(jnp.asarray(x),
                                     jax.tree.map(jnp.asarray, bp), jcfg))
    assert global_block.global_attn_block.launches == 0
    assert fused_block.fused_ln_mlp.launches == 0


@pytest.fixture(scope="module")
def hpt_outputs():
    """``flash -> (port outputs, JAX outputs)`` of the ``tiny_hpt`` forward
    on the same weights (JAX init -> numpy -> ``from_jax``) and batch."""
    jcfg = jax_hpt.tiny_hpt()
    jparams = jax.device_get(jax.jit(
        lambda k: jgrounding.init_params(jcfg, k))(jax.random.key(0)))
    rng = np.random.default_rng(9)  # a pos-embed the resample has to bend
    pos = jparams["frozen"]["vision"]["pos_embed"]
    jparams["frozen"]["vision"]["pos_embed"] = _r(rng, *pos.shape, scale=0.5)
    batch = jax_synthetic_batch(jcfg, batch_size=2, seed=0)
    want = jax.device_get(jax.jit(lambda p, b: jgrounding.forward(
        p, jcfg, b))(jparams, jax.tree.map(jnp.asarray, batch)))
    tparams = from_jax(jparams)
    jloss, _ = jax.jit(lambda p, b: jgrounding.loss_fn(p, jcfg, b))(
        jparams, jax.tree.map(jnp.asarray, batch))
    want["loss"] = np.asarray(jloss)
    cache = {}

    def outputs(flash):
        if flash not in cache:
            tcfg = torch_hpt.tiny_hpt()
            tcfg = dataclasses.replace(tcfg, vision=dataclasses.replace(
                tcfg.vision, flash=flash))
            with torch.no_grad():
                tbatch = from_jax(synthetic_batch(tcfg, batch_size=2, seed=0))
                cache[flash] = grounding.forward(tparams, tcfg, tbatch)
                cache[flash]["loss"] = grounding.loss_fn(tparams, tcfg,
                                                         tbatch)[0]
        return cache[flash], want
    return outputs


@pytest.mark.parametrize("flash", [False, True], ids=["eager", "flash"])
@pytest.mark.parametrize("key", ["coarse_logits", "sam_logits", "iou_pred",
                                 "hidden", "boxes", "loss"])
def test_tiny_hpt_forward_matches_jax(hpt_outputs, flash, key):
    """The five outputs of the forward and the training loss, which the
    ``hpt`` family takes from the same model module."""
    got, want = hpt_outputs(flash)
    assert tuple(got[key].shape) == want[key].shape
    assert torch.isfinite(got[key]).all()
    _close(got[key], want[key], SLICE_TOL)


def test_tiny_hpt_tower_resamples_above_the_native_grid():
    """64 px over a native 32 px grid: 8 x 8 patches + CLS out of a 4 x 4
    position embedding, against the JAX tower; a non-square input raises."""
    jcfg, tcfg = jax_hpt.tiny_hpt().vision, torch_hpt.tiny_hpt().vision
    params = jax.device_get(jax.jit(lambda k: jvit.init_params(jcfg, k))(
        jax.random.key(1)))
    px = _r(np.random.default_rng(10), 2, 64, 64, 3)
    want = jvit.forward(params, jcfg, jnp.asarray(px), select_layer=-2)
    got = vit.forward(from_jax(params), tcfg, torch.from_numpy(px),
                      select_layer=-2)
    assert tuple(got.shape) == (2, 65, 32)
    _close(got, want)
    with pytest.raises(ValueError, match="non-square"):
        vit.forward(from_jax(params), tcfg, torch.zeros(1, 64, 48, 3))


@pytest.mark.parametrize("preset", ["tiny", "air", "air_1_5"])
def test_hpt_init_params_tree_matches_jax(preset):
    """Keys, shapes and dtypes of the whole tree, without allocating the
    full-size trees (``eval_shape`` on one side, the meta device on the
    other)."""
    jcfg = jregistry.get_config("hpt", preset)
    tcfg = registry.get_config("hpt", preset)
    want = jax.eval_shape(lambda k: jgrounding.init_params(jcfg, k),
                          jax.random.key(0))
    got = grounding.init_params(tcfg, None, "meta")

    def signature(tree, path=""):
        if isinstance(tree, dict):
            items = tree.items()
        elif isinstance(tree, (list, tuple)):
            items = enumerate(tree)
        else:
            return {path: (tuple(tree.shape),
                           str(tree.dtype).replace("torch.", ""))}
        out = {}
        for k, v in items:
            out.update(signature(v, f"{path}/{k}"))
        return out

    assert signature(got) == signature(want)


@pytest.mark.parametrize("preset,kwargs", [
    ("tiny", {}), ("air", {"batch_size": 1}),
    ("air_1_5", {"batch_size": 1, "seq_len": 1280, "max_masks": 8,
                 "text_tokens_per_mask": 12})])
def test_synthetic_batch_is_bit_identical_for_hpt(preset, kwargs):
    """``image_input_size`` (64 / 392 / 448) sets the tower's pixels, and
    the image block of the flagship sits at 128."""
    extra = {"img_start": 128} if preset == "air_1_5" else {}
    jcfg = jregistry.get_config("hpt", preset, **extra)
    tcfg = registry.get_config("hpt", preset, **extra)
    want = jax_synthetic_batch(jcfg, seed=3, **kwargs)
    got = synthetic_batch(tcfg, seed=3, **kwargs)
    assert set(got) == set(want)
    for key in want:
        if key == "geom":
            assert set(got[key]) == set(want[key])
            for g in want[key]:
                np.testing.assert_array_equal(got[key][g], want[key][g])
        else:
            assert got[key].dtype == want[key].dtype, key
            np.testing.assert_array_equal(got[key], want[key])
    size = {"tiny": 64, "air": 392, "air_1_5": 448}[preset]
    assert got["pixel_values"].shape[1:3] == (size, size)
    if preset == "air_1_5":
        assert tcfg.llm.use_flash_capture and tcfg.img_start % 128 == 0
        assert (got["input_ids"][0, 128:128 + 1024] == 5).all()


def test_hpt_registry_and_gates():
    """The ``hpt`` family resolves to the JAX presets' names; the switches
    of the kernel path are plain config flags that no longer raise."""
    assert set(registry.FAMILIES["hpt"][1]) == set(
        jregistry.FAMILIES["hpt"].presets)
    assert registry.get_model("hpt") is grounding
    cfg = registry.get_config("hpt", "air_1_5", img_start=128)
    assert cfg == torch_hpt.hpt_air_1_5(img_start=128)
    assert cfg.llm.use_flash_capture
    assert not registry.get_config("hpt", "air_1_5").llm.use_flash_capture
    assert cfg.vision.head_dim == 72 and cfg.vision.mlp_dim % 512
    vision = dataclasses.replace(cfg.vision, flash=True)
    enc = dataclasses.replace(cfg.sam.encoder, global_block_fused=True)
    assert vision.flash and enc.global_block_fused
    assert enc.window_block_fused and enc.flash_global and enc.flash_window


def _wrapper_cases(rng):
    side, nh, hd = 4, 2, 8
    C = nh * hd
    p = {k: torch.from_numpy(v) for k, v in _global_block_inputs(
        rng, 2, side, nh, hd).items()}
    bias = torch.from_numpy(_r(rng, 2, nh, side * side, 2 * side, scale=0.1))
    qkv = torch.from_numpy(_r(rng, 2, 20, 3 * 4 * 72))
    return {
        # (B, H, S, hd) views of a tower's qkv rows, as the tower calls it
        "plain_flash_attention": (
            sam_flash.plain_flash_attention,
            sam_flash.plain_flash_attention_plain,
            tuple(t.reshape(2, 20, 4, 72).transpose(1, 2)
                  for t in qkv.split(4 * 72, dim=-1))),
        "fused_ln_mlp": (
            fused_block.fused_ln_mlp, fused_block.fused_ln_mlp_plain,
            (p["x"], *_t(*_mlp_weights(rng, C, 64)))),
        "global_attn_block": (
            global_block.global_attn_block,
            global_block.global_attn_block_plain,
            (p["x"], bias, p["lw"], p["lb"], p["wqkv"], p["bqkv"], p["wo"],
             p["bo"], side, nh)),
    }


WRAPPERS = ["plain_flash_attention", "fused_ln_mlp", "global_attn_block"]


@pytest.mark.parametrize("name", WRAPPERS)
def test_wrapper_takes_plain_version_on_cpu_and_launches_nothing(name):
    wrapper, plain, args = _wrapper_cases(np.random.default_rng(11))[name]
    before = wrapper.launches
    got = wrapper(*args)
    assert wrapper.launches == before == 0
    torch.testing.assert_close(got, plain(*args), rtol=0, atol=0)
    assert torch.isfinite(got).all()


@pytest.mark.parametrize("name", WRAPPERS)
def test_wrapper_refuses_inputs_that_require_grad(name):
    wrapper, _, args = _wrapper_cases(np.random.default_rng(12))[name]
    args = list(args)
    args[0] = args[0].clone().requires_grad_(True)
    with pytest.raises(RuntimeError, match="requires grad"):
        wrapper(*args)
    with torch.no_grad():
        wrapper(*args)
    assert wrapper.launches == 0
