"""The split window path of the SAM encoder (K3 -> K6 -> K4) and the
reduced-resolution SAM schedule against the JAX package on the CPU, in f32.

* K6's plain version against the Pallas kernel ``sam_window_attention_v9``
  in interpret mode, at the 14 x 14 window and at a small side;
* the port's kernel-path block (``_flash_block``, every wrapper on its plain
  version here) against JAX's plain windowed ``_block``, on a grid that
  divides into windows and on a padded grid with a nonzero ``bqkv``, where
  the pad tokens' keys and values are ``b_k`` and ``b_v`` in the reference;
  the JAX package's own K6 path deviates there, because it pads qkv with
  zeros, and the test records by how much;
* ``with_sam_size`` against the JAX registry, and the tiny grounding forward
  at a reduced SAM size against flmm_tpu.

Tolerances: the attention in f32 with another softmax base and summation
order (1e-3; the differences measure ~2e-6); the block and the forward
through f32 layers (1e-3).
"""

import dataclasses
import functools

import numpy as np
import jax
import jax.numpy as jnp
import pytest
import torch

from flmm_tpu import registry as jregistry
from flmm_tpu.configs import deepseek_vl as jax_configs
from flmm_tpu.data.synthetic import synthetic_batch as jax_synthetic_batch
from flmm_tpu.models.frozen import grounding as jgrounding
from flmm_tpu.models.sam import image_encoder as jencoder
from flmm_tpu.ops import sam_flash as jsf
from flmm_tpu_torch import registry
from flmm_tpu_torch.configs import deepseek_vl as torch_configs
from flmm_tpu_torch.convert.from_jax import from_jax
from flmm_tpu_torch.data.synthetic import synthetic_batch
from flmm_tpu_torch.models.frozen import grounding
from flmm_tpu_torch.models.sam import image_encoder as encoder
from flmm_tpu_torch.ops import fused_block, sam_flash

TOL = 1e-3


def _r(rng, *shape, scale=1.0):
    return (rng.standard_normal(shape) * scale).astype(np.float32)


@pytest.mark.parametrize("side,G", [(14, 3), (5, 4)])
def test_window_attention_plain_matches_pallas_v9(side, G):
    rng = np.random.default_rng(side)
    hd, T = 64, side * side
    q, k, v = (_r(rng, G, T, hd) for _ in range(3))
    rph, rpw = (_r(rng, 2 * side - 1, hd, scale=0.3) for _ in range(2))
    want = jsf.sam_window_attention_v9(*map(jnp.asarray, (q, k, v, rph, rpw)),
                                       side, interpret=True)
    tensors = [torch.from_numpy(a) for a in (q, k, v, rph, rpw)]
    got = sam_flash.sam_window_attention_v9_plain(*tensors, side)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=TOL,
                               rtol=TOL)
    # the (NW, nh, T, hd) form of a windowised qkv gives the same heads
    four = [t.reshape(G, 1, T, hd) for t in tensors[:3]]
    np.testing.assert_array_equal(
        sam_flash.sam_window_attention_v9_plain(*four, *tensors[3:], side)
        .reshape(G, T, hd).numpy(), got.numpy())


def _block_setup(grid):
    """A ViT block at width 128 with two 64-wide heads (so the K3 / K4 gate
    holds), 14 x 14 windows, nonzero biases and rel-pos tables."""
    kw = dict(img_size=16 * grid, patch_size=16, embed_dim=128, depth=1,
              num_heads=2, mlp_ratio=4.0, out_chans=16, window_size=14,
              global_attn_indexes=())
    jcfg = jencoder.SamEncoderConfig(dtype=jnp.float32, flash_window=True,
                                     **kw)
    tcfg = encoder.SamEncoderConfig(dtype=torch.float32, flash_window=True,
                                    **kw)
    bp = jax.device_get(jax.jit(lambda k: jencoder.init_params(jcfg, k))(
        jax.random.key(1)))["blocks"][0]
    rng = np.random.default_rng(grid)
    for key in ("bqkv", "bo", "ln1_b", "ln2_b"):
        bp[key] = _r(rng, *bp[key].shape, scale=0.5)
    for key in ("rel_pos_h", "rel_pos_w"):
        bp[key] = _r(rng, *bp[key].shape, scale=0.1)
    x = _r(rng, 2, grid, grid, 128)
    return jcfg, tcfg, bp, x


@pytest.mark.parametrize("grid", [14, 16])  # 16: padded to 28, 4 windows
def test_flash_window_block_matches_jax_plain_block(grid, monkeypatch):
    jcfg, tcfg, bp, x = _block_setup(grid)
    jbp = jax.tree.map(jnp.asarray, bp)
    want = np.asarray(jencoder._block(jnp.asarray(x), jbp, jcfg,
                                      windowed=True))
    tbp = from_jax(bp)
    launches = sam_flash.sam_window_attention_v9.launches
    got = encoder._flash_block(torch.from_numpy(x), tbp, tcfg, windowed=True)
    assert sam_flash.sam_window_attention_v9.launches == launches
    assert fused_block.fused_ln_qkv.launches == 0
    np.testing.assert_allclose(got.numpy(), want, atol=TOL, rtol=TOL)

    # the JAX kernel path's attention core, K6 in interpret mode
    monkeypatch.setattr(jsf, "sam_window_attention_v9", functools.partial(
        jsf.sam_window_attention_v9, interpret=True))
    y = jencoder.layer_norm(jnp.asarray(x), jbp["ln1_w"], jbp["ln1_b"],
                            jcfg.ln_eps)
    qkv = y @ jbp["wqkv"] + jbp["bqkv"]
    jax_core = np.asarray(jencoder._flash_window_core(qkv, jbp, jcfg))
    port_core = encoder._flash_window_core(
        torch.from_numpy(np.array(qkv)), tbp, tcfg).numpy()
    dev = np.abs(jax_core - port_core).max()
    if grid == 14:
        assert dev <= TOL
    else:
        # zero-padded keys and values pull the JAX K6 path off the
        # reference wherever a window holds pad tokens (max |diff| 1.64
        # here, against 2e-6 on the unpadded grid)
        assert dev > 10 * TOL, dev


def test_with_sam_size_mirrors_jax():
    for jcfg, tcfg, size in (
            (jax_configs.deepseek_vl_1_3b(), torch_configs.deepseek_vl_1_3b(),
             448),
            (jax_configs.tiny(), torch_configs.tiny(), 80)):
        pairs = [(jregistry.with_sam_size(jcfg, size),
                  registry.with_sam_size(tcfg, size))]
        while pairs:  # every field, nested configs included, but dtypes
            want, got = pairs.pop()
            for f in dataclasses.fields(want):
                w, g = getattr(want, f.name), getattr(got, f.name)
                if dataclasses.is_dataclass(w):
                    pairs.append((w, g))
                elif f.name != "dtype":
                    assert g == w, (type(want).__name__, f.name)
    sam = registry.with_sam_size(torch_configs.deepseek_vl_1_3b(), 448).sam
    assert (sam.encoder.grid, sam.prompt.image_embedding_size,
            sam.prompt_size) == (28, 28, 112)
    with pytest.raises(ValueError):
        registry.with_sam_size(torch_configs.tiny(), 100)


def test_registry_families():
    assert registry.get_model("deepseek_vl").loss_fn is grounding.loss_fn
    cfg = registry.get_config("deepseek_vl", "1_3b", img_start=128)
    assert cfg.llm.use_flash_capture and cfg.sam.encoder.img_size == 1024
    assert registry.get_config("hpt", "air").image_input_size == 392
    hybrid = registry.get_config("deepseek_vl", "7b")
    assert hybrid.hybrid_high.encoder.embed_dim == 768
    assert hybrid.llm.num_layers == 30 and not hybrid.llm.use_flash_capture
    with pytest.raises(NotImplementedError, match="not ported"):
        registry.get_config("hpt", "pro")
    # mgm is ported since: its tiny preset and model module
    mgm = registry.get_config("mgm", "tiny")
    assert mgm.aux.out_channels == 120 and mgm.base.llm.gemma_norm
    assert registry.get_model("mgm").forward.__module__ == \
        "flmm_tpu_torch.models.frozen.mgm"


@pytest.fixture(scope="module")
def reduced_forward():
    """(port outputs, JAX outputs) of the tiny forward with SAM at 80: a
    5 x 5 grid in 2 x 2 windows, so the windows are padded."""
    jcfg = jregistry.with_sam_size(jax_configs.tiny(), 80)
    tcfg = registry.with_sam_size(torch_configs.tiny(), 80)
    jparams = jax.device_get(jax.jit(
        lambda k: jgrounding.init_params(jcfg, k))(jax.random.key(0)))
    batch = jax_synthetic_batch(jcfg, batch_size=2, seed=0)
    want = jax.device_get(jax.jit(lambda p, b: jgrounding.forward(
        p, jcfg, b))(jparams, jax.tree.map(jnp.asarray, batch)))
    with torch.no_grad():
        got = grounding.forward(from_jax(jparams), tcfg, from_jax(
            synthetic_batch(tcfg, batch_size=2, seed=0)))
    return got, want


@pytest.mark.parametrize("key", ["coarse_logits", "sam_logits", "iou_pred",
                                 "boxes"])
def test_reduced_sam_forward_matches_jax(reduced_forward, key):
    got, want = reduced_forward
    assert tuple(got[key].shape) == want[key].shape
    assert torch.isfinite(got[key]).all()
    np.testing.assert_allclose(got[key].numpy(), want[key], atol=TOL,
                               rtol=TOL)
    if key == "sam_logits":
        assert got[key].shape[-1] == 20  # prompt_size = 4 * grid
