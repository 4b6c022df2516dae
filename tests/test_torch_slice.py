"""The port's models and the whole grounding forward against the JAX
package on the CPU, in f32: JAX ``init_params(key 0)`` -> numpy ->
``flmm_tpu_torch.convert.from_jax`` -> the same weights on both sides, the
same seeded inputs.

On a CPU tensor every kernel gate of the port is closed, so these run the
plain paths; the JAX side runs its XLA paths (its Pallas gates need a TPU).

Tolerances: f32 with different summation orders through up to 24 layers;
the slice's outputs agree to atol/rtol 1e-3, the single modules to 1e-4.
"""

import dataclasses

import numpy as np
import jax
import jax.numpy as jnp
import pytest
import torch

from flmm_tpu.configs import deepseek_vl as jax_configs
from flmm_tpu.configs import hpt as jax_hpt
from flmm_tpu.configs import llava as jax_llava
from flmm_tpu.configs import llava_next as jax_llava_next
from flmm_tpu.data.synthetic import synthetic_batch as jax_synthetic_batch
from flmm_tpu.models.frozen import grounding as jgrounding
from flmm_tpu.models.frozen import llava_next as jllava_next
from flmm_tpu.models.llm import decoder as jdecoder
from flmm_tpu.models.sam import image_encoder as jencoder
from flmm_tpu.models.vision import vit as jvit
from flmm_tpu.ops import masks as jmasks
from flmm_tpu_torch.configs import deepseek_vl as torch_configs
from flmm_tpu_torch.configs import hpt as torch_hpt
from flmm_tpu_torch.configs import llava as torch_llava
from flmm_tpu_torch.configs import llava_next as torch_llava_next
from flmm_tpu_torch.convert.from_jax import from_jax
from flmm_tpu_torch.data.synthetic import synthetic_batch
from flmm_tpu_torch.models.frozen import grounding, llava_next
from flmm_tpu_torch.models.llm import decoder
from flmm_tpu_torch.models.sam import image_encoder as encoder
from flmm_tpu_torch.models.vision import vit
from flmm_tpu_torch.ops import masks, window_block

SLICE_TOL = 1e-3
MODULE_TOL = 1e-4


def _close(got, want, tol=MODULE_TOL):
    np.testing.assert_allclose(got.detach().numpy(), np.asarray(want),
                               atol=tol, rtol=tol)


@pytest.fixture(scope="module")
def tiny():
    """(JAX config, port config, JAX params as numpy, port params)."""
    jcfg, tcfg = jax_configs.tiny(), torch_configs.tiny()
    jparams = jax.device_get(jax.jit(
        lambda k: jgrounding.init_params(jcfg, k))(jax.random.key(0)))
    return jcfg, tcfg, jparams, from_jax(jparams)


@pytest.fixture(scope="module")
def slice_outputs(tiny):
    """``preset -> (port outputs, JAX outputs)`` of the grounding forward,
    each computed once: the DeepSeek-VL ``tiny`` and ``tiny_llava`` (CLIP
    topology: CLS token dropped, pre-norm, quick_gelu, layer -2)."""
    cache = {}

    def outputs(preset):
        if preset not in cache:
            if preset == "tiny":
                jcfg, tcfg, jparams, tparams = tiny
            else:
                jcfg, tcfg = jax_llava.tiny_llava(), torch_llava.tiny_llava()
                jparams = jax.device_get(jax.jit(
                    lambda k: jgrounding.init_params(jcfg, k))(
                        jax.random.key(0)))
                tparams = from_jax(jparams)
            batch = jax_synthetic_batch(jcfg, batch_size=2, seed=0)
            want = jax.device_get(jax.jit(lambda p, b: jgrounding.forward(
                p, jcfg, b))(jparams, jax.tree.map(jnp.asarray, batch)))
            with torch.no_grad():
                got = grounding.forward(tparams, tcfg, from_jax(
                    synthetic_batch(tcfg, batch_size=2, seed=0)))
            cache[preset] = got, want
        return cache[preset]
    return outputs


@pytest.mark.parametrize("preset,key", [
    pytest.param(preset, key, id=key if preset == "tiny" else
                 f"{preset}-{key}")
    for preset in ("tiny", "tiny_llava")
    for key in ("coarse_logits", "sam_logits", "iou_pred", "hidden", "boxes")
])
def test_grounding_forward_matches_jax(slice_outputs, preset, key):
    got, want = slice_outputs(preset)
    assert tuple(got[key].shape) == want[key].shape
    assert torch.isfinite(got[key]).all()
    _close(got[key], want[key], SLICE_TOL)


def _tree_signature(tree, path=""):
    if isinstance(tree, dict):
        out = {}
        for k, v in tree.items():
            out.update(_tree_signature(v, f"{path}/{k}"))
        return out
    if isinstance(tree, (list, tuple)):
        out = {}
        for i, v in enumerate(tree):
            out.update(_tree_signature(v, f"{path}/{i}"))
        return out
    return {path: (tuple(tree.shape), str(tree.dtype).replace("torch.", ""))}


@pytest.mark.parametrize("preset", ["tiny", "tiny_bf16", "tiny_llava",
                                    "tiny_llava_next"])
def test_init_params_tree_matches_jax(preset):
    bf16 = preset == "tiny_bf16"
    jdt, tdt = (jnp.bfloat16, torch.bfloat16) if bf16 else (jnp.float32,
                                                           torch.float32)
    jinit, tinit = jgrounding.init_params, grounding.init_params
    if preset == "tiny_llava_next":
        jinit, tinit = jllava_next.init_params, llava_next.init_params
    jfac, tfac = {
        "tiny_llava": (jax_llava.tiny_llava, torch_llava.tiny_llava),
        "tiny_llava_next": (jax_llava_next.tiny_llava_next,
                            torch_llava_next.tiny_llava_next),
    }.get(preset, (jax_configs.tiny, torch_configs.tiny))
    jcfg, tcfg = jfac(dtype=jdt), tfac(dtype=tdt)
    want = jax.eval_shape(lambda k: jinit(jcfg, k), jax.random.key(0))
    got = tinit(tcfg, torch.Generator().manual_seed(0), "cpu")
    assert _tree_signature(got) == _tree_signature(want)


def test_port_config_fields_mirror_jax():
    """Every config dataclass carries the JAX fields one for one: the
    DeepSeek-VL, LLaVA-1.5, LLaVA-NeXT and HPT presets, full size and tiny,
    and the anyres specs."""
    pairs = [
        (jax_configs.tiny(), torch_configs.tiny()),
        (jax_configs.deepseek_vl_1_3b(), torch_configs.deepseek_vl_1_3b()),
        (jax_llava.tiny_llava(), torch_llava.tiny_llava()),
        (jax_llava.llava_1_5_7b(), torch_llava.llava_1_5_7b()),
        (jax_llava_next.tiny_llava_next(), torch_llava_next.tiny_llava_next()),
        (jax_llava_next.llava_next_vicuna_7b(img_start=128),
         torch_llava_next.llava_next_vicuna_7b(img_start=128)),
        (jax_llava_next.llava_next_mistral_7b(),
         torch_llava_next.llava_next_mistral_7b()),
        (jax_llava_next.tiny_anyres_spec(),
         torch_llava_next.tiny_anyres_spec()),
        (jax_llava_next.llava_next_vicuna_7b().anyres_spec(),
         torch_llava_next.llava_next_vicuna_7b().anyres_spec()),
        (jax_hpt.tiny_hpt(), torch_hpt.tiny_hpt()),
        (jax_hpt.hpt_air(), torch_hpt.hpt_air()),
        (jax_hpt.hpt_air_1_5(), torch_hpt.hpt_air_1_5()),
        (jax_hpt.hpt_air_1_5(img_start=128),
         torch_hpt.hpt_air_1_5(img_start=128)),
    ]
    while pairs:
        j, t = pairs.pop()
        jf = [f.name for f in dataclasses.fields(j)]
        assert [f.name for f in dataclasses.fields(t)] == jf, type(t)
        for name in jf:
            jv, tv = getattr(j, name), getattr(t, name)
            if dataclasses.is_dataclass(jv):
                pairs.append((jv, tv))
            elif name != "dtype":
                assert tv == jv, (type(t).__name__, name)


@pytest.mark.parametrize("select_layer", [-1, -2])
def test_siglip_forward_matches_jax(tiny, select_layer):
    jcfg, tcfg, jparams, tparams = tiny
    px = np.random.default_rng(0).standard_normal(
        (2, 64, 64, 3)).astype(np.float32)
    want = jvit.forward(jparams["frozen"]["vision"], jcfg.vision,
                        jnp.asarray(px), select_layer=select_layer)
    got = vit.forward(tparams["frozen"]["vision"], tcfg.vision,
                      torch.from_numpy(px), select_layer=select_layer)
    _close(got, want)


@pytest.mark.parametrize("merge", ["mean", "max"])
def test_decoder_forward_capture_matches_jax(tiny, merge):
    jcfg, tcfg, jparams, tparams = tiny
    rng = np.random.default_rng(1)
    B, S, M, D = 2, 40, 3, jcfg.llm.hidden_size
    emb = rng.standard_normal((B, S, D)).astype(np.float32)
    attn_mask = np.ones((B, S), bool)
    attn_mask[1, -5:] = False
    ids = np.full((B, S), -1, np.int32)
    ids[:, 30:33], ids[:, 34:36] = 0, 1
    ids[0, 37] = 2
    lw = rng.standard_normal(jcfg.llm.num_layers).astype(np.float32)
    make = {"mean": (jmasks.mean_merge_matrix, masks.mean_merge_matrix),
            "max": (jmasks.segment_matrix, masks.segment_matrix)}[merge]
    jmm = jax.vmap(lambda i: make[0](i, M))(jnp.asarray(ids))
    want = jdecoder.forward_capture(
        jparams["frozen"]["llm"], jcfg.llm, jnp.asarray(emb),
        jnp.asarray(attn_mask), img_start=3, n_img=16, merge_matrix=jmm,
        merge=merge, layer_weights=jax.nn.softmax(jnp.asarray(lw)))
    got = decoder.forward_capture(
        tparams["frozen"]["llm"], tcfg.llm, torch.from_numpy(emb),
        torch.from_numpy(attn_mask), img_start=3, n_img=16,
        merge_matrix=make[1](torch.from_numpy(ids), M), merge=merge,
        layer_weights=torch.softmax(torch.from_numpy(lw), 0))
    for key in ("attn", "hidden", "last_hidden"):
        _close(got[key], want[key])


def _padded_encoder_configs():
    """grid 6 with window 4: padded to 8, 4 windows per image; blocks 1
    and 3 global."""
    kw = dict(img_size=96, patch_size=16, embed_dim=32, depth=4,
              num_heads=2, mlp_ratio=2.0, out_chans=16, window_size=4,
              global_attn_indexes=(1, 3))
    return (jencoder.SamEncoderConfig(dtype=jnp.float32, **kw),
            encoder.SamEncoderConfig(dtype=torch.float32, **kw))


def _padded_encoder_params(jcfg):
    params = jax.device_get(jax.jit(lambda k: jencoder.init_params(
        jcfg, k))(jax.random.key(3)))
    rng = np.random.default_rng(3)  # non-trivial rel-pos tables
    for bp in params["blocks"]:
        for k in ("rel_pos_h", "rel_pos_w"):
            bp[k] = rng.standard_normal(bp[k].shape).astype(np.float32) * 0.1
    return params


def test_sam_encoder_padded_grid_matches_jax():
    jcfg, tcfg = _padded_encoder_configs()
    params = _padded_encoder_params(jcfg)
    px = np.random.default_rng(4).standard_normal(
        (2, 96, 96, 3)).astype(np.float32)
    want = jencoder.forward(jax.tree.map(jnp.asarray, params), jcfg,
                            jnp.asarray(px))
    got = encoder.forward(from_jax(params), tcfg, torch.from_numpy(px))
    assert tuple(got.shape) == (2, 6, 6, 16)
    _close(got, want)


def test_window_major_block_matches_jax_window_block_path():
    """The K1 route on a padded grid -- windowize, pad-slot mask, rel-pos
    rows, the window block (plain version on the CPU), dewindowize --
    against JAX's plain ``_block(windowed=True)``."""
    jcfg, tcfg = _padded_encoder_configs()
    params = _padded_encoder_params(jcfg)
    bp = params["blocks"][0]
    x = np.random.default_rng(5).standard_normal(
        (2, 6, 6, 32)).astype(np.float32)
    want = jencoder._block(jnp.asarray(x), jax.tree.map(jnp.asarray, bp),
                           jcfg, windowed=True)
    xt = torch.from_numpy(x)
    xw, geom = encoder._windowize(xt, 4)
    valid = encoder._window_valid_tokens(geom, 4, xt.device)
    assert valid is not None and valid.shape == (8, 16)
    assert int(valid.sum()) == 2 * 36
    yw = encoder._window_block_fused(xw, from_jax(bp), tcfg, valid)
    _close(encoder._dewindowize(yw, geom, 4), want)
    # no pad slots when the grid divides into windows
    assert encoder._window_valid_tokens((2, 8, 8, 8, 8), 4, "cpu") is None
    assert window_block.window_block.launches == 0
