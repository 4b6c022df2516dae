"""flmm_tpu_torch shared ops and SAM building blocks against the JAX
package, f32 on the CPU, inputs from a seeded numpy generator.

Tolerances: the two frameworks sum in different orders, so f32 results
agree to a few ulps of their magnitude (atol/rtol 1e-5 unless stated);
index results (boxes, merge matrices, the synthetic batch) must be equal.
"""

import numpy as np
import jax
import jax.numpy as jnp
import pytest
import torch

from flmm_tpu.configs import deepseek_vl as jax_configs
from flmm_tpu.data.synthetic import synthetic_batch as jax_synthetic_batch
from flmm_tpu.models.sam import common as jcommon
from flmm_tpu.ops import masks as jmasks
from flmm_tpu.ops import resize as jresize
from flmm_tpu_torch.configs import deepseek_vl as torch_configs
from flmm_tpu_torch.data.synthetic import synthetic_batch
from flmm_tpu_torch.models.sam import common
from flmm_tpu_torch.ops import masks, resize


def _r(rng, *shape, scale=1.0):
    return (rng.standard_normal(shape) * scale).astype(np.float32)


def _close(got, want, atol=1e-5, rtol=1e-5):
    np.testing.assert_allclose(got.detach().numpy(), np.asarray(want),
                               atol=atol, rtol=rtol)


def test_merge_matrices_match_jax():
    rng = np.random.default_rng(0)
    ids = rng.integers(-1, 4, (2, 30)).astype(np.int32)
    for name in ("segment_matrix", "mean_merge_matrix"):
        want = np.stack([np.asarray(getattr(jmasks, name)(jnp.asarray(i), 5))
                         for i in ids])
        got = getattr(masks, name)(torch.from_numpy(ids), 5)
        np.testing.assert_array_equal(got.numpy(), want, err_msg=name)


def test_mask_to_box_matches_jax_including_empty_masks():
    rng = np.random.default_rng(1)
    m = rng.random((4, 12, 9)) > 0.9
    m[1] = False  # empty -> full frame
    m[2] = False
    m[2, 3:5, 2] = True
    want = np.stack([np.asarray(jmasks.mask_to_box(jnp.asarray(x)))
                     for x in m])
    got = masks.mask_to_box(torch.from_numpy(m))
    np.testing.assert_array_equal(got.numpy(), want)


@pytest.mark.parametrize("out_hw,scale", [
    ((16, 16), None),           # 2x upsample (U-Net decoder)
    ((7, 5), None),             # downsample
    ((21, 21), (2.7, 2.7)),     # scale_factor map (U-Net input upsample)
])
def test_resize_bilinear_matches_jax(out_hw, scale):
    x = _r(np.random.default_rng(2), 3, 2, 8, 8)
    want = jresize.resize_bilinear(jnp.asarray(x), out_hw, scale=scale)
    _close(resize.resize_bilinear(torch.from_numpy(x), out_hw, scale=scale),
           want)


@pytest.mark.parametrize("mode", ["fill", "clamp"])
def test_affine_grid_sample_matches_jax(mode):
    rng = np.random.default_rng(3)
    img = _r(rng, 3, 16, 16)
    scale = np.asarray([0.37, 0.52], np.float32)
    offset = np.asarray([2.0, 3.0], np.float32)
    lo = np.asarray([2.0, 3.0], np.float32)
    hi = np.asarray([12.0, 10.0], np.float32)
    kw = dict(mode=mode, fill=-1.5) if mode == "fill" else dict(mode=mode)
    want = jresize.affine_grid_sample(
        jnp.asarray(img), jnp.asarray(scale), jnp.asarray(offset), (24, 20),
        src_lo=jnp.asarray(lo), src_hi=jnp.asarray(hi), **kw)
    got = resize.affine_grid_sample(
        torch.from_numpy(img), torch.from_numpy(scale),
        torch.from_numpy(offset), (24, 20), src_lo=torch.from_numpy(lo),
        src_hi=torch.from_numpy(hi), **kw)
    _close(got, want)


def _common_case(name, rng):
    x = _r(rng, 2, 8, 8, 6)
    if name == "layer_norm":
        args = (x, _r(rng, 6, scale=0.1) + 1, _r(rng, 6, scale=0.1))
        return args, {}
    if name == "conv2d_stride":
        return (x, _r(rng, 2, 2, 6, 5), _r(rng, 5)), {"stride": 2}
    if name == "conv2d_pad":
        return (x, _r(rng, 3, 3, 6, 4)), {"padding": 1}
    if name == "conv_transpose2d":
        return (x, _r(rng, 2, 2, 6, 3), _r(rng, 3)), {}
    p = {"w1": _r(rng, 6, 12), "b1": _r(rng, 12), "w2": _r(rng, 12, 6),
         "b2": _r(rng, 6)}
    if name.startswith("mlp_block"):
        return (x, p), {"act": name.split("_")[-1]}
    layers = [{"w": _r(rng, 6, 12), "b": _r(rng, 12)},
              {"w": _r(rng, 12, 3), "b": _r(rng, 3)}]
    return (x, layers), {"sigmoid_output": True}


@pytest.mark.parametrize("name", [
    "layer_norm", "conv2d_stride", "conv2d_pad", "conv_transpose2d",
    "mlp_block_gelu", "mlp_block_relu", "mlp"])
def test_sam_common_matches_jax(name):
    args, kw = _common_case(name, np.random.default_rng(4))
    fn = name.split("_stride")[0].split("_pad")[0]
    fn = "mlp_block" if fn.startswith("mlp_block") else fn

    want = getattr(jcommon, fn)(
        *jax.tree.map(jnp.asarray, args), **kw)
    got = getattr(common, fn)(
        *jax.tree.map(torch.from_numpy, args), **kw)
    _close(got, want, atol=1e-5, rtol=1e-4)


@pytest.mark.parametrize("preset,bs,seed", [
    ("tiny", 2, 0), ("tiny", 3, 7), ("deepseek_vl_1_3b", 1, 1)])
def test_synthetic_batch_is_bit_identical(preset, bs, seed):
    jcfg = getattr(jax_configs, preset)()
    tcfg = getattr(torch_configs, preset)()
    kw = dict(batch_size=bs, seed=seed, max_masks=4, text_tokens_per_mask=5)
    want = jax_synthetic_batch(jcfg, **kw)
    got = synthetic_batch(tcfg, **kw)
    assert got.keys() == want.keys()
    for key in want:
        if key == "geom":
            assert got[key].keys() == want[key].keys()
            for k in want[key]:
                np.testing.assert_array_equal(got[key][k], want[key][k])
        else:
            assert got[key].dtype == want[key].dtype, key
            np.testing.assert_array_equal(got[key], want[key], err_msg=key)
