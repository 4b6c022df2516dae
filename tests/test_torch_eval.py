"""The port's eval loop against the JAX package's on the CPU: the host
processors, the batch builder, the synthetic sample stream, the metrics,
the device-side mask post-processing and ``run_eval`` itself, through mock
predictors and through the tiny grounding forward on both sides.

The port reads ``(H, W, 3)`` uint8 arrays; the JAX side gets the same
arrays wrapped with ``Image.fromarray``.  Tolerances: the resamples, the
pixels, the metas, the batches and the metrics are exact (the port's
resample is PIL's fixed-point arithmetic); the probability maps are resized
by ``F.interpolate`` on the port's side and by PIL's float filter on the
JAX side, 1e-5 apart, so masks are compared outside a 1e-4 band around the
0.5 threshold and the results (in percent) within 1e-3; the tiny forward's
logits agree to 1e-3 as in tests/test_torch_slice.py, and its results too
within 1e-3.
"""

import dataclasses

import numpy as np
import jax
import jax.numpy as jnp
import pytest
import torch
from PIL import Image

from flmm_tpu.configs import deepseek_vl as jconfigs
from flmm_tpu.data import collate as jcollate
from flmm_tpu.data import processors as jproc
from flmm_tpu.data.synthetic import synthetic_samples as jsamples
from flmm_tpu.evalsuite import metrics as jmetrics
from flmm_tpu.evalsuite import runner as jrunner
from flmm_tpu.models.frozen import grounding as jgrounding
from flmm_tpu_torch import registry
from flmm_tpu_torch.configs import deepseek_vl as tconfigs
from flmm_tpu_torch.convert.from_jax import from_jax
from flmm_tpu_torch.data import collate, processors
from flmm_tpu_torch.data import llava_next as llava_next_data
from flmm_tpu_torch.data import mgm as mgm_data
from flmm_tpu_torch.data.synthetic import synthetic_samples
from flmm_tpu_torch.evalsuite import metrics, runner
from flmm_tpu_torch.models.frozen import grounding

RESULT_TOL, TIE_BAND, LOGIT_TOL = 1e-3, 1e-4, 1e-3
PIL_FILTERS = {"bicubic": Image.BICUBIC, "bilinear": Image.BILINEAR}


def _pil(sample):
    """The JAX side's copy of a port sample: the image as a PIL image."""
    return {**sample, "image": Image.fromarray(sample["image"], "RGB")}


def _spec(cfg, mod, seq_len, **kw):
    """The batch spec of the eval scripts for a family config, built as
    flmm_tpu/registry.py builds it, from the module ``mod`` (port or JAX)."""
    return mod.BatchSpec(
        seq_len=seq_len, max_masks=2, text_per_mask=8,
        coarse_hw=registry.get_coarse_hw(cfg),
        sam_size=cfg.sam.encoder.img_size, prompt_size=cfg.sam.prompt_size,
        expected_img_start=cfg.img_start,
        processor=(processors if mod is collate else jproc).ProcessorConfig(
            size=cfg.input_size,
            size_rule=registry.FAMILY_SIZE_RULES["deepseek_vl"]), **kw)


@pytest.fixture(scope="module")
def samples():
    return synthetic_samples(tconfigs.tiny(), n=5, seed=3)


# --- processors ---------------------------------------------------------

@pytest.mark.parametrize("name", ["bicubic", "bilinear"])
@pytest.mark.parametrize("in_hw, out_hw", [
    ((48, 131), (384, 1024)), ((159, 60), (64, 24)), ((100, 100), (100, 37)),
    ((7, 300), (250, 9))])
def test_resample_is_pils_bit_for_bit(name, in_hw, out_hw):
    """Up and down, one axis alone, a downscale of 33x."""
    img = np.random.default_rng(sum(in_hw)).integers(
        0, 256, (*in_hw, 3), np.uint8)
    want = np.asarray(Image.fromarray(img, "RGB").resize(
        out_hw[::-1], PIL_FILTERS[name]))
    np.testing.assert_array_equal(processors.resample(img, out_hw, name),
                                  want)


@pytest.mark.parametrize("rule", ["deepseek", "llava", "hpt15"])
def test_processors_match_jax_on_the_synthetic_images(samples, rule):
    pcfg = processors.ProcessorConfig(size=64, size_rule=rule)
    jcfg = jproc.ProcessorConfig(size=64, size_rule=rule)
    for s in samples:
        got = processors.square_pad_preprocess(s["image"], pcfg)
        want = jproc.square_pad_preprocess(_pil(s)["image"], jcfg)
        np.testing.assert_array_equal(got["pixel_values"],
                                      want["pixel_values"])
        assert got["meta"] == want["meta"]
        assert got["image_size"] == want["image_size"]
        got = processors.sam_preprocess(s["image"], 128)
        want = jproc.sam_preprocess(_pil(s)["image"], 128)
        np.testing.assert_array_equal(got["sam_pixel_values"],
                                      want["sam_pixel_values"])
        assert got["sam_input_size"] == want["sam_input_size"]


def test_processors_refuse_what_is_no_uint8_rgb_array():
    img = np.zeros((8, 8, 3), np.float32)
    with pytest.raises(ValueError, match="uint8"):
        processors.sam_preprocess(img, 16)
    with pytest.raises(ValueError, match="one of"):
        processors.resample(img.astype(np.uint8), (4, 4), "lanczos")


# --- samples and batches ------------------------------------------------

def test_synthetic_samples_are_the_jax_packages(samples):
    want = jsamples(jconfigs.tiny(), n=5, seed=3)
    assert len(samples) == len(want)
    for got, ref in zip(samples, want):
        assert set(got) == set(ref)
        np.testing.assert_array_equal(got["image"], np.asarray(ref["image"]))
        assert got["image"].dtype == np.uint8
        for key in ("input_ids", "mask_ids", "masks"):
            np.testing.assert_array_equal(got[key], ref[key])
            assert got[key].dtype == ref[key].dtype
        for key in ("spans", "mask_infos", "img_start", "file_name"):
            assert got[key] == ref[key]


def _equal_trees(got, want):
    assert set(got) == set(want)
    for key, ref in want.items():
        if isinstance(ref, dict):
            _equal_trees(got[key], ref)
        elif key == "infos":
            for a, b in zip(got[key], ref):
                assert a.keys() == b.keys()
                assert tuple(a["orig_size"]) == tuple(b["orig_size"])
                assert {k: v for k, v in a.items() if k != "orig_size"} == \
                    {k: v for k, v in b.items() if k != "orig_size"}
        else:
            assert got[key].dtype == ref.dtype, key
            np.testing.assert_array_equal(got[key], ref, err_msg=key)


@pytest.mark.parametrize("extra", [{}, {"align_image_block": 128,
                                        "hires_size": 96}])
def test_build_batch_matches_jax(samples, extra):
    """Every array bit for bit, the geometry and the infos equal; aligned:
    the image block moved to 128 and its pads masked, a hybrid tower's high
    resolution copy."""
    cfg = tconfigs.tiny(img_start=128 if extra else 3)
    jcfg = jconfigs.tiny(img_start=128 if extra else 3)
    # aligned: the prompts' image block at 3, moved to 128 by the pads
    src = synthetic_samples(tconfigs.tiny(), n=3, seed=4) if extra \
        else samples[:3]
    got = collate.build_batch(src, _spec(cfg, collate, 256, **extra))
    want = jcollate.build_batch([_pil(s) for s in src],
                                _spec(jcfg, jcollate, 256, **extra))
    _equal_trees(got, want)
    assert got["mask_valid"].any()


def test_build_batch_refuses_a_sample_whose_image_block_moved(samples):
    spec = dataclasses.replace(_spec(tconfigs.tiny(), collate, 128),
                               expected_img_start=4)
    with pytest.raises(ValueError, match="img_start"):
        collate.build_batch(samples[:1], spec)


def test_get_batch_builder():
    for family in ("deepseek_vl", "hpt"):
        cfg = registry.get_config(family, "tiny")
        assert registry.get_batch_builder(family, cfg) is collate.build_batch
    # the anyres builder binds the config's tiles and pinpoints;
    # tests/test_torch_llava_next.py holds it to JAX's
    cfg = registry.get_config("llava_next", "tiny")
    build = registry.get_batch_builder("llava_next", cfg)
    assert build.func is llava_next_data.build_anyres_batch
    assert build.keywords["anyres"] == llava_next_data.AnyresSpec(
        tile_size=32, patch_size=cfg.base.vision.patch_size,
        pinpoints=cfg.pinpoints)
    # the MGM builder binds the config's crop grid and sizes (MGM-HD: 2 x 2
    # and the global crop); tests/test_torch_mgm_io.py holds it to JAX's
    cfg = registry.get_config("mgm", "vicuna_7b_hd")
    build = registry.get_batch_builder("mgm", cfg)
    assert build.func is mgm_data.build_mgm_batch
    assert build.keywords["mgm"] == mgm_data.MGMProcessSpec(
        crop_size=336, aux_size=1536, image_grid=2, image_global=True)
    with pytest.raises(NotImplementedError, match="'nope' is not ported"):
        registry.get_batch_builder("nope", cfg)
    assert set(registry.FAMILY_SIZE_RULES) == set(registry.BATCH_BUILDERS)


# --- metrics --------------------------------------------------------------

def _mask_pairs(seed, n=12, hw=(23, 31)):
    rng = np.random.default_rng(seed)
    pairs = [(rng.random(hw) < p, rng.random(hw) < q)
             for p, q in rng.random((n, 2))]
    pairs.append((np.zeros(hw, bool), np.zeros(hw, bool)))  # empty union
    return [(a.astype(np.uint8), b.astype(np.uint8)) for a, b in pairs]


def test_metrics_equal_the_jax_packages():
    pairs = _mask_pairs(0)
    infos = [{"isthing": i % 3 == 0, "plural": i % 2 == 1}
             for i in range(len(pairs))]
    ref, jref = metrics.RefSegAccumulator(), jmetrics.RefSegAccumulator()
    png, jpng = metrics.PNGAccumulator(), jmetrics.PNGAccumulator()
    for (pred, gt), info in zip(pairs, infos):
        ref.add(pred, gt)
        jref.add(pred, gt)
        png.add(pred, gt, info)
        jpng.add(pred, gt, info)
    other, jother = metrics.RefSegAccumulator(), jmetrics.RefSegAccumulator()
    other.add(*pairs[0])
    jother.add(*pairs[0])
    ref.merge(other)
    jref.merge(jother)
    assert ref.results() == jref.results()
    assert png.results() == jpng.results()
    assert metrics.PNGAccumulator().results() == \
        jmetrics.PNGAccumulator().results()
    ious = np.random.default_rng(1).random(50)
    assert metrics.average_accuracy(ious) == jmetrics.average_accuracy(ious)


# --- the runner ---------------------------------------------------------

@pytest.mark.parametrize("sam_hw, orig_hw", [
    ((128, 77), (131, 79)), ((45, 128), (48, 137)), ((128, 128), (20, 20))])
def test_sam_logits_to_masks_match_jax_outside_the_tie_band(sam_hw, orig_hw):
    """Up- and downscaled crops of random logits."""
    logits = np.random.default_rng(sum(orig_hw)).standard_normal(
        (3, 32, 32)).astype(np.float32)
    want = jrunner.sam_logits_to_masks(logits, sam_hw, orig_hw, 128, 32)
    got = runner.sam_logits_to_masks(torch.from_numpy(logits), sam_hw,
                                     orig_hw, 128, 32)
    assert got.dtype == np.uint8 and got.shape == want.shape
    rh, rw = (max(1, round(n * 32 / 128)) for n in sam_hw)
    probs = 1 / (1 + np.exp(-logits[:, :rh, :rw].astype(np.float64)))
    ref = np.stack([jrunner.resize_prob_map(p.astype(np.float32), orig_hw)
                    for p in probs])
    away = np.abs(ref - 0.5) > TIE_BAND
    assert away.mean() > 0.99
    np.testing.assert_array_equal(got[away], want[away])


def _gt_logits(batch):
    """GT as +-8 logits (tests/test_eval.py's mock)."""
    return np.where(batch["gt_sam"] > 0.5, 8.0, -8.0).astype(np.float32)


def _wavy_logits(batch):
    """Logits that depend on the batch and cross 0 everywhere: the GT
    blurred by a ripple."""
    P = batch["gt_sam"].shape[-1]
    y, x = np.mgrid[:P, :P] / P
    ripple = np.sin(7 * x + 3 * y) + 0.5 * np.cos(11 * y - 2 * x)
    return (4 * batch["gt_sam"] - 2 + 1.5 * ripple).astype(np.float32)


@pytest.mark.parametrize("predict", [_gt_logits, _wavy_logits])
@pytest.mark.parametrize("acc, score", [("RefSegAccumulator",
                                         "refcoco_score"),
                                        ("PNGAccumulator", "png_score")])
def test_run_eval_matches_jax_with_a_mock_predictor(samples, predict, acc,
                                                    score):
    """5 samples in batches of 2 (the last one padded), buckets 80 and 96
    (prompts of 75 tokens and 6 a mask): the same batches, the same
    results."""
    cfg, jcfg = tconfigs.tiny(), jconfigs.tiny()
    seen = []

    def port_predict(batch):
        seen.append(batch["input_ids"].shape[1])
        return torch.from_numpy(predict(batch))

    got = runner.run_eval(samples, port_predict, _spec(cfg, collate, 128), 2,
                          getattr(metrics, acc), getattr(runner, score),
                          seq_len_buckets=(80, 96)).results()
    want = jrunner.run_eval([_pil(s) for s in samples], predict,
                            _spec(jcfg, jcollate, 128), 2,
                            getattr(jmetrics, acc), getattr(jrunner, score),
                            seq_len_buckets=(80, 96)).results()
    assert set(got) == set(want)
    assert got["n"] == want["n"] == sum(len(s["spans"]) for s in samples)
    for key in want:
        assert abs(got[key] - want[key]) <= RESULT_TOL * max(
            1.0, abs(want[key])), (key, got, want)
    lens = [len(s["input_ids"]) for s in samples]
    assert seen == [80 if max(lens[i:i + 2]) <= 80 else 96
                    for i in range(0, 5, 2)]
    assert set(seen) == {80, 96}
    if predict is _gt_logits and acc == "RefSegAccumulator":
        # the masks make a round trip through the tiny 32 x 32 frame (74.1
        # measured); at SAM-1024's 256 frame chip_smoke.py asks for 85
        assert got["cIoU"] > 70.0 and got["mIoU"] > 70.0


def _numpy_tree(tree):
    if isinstance(tree, dict):
        return {k: _numpy_tree(v) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return type(tree)(_numpy_tree(v) for v in tree)
    return tree.numpy()


def test_run_eval_with_the_tiny_forward_matches_jax(samples):
    """The tiny forward on both sides, each through its own runner, on one
    set of weights as numpy, carried into the port by convert/from_jax.py
    (the port's seeded init: the JAX init compiles for some 20 s on the
    CPU, and the two trees are one structure, tests/test_torch_slice.py):
    the logits of every batch agree, and so do the results."""
    cfg, jcfg = tconfigs.tiny(), jconfigs.tiny()
    jparams = _numpy_tree(grounding.init_params(
        cfg, torch.Generator().manual_seed(0), "cpu"))
    params = from_jax(jparams)
    jforward = jax.jit(lambda p, b: jgrounding.forward(p, jcfg, b)[
        "sam_logits"])
    logits = {"port": [], "jax": []}

    def port_predict(batch):
        with torch.no_grad():
            out = grounding.forward(params, cfg, from_jax(batch))
        logits["port"].append(out["sam_logits"].numpy())
        return out["sam_logits"]

    jtree = jax.tree.map(jnp.asarray, jparams)

    def jax_predict(batch):
        out = np.asarray(jforward(jtree, jax.tree.map(jnp.asarray, batch)))
        logits["jax"].append(out)
        return out

    got = runner.run_eval(samples, port_predict, _spec(cfg, collate, 128), 4,
                          metrics.RefSegAccumulator, runner.refcoco_score,
                          seq_len_buckets=(80, 96)).results()
    want = jrunner.run_eval([_pil(s) for s in samples], jax_predict,
                            _spec(jcfg, jcollate, 128), 4,
                            jmetrics.RefSegAccumulator, jrunner.refcoco_score,
                            seq_len_buckets=(80, 96)).results()
    assert [a.shape for a in logits["port"]] == [
        a.shape for a in logits["jax"]] == [(4, 2, 32, 32)] * 2
    for a, b in zip(logits["port"], logits["jax"]):
        np.testing.assert_allclose(a, b, atol=LOGIT_TOL, rtol=LOGIT_TOL)
    assert got["n"] == want["n"] == sum(len(s["spans"]) for s in samples)
    for key in ("cIoU", "mIoU"):
        assert np.isfinite(got[key])
        assert abs(got[key] - want[key]) <= RESULT_TOL, (key, got, want)
