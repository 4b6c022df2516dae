"""The port's LLaVA-NeXT anyres slice against the JAX package on the CPU:
the numpy anyres math, the synthetic batch builder against
``flmm_tpu.data.llava_next.build_anyres_batch`` on the same token streams
and image sizes, ``build_anyres_batch`` over committed images against it,
the CLIP tower, the packing and frame assembly, the tiny-config forward
with the image block at 128, and its loss and gradients.

Same weights on both sides: JAX ``init_params(key 0)`` -> numpy ->
``flmm_tpu_torch.convert.from_jax``.  Tolerances as tests/test_torch_slice.py:
single modules 1e-4, the whole forward 1e-3 (f32, other summation orders).
The port's forward runs with the flash-capture gate open (K5's plain
version on the CPU) and closed (the eager capture); the JAX forward it is
held to takes the XLA capture, which is f32 throughout: the Pallas kernel
rounds its merged product to bf16, which the U-Net turns into up to 2.4e-3
on the coarse logits, and tests/test_torch_flash_capture.py holds K5 to
that kernel at its own tolerance.  Everything derived from token streams
and image sizes must be bit-identical.
"""

import dataclasses
import pathlib

import numpy as np
import jax
import jax.numpy as jnp
import pytest
import torch
from PIL import Image

from flmm_tpu import registry as jregistry
from flmm_tpu.configs import llava_next as jax_configs
from flmm_tpu.data import collate as jcollate
from flmm_tpu.data import llava_next as jdata
from flmm_tpu.models.frozen import llava_next as jmodel
from flmm_tpu.models.vision import vit as jvit
from flmm_tpu_torch import registry
from flmm_tpu_torch.configs import llava_next as torch_configs
from flmm_tpu_torch.convert.from_jax import from_jax
from flmm_tpu_torch.data import collate
from flmm_tpu_torch.data import llava_next as data
from flmm_tpu_torch.models.frozen import llava_next as model
from flmm_tpu_torch.models.vision import vit
from flmm_tpu_torch.ops import flash_attention as fa
from flmm_tpu_torch.registry import get_coarse_hw
from flmm_tpu_torch.train import loop

REPO = pathlib.Path(__file__).resolve().parent.parent
SLICE_TOL = 1e-3
MODULE_TOL = 1e-4
LOSS_TOL = 1e-6
IMG_START = 128
# (h, w) per sample: a wide and a tall image for the tiny 32-px tiles; a
# 2x2 and a 3x1 pinpoint grid, both with unpadded fine rows or columns, at
# the 336-px tiles (the chip_smoke batch)
SIZES = {"tiny": ((40, 100), (90, 50)), "full": ((600, 640), (900, 280))}
SPECS = {"tiny": (jax_configs.tiny_anyres_spec, torch_configs.tiny_anyres_spec),
         "full": (jdata.AnyresSpec, data.AnyresSpec)}


def _close(got, want, tol=MODULE_TOL):
    np.testing.assert_allclose(got.detach().numpy(), np.asarray(want),
                               atol=tol, rtol=tol)


@pytest.mark.parametrize("spec", ["tiny", "full"])
def test_anyres_math_matches_jax(spec):
    jspec, tspec = SPECS[spec][0](), SPECS[spec][1]()
    for name in ("grid", "max_tiles", "max_fine_hw", "n_img_max", "mean",
                 "std", "pinpoints"):
        assert getattr(tspec, name) == getattr(jspec, name), name
    rng = np.random.default_rng(0)
    for _ in range(40):
        hw = (int(rng.integers(20, 2000)), int(rng.integers(20, 2000)))
        assert (data.select_best_resolution(hw, tspec.pinpoints)
                == jdata.select_best_resolution(hw, jspec.pinpoints))
        th, tw = jdata.select_best_resolution(hw, jspec.pinpoints)
        assert (data._patch_output_size(*hw, th, tw)
                == jdata._patch_output_size(*hw, th, tw))
        g, gr = tspec.tile_size, tspec.grid
        canvas = ((th // g) * gr, (tw // g) * gr)
        unpad = data.unpad_feature_hw(hw, canvas)
        assert unpad == jdata.unpad_feature_hw(hw, canvas)
        geo = data.anyres_geometry(hw, tspec)
        assert geo == {"grid": (th // g, tw // g), "fine_hw": unpad[:2],
                       "fine_pad": unpad[2:]}
        got = data.block_layout(tspec, geo["grid"], unpad[:2], unpad[2:])
        want = jdata.block_layout(jspec, geo["grid"], unpad[:2], unpad[2:])
        for key in want:
            np.testing.assert_array_equal(got[key], want[key])


@pytest.fixture(scope="module", params=["tiny", "full"])
def both_batches(request):
    """The port's synthetic anyres batch and ``build_anyres_batch`` on the
    same token streams, with a blank image of each size on the JAX side."""
    jspec, tspec = SPECS[request.param][0](), SPECS[request.param][1]()
    full = request.param == "full"
    M, T = (8, 12) if full else (3, 4)
    samples = data.synthetic_anyres_samples(
        SIZES[request.param], tspec.n_img_max, img_start=35 if full else 5,
        max_masks=M, caption_tokens=T, seed=3)
    S = 3200 if full else 256
    coarse, sam_size, P = ((64, 64), 1024, 256) if full else ((16, 16), 128,
                                                              32)
    spec = data.BatchSpec(seq_len=S, max_masks=M, text_per_mask=T,
                          coarse_hw=coarse, sam_size=sam_size, prompt_size=P,
                          align_image_block=128, expected_img_start=IMG_START)
    got = data.build_synthetic_anyres_batch(samples, spec, tspec, seed=3)
    jsamples = [{
        "input_ids": s["input_ids"], "mask_ids": s["mask_ids"],
        "spans": s["spans"], "img_start": s["img_start"],
        "image": Image.new("RGB", s["orig_hw"][::-1]),
        "masks": np.zeros((len(s["spans"]),) + s["orig_hw"], np.uint8),
    } for s in samples]
    jspec_b = jcollate.BatchSpec(
        seq_len=S, max_masks=M, text_per_mask=T, coarse_hw=coarse,
        sam_size=sam_size, prompt_size=P, align_image_block=128,
        expected_img_start=IMG_START)
    return got, jdata.build_anyres_batch(jsamples, jspec_b, jspec)


def test_synthetic_batch_matches_jax_builder(both_batches):
    got, want = both_batches
    assert set(got) == set(want) - {"infos"}
    for key in ("input_ids", "attn_mask", "position_ids", "mask_ids",
                "mask_valid", "text_idx", "text_valid", "tile_valid",
                "block_index", "block_valid", "fine_gather", "fine_valid",
                "fine_hw", "coarse_weight", "sam_weight"):
        assert got[key].dtype == want[key].dtype, key
        np.testing.assert_array_equal(got[key], want[key], err_msg=key)
    for key in want["geom"]:
        np.testing.assert_array_equal(got["geom"][key], want["geom"][key])
    for key in ("tiles", "sam_pixel_values", "gt_coarse", "gt_sam"):
        assert got[key].shape == want[key].shape, key
    # the key holes (alignment pads + image-pad slots) differ per sample
    n_block = got["block_valid"].shape[1]
    holes = (~got["attn_mask"][:, :IMG_START + n_block]).sum(1)
    assert holes[0] != holes[1] and holes.min() > IMG_START - 35


def test_synthetic_anyres_batch_follows_the_bench_rule():
    """The chip_smoke geometry: S = 3200, both samples 128-aligned at
    img_start 128, a 2x2 and a 3x1 grid."""
    cfg = torch_configs.llava_next_vicuna_7b(img_start=IMG_START)
    batch = data.synthetic_anyres_batch(cfg, SIZES["full"])
    assert batch["input_ids"].shape == (2, 3200)
    assert get_coarse_hw(cfg) == (64, 64)
    assert batch["tile_valid"].sum(1).tolist() == [5, 4]
    assert not batch["attn_mask"][:, 35:IMG_START].any()
    assert batch["attn_mask"][:, IMG_START:IMG_START + 576].all()


def _with_flash(cfg, on: bool = True):
    base = cfg.base
    return dataclasses.replace(cfg, base=dataclasses.replace(
        base, llm=dataclasses.replace(base.llm, use_flash_capture=on)))


@pytest.fixture(scope="module")
def tiny():
    """(JAX config, port config, JAX params as numpy, port params, batch)
    for tiny LLaVA-NeXT with the image block at 128; the port config has
    the flash-capture gate open."""
    jcfg = jax_configs.tiny_llava_next(img_start=IMG_START)
    tcfg = _with_flash(torch_configs.tiny_llava_next(img_start=IMG_START))
    jparams = jax.device_get(jax.jit(
        lambda k: jmodel.init_params(jcfg, k))(jax.random.key(0)))
    batch = data.synthetic_anyres_batch(tcfg, SIZES["tiny"], prompt_len=5,
                                        max_masks=3, caption_tokens=4)
    return jcfg, tcfg, jparams, from_jax(jparams), batch


def _jax_batch(batch):
    return jax.tree.map(jnp.asarray, batch)


@pytest.mark.parametrize("select_layer", [-2, -1])
def test_clip_forward_matches_jax(tiny, select_layer):
    """CLS token, pre-norm, no patch bias, quick_gelu, no final norm."""
    jcfg, tcfg, jparams, tparams, _ = tiny
    px = np.random.default_rng(0).standard_normal(
        (3, 32, 32, 3)).astype(np.float32)
    want = jvit.forward(jparams["frozen"]["vision"], jcfg.base.vision,
                        jnp.asarray(px), select_layer=select_layer)
    got = vit.forward(tparams["frozen"]["vision"], tcfg.base.vision,
                      torch.from_numpy(px), select_layer=select_layer)
    assert tuple(got.shape) == (3, 17, 32)
    _close(got, want)


def test_pack_embeds_matches_jax(tiny):
    jcfg, tcfg, jparams, tparams, batch = tiny
    want = jmodel.pack_embeds(jax.tree.map(jnp.asarray, jparams), jcfg,
                              _jax_batch(batch))
    got = model.pack_embeds(tparams, tcfg, from_jax(batch))
    _close(got, want)


def test_assemble_frames_matches_jax(tiny):
    jcfg, tcfg, _, _, batch = tiny
    attn = np.random.default_rng(2).random(
        (2, 3, 4, 3, jcfg.n_img_max)).astype(np.float32)
    want = jmodel.assemble_frames(jcfg, jnp.asarray(attn), _jax_batch(batch))
    got = model.assemble_frames(tcfg, torch.from_numpy(attn),
                                from_jax(batch))
    assert tuple(got.shape) == (2 * 3, 16, 16, 2 * 3 * 4)
    _close(got, want)


@pytest.fixture(scope="module")
def jax_forward(tiny):
    jcfg, _, jparams, _, batch = tiny
    return jax.device_get(jax.jit(lambda p, b: jmodel.forward(
        p, jcfg, b))(jparams, _jax_batch(batch)))


@pytest.fixture(scope="module", params=["flash", "eager"])
def port_forward(request, tiny):
    _, tcfg, _, tparams, batch = tiny
    tcfg = _with_flash(tcfg, request.param == "flash")
    launches = fa.flash_attention_with_merged_capture.launches
    with torch.no_grad():
        out = model.forward(tparams, tcfg, from_jax(batch))
    assert fa.flash_attention_with_merged_capture.launches == launches
    return out


@pytest.mark.parametrize("key", ["coarse_logits", "sam_logits", "iou_pred",
                                 "hidden", "boxes"])
def test_llava_next_forward_matches_jax(port_forward, jax_forward, key):
    got, want = port_forward, jax_forward
    assert tuple(got[key].shape) == want[key].shape
    assert torch.isfinite(got[key]).all()
    _close(got[key], want[key], SLICE_TOL)


# --- build_anyres_batch over real images, and the loss --------------------

def _image_samples(tspec, full: bool):
    """Token streams as ``both_batches``' over two committed COCO images
    (tests/data) with one rectangle mask a span, as ``(H, W, 3)`` uint8
    arrays for the port and PIL images of them for the JAX side."""
    files = sorted((REPO / "tests" / "data" / "refcoco" /
                    "train2014").glob("*.jpg"))[:2]
    images = [np.asarray(Image.open(f).convert("RGB")) for f in files]
    M, T = (8, 12) if full else (3, 4)
    samples = data.synthetic_anyres_samples(
        [im.shape[:2] for im in images], tspec.n_img_max,
        img_start=35 if full else 5, max_masks=M, caption_tokens=T, seed=4)
    rng = np.random.default_rng(4)
    for s, im, f in zip(samples, images, files):
        h, w = im.shape[:2]
        masks = np.zeros((len(s["spans"]), h, w), np.uint8)
        for m in masks:
            y0, x0 = rng.integers(0, h // 2), rng.integers(0, w // 2)
            m[y0:y0 + h // 3, x0:x0 + w // 3] = 1
        s.update(image=im, masks=masks, file_name=f.name,
                 mask_infos=[{"plural": False, "isthing": True}] * M)
    jsamples = [{**s, "image": Image.fromarray(s["image"])} for s in samples]
    return samples, jsamples, M, T


@pytest.mark.parametrize("spec", ["tiny", "full"])
def test_build_anyres_batch_matches_jax(spec):
    """The port's builder over real pixels, bound through the registry to
    the config's own anyres spec, against ``flmm_tpu``'s: ints and bools
    exact, floats within 1e-6 (both resample with PIL's bicubic and
    bilinear arithmetic), ``infos`` equal."""
    full = spec == "full"
    cfg = (torch_configs.llava_next_vicuna_7b(img_start=IMG_START) if full
           else torch_configs.tiny_llava_next(img_start=IMG_START))
    tspec, jspec = cfg.anyres_spec(), SPECS[spec][0]()
    assert dataclasses.asdict(tspec) == dataclasses.asdict(jspec)
    samples, jsamples, M, T = _image_samples(tspec, full)
    kw = dict(seq_len=3200 if full else 256, max_masks=M, text_per_mask=T,
              coarse_hw=get_coarse_hw(cfg),
              sam_size=cfg.base.sam.encoder.img_size,
              prompt_size=cfg.base.sam.prompt_size, align_image_block=128,
              expected_img_start=IMG_START)
    got = registry.get_batch_builder("llava_next", cfg)(
        samples, collate.BatchSpec(**kw))
    want = jregistry.get_batch_builder(
        "llava_next", tile_size=jspec.tile_size,
        patch_size=jspec.patch_size, pinpoints=jspec.pinpoints)(
        jsamples, jcollate.BatchSpec(**kw))
    assert set(got) == set(want)
    for key, w in want.items():
        if key == "infos":
            for a, b in zip(got[key], w):
                assert a["file_name"] == b["file_name"]
                assert a["num_masks"] == b["num_masks"] > 0
                assert tuple(a["orig_size"]) == tuple(b["orig_size"])
                assert a["mask_infos"] == b["mask_infos"]
        elif key == "geom":
            for k in w:
                np.testing.assert_allclose(got[key][k], w[k], rtol=0,
                                           atol=1e-6, err_msg=k)
        elif w.dtype.kind == "f":
            assert got[key].dtype == w.dtype, key
            np.testing.assert_allclose(got[key], w, rtol=0, atol=1e-6,
                                       err_msg=key)
        else:
            assert got[key].dtype == w.dtype, key
            np.testing.assert_array_equal(got[key], w, err_msg=key)
    assert got["tile_valid"].sum() > 2 and got["gt_sam"].any()
    # a sample whose image block does not land at the config's start
    bad = collate.BatchSpec(**{**kw, "expected_img_start": IMG_START + 1})
    with pytest.raises(ValueError, match="img_start"):
        registry.get_batch_builder("llava_next", cfg)(samples[:1], bad)


def test_tiny_loss_and_gradients_match_jax(tiny):
    """``llava_next.loss_fn`` as tests/test_torch_train.py holds the tiny
    loss (1e-6 relative) and every trainable gradient (1e-3 of the leaf's
    largest) against ``jax.value_and_grad`` of ``flmm_tpu``'s; the frozen
    tree gets no gradient."""
    jcfg, tcfg, jparams, _, batch = tiny
    tcfg = _with_flash(tcfg, False)
    vg = jax.jit(jax.value_and_grad(
        lambda tr, fr, b: jmodel.loss_fn({"frozen": fr, "trainable": tr},
                                         jcfg, b), has_aux=True))
    (jloss, jmetrics), jgrads = jax.device_get(vg(
        jparams["trainable"], jparams["frozen"], _jax_batch(batch)))
    tp = from_jax(jparams)
    state = loop.init_state(tp["trainable"],
                            loop.make_optimizer(loop.OptimConfig()))
    (loss, metrics), grads = loop.value_and_grad(
        lambda p, b: registry.get_model("llava_next").loss_fn(p, tcfg, b),
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
