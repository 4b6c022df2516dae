"""The port's grounder API (flmm_tpu_torch.generation.api) against the JAX
package's on the CPU: ``Grounder.answer`` (also with ``history``),
``ground``, ``visual_cot_v1/v2/v3`` at the tiny DeepSeek-VL preset, with the
fake tokenizers of tests/test_generation_api.py; ``AnyresGrounder`` at
``tiny_llava_next``; ``make_grounder``; ``mask2box_scaled`` and
``encode_with_images``.

Same weights on both sides (the port's seeded ``init_params`` -> numpy ->
JAX arrays and ``convert.from_jax``) and the same image: a uint8 array on the port's side,
``PIL.Image.fromarray`` of it on the JAX side.  Ids, text, boxes and masks
must be equal; attention maps and hidden states agree within 1e-4, coarse
and SAM low-res logits within 1e-3 (f32, the 1e-3 of the grounding forward
in tests/test_torch_slice.py).  The low-res logits are read where each
package hands them to ``sam_logits_to_masks``.
"""

import contextlib
import dataclasses

import numpy as np
import jax
import jax.numpy as jnp
import pytest
import torch
from PIL import Image

from flmm_tpu.configs import deepseek_vl as jds
from flmm_tpu.configs import hpt as jhpt
from flmm_tpu.configs import llava as jllava
from flmm_tpu.configs import llava_next as jllava_next
from flmm_tpu.data import tokenization as jtok
from flmm_tpu.data.processors import ProcessorConfig as JProcessorConfig
from flmm_tpu.evalsuite import runner as jrunner
from flmm_tpu.generation import api as japi
from flmm_tpu_torch.configs import deepseek_vl as tds
from flmm_tpu_torch.configs import hpt as thpt
from flmm_tpu_torch.configs import llava as tllava
from flmm_tpu_torch.configs import llava_next as tllava_next
from flmm_tpu_torch.convert.from_jax import from_jax
from flmm_tpu_torch.data import tokenization as tok
from flmm_tpu_torch.data.processors import ProcessorConfig
from flmm_tpu_torch.evalsuite import runner as trunner
from flmm_tpu_torch.generation import api
from flmm_tpu_torch.models.frozen import grounding as tgrounding
from flmm_tpu_torch.models.frozen import llava_next as tmln
from tests.test_data import IMAGE_TOKEN_ID
from tests.test_generation_api import DecodingFakeTokenizer, \
    FragmentingFakeTokenizer

MAP_TOL, LOGIT_TOL = 1e-4, 1e-3
# A mask is the sigmoid of the low-res logits, cropped to the SAM region,
# resized bilinearly to the image and thresholded at 0.5.  The logits agree
# within LOGIT_TOL; the sigmoid's slope is at most 1/4, so the probabilities
# agree within LOGIT_TOL / 4, and the resize, a convex combination of them
# at each pixel, moves no difference past that: PROB_TOL bounds the two
# probability maps' distance.  A pixel can fall on opposite sides of 0.5
# only where the maps lie within their distance of it, so every other pixel
# must be equal.  At random weights the logits sit near 0, so the whole
# PROB_TOL band holds ~1% of the pixels; the exemption is the band of the
# maps' measured distance instead, and at most MAX_EXEMPT of a mask's pixels
# may fall in it, so that a real fault cannot hide under it.
PROB_TOL = LOGIT_TOL / 4
MAX_EXEMPT = 1e-3


def _close(got, want, tol):
    np.testing.assert_allclose(torch.as_tensor(got).detach().numpy(),
                               np.asarray(want), atol=tol, rtol=tol)


def _image(h=60, w=90, seed=0):
    return np.random.default_rng(seed).integers(0, 255, (h, w, 3), np.uint8)


def _img_start(tokenizer, template, n_img):
    spec = jtok.PromptSpec(jtok.TEMPLATES[template],
                           "<image_placeholder>" * n_img)
    start, n = jtok.find_image_block(jtok.encode_prompt(tokenizer, spec),
                                     IMAGE_TOKEN_ID)
    assert n == n_img
    return start


def assert_masks_pinned(mask, jmask, records, i=0):
    """``mask`` (port) and ``jmask`` (JAX) equal at every pixel but those
    where the two probability maps straddle 0.5 or may: each package's own
    ``resize_prob_map`` makes its map from its ``i``-th recorded low-res
    logits (the crop from the JAX side's call), the maps must agree within
    ``PROB_TOL``, and a pixel is exempt where either map lies within their
    distance of 0.5."""
    args, kw = records["jax_call"][i]
    (nh, nw), orig_hw = args
    rh = max(1, int(round(nh * kw["prompt_size"] / kw["sam_size"])))
    rw = max(1, int(round(nw * kw["prompt_size"] / kw["sam_size"])))
    jlow = records["jax"][i].astype(np.float32)
    jprob = np.stack([jrunner.resize_prob_map(p[:rh, :rw], orig_hw)
                      for p in 1.0 / (1.0 + np.exp(-jlow))])
    prob = trunner.resize_prob_map(torch.sigmoid(
        torch.as_tensor(records["port"][i]).float())[:, :rh, :rw],
        orig_hw).numpy()
    # a visual CoT's mask is its one map, squeezed
    assert mask.shape == jmask.shape and prob.size == jprob.size == mask.size
    prob, jprob = prob.reshape(mask.shape), jprob.reshape(mask.shape)
    gap = float(np.abs(prob - jprob).max())
    assert gap <= PROB_TOL, gap
    exempt = (np.abs(prob - 0.5) <= gap) | (np.abs(jprob - 0.5) <= gap)
    assert exempt.mean() <= MAX_EXEMPT, (int(exempt.sum()), exempt.size)
    np.testing.assert_array_equal(np.where(exempt, 0, mask),
                                  np.where(exempt, 0, jmask))


def _numpy_tree(tree):
    if isinstance(tree, dict):
        return {k: _numpy_tree(v) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return type(tree)(_numpy_tree(v) for v in tree)
    return tree.numpy()


def _params(init, tcfg):
    """One set of weights on both sides: the port's seeded init as numpy
    (the JAX init compiles for some 20 s on the CPU; the two trees are one
    structure, tests/test_torch_slice.py), as JAX arrays and carried into
    the port by convert/from_jax.py."""
    params = _numpy_tree(init(tcfg, torch.Generator().manual_seed(0), "cpu"))
    return jax.tree.map(jnp.asarray, params), from_jax(params)


@pytest.fixture(scope="module")
def deepseek_params():
    return _params(tgrounding.init_params, tds.tiny())


@contextlib.contextmanager
def _low_res(records):
    """Record the low-res logits each package's grounder turns into
    masks, port first."""
    with pytest.MonkeyPatch.context() as mp:
        for side, mod in (("port", api), ("jax", japi)):
            fn = mod.sam_logits_to_masks

            def rec(low_res, *a, _fn=fn, _side=side, **kw):
                records.setdefault(_side, []).append(
                    np.array(low_res) if _side == "jax"
                    else low_res.cpu().numpy())
                records.setdefault(_side + "_call", []).append((a, kw))
                return _fn(low_res, *a, **kw)
            mp.setattr(mod, "sam_logits_to_masks", rec)
        yield


class _Pair:
    """A port grounder and a JAX grounder on the same weights; each call is
    made once on both sides and cached with the low-res logits it
    produced."""

    def __init__(self, port, jax_side):
        self.port, self.jax = port, jax_side
        self.cache = {}

    def __call__(self, name, fn):
        if name not in self.cache:
            records = {}
            with _low_res(records):
                got = fn(self.port, np.asarray)
                want = fn(self.jax, Image.fromarray)
            self.cache[name] = got, want, records
        return self.cache[name]


@pytest.fixture(scope="module")
def deepseek(deepseek_params):
    tokenizer = DecodingFakeTokenizer()
    start = _img_start(tokenizer, "deepseek", 64)
    jcfg, tcfg = jds.tiny(img_start=start), tds.tiny(img_start=start)
    jp, tp = deepseek_params
    kw = dict(tokenizer=tokenizer, max_new_tokens=6, max_thought_tokens=4)
    return _Pair(
        api.Grounder(cfg=tcfg, params=tp,
                     prompt_template=tok.TEMPLATES["deepseek"],
                     processor=ProcessorConfig(size=tcfg.input_size),
                     device="cpu", **kw),
        japi.Grounder(cfg=jcfg, params=jp,
                      prompt_template=jtok.TEMPLATES["deepseek"],
                      processor=JProcessorConfig(size=jcfg.input_size),
                      **kw))


def _answer(g, wrap):
    return g.answer(wrap(_image()), "what is this?")


def _check_answer(got, want):
    assert list(got["output_ids"]) == list(want["output_ids"])
    assert got["output_ids"].dtype == want["output_ids"].dtype
    assert got["output_text"] == want["output_text"]
    for key in ("attention_maps", "hidden_states"):
        assert tuple(got[key].shape) == want[key].shape, key
        _close(got[key], want[key], MAP_TOL)
    for key in ("meta_data", "sam_input_size", "orig_size"):
        assert got[key] == want[key], key
    np.testing.assert_array_equal(got["sam_pixels"], want["sam_pixels"])


def test_answer_matches_jax(deepseek):
    got, want, _ = deepseek("answer", _answer)
    assert got["attention_maps"].shape[:2] == (3, 4)
    assert got["attention_maps"].shape[3] == 64
    _check_answer(got, want)


def test_answer_with_history_matches_jax(deepseek):
    history = [("what is this?", "a cat"), ("and that?", "a dog")]
    got, want, _ = deepseek("history", lambda g, wrap: g.answer(
        wrap(_image()), "which is bigger?", history=history))
    _check_answer(got, want)


def _check_ground(got, want, records):
    (gc, gm), (wc, wm) = got, want
    assert tuple(gc.shape) == wc.shape
    _close(gc, wc, LOGIT_TOL)
    assert len(records["port"]) == len(records["jax"]) == 1
    _close(records["port"][0], records["jax"][0], LOGIT_TOL)
    assert gm.dtype == wm.dtype == np.uint8
    assert_masks_pinned(gm, wm, records)


def test_ground_matches_jax(deepseek):
    answer = deepseek("answer", _answer)

    def ground(g, wrap):
        out = answer[0] if wrap is np.asarray else answer[1]
        t = out["attention_maps"].shape[2]
        return g.ground(out, [(0, t), (max(0, t - 2), t)])

    got, want, records = deepseek("ground", ground)
    assert got[1].shape == (2, 60, 90)
    _check_ground(got, want, records)


@pytest.mark.parametrize("version", ["v1", "v2", "v3"])
def test_visual_cot_matches_jax(deepseek, version):
    got, want, records = deepseek(f"cot_{version}", lambda g, wrap: getattr(
        g, f"visual_cot_{version}")(wrap(_image()), "why?"))
    (thought, bbox, final, mask), (jthought, jbbox, jfinal, jmask) = got, want
    assert (thought, tuple(bbox), final) == (jthought, tuple(jbbox), jfinal)
    if version == "v3":
        assert mask is None and jmask is None and bbox == (0, 0, 90, 60)
        return
    assert len(records["port"]) == len(records["jax"]) == 1
    _close(records["port"][0], records["jax"][0], LOGIT_TOL)
    assert_masks_pinned(mask, jmask, records)
    x0, y0, x1, y1 = bbox
    assert 0 <= x0 < x1 <= 90 and 0 <= y0 < y1 <= 60


def test_grounder_with_fragmenting_tokenizer(deepseek_params):
    """No single id for '<image>': the sentinel 0 is spliced, the block
    start tracked, and answer / ground agree with the JAX grounder."""
    tokenizer = FragmentingFakeTokenizer()
    jcfg, tcfg = jds.tiny(), tds.tiny()
    jp, tp = deepseek_params
    kw = dict(tokenizer=tokenizer, image_token="<image>", max_new_tokens=4)
    pair = _Pair(
        api.Grounder(cfg=tcfg, params=tp,
                     prompt_template=tok.TEMPLATES["vicuna"],
                     processor=ProcessorConfig(size=tcfg.input_size),
                     device="cpu", **kw),
        japi.Grounder(cfg=jcfg, params=jp,
                      prompt_template=jtok.TEMPLATES["vicuna"],
                      processor=JProcessorConfig(size=jcfg.input_size),
                      **kw))
    assert pair.port.image_token_id == pair.jax.image_token_id == 0
    ids, starts = pair.port._encode_content("<image>what?")
    jids, jstarts = pair.jax._encode_content("<image>what?")
    np.testing.assert_array_equal(ids, jids)
    assert starts == jstarts
    assert list(ids[starts[0]:starts[0] + 64]) == [0] * 64

    def answer_and_ground(g, wrap):
        out = g.answer(wrap(_image()), "what is this?")
        return out, g.ground(out, [(0, out["attention_maps"].shape[2])])

    (got, gground), (want, wground), records = pair("ag", answer_and_ground)
    _check_answer(got, want)
    _check_ground(gground, wground, records)


# -- LLaVA-NeXT anyres ---------------------------------------------------------

@pytest.fixture(scope="module")
def anyres():
    tokenizer = DecodingFakeTokenizer()
    start = _img_start(tokenizer, "vicuna",
                       jllava_next.tiny_llava_next().n_img_max)
    jcfg = jllava_next.tiny_llava_next(img_start=start)
    tcfg = tllava_next.tiny_llava_next(img_start=start)
    jp, tp = _params(tmln.init_params, tcfg)
    kw = dict(tokenizer=tokenizer, max_new_tokens=5)
    return _Pair(
        api.AnyresGrounder(cfg=tcfg, params=tp,
                           prompt_template=tok.TEMPLATES["vicuna"],
                           device="cpu", **kw),
        japi.AnyresGrounder(cfg=jcfg, params=jp,
                            prompt_template=jtok.TEMPLATES["vicuna"], **kw))


def test_anyres_answer_and_ground_match_jax(anyres):
    def answer_and_ground(g, wrap):
        out = g.answer(wrap(_image()), "what is this?")
        return out, g.ground(out, [(0, out["attention_maps"].shape[2])])

    (got, gground), (want, wground), records = anyres("ag", answer_and_ground)
    assert got["attention_maps"].shape[3] == anyres.port.cfg.n_img_max
    _check_answer(got, want)
    for key in ("fine_gather", "fine_valid", "fine_hw"):
        np.testing.assert_array_equal(got[key], want[key])
    _check_ground(gground, wground, records)


@pytest.mark.parametrize("version", ["v2", "v3"])
def test_anyres_visual_cot_matches_jax(anyres, version):
    got, want, records = anyres(f"cot_{version}", lambda g, wrap: getattr(
        g, f"visual_cot_{version}")(wrap(_image()), "where?"))
    (_, bbox, final, mask), (_, jbbox, jfinal, jmask) = got, want
    assert (tuple(bbox), final) == (tuple(jbbox), jfinal)
    if version == "v3":
        assert mask is None and jmask is None and bbox == (0, 0, 90, 60)
        return
    assert len(records["port"]) == len(records["jax"]) == 1
    _close(records["port"][0], records["jax"][0], LOGIT_TOL)
    assert_masks_pinned(mask, jmask, records)


# -- make_grounder, boxes, prompt encoding -------------------------------------

@pytest.mark.parametrize("family,jfactory,tfactory", [
    ("deepseek_vl", jds.tiny, tds.tiny),
    ("llava", jllava.tiny_llava, tllava.tiny_llava),
    ("llava_next", jllava_next.tiny_llava_next, tllava_next.tiny_llava_next),
    ("hpt", jhpt.tiny_hpt, thpt.tiny_hpt),
])
def test_make_grounder_matches_jax(family, jfactory, tfactory):
    tokenizer = DecodingFakeTokenizer()
    kw = dict(max_new_tokens=3, max_thought_tokens=2)
    with pytest.warns(UserWarning) if family == "llava_next" else \
            contextlib.nullcontext():
        got = api.make_grounder(family, tfactory(), {}, tokenizer,
                                device="cpu", **kw)
    with pytest.warns(UserWarning) if family == "llava_next" else \
            contextlib.nullcontext():
        want = japi.make_grounder(family, jfactory(), {}, tokenizer, **kw)
    assert type(got).__name__ == type(want).__name__
    assert got.prompt_template == want.prompt_template
    assert got.image_token == want.image_token
    assert got.image_token_id == want.image_token_id
    assert got.stop_ids == want.stop_ids
    assert got.max_new_tokens == want.max_new_tokens == 3
    assert got.device == torch.device("cpu")
    if family != "llava_next":
        assert got.thought_stop_ids == want.thought_stop_ids
        assert got.max_thought_tokens == 2
        for field in ("size", "size_rule", "mean", "std", "min_size"):
            assert getattr(got.processor, field) == getattr(
                want.processor, field), field
        # JAX keeps PIL's filter number, the port its name
        assert (got.processor.resample, want.processor.resample) == (
            "bicubic", Image.BICUBIC)


def test_make_grounder_drops_unsupported_kwargs():
    """A knob the port's grounder lacks (the JAX grounder's ``use_sam``,
    which the port does not take: ``ground`` always refines with SAM) is
    dropped with a warning, not taken silently."""
    with pytest.warns(UserWarning, match="use_sam"):
        got = api.make_grounder("deepseek_vl", tds.tiny(), {},
                                DecodingFakeTokenizer(), device="cpu",
                                use_sam=False)
    assert not hasattr(got, "use_sam")


def test_make_grounder_refuses_mgm():
    """Ported since: ``make_grounder('mgm')`` gives an ``MGMGrounder`` over
    the config's base with Gemma's template, as JAX's does
    (tests/test_torch_mgm_io.py runs it against JAX's)."""
    from flmm_tpu.configs import mgm as jmgm_configs
    from flmm_tpu_torch.configs import mgm as tmgm_configs

    tokenizer = DecodingFakeTokenizer()
    got = api.make_grounder("mgm", tmgm_configs.tiny_mgm(hd=True), {},
                            tokenizer, device="cpu", max_new_tokens=3)
    want = japi.make_grounder("mgm", jmgm_configs.tiny_mgm(hd=True), {},
                              tokenizer, max_new_tokens=3)
    assert type(got) is api.MGMGrounder
    assert type(want).__name__ == "MGMGrounder"
    assert got.prompt_template == want.prompt_template == \
        tok.TEMPLATES["gemma"]
    assert (got.image_token, got.image_token_id, got.stop_ids) == (
        want.image_token, want.image_token_id, want.stop_ids)
    assert got.cfg is got.mgm_cfg.base and got.mgm_cfg.num_crops == 5
    assert dataclasses.astuple(got.spec) == dataclasses.astuple(
        want._mgm_spec())


def test_mask2box_scaled_matches_jax_and_pil_crop():
    rng = np.random.default_rng(0)
    img = _image(50, 70)
    masks = [np.zeros((50, 70), bool), np.ones((50, 70), bool)]
    for _ in range(20):
        m = np.zeros((50, 70), bool)
        y, x = rng.integers(0, 50), rng.integers(0, 70)
        m[y:y + rng.integers(1, 30), x:x + rng.integers(1, 30)] = True
        masks.append(m)
    for m in masks:
        for scale in (0.5, 1.0, 2.0, 4.0):
            box = api.mask2box_scaled(m, scale)
            assert box == japi.mask2box_scaled(m, scale)
            x0, y0, x1, y1 = box
            np.testing.assert_array_equal(
                api._crop(img, box),
                np.asarray(Image.fromarray(img).crop(box)))


@pytest.mark.parametrize("tokenizer", [DecodingFakeTokenizer(),
                                       FragmentingFakeTokenizer()],
                         ids=["single_id", "fragmenting"])
def test_encode_with_images_matches_jax(tokenizer):
    for marker in ("<image_placeholder>", "<image>"):
        image_id = api._sentinel_image_token_id(tokenizer, marker)
        assert image_id == japi._sentinel_image_token_id(tokenizer, marker)
        for content, n_markers, suffix in (
                (marker + "what is it?", 1, ""),
                (marker + "what is " + marker + " here?", 1, " It is"),
                (marker + "the whole image, " + marker + "the crop", 2, ""),
                (marker + "a " + marker + "b " + marker + "c", None, "")):
            args = (tokenizer, tok.TEMPLATES["vicuna"], content, marker, 7,
                    image_id)
            got = api.encode_with_images(*args, suffix=suffix,
                                         n_markers=n_markers)
            want = japi.encode_with_images(*args, suffix=suffix,
                                           n_markers=n_markers)
            np.testing.assert_array_equal(got[0], want[0])
            assert got[0].dtype == want[0].dtype and got[1] == want[1]
    with pytest.raises(ValueError):
        api.encode_with_images(tokenizer, tok.TEMPLATES["vicuna"], "no image",
                               "<image>", 7, 0)
