"""The port's MGM entry points against the JAX package on the CPU: the host
processing (``pad2square``, ``mgm_process``, ``build_mgm_batch``), the video
path, the checkpoint loaders (``convnext_params``, ``mgm_frozen`` through
``registry.get_loader('mgm')``, Mixtral's ``block_sparse_moe`` keys,
``eva_vit_params``), the trainer's refusal of the family's grounding
task and ``MGMGrounder`` (answer, ground, visual CoT) at ``tiny_mgm``
(tests/test_torch_bench.py holds ``bench.build`` at ``BENCH_FAMILY=mgm``).

Images are ``(H, W, 3)`` uint8 arrays on the port's side and
``PIL.Image.fromarray`` of them on the JAX side.  Batches, processed pixels
and loader trees must be equal bit for bit; token ids, text, boxes and masks
exactly; video frames within 1e-5 (both bicubic resizes are PyTorch's
kernel, the JAX one re-expressed in its own ops); attention maps and hidden
states within 1e-4, coarse and SAM low-res logits within 1e-3.
"""

import contextlib
import dataclasses
import os
import subprocess
import sys

import numpy as np
import jax
import jax.numpy as jnp
import pytest
import torch
from PIL import Image

from flmm_tpu import registry as jregistry
from flmm_tpu.configs import mgm as jconfigs
from flmm_tpu.convert import hf_weights as jhf
from flmm_tpu.convert import load as jload
from flmm_tpu.data import collate as jcollate
from flmm_tpu.data import mgm as jdata
from flmm_tpu.data import processors as jproc
from flmm_tpu.data import tokenization as jtok
from flmm_tpu.data import video as jvideo
from flmm_tpu.generation import api as japi
from flmm_tpu.models.llm import decoder as jdecoder
from flmm_tpu_torch import registry
from flmm_tpu_torch.configs import mgm as tconfigs
from flmm_tpu_torch.convert import hf_weights, load
from flmm_tpu_torch.convert.from_jax import from_jax
from flmm_tpu_torch.data import collate, processors, video
from flmm_tpu_torch.data import mgm as data
from flmm_tpu_torch.data.synthetic import synthetic_samples
from flmm_tpu_torch.generation import api
from flmm_tpu_torch.models.llm import decoder
from flmm_tpu_torch.models.vision import vit
from tests import checkpoint_writers as cw
from tests.test_data import IMAGE_TOKEN_ID
from tests.test_generation_api import DecodingFakeTokenizer
from tests.test_torch_generation_api import assert_masks_pinned
from tests.test_torch_convert import JDT, _jax, assert_trees_equal
from tests.test_torch_mgm import seeded_params

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
MAP_TOL, LOGIT_TOL, VIDEO_TOL = 1e-4, 1e-3, 1e-5
# (h, w): tall, wide, square and odd sizes
SIZES = ((60, 90), (97, 41), (33, 33), (7, 120))


def _image(h=60, w=90, seed=0):
    return np.random.default_rng(seed).integers(0, 255, (h, w, 3), np.uint8)


def _pil(sample):
    return {**sample, "image": Image.fromarray(sample["image"], "RGB")}


def _equal_batches(got, want):
    assert set(got) == set(want)
    for key, ref in want.items():
        if isinstance(ref, dict):
            _equal_batches(got[key], ref)
        elif key == "infos":
            assert len(got[key]) == len(ref)
            for a, b in zip(got[key], ref):
                assert a["num_masks"] == b["num_masks"]
                assert tuple(a["orig_size"]) == tuple(b["orig_size"])
        else:
            assert got[key].dtype == ref.dtype, key
            np.testing.assert_array_equal(got[key], ref, err_msg=key)


def _mgm_spec(cfg, mod):
    return mod.MGMProcessSpec(**dataclasses.asdict(cfg.process_spec()))


# --- host processing -------------------------------------------------------

@pytest.mark.parametrize("hd", [False, True], ids=["single", "hd"])
@pytest.mark.parametrize("hw", SIZES)
def test_mgm_process_matches_jax(hd, hw):
    """The square pad (meta and canvas colour), the aux image, the crop
    grid and the global crop, bit for bit (PIL's bicubic in both)."""
    cfg = tconfigs.tiny_mgm(hd=hd)
    image = _image(*hw)
    got = data.mgm_process(image, _mgm_spec(cfg, data))
    want = jdata.mgm_process(Image.fromarray(image),
                             _mgm_spec(cfg, jdata))
    assert got["meta"] == want["meta"]
    for key in ("crops", "aux"):
        assert got[key].dtype == want[key].dtype == np.float32
        np.testing.assert_array_equal(got[key], want[key], err_msg=key)
    assert got["crops"].shape == (5 if hd else 1, 32, 32, 3)
    square, meta = data.pad2square(image, processors.CLIP_MEAN)
    jsquare, jmeta = jdata.pad2square(Image.fromarray(image),
                                      jproc.CLIP_MEAN)
    np.testing.assert_array_equal(square, np.asarray(jsquare))
    assert meta == jmeta


def _batch_spec(cfg, mod, proc, **kw):
    base = cfg.base
    return mod.BatchSpec(
        seq_len=kw.pop("seq_len", 160), max_masks=3, text_per_mask=5,
        coarse_hw=registry.get_coarse_hw(cfg),
        sam_size=base.sam.encoder.img_size, prompt_size=base.sam.prompt_size,
        expected_img_start=base.img_start,
        processor=proc.ProcessorConfig(size=base.input_size), **kw)


@pytest.mark.parametrize("hd", [False, True], ids=["single", "hd"])
def test_build_mgm_batch_matches_jax(hd):
    """Through ``get_batch_builder('mgm', ...)`` on both sides (the port's
    bound to the config, JAX's given its spec), one sample's prompt cut by
    the sequence length."""
    cfg, jcfg = tconfigs.tiny_mgm(hd=hd), jconfigs.tiny_mgm(hd=hd)
    samples = synthetic_samples(cfg, n=3, seed=5, max_masks=3,
                                caption_tokens=5)
    seq = max(len(s["input_ids"]) for s in samples) - 3
    got = registry.get_batch_builder("mgm", cfg)(
        samples, _batch_spec(cfg, collate, processors, seq_len=seq))
    want = jregistry.get_batch_builder(
        "mgm", **dataclasses.asdict(cfg.process_spec()))(
        [_pil(s) for s in samples],
        _batch_spec(jcfg, jcollate, jproc, seq_len=seq))
    _equal_batches(got, want)
    assert got["pixel_values"].shape == (3, cfg.num_crops, 32, 32, 3)
    assert got["aux_pixel_values"].shape == (3, 64 * (2 if hd else 1),
                                             64 * (2 if hd else 1), 3)
    assert "position_ids" not in got and got["mask_valid"].any()


def test_build_mgm_batch_refuses_a_moved_image_block():
    cfg = tconfigs.tiny_mgm()
    spec = dataclasses.replace(_batch_spec(cfg, collate, processors),
                               expected_img_start=4)
    with pytest.raises(ValueError, match="img_start"):
        data.build_mgm_batch(synthetic_samples(cfg, n=1), spec,
                             data.MGMProcessSpec(crop_size=32, aux_size=64))


# --- the video path ----------------------------------------------------------

def test_video_frames_match_jax():
    rng = np.random.default_rng(0)
    for shape, edge in (((3, 120, 160, 3), 96), ((2, 200, 110, 3), 96),
                        ((1, 96, 96, 3), 96), ((2, 50, 70, 3), 32)):
        frames = rng.integers(0, 255, shape).astype(np.uint8)
        got = video.preprocess_video_frames(frames, shortest_edge=edge,
                                            crop_size=edge)
        want = jvideo.preprocess_video_frames(frames, shortest_edge=edge,
                                              crop_size=edge)
        assert got.shape == want.shape == (shape[0], 3, edge, edge)
        np.testing.assert_allclose(got, want, atol=VIDEO_TOL,
                                   rtol=VIDEO_TOL)
    for n_total, n in ((4, 8), (100, 8), (9, 3), (1, 1)):
        assert video.sample_indices(n_total, n) == \
            jvideo.sample_indices(n_total, n)


def test_video_dir_through_mgm_processing_matches_jax(tmp_path):
    """A frame directory (PNG and JPEG, decoded without PIL here) sampled
    and processed as JAX's ``process_video`` does."""
    rng = np.random.default_rng(1)
    for i in range(6):
        img = Image.fromarray(rng.integers(0, 255, (60, 80, 3), np.uint8))
        img.save(tmp_path / f"frame_{i:03d}.{'png' if i % 2 else 'jpg'}")
    (tmp_path / "notes.txt").write_text("not a frame")
    got = video.load_frames_from_dir(str(tmp_path), n_frames=4)
    want = jvideo.load_frames_from_dir(str(tmp_path), n_frames=4)
    assert len(got) == len(want) == 4
    for a, b in zip(got, want):
        np.testing.assert_array_equal(a, np.asarray(b))
    cfg = tconfigs.tiny_mgm()
    spec, jspec = _mgm_spec(cfg, data), _mgm_spec(cfg, jdata)

    def prep(mod, s):
        def fn(im):
            out = mod.mgm_process(im, s)
            return {"pixel_values": out["crops"][0], "meta": out["meta"]}
        return fn

    res = video.process_video(got, prep(data, spec), n_frames=3)
    jres = jvideo.process_video(want, prep(jdata, jspec), n_frames=3)
    assert res["frame_indices"] == jres["frame_indices"]
    assert res["metas"] == jres["metas"]
    np.testing.assert_array_equal(res["pixel_values"], jres["pixel_values"])


# --- checkpoint loaders -------------------------------------------------------

@pytest.fixture(scope="module")
def mgm_world(tmp_path_factory):
    """Random tiny MGM frozen trees (every leaf drawn) and their three
    checkpoints in f32 and bf16."""
    cfg = tconfigs.tiny_mgm()
    g = torch.Generator().manual_seed(2)

    def rand(tree):
        if isinstance(tree, dict):
            return {k: rand(v) for k, v in tree.items()}
        if isinstance(tree, list):
            return [rand(v) for v in tree]
        return torch.randn(tree.shape, generator=g).to(tree.dtype)

    fro = rand(registry.get_model("mgm").init_frozen(
        cfg, torch.Generator().manual_seed(0), "cpu"))
    root = tmp_path_factory.mktemp("mgm_ckpt")
    paths = {dt: cw.mgm_checkpoints(root / str(dt).split(".")[-1], fro, dt)
             for dt in (torch.float32, torch.bfloat16)}
    sam = root / "sam.pth"
    torch.save(cw.sam_encoder_state_dict(fro["sam_encoder"]), sam)
    return cfg, fro, paths, str(sam)


@pytest.mark.parametrize("ckpt_dtype", [torch.float32, torch.bfloat16])
def test_get_loader_mgm_matches_jax(mgm_world, ckpt_dtype):
    """``get_loader('mgm')`` against JAX's ``mgm_frozen`` bit for bit, and
    (f32 checkpoints) against the tree the files were written from; the
    open_clip ConvNeXt is the only ``*.bin`` of its folder."""
    cfg, fro, paths, sam = mgm_world
    p = paths[ckpt_dtype]
    got = registry.get_loader("mgm")(
        str(p["checkpoint"]), cfg, sam, clip_checkpoint=str(p["clip"]),
        aux_checkpoint=str(p["aux"]))
    want = _jax(jload.mgm_frozen(str(p["checkpoint"]), jconfigs.tiny_mgm(),
                                 str(p["clip"]), str(p["aux"]), sam))
    assert_trees_equal(got, want)
    if ckpt_dtype == torch.float32:
        assert_trees_equal(got, fro)
    with pytest.raises(ValueError, match="both required"):
        registry.get_loader("mgm")(str(p["checkpoint"]), cfg, sam)


@pytest.mark.parametrize("target", [torch.float32, torch.bfloat16])
def test_convnext_params_match_jax(mgm_world, target):
    cfg, fro, paths, _ = mgm_world
    sd = load.load_state_dict(paths[torch.bfloat16]["aux"])
    got = load.convnext_params(sd, cfg.aux, dtype=target)
    want = _jax(jload.convnext_params(sd, jconfigs.tiny_mgm().aux,
                                      dtype=JDT[target]))
    assert_trees_equal(got, want)


def test_mixtral_and_eva_converters_match_jax():
    """Mixtral's ``block_sparse_moe`` keys (router, w1 / w3 / w2 per expert)
    and the EVA-G trunk's fused qkv with its q and v biases."""
    moe = dict(vocab_size=64, hidden_size=32, num_layers=2, num_heads=4,
               num_kv_heads=2, head_dim=8, intermediate_size=48,
               num_experts=4, num_experts_per_tok=2)
    tcfg = decoder.DecoderConfig(dtype=torch.float32, **moe)
    jcfg = jdecoder.DecoderConfig(dtype=jnp.float32, **moe)
    g = torch.Generator().manual_seed(4)
    tree = decoder.init_params(tcfg, g, "cpu")
    sd = cw.llama_state_dict(tree)
    assert "model.layers.1.block_sparse_moe.experts.3.w2.weight" in sd
    got = hf_weights.llama_decoder_params(sd, tcfg)
    assert_trees_equal(got, _jax(jhf.llama_decoder_params(sd, jcfg)))
    assert_trees_equal(got, tree)

    ecfg = dataclasses.replace(tconfigs.eva_g_14(dtype=torch.float32),
                               hidden_size=32, num_layers=2, num_heads=2,
                               mlp_dim=48, image_size=28)
    jecfg = dataclasses.replace(jconfigs.eva_g_14(dtype=jnp.float32),
                                hidden_size=32, num_layers=2, num_heads=2,
                                mlp_dim=48, image_size=28)
    r = lambda *s: torch.randn(s, generator=g)  # noqa: E731
    esd = {"patch_embed.proj.weight": r(32, 3, 14, 14),
           "patch_embed.proj.bias": r(32), "cls_token": r(1, 1, 32),
           "pos_embed": r(1, 5, 32), "norm.weight": r(32),
           "norm.bias": r(32)}
    for i in range(2):
        b = f"blocks.{i}."
        esd.update({b + "norm1.weight": r(32), b + "norm1.bias": r(32),
                    b + "norm2.weight": r(32), b + "norm2.bias": r(32),
                    b + "attn.qkv.weight": r(96, 32),
                    b + "attn.q_bias": r(32), b + "attn.v_bias": r(32),
                    b + "attn.proj.weight": r(32, 32),
                    b + "attn.proj.bias": r(32),
                    b + "mlp.fc1.weight": r(48, 32), b + "mlp.fc1.bias": r(48),
                    b + "mlp.fc2.weight": r(32, 48),
                    b + "mlp.fc2.bias": r(32)})
    for final in (False, True):
        c = dataclasses.replace(ecfg, final_norm=final)
        jc = dataclasses.replace(jecfg, final_norm=final)
        got = hf_weights.eva_vit_params(esd, c)
        assert_trees_equal(got, _jax(jhf.eva_vit_params(esd, jc)))
        assert ("final_ln_w" in got) == final
        # the tree runs through the port's tower
        out = vit.forward(got, c, torch.zeros(1, 28, 28, 3))
        assert tuple(out.shape) == (1, 5, 32)


# --- entry points -------------------------------------------------------------

def test_trainer_refuses_mgm(tmp_path):
    """The trainer takes the mgm family's random stream
    (tests/test_torch_train_real.py) and refuses it the derivable
    grounding task, whose batches have the standard schema only (the JAX
    script asserts the same)."""
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    proc = subprocess.run(
        [sys.executable, "-m", "flmm_tpu_torch.train", "--family", "mgm",
         "--preset", "tiny", "--synthetic", "--synthetic-task", "grounding",
         "--steps", "1", "--work-dir", str(tmp_path), "--device", "cpu"],
        cwd=REPO, env=env, capture_output=True, text=True, timeout=300)
    assert proc.returncode != 0 and "grounding takes" in proc.stderr
    assert not (tmp_path / "step_1").exists()


# --- MGMGrounder --------------------------------------------------------------

def _img_start(tokenizer, n_img):
    spec = jtok.PromptSpec(jtok.TEMPLATES["gemma"],
                           "<image_placeholder>" * n_img)
    start, n = jtok.find_image_block(jtok.encode_prompt(tokenizer, spec),
                                     IMAGE_TOKEN_ID)
    assert n == n_img
    return start


@contextlib.contextmanager
def _low_res(records):
    """Record the low-res logits each package's grounder turns into masks."""
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


@pytest.fixture(scope="module", params=[False, True], ids=["single", "hd"])
def grounders(request):
    """A port and a JAX ``MGMGrounder`` on one set of weights, through each
    package's ``make_grounder('mgm')``."""
    hd = request.param
    tokenizer = DecodingFakeTokenizer()
    n_img = tconfigs.tiny_mgm(hd=hd).base.num_img_tokens
    start = _img_start(tokenizer, n_img)
    tcfg = tconfigs.tiny_mgm(hd=hd, img_start=start)
    jcfg = jconfigs.tiny_mgm(hd=hd, img_start=start)
    params = seeded_params(tcfg)
    kw = dict(max_new_tokens=5, max_thought_tokens=3)
    port = api.make_grounder("mgm", tcfg, from_jax(params), tokenizer,
                             device="cpu", **kw)
    want = japi.make_grounder("mgm", jcfg, jax.tree.map(jnp.asarray, params),
                              tokenizer, **kw)
    return port, want, {}


def _both(grounders, name, fn):
    port, jside, cache = grounders
    if name not in cache:
        records = {}
        with _low_res(records):
            got = fn(port, np.asarray)
            want = fn(jside, Image.fromarray)
        cache[name] = got, want, records
    return cache[name]


def _answer(g, wrap):
    return g.answer(wrap(_image()), "what is this?")


def test_mgm_grounder_answer_matches_jax(grounders):
    got, want, _ = _both(grounders, "answer", _answer)
    port = grounders[0]
    assert type(port).__name__ == "MGMGrounder"
    assert port.cfg is port.mgm_cfg.base
    assert list(got["output_ids"]) == list(want["output_ids"])
    assert got["output_text"] == want["output_text"]
    for key in ("attention_maps", "hidden_states"):
        assert tuple(got[key].shape) == want[key].shape, key
        np.testing.assert_allclose(got[key].numpy(), np.asarray(want[key]),
                                   atol=MAP_TOL, rtol=MAP_TOL, err_msg=key)
    assert got["attention_maps"].shape[3] == port.cfg.num_img_tokens
    for key in ("meta_data", "sam_input_size", "orig_size"):
        assert got[key] == want[key], key


def test_mgm_grounder_ground_matches_jax(grounders):
    """The spans' maps re-assembled as the forward's (the HD tiles
    stitched beside the upsampled global map)."""
    answer = _both(grounders, "answer", _answer)

    def ground(g, wrap):
        out = answer[0] if wrap is np.asarray else answer[1]
        t = out["attention_maps"].shape[2]
        return g.ground(out, [(0, t), (max(0, t - 2), t)])

    (gc, gm), (wc, wm), records = _both(grounders, "ground", ground)
    assert tuple(gc.shape) == wc.shape == (2, 16, 16)
    np.testing.assert_allclose(gc.numpy(), np.asarray(wc), atol=LOGIT_TOL,
                               rtol=LOGIT_TOL)
    assert len(records["port"]) == len(records["jax"]) == 1
    np.testing.assert_allclose(records["port"][0], records["jax"][0],
                               atol=LOGIT_TOL, rtol=LOGIT_TOL)
    assert gm.shape == (2, 60, 90) and gm.dtype == wm.dtype == np.uint8
    assert_masks_pinned(gm, wm, records)


@pytest.mark.parametrize("version", ["v1", "v2"])
def test_mgm_grounder_visual_cot_matches_jax(grounders, version):
    """The two-image round encodes the image and the crop through both
    towers, as JAX's ``MGMGrounder._two_image_answer``."""
    got, want, records = _both(
        grounders, f"cot_{version}", lambda g, wrap: getattr(
            g, f"visual_cot_{version}")(wrap(_image()), "why?"))
    (thought, bbox, final, mask), (jthought, jbbox, jfinal, jmask) = \
        got, want
    assert (thought, tuple(bbox), final) == (jthought, tuple(jbbox), jfinal)
    np.testing.assert_allclose(records["port"][0], records["jax"][0],
                               atol=LOGIT_TOL, rtol=LOGIT_TOL)
    assert_masks_pinned(mask, jmask, records)
