"""The DeepSeek-VL-7B hybrid slice against the JAX package on the CPU: the
SAM-B high-resolution tower (``models/vision/sam_tower.py``), the split
projector, the ``tiny_hybrid`` forward, loss and gradients, its synthetic and
collated batches, the eval loop, the bench and the trainer at
``tiny_hybrid``, the ``7b`` config field by field, and the three refusals
(hybrid grounder, hybrid checkpoint loader, the eval CLIs at a hybrid
preset).

The JAX side runs its plain XLA path.  The weights are the port's seeded
init as numpy, carried into the port by ``from_jax`` (the JAX init compiles
for some 20 s), with what the init leaves trivial made non-trivial by
``bench.randomize_frozen``: rel-pos tables in both SAM trunks, ``hd_alpha``
0.5 (the init: 0, which would hide the HD branch) and a ``neck_hd`` apart
from the encoder neck (the init: a copy).

Tolerances: the tower at SAM-B's widths 1e-4 in f32 (measured 1.0e-5 on
outputs up to 4.4); the projector 1e-5; the tiny forward, loss and each
trainable gradient 1e-3, as the other families are held; batches bit for
bit.
"""

import dataclasses
import os
import pathlib
import subprocess
import sys

import numpy as np
import jax
import jax.numpy as jnp
import pytest
import torch

import bench as jbench
from flmm_tpu import registry as jregistry
from flmm_tpu.configs import deepseek_vl as jconfigs
from flmm_tpu.data import collate as jcollate
from flmm_tpu.data import processors as jproc
from flmm_tpu.data import synthetic as jsynthetic
from flmm_tpu.evalsuite import metrics as jmetrics
from flmm_tpu.evalsuite import runner as jrunner
from flmm_tpu.models.frozen import grounding as jgrounding
from flmm_tpu.models.sam import image_encoder as jsam_enc
from flmm_tpu.models.vision import sam_tower as jsam_tower
from flmm_tpu_torch import bench, eval_png, eval_refcoco, registry
from flmm_tpu_torch.configs import deepseek_vl as tconfigs
from flmm_tpu_torch.convert import load
from flmm_tpu_torch.convert.from_jax import from_jax
from flmm_tpu_torch.data import collate, processors, synthetic
from flmm_tpu_torch.data import tokenization as tok
from flmm_tpu_torch.evalsuite import metrics, runner
from flmm_tpu_torch.generation import api as generation
from flmm_tpu_torch.models.frozen import deepseek_vl, grounding
from flmm_tpu_torch.models.sam import image_encoder as sam_enc
from flmm_tpu_torch.models.vision import sam_tower
from flmm_tpu_torch.train import loop

REPO = pathlib.Path(__file__).resolve().parent.parent
TOWER_TOL, PROJ_TOL, SLICE_TOL = 1e-4, 1e-5, 1e-3
OUT_KEYS = ("coarse_logits", "sam_logits", "iou_pred", "boxes", "hidden")


def _numpy(tree):
    if isinstance(tree, dict):
        return {k: _numpy(v) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return type(tree)(_numpy(v) for v in tree)
    return tree.numpy()


def _jnp(tree):
    return jax.tree.map(jnp.asarray, tree)


def _assert_same_fields(want, got):
    """Every field of two config dataclasses, nested ones included, but
    dtypes (jnp vs torch)."""
    pairs = [(want, got)]
    while pairs:
        w, g = pairs.pop()
        assert [f.name for f in dataclasses.fields(w)] == [
            f.name for f in dataclasses.fields(g)], type(w).__name__
        for f in dataclasses.fields(w):
            a, b = getattr(w, f.name), getattr(g, f.name)
            if dataclasses.is_dataclass(a):
                pairs.append((a, b))
            elif f.name != "dtype":
                assert b == a, (type(w).__name__, f.name, a, b)


def _equal_batches(got, want):
    assert set(got) == set(want)
    for key, ref in want.items():
        if isinstance(ref, dict):
            _equal_batches(got[key], ref)
        elif key == "infos":
            assert len(got[key]) == len(ref)
        else:
            assert got[key].dtype == ref.dtype, key
            np.testing.assert_array_equal(got[key], ref, err_msg=key)


def _seeded_params(cfg, seed: int = 0) -> dict:
    params = grounding.init_params(cfg, torch.Generator().manual_seed(seed),
                                   "cpu")
    bench.randomize_frozen(params, torch.Generator().manual_seed(seed + 1))
    return params


# --- the tower and the projector ----------------------------------------

def _sam_b_cut(enc_mod, tower_mod):
    """SAM-B's widths (768, 12 heads, neck 256, downsample 512 -> 1024) cut
    to 3 blocks at 256 px: a 16 x 16 grid, padded to 2 x 2 windows of 14."""
    return tower_mod.SamTowerConfig(
        encoder=enc_mod.SamEncoderConfig(
            img_size=256, embed_dim=768, depth=3, num_heads=12,
            global_attn_indexes=(1,)),
        downsample_channels=(512, 1024), neck_size=24)


@pytest.mark.parametrize("which", ["tiny_hybrid", "sam_b_cut"])
def test_sam_tower_matches_jax(which):
    if which == "tiny_hybrid":
        jcfg = jconfigs.tiny_hybrid().hybrid_high
        tcfg = tconfigs.tiny_hybrid().hybrid_high
    else:
        jcfg, tcfg = _sam_b_cut(jsam_enc, jsam_tower), _sam_b_cut(
            sam_enc, sam_tower)
    g = torch.Generator().manual_seed(5)
    tower = sam_tower.init_params(tcfg, g, "cpu")
    assert float(tower["hd_alpha"]) == 0.0
    for k in sam_tower.NECK_KEYS:
        assert torch.equal(tower["neck_hd"][k], tower["encoder"][k])
    params = {"frozen": {"sam_encoder": {"blocks": []},
                         "vision_high": tower}}
    bench.randomize_frozen(params, g)
    assert float(tower["hd_alpha"]) == bench.HD_ALPHA == 0.5
    for k in sam_tower.NECK_KEYS:
        assert not torch.equal(tower["neck_hd"][k], tower["encoder"][k])
    for bp in tower["encoder"]["blocks"]:
        bp["bqkv"] = torch.randn(bp["bqkv"].shape, generator=g) * 0.05
    side = tcfg.encoder.img_size
    px = np.random.default_rng(1).standard_normal(
        (2, side, side, 3)).astype(np.float32)
    with torch.no_grad():
        got = sam_tower.forward(tower, tcfg, torch.from_numpy(px))
        without_hd = sam_tower.forward({**tower, "hd_alpha": torch.zeros(1)},
                                       tcfg, torch.from_numpy(px))
    want = np.asarray(jax.jit(lambda p, x: jsam_tower.forward(p, jcfg, x))(
        _jnp(_numpy(tower)), px))
    n = tcfg.neck_size // 4
    assert got.shape == want.shape == (2, n, n, tcfg.out_channels)
    np.testing.assert_allclose(got.numpy(), want, atol=TOWER_TOL,
                               rtol=TOWER_TOL)
    # the HD branch does work here
    assert float((got - without_hd).abs().max()) > 100 * TOWER_TOL


def test_project_hybrid_matches_jax():
    rng = np.random.default_rng(2)
    high = rng.standard_normal((2, 36, 48)).astype(np.float32)
    low = rng.standard_normal((2, 36, 40)).astype(np.float32)

    def lin(i, o):
        return {"w": (rng.standard_normal((i, o)) / np.sqrt(i)).astype(
                    np.float32),
                "b": (rng.standard_normal((o,)) * 0.1).astype(np.float32)}

    p = {"high_up": lin(48, 32), "low_up": lin(40, 32),
         "layers": [lin(64, 64), lin(64, 64)]}
    got = grounding._project_hybrid(torch.from_numpy(high),
                                    torch.from_numpy(low), from_jax(p))
    want = jgrounding._project_hybrid(jnp.asarray(high), jnp.asarray(low),
                                      _jnp(p))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=PROJ_TOL,
                               rtol=PROJ_TOL)


# --- the tiny_hybrid forward, loss and gradients -------------------------

@pytest.fixture(scope="module")
def hybrid():
    """(JAX config, port config, weights as numpy, a JAX synthetic batch)."""
    jcfg, tcfg = jconfigs.tiny_hybrid(), tconfigs.tiny_hybrid()
    jparams = _numpy(_seeded_params(tcfg))
    batch = jsynthetic.synthetic_batch(jcfg, batch_size=2, seed=3)
    return jcfg, tcfg, jparams, batch


def test_tiny_hybrid_tree_is_the_jax_init_tree(hybrid):
    """The port's init has the JAX init's leaves, shapes and dtypes (the
    JAX tree traced, not built), ``vision_high`` and the split projector
    included; ``from_jax`` carries the tree across unchanged."""
    jcfg, _, jparams, _ = hybrid
    abstract = jax.eval_shape(lambda k: jgrounding.init_params(jcfg, k),
                              jax.random.key(0))
    want = {jax.tree_util.keystr(p): (a.shape, np.dtype(a.dtype).name)
            for p, a in jax.tree_util.tree_leaves_with_path(abstract)}
    got = {jax.tree_util.keystr(p): (a.shape, a.dtype.name)
           for p, a in jax.tree_util.tree_leaves_with_path(jparams)}
    assert got == want
    assert set(jparams["frozen"]["projector"]) == {"high_up", "low_up",
                                                   "layers"}
    carried = from_jax(jparams)["frozen"]["vision_high"]
    for path, leaf in jax.tree_util.tree_leaves_with_path(
            jparams["frozen"]["vision_high"]):
        node = carried
        for key in path:
            node = node[getattr(key, "key", getattr(key, "idx", None))]
        np.testing.assert_array_equal(node.numpy(), leaf)


def test_tiny_hybrid_forward_matches_jax(hybrid):
    jcfg, tcfg, jparams, batch = hybrid
    want = jax.device_get(jax.jit(
        lambda p, b: jgrounding.forward(p, jcfg, b))(_jnp(jparams),
                                                     _jnp(batch)))
    with torch.no_grad():
        got = grounding.forward(from_jax(jparams), tcfg, from_jax(batch))
        # the high-resolution pixels reach the output
        moved = grounding.forward(from_jax(jparams), tcfg, from_jax(
            {**batch, "hires_pixel_values": batch["hires_pixel_values"]
             + 0.5}))
    for key in OUT_KEYS:
        assert got[key].shape == want[key].shape, key
        np.testing.assert_allclose(got[key].numpy(), np.asarray(want[key]),
                                   atol=SLICE_TOL, rtol=SLICE_TOL,
                                   err_msg=key)
    assert not torch.allclose(moved["coarse_logits"], got["coarse_logits"])
    assert registry.get_model("deepseek_vl").forward is grounding.forward


def test_tiny_hybrid_loss_and_gradients_match_jax(hybrid):
    """As tests/test_torch_train.py holds the tiny loss: each trainable
    leaf's gradient within 1e-3 of max |ref| (floored at 1e-5 of the largest
    gradient), the frozen tree -- SAM-B trunk and split projector included --
    without gradients."""
    jcfg, tcfg, jparams, batch = hybrid
    vg = jax.jit(jax.value_and_grad(
        lambda tr, fr, b: jgrounding.loss_fn(
            {"frozen": fr, "trainable": tr}, jcfg, b), has_aux=True))
    (jloss, jmetrics_), jgrads = jax.device_get(vg(
        _jnp(jparams["trainable"]), _jnp(jparams["frozen"]), _jnp(batch)))
    params = from_jax(jparams)
    state = loop.init_state(params["trainable"],
                            loop.make_optimizer(loop.OptimConfig()))
    (loss, metrics_), grads = loop.value_and_grad(
        lambda p, b: deepseek_vl.loss_fn(p, tcfg, b), params["frozen"],
        state["params"], from_jax(batch))
    assert abs(float(loss) - float(jloss)) <= SLICE_TOL * abs(float(jloss))
    for key, want in jmetrics_.items():
        np.testing.assert_allclose(metrics_[key].numpy(), want,
                                   rtol=SLICE_TOL, atol=1e-6, err_msg=key)
    want = dict(loop.tree_leaves(jgrads))
    assert set(grads) == set(want)
    scale = max(np.abs(g).max() for g in want.values())
    for path, ref in want.items():
        got = (np.zeros_like(ref) if grads[path] is None
               else grads[path].numpy())
        err = np.abs(got - ref).max() / max(np.abs(ref).max(), 1e-5 * scale)
        assert err <= SLICE_TOL, (path, err)
    for path, leaf in loop.tree_leaves(params["frozen"]):
        assert not leaf.requires_grad and leaf.grad is None, path


# --- batches --------------------------------------------------------------

@pytest.mark.parametrize("kind", ["batch", "grounding_batch", "samples"])
def test_synthetic_data_is_the_jax_packages(kind):
    """In JAX's draw order: ``hires_pixel_values`` between the tower's and
    SAM's pixels; zeros in the grounding task, as JAX gives them."""
    jcfg, tcfg = jconfigs.tiny_hybrid(), tconfigs.tiny_hybrid()
    if kind == "samples":
        want = jsynthetic.synthetic_samples(jcfg, n=3, seed=4)
        got = synthetic.synthetic_samples(tcfg, n=3, seed=4)
        for g, w in zip(got, want):
            np.testing.assert_array_equal(g["image"], np.asarray(w["image"]))
            for key in ("input_ids", "mask_ids", "masks"):
                np.testing.assert_array_equal(g[key], w[key])
            assert g["spans"] == w["spans"]
        return
    fn = ("synthetic_batch" if kind == "batch"
          else "synthetic_grounding_batch")
    want = getattr(jsynthetic, fn)(jcfg, batch_size=3, seed=2)
    got = getattr(synthetic, fn)(tcfg, batch_size=3, seed=2)
    _equal_batches(got, want)
    assert got["hires_pixel_values"].shape == (3, 64, 64, 3)
    assert (got["hires_pixel_values"] != 0).any() == (kind == "batch")


def _spec(cfg, mod, proc, **kw):
    return mod.BatchSpec(
        seq_len=128, max_masks=2, text_per_mask=8,
        coarse_hw=registry.get_coarse_hw(cfg),
        sam_size=cfg.sam.encoder.img_size, prompt_size=cfg.sam.prompt_size,
        expected_img_start=cfg.img_start,
        hires_size=cfg.hybrid_high.encoder.img_size,
        processor=proc.ProcessorConfig(
            size=cfg.input_size,
            size_rule=registry.FAMILY_SIZE_RULES["deepseek_vl"]), **kw)


def _pil(sample):
    from PIL import Image

    return {**sample, "image": Image.fromarray(sample["image"], "RGB")}


def test_collate_with_hires_size_matches_jax():
    cfg, jcfg = tconfigs.tiny_hybrid(), jconfigs.tiny_hybrid()
    samples = synthetic.synthetic_samples(cfg, n=3, seed=6)
    got = collate.build_batch(samples, _spec(cfg, collate, processors))
    want = jcollate.build_batch([_pil(s) for s in samples],
                                _spec(jcfg, jcollate, jproc))
    _equal_batches(got, want)
    assert got["hires_pixel_values"].shape == (3, 64, 64, 3)
    assert got["hires_pixel_values"].any()


def test_run_eval_at_tiny_hybrid_matches_jax(hybrid):
    """Each package's runner and forward on one set of weights, the batch
    spec from the port's ``resolve_family_setup`` on both sides (the JAX
    registry's lacks ``hires_size``, ROADMAP queue 3): the logits of every
    batch, then the scores."""
    _, _, jparams, _ = hybrid
    cfg, _, kw = registry.resolve_family_setup("deepseek_vl", "tiny_hybrid",
                                               _Tokenizer())
    jcfg = jconfigs.tiny_hybrid(img_start=cfg.img_start)
    common = dict(seq_len=128, max_masks=2, text_per_mask=8,
                  coarse_hw=registry.get_coarse_hw(cfg))
    spec = collate.BatchSpec(**common, **kw)
    proc = kw["processor"]
    jspec = jcollate.BatchSpec(**common, **{**kw, "processor":
                               jproc.ProcessorConfig(
                                   size=proc.size,
                                   size_rule=proc.size_rule)})
    assert spec.hires_size == jspec.hires_size == 64
    samples = synthetic.synthetic_samples(cfg, n=5, seed=3)
    params = from_jax(jparams)
    jforward = jax.jit(lambda p, b: jgrounding.forward(p, jcfg, b)[
        "sam_logits"])
    jtree = _jnp(jparams)
    logits = {"port": [], "jax": []}

    def port_predict(batch):
        with torch.no_grad():
            out = grounding.forward(params, cfg, from_jax(batch))
        logits["port"].append(out["sam_logits"].numpy())
        return out["sam_logits"]

    def jax_predict(batch):
        out = np.asarray(jforward(jtree, _jnp(batch)))
        logits["jax"].append(out)
        return out

    got = runner.run_eval(samples, port_predict, spec, 4,
                          metrics.RefSegAccumulator,
                          runner.refcoco_score).results()
    want = jrunner.run_eval([_pil(s) for s in samples], jax_predict, jspec,
                            4, jmetrics.RefSegAccumulator,
                            jrunner.refcoco_score).results()
    assert len(logits["port"]) == len(logits["jax"]) == 2
    for a, b in zip(logits["port"], logits["jax"]):
        np.testing.assert_allclose(a, b, atol=SLICE_TOL, rtol=SLICE_TOL)
    assert got["n"] == want["n"] == sum(len(s["spans"]) for s in samples)
    for key in ("cIoU", "mIoU"):
        assert abs(got[key] - want[key]) <= SLICE_TOL, (key, got, want)


# --- entry points ---------------------------------------------------------

def test_bench_build_at_tiny_hybrid_matches_bench_py(monkeypatch):
    """``bench.build`` against root bench.py at BENCH_PRESET=tiny_hybrid, as
    tests/test_torch_bench.py holds the other tiny presets: the batch bit
    for bit, the port's forward on the JAX script's weights within 1e-3;
    the port's own weights have the JAX tree's leaves and a live HD
    branch."""
    for key in ("BENCH_FAMILY", "BENCH_GLOBAL_BLOCK", "BENCH_GLOBAL_KERNEL",
                "BENCH_QUANT_LLM"):
        monkeypatch.delenv(key, raising=False)
    monkeypatch.setenv("BENCH_PRESET", "tiny_hybrid")
    monkeypatch.setenv("BENCH_SAM_SIZE", "128")
    monkeypatch.setenv("BENCH_SEQ", "112")
    _, jparams, jbatch = jbench.build(2)
    knobs = bench.Knobs.from_env()
    model, cfg, params, batch = bench.build(2, knobs, "cpu")
    _equal_batches(_numpy(batch), jax.device_get(jbatch))
    jparams = jax.device_get(jparams)
    assert {jax.tree_util.keystr(p): a.shape for p, a in
            jax.tree_util.tree_leaves_with_path(jparams)} == {
        jax.tree_util.keystr(p): tuple(a.shape) for p, a in
        jax.tree_util.tree_leaves_with_path(_numpy(params))}
    assert float(params["frozen"]["vision_high"]["hd_alpha"]) == 0.5
    jcfg = jregistry.get_config("deepseek_vl", "tiny_hybrid")
    _assert_same_fields(jcfg, cfg)
    want = jax.device_get(jax.jit(
        lambda p, b: jgrounding.forward(p, jcfg, b))(jparams, jbatch))
    with torch.no_grad():
        got = model.forward(from_jax(jparams), cfg, batch)
    for key in ("coarse_logits", "sam_logits", "iou_pred", "hidden"):
        np.testing.assert_allclose(got[key].numpy(), np.asarray(want[key]),
                                   atol=SLICE_TOL, rtol=SLICE_TOL,
                                   err_msg=key)


def test_trainer_runs_tiny_hybrid_on_cpu(tmp_path):
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    env["CUDA_VISIBLE_DEVICES"] = ""
    proc = subprocess.run(
        [sys.executable, "-m", "flmm_tpu_torch.train", "--preset",
         "tiny_hybrid", "--synthetic", "--steps", "2", "--batch-size", "2",
         "--work-dir", str(tmp_path / "wd"), "--log-interval", "1",
         "--device", "cpu"],
        cwd=REPO, env=env, capture_output=True, text=True, timeout=300)
    assert proc.returncode == 0, proc.stderr
    lines = [ln for ln in proc.stdout.splitlines() if ln.startswith("{")]
    assert len(lines) == 2 and "saved step_2" in proc.stdout


@pytest.mark.parametrize("img_start", [5, 128])
def test_7b_config_is_the_jax_packages(img_start):
    """Field by field, without building weights; the kernel gates follow
    the image block and the SAM-B trunk stays on its plain path."""
    want = jconfigs.deepseek_vl_7b(img_start=img_start)
    got = registry.get_config("deepseek_vl", "7b", img_start=img_start)
    _assert_same_fields(want, got)
    assert got.llm.use_flash_capture == (img_start == 128)
    assert got.dtype == got.hybrid_high.dtype == torch.bfloat16
    assert got.hybrid_high.encoder.dtype == torch.bfloat16
    trunk = got.hybrid_high.encoder
    assert not (trunk.flash_global or trunk.flash_window
                or trunk.window_block_fused or trunk.global_block_fused)
    assert (got.hybrid_high.out_channels, got.unet.in_channels,
            got.input_size) == (1024, 960, 384)
    plain = registry.plain_config(got)
    assert plain.hybrid_high == got.hybrid_high
    assert not plain.llm.use_flash_capture


class _Tokenizer:
    """DeepSeek-VL's image token as one id, every other word its own."""

    def encode(self, text, add_special_tokens=False):
        text = text.replace("<image_placeholder>", " <image_placeholder> ")
        ids = [100000] if add_special_tokens else []
        return ids + [100015 if w == "<image_placeholder>"
                      else 1000 + sum(map(ord, w)) % 90000
                      for w in text.split()]


@pytest.mark.parametrize("preset", ["7b", "tiny_hybrid"])
def test_resolve_family_setup_passes_hires_size(preset):
    """The port's repair of the JAX registry, which leaves hires_size out of
    the batch spec (flmm_tpu/registry.py:181-187)."""
    cfg, rp, kw = registry.resolve_family_setup("deepseek_vl", preset,
                                                _Tokenizer())
    jcfg, jrp, jkw = jregistry.resolve_family_setup("deepseek_vl", preset,
                                                    _Tokenizer())
    _assert_same_fields(jcfg, cfg)
    assert cfg.img_start == rp.img_start == jrp.img_start
    assert set(kw) == set(jkw) | {"hires_size"}
    assert kw["hires_size"] == cfg.hybrid_high.encoder.img_size
    assert "hires_size" not in jkw


# --- refusals --------------------------------------------------------------

def test_make_grounder_refuses_a_hybrid_config(hybrid):
    _, cfg, jparams, _ = hybrid
    with pytest.raises(NotImplementedError,
                       match="flmm_tpu/generation/api.py:186-192"):
        generation.make_grounder("deepseek_vl", cfg, from_jax(jparams),
                                 _Tokenizer(), device="cpu")
    with pytest.raises(NotImplementedError, match="hybrid Grounder"):
        generation.Grounder(cfg=cfg, params=from_jax(jparams),
                            tokenizer=_Tokenizer(),
                            prompt_template=tok.TEMPLATES["deepseek"],
                            device="cpu")


def test_loader_refuses_a_hybrid_config(tmp_path):
    cfg = registry.get_config("deepseek_vl", "7b")
    for loader in (load.deepseek_vl_frozen,
                   registry.get_loader("deepseek_vl")):
        with pytest.raises(NotImplementedError,
                           match="neither the SAM-B high-resolution tower "
                                 r"\(vision_high\) nor the split projector"):
            loader(str(tmp_path / "no_checkpoint"), cfg)


@pytest.mark.parametrize("cli", [eval_refcoco, eval_png])
def test_eval_clis_refuse_a_hybrid_preset(cli, tmp_path):
    """Refused at the loader, before any file is read: the checkpoint
    directory does not exist."""
    with pytest.raises(NotImplementedError, match="DeepSeek-VL-7B"):
        cli.main(["--family", "deepseek_vl", "--preset", "7b",
                  "--checkpoint", str(tmp_path / "no_checkpoint"),
                  "--data-root", str(tmp_path), "--device", "cpu"],
                 tokenizer=_Tokenizer())
