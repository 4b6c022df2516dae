"""The port's eval CLIs (``python -m flmm_tpu_torch.eval_refcoco`` and
``eval_png``) and ``registry.resolve_family_setup`` against the JAX
package's on the CPU.

``resolve_family_setup``: for every family and preset the port has, with
the fixture tokenizer, the config (field by field, dtypes by name), the
rendered prompt and the batch-spec kwargs equal the JAX function's.

The CLIs run end to end at the ``tiny`` preset with ``--device cpu --debug``
on the on-disk world of tests/cli_fixtures.py (tokenizer, DeepSeek-VL
checkpoint, SAM ``.pth``, RefCOCO and PNG roots) and one released-layout
``--trained`` ``.pth`` (tests/checkpoint_writers.py), so that both packages
hold the same weights.  The JAX side is the JAX scripts' flow run in
process through the JAX modules (every leaf comes from a checkpoint, so its
random init is skipped).  Per split: the same number of scored masks; every
batch the port's CLI builds equals the JAX builder's bit for bit; its SAM
low-res logits agree with the JAX forward's on that batch within 1e-3 (the
tiny forward's tolerance, tests/test_torch_slice.py); and the JAX scorer
fed the port's logits gives exactly the port's scores.
"""

import dataclasses
import json

import transformers  # noqa: F401  (before any test stubs torchvision)
from transformers import AutoTokenizer

import numpy as np
import jax
import jax.numpy as jnp
import pytest
import torch
from PIL import Image

from flmm_tpu import registry as jregistry
from flmm_tpu.convert import load as jload
from flmm_tpu.data.collate import BatchSpec as JBatchSpec
from flmm_tpu.data.png import PNGDataset as JPNGDataset
from flmm_tpu.data.refcoco import RefCocoDataset as JRefCocoDataset
from flmm_tpu.data.refcoco import refcoco_to_sample as jrefcoco_to_sample
from flmm_tpu.evalsuite import metrics as jmetrics
from flmm_tpu.evalsuite import runner as jrunner
from flmm_tpu_torch import eval_png, eval_refcoco, registry
from flmm_tpu_torch.configs import deepseek_vl as tds
from flmm_tpu_torch.convert import load
from flmm_tpu_torch.convert.from_jax import from_jax
from flmm_tpu_torch.evalsuite import cli
from flmm_tpu_torch.models.frozen import grounding
from flmm_tpu_torch.train.loop import tree_leaves
from tests import checkpoint_writers as cw
from tests import cli_fixtures as fx

LOGIT_TOL = 1e-3
BS, SEQ, MASKS = 2, 96, 4
# the port's processors name the resample filter; the JAX ones hold PIL's
PIL_FILTERS = {"bicubic": Image.BICUBIC, "bilinear": Image.BILINEAR}


def _norm(x):
    """Configs and spec kwargs as plain values; dtypes by name."""
    if dataclasses.is_dataclass(x):
        return {f.name: _norm(getattr(x, f.name))
                for f in dataclasses.fields(x)}
    if isinstance(x, dict):
        return {k: _norm(v) for k, v in x.items()}
    if isinstance(x, (list, tuple)):
        return [_norm(v) for v in x]
    if isinstance(x, torch.dtype):
        return str(x).removeprefix("torch.")
    if isinstance(x, type) or type(x).__module__.startswith(("jax", "numpy",
                                                              "ml_dtypes")):
        return np.dtype(x).name
    return x


def _subset(got, want, where=""):
    """Every field of the port's value equals the JAX one's (the JAX configs
    carry options the port refuses, e.g. the hybrid tower)."""
    if isinstance(got, dict):
        for k, v in got.items():
            assert k in want, f"{where}/{k}"
            _subset(v, want[k], f"{where}/{k}")
    elif where.endswith("/resample"):
        assert PIL_FILTERS[got] == want, where
    else:
        assert got == want, (where, got, want)


@pytest.fixture(scope="module")
def world(tmp_path_factory):
    from flmm_tpu.configs.deepseek_vl import tiny

    root = tmp_path_factory.mktemp("eval_cli")
    jcfg = tiny()
    tokenizer_dir = fx.make_tokenizer(root / "tok")
    w = {"tokenizer": AutoTokenizer.from_pretrained(str(tokenizer_dir)),
         "tokenizer_dir": str(tokenizer_dir),
         "checkpoint": str(fx.make_deepseek_checkpoint(root / "ckpt", jcfg)),
         "sam": str(fx.make_sam_checkpoint(root / "sam.pth",
                                           jcfg.sam.encoder)),
         "refcoco": str(fx.make_refcoco_root(root / "coco")),
         "png": str(fx.make_png_root(root / "png")),
         "trained": str(root / "trained.pth")}
    g = torch.Generator().manual_seed(3)
    tra = grounding.init_params(tds.tiny(), g, "cpu")["trainable"]
    for leaf in (tra["text_layer_weights"], tra["text_proj"]["b"]):
        leaf.copy_(torch.randn(leaf.shape, generator=g) * 0.5)
    torch.save({"state_dict": cw.released_trained_state_dict(tra)},
               w["trained"])
    return w


PRESETS = [(f, p) for f, (_, presets) in registry.FAMILIES.items()
           for p in presets]


@pytest.mark.parametrize("family, preset", PRESETS)
def test_resolve_family_setup_matches_jax(world, family, preset):
    t = world["tokenizer"]
    for sam_size in (None, 448):
        got = registry.resolve_family_setup(family, preset, t,
                                            sam_size=sam_size)
        want = jregistry.resolve_family_setup(family, preset, t,
                                              sam_size=sam_size)
        _subset(_norm(got[0]), _norm(want[0]), f"{family}/{preset}")
        assert dataclasses.asdict(got[1]) == dataclasses.asdict(want[1])
        # the port passes a hybrid tower's hires_size, which the JAX
        # registry leaves out (flmm_tpu/registry.py:181-187)
        hires = ({"hires_size": 64 if preset == "tiny_hybrid" else 1024}
                 if getattr(got[0], "hybrid_high", None) is not None else {})
        assert {k: got[2][k] for k in hires} == hires
        _subset(_norm({k: v for k, v in got[2].items() if k not in hires}),
                _norm(want[2]))
        assert set(got[2]) == set(want[2]) | set(hires)
    base = got[0].base if hasattr(got[0], "base") else got[0]
    if base.llm.use_flash_capture:
        assert base.img_start % 128 == 0
    else:
        assert base.img_start == got[1].img_start


def _cli_args(world, root, extra=()):
    return ["--family", "deepseek_vl", "--preset", "tiny",
            "--checkpoint", world["checkpoint"],
            "--sam-checkpoint", world["sam"], "--trained", world["trained"],
            "--tokenizer", world["tokenizer_dir"], "--data-root", root,
            "--batch-size", str(BS), "--seq-len", str(SEQ),
            "--max-masks", str(MASKS), "--debug", "--device", "cpu",
            *extra]


@pytest.fixture
def recorded(monkeypatch):
    """Every batch the port's CLI forwards and the logits it got."""
    seen = []
    make = cli.make_predict

    def recording(model, params, cfg, device):
        predict = make(model, params, cfg, device)

        def run(batch):
            out = predict(batch)
            seen.append((batch, out.numpy().copy()))
            return out

        return run

    monkeypatch.setattr(cli, "make_predict", recording)
    return seen


def _jax_setup(world, family, checkpoint, build_kwargs=(), seq=SEQ,
               trained=None, **loader_kwargs):
    """The JAX scripts' model setup at ``family``'s tiny preset: config,
    prompt and spec from the tokenizer, the frozen tree from ``checkpoint``
    and the world's SAM ``.pth``, the released trained ``.pth`` (the
    world's unless ``trained``), and the family's builder given
    ``build_kwargs``."""
    t = world["tokenizer"]
    cfg, rp, spec_kwargs = jregistry.resolve_family_setup(family, "tiny", t)
    params = {
        "frozen": jax.tree.map(jnp.asarray, jregistry.get_loader(family)(
            checkpoint, cfg, world["sam"], **loader_kwargs)),
        "trainable": jax.tree.map(jnp.asarray, jload.reference_trained(
            trained or world["trained"], cfg))}
    model = jregistry.get_model(family)
    forward = jax.jit(lambda b: model.forward(params, cfg, b)["sam_logits"])
    spec = JBatchSpec(seq_len=seq, max_masks=MASKS,
                      coarse_hw=jregistry.get_coarse_hw(cfg), **spec_kwargs)
    return {"rp": rp, "forward": forward, "spec": spec,
            "build": jregistry.get_batch_builder(family,
                                                 **dict(build_kwargs))}


@pytest.fixture(scope="module")
def jax_model(world):
    return _jax_setup(world, "deepseek_vl", world["checkpoint"])


def _check_batches(seen, jax_model, n_samples):
    """The port's batches against the JAX builder's (bit for bit) and its
    logits against the JAX forward's; returns the port's logits in order."""
    assert len(seen) == -(-n_samples // BS)
    for batch, logits in seen:
        want = jax.device_get(jax_model["forward"](
            jax.tree.map(jnp.asarray, batch)))
        assert logits.shape == want.shape
        np.testing.assert_allclose(logits, want, rtol=0, atol=LOGIT_TOL)
    return [logits for _, logits in seen]


def _replay(jax_model, samples, acc, score, logits):
    """The JAX runner fed the port's logits, batch by batch; it checks that
    its own batches equal the port's."""
    it = iter(logits)
    got_batches = []

    def predict(batch):
        got_batches.append(batch)
        return next(it)

    res = jrunner.run_eval(samples, predict, jax_model["spec"], BS, acc,
                           score, batch_builder=jax_model["build"]).results()
    assert next(it, None) is None
    return res, got_batches


def _assert_batches_equal(got, want):
    assert len(got) == len(want)
    for a, b in zip(got, want):
        assert set(a) == set(b)
        for k in b:
            if isinstance(b[k], dict):
                for kk in b[k]:
                    np.testing.assert_array_equal(a[k][kk], b[k][kk])
            else:
                np.testing.assert_array_equal(a[k], b[k], err_msg=k)


def test_eval_refcoco_cli_matches_jax(world, jax_model, recorded, capsys):
    results = eval_refcoco.main(_cli_args(world, world["refcoco"]),
                                tokenizer=world["tokenizer"])
    lines = capsys.readouterr().out.splitlines()
    per_split = [json.loads(line) for line in lines[:8]]
    assert [next(iter(d)) for d in per_split] == [
        f"{n}/{s}" for n, _, s in eval_refcoco.SPLITS]
    assert json.loads("\n".join(lines[8:])) == results
    t, root = world["tokenizer"], world["refcoco"]
    start = 0
    for name, split_file, split in eval_refcoco.SPLITS:
        ds = JRefCocoDataset(
            ann_file=f"{root}/{name}/instances.json",
            split_file=f"{root}/{name}/{split_file}",
            image_path=f"{root}/train2014", split=split)
        samples = [s for i in range(min(len(ds), 100)) for s in
                   jrefcoco_to_sample(ds[i], t, jax_model["rp"],
                                      concat=False)]
        n_batches = -(-len(samples) // BS)
        seen = recorded[start:start + n_batches]
        start += n_batches
        logits = _check_batches(seen, jax_model, len(samples))
        want, jbatches = _replay(jax_model, samples,
                                 jmetrics.RefSegAccumulator,
                                 jrunner.refcoco_score, logits)
        _assert_batches_equal([b for b, _ in seen], jbatches)
        got = results[f"{name}/{split}"]
        assert got["n"] == want["n"] == sum(len(s["masks"])
                                            for s in samples)
        assert got == want, (name, split)
    assert start == len(recorded)


def test_eval_png_cli_matches_jax(world, jax_model, recorded):
    results = eval_png.main(_cli_args(world, world["png"]),
                            tokenizer=world["tokenizer"])
    root = world["png"]
    ds = JPNGDataset(
        json_file=f"{root}/annotations/png_coco_val2017.json",
        panoptic_json_file=f"{root}/annotations/panoptic_val2017.json",
        panoptic_png_path=f"{root}/annotations/panoptic_val2017",
        image_path=f"{root}/val2017", tokenizer=world["tokenizer"],
        prompt_spec=jax_model["rp"])
    samples = [ds[i] for i in range(min(len(ds), 100))]
    logits = _check_batches(recorded, jax_model, len(samples))
    want, jbatches = _replay(jax_model, samples, jmetrics.PNGAccumulator,
                             jrunner.png_score, logits)
    _assert_batches_equal([b for b, _ in recorded], jbatches)
    assert results["n"] == want["n"] == sum(len(s["masks"]) for s in samples)
    assert results == want
    assert {"AA", "aAcc@0.5"} <= set(results)


def test_cli_refusals(world, capsys):
    """``--sharded-eval`` runs (in a group of one on the CPU, gloo) and
    gives the host path's results; MGM's tower flags (the mgm family runs
    since: test_eval_clis_at_mgm_match_jax) are an argument error for any
    other family."""
    base = _cli_args(world, world["png"])
    host = eval_png.main(base, tokenizer=world["tokenizer"])
    sharded = eval_png.main(base + ["--sharded-eval"],
                            tokenizer=world["tokenizer"])
    assert sharded == host and host["n"] > 0
    assert not torch.distributed.is_initialized()
    for flags in (["--clip-checkpoint", "clip.bin"],
                  ["--aux-checkpoint", "convnext.bin"]):
        with pytest.raises(SystemExit):
            eval_refcoco.main(base + flags, tokenizer=world["tokenizer"])
        assert "load MGM's towers" in capsys.readouterr().err
    no_tok = [a for a in base if a not in ("--tokenizer",
                                           world["tokenizer_dir"])]
    with pytest.raises(SystemExit):
        eval_png.main(no_tok)



@pytest.fixture(scope="module")
def jax_int8_model(world):
    """The JAX scripts' setup with ``--int8-sam``: ``quantize_frozen_sam``
    of the loaded tree (scripts/eval_refcoco.py:112-114)."""
    from flmm_tpu.models.frozen.grounding import quantize_frozen_sam

    m = _jax_setup(world, "deepseek_vl", world["checkpoint"])
    t = world["tokenizer"]
    cfg, _, _ = jregistry.resolve_family_setup("deepseek_vl", "tiny", t)
    params = {
        "frozen": jax.tree.map(jnp.asarray, jregistry.get_loader(
            "deepseek_vl")(world["checkpoint"], cfg, world["sam"])),
        "trainable": jax.tree.map(jnp.asarray, jload.reference_trained(
            world["trained"], cfg))}
    params = quantize_frozen_sam(params)
    model = jregistry.get_model("deepseek_vl")
    m["forward"] = jax.jit(
        lambda b: model.forward(params, cfg, b)["sam_logits"])
    return m


@pytest.mark.parametrize("cli_main, root", [(eval_refcoco.main, "refcoco"),
                                            (eval_png.main, "png")],
                         ids=["eval_refcoco", "eval_png"])
def test_int8_sam_clis_match_jax(world, jax_int8_model, recorded, cli_main,
                                 root):
    """``--int8-sam``: the port's CLI forwards an int8 SAM encoder, and
    its logits stay within 1e-3 of the JAX script's chain on the same
    batches."""
    cli_main(_cli_args(world, world[root], ["--int8-sam"]),
             tokenizer=world["tokenizer"])
    assert recorded
    for batch, logits in recorded:
        want = jax.device_get(jax_int8_model["forward"](
            jax.tree.map(jnp.asarray, batch)))
        np.testing.assert_allclose(logits, want, rtol=0, atol=LOGIT_TOL)


def test_int8_sam_setup_quantises_the_encoder_only(world):
    args = cli.parse(cli.parser("t", 4), _cli_args(world, world["png"],
                                                   ["--int8-sam"]),
                     world["tokenizer"])
    params = cli.setup(args, world["tokenizer"])["params"]
    blocks = params["frozen"]["sam_encoder"]["blocks"]
    assert all("wqkv_q" in bp and "w1_q" in bp["mlp"] for bp in blocks)
    assert all(bp["wqkv_q"].dtype == torch.int8 for bp in blocks)
    assert "wq" in params["frozen"]["llm"]["layers"]


def test_trained_orbax_dir_matches_the_jax_script(world, jax_model, recorded,
                                                 tmp_path):
    """``--trained <an Orbax directory>``: the JAX trainer's state of the
    world's trained tree, written by ``flmm_tpu.train.checkpoint.save``;
    the port's CLI reads it without orbax and its logits stay within 1e-3
    of the JAX script's chain."""
    from flmm_tpu.train import checkpoint as jckpt
    from flmm_tpu.train import loop as jloop

    t = world["tokenizer"]
    cfg, _, _ = jregistry.resolve_family_setup("deepseek_vl", "tiny", t)
    tra = jax.tree.map(jnp.asarray, jload.reference_trained(
        world["trained"], cfg))
    state = jloop.init_state(tra, jloop.make_optimizer(jloop.OptimConfig()))
    jckpt.save(tmp_path / "step_2", state)
    args = _cli_args(world, world["png"])
    args[args.index("--trained") + 1] = str(tmp_path / "step_2")
    eval_png.main(args, tokenizer=t)
    assert recorded
    for batch, logits in recorded:
        want = jax.device_get(jax_model["forward"](
            jax.tree.map(jnp.asarray, batch)))
        np.testing.assert_allclose(logits, want, rtol=0, atol=LOGIT_TOL)


def test_setup_draws_only_what_the_checkpoints_lack(world):
    """The frozen tree is the loader's, and only what no checkpoint holds
    is drawn: without ``--sam-checkpoint`` the SAM encoder, as
    ``init_frozen`` draws it alone from seed 0.  The trainable tree is
    ``--trained``'s, or else ``init_trainable``'s drawn after it."""
    t = world["tokenizer"]
    with_all = _cli_args(world, world["png"])
    bare = [a for a in with_all if a not in (
        "--sam-checkpoint", world["sam"], "--trained", world["trained"])]
    for argv in (with_all, bare):
        args = cli.parse(cli.parser("", 8), argv, t)
        params = cli.setup(args, t)["params"]
        cfg = tds.tiny()
        loaded = registry.get_loader("deepseek_vl")(
            world["checkpoint"], cfg, args.sam_checkpoint)
        assert ("sam_encoder" in loaded) == (argv is with_all)
        g = torch.Generator().manual_seed(0)
        frozen = {**loaded,
                  **grounding.init_frozen(cfg, g, "cpu", skip=loaded)}
        trainable = (load.reference_trained(args.trained, cfg)
                     if args.trained else
                     grounding.init_trainable(cfg, g, "cpu"))
        for got, want in ((params["frozen"], frozen),
                          (params["trainable"], trainable)):
            got, want = dict(tree_leaves(got)), dict(tree_leaves(want))
            assert got.keys() == want.keys()
            for k, v in want.items():
                assert got[k].dtype == v.dtype and torch.equal(got[k], v), k


# --- the mgm family ----------------------------------------------------------

@pytest.fixture(scope="module")
def mgm_world(world, tmp_path_factory):
    """MGM's three checkpoints at ``tiny_mgm`` (random frozen tree from the
    port's seeded init) beside the world's SAM ``.pth`` and trained heads,
    which fit the single-crop tiny preset (U-Net in_channels 3 x 4)."""
    from tests import test_torch_mgm

    cfg, _, _ = registry.resolve_family_setup("mgm", "tiny",
                                              world["tokenizer"])
    fro = from_jax(test_torch_mgm.seeded_params(cfg, 5)["frozen"])
    fro.pop("sam_encoder")
    paths = cw.mgm_checkpoints(tmp_path_factory.mktemp("mgm_cli"), fro)
    return {k: str(v) for k, v in paths.items()}


def _mgm_args(world, mgm_world, root):
    args = _cli_args(world, root, ["--clip-checkpoint", mgm_world["clip"],
                                   "--aux-checkpoint", mgm_world["aux"]])
    args[1], args[3] = "mgm", "tiny"
    args[5] = mgm_world["checkpoint"]
    return args


@pytest.fixture(scope="module")
def mgm_jax_model(world, mgm_world):
    """The JAX scripts' MGM setup (flmm_tpu/registry.get_loader('mgm') with
    the CLIP and ConvNeXt checkpoints), its batch builder bound to the
    config's crop grid and sizes as the port's CLI binds it."""
    spec = registry.get_config("mgm", "tiny").process_spec()
    return _jax_setup(world, "mgm", mgm_world["checkpoint"],
                      dataclasses.asdict(spec),
                      clip_checkpoint=mgm_world["clip"],
                      aux_checkpoint=mgm_world["aux"])


def _check_clis(world, args, jmodel, recorded):
    """``eval_png``, then ``eval_refcoco``'s first split, with the CLI
    arguments ``args(data_root)`` against the JAX setup ``jmodel``: every
    batch bit for bit, the logits within 1e-3, the scores from the same
    logits exactly.  Returns the first batch ``eval_png`` built."""
    t, root = world["tokenizer"], world["png"]
    results = eval_png.main(args(root), tokenizer=t)
    ds = JPNGDataset(
        json_file=f"{root}/annotations/png_coco_val2017.json",
        panoptic_json_file=f"{root}/annotations/panoptic_val2017.json",
        panoptic_png_path=f"{root}/annotations/panoptic_val2017",
        image_path=f"{root}/val2017", tokenizer=t,
        prompt_spec=jmodel["rp"])
    samples = [ds[i] for i in range(min(len(ds), 100))]
    logits = _check_batches(recorded, jmodel, len(samples))
    want, jbatches = _replay(jmodel, samples, jmetrics.PNGAccumulator,
                             jrunner.png_score, logits)
    _assert_batches_equal([b for b, _ in recorded], jbatches)
    assert results == want and results["n"] > 0
    first = recorded[0][0]

    recorded.clear()
    root = world["refcoco"]
    results = eval_refcoco.main(args(root), tokenizer=t)
    name, split_file, split = eval_refcoco.SPLITS[0]
    ds = JRefCocoDataset(ann_file=f"{root}/{name}/instances.json",
                         split_file=f"{root}/{name}/{split_file}",
                         image_path=f"{root}/train2014", split=split)
    samples = [s for i in range(min(len(ds), 100)) for s in
               jrefcoco_to_sample(ds[i], t, jmodel["rp"], concat=False)]
    seen = recorded[:-(-len(samples) // BS)]
    logits = _check_batches(seen, jmodel, len(samples))
    want, jbatches = _replay(jmodel, samples, jmetrics.RefSegAccumulator,
                             jrunner.refcoco_score, logits)
    _assert_batches_equal([b for b, _ in seen], jbatches)
    assert results[f"{name}/{split}"] == want
    assert len(results) == len(eval_refcoco.SPLITS)
    return first


def test_eval_clis_at_mgm_match_jax(world, mgm_world, mgm_jax_model,
                                    recorded):
    """``eval_png`` and ``eval_refcoco`` at ``--family mgm --preset tiny``
    with ``--clip-checkpoint`` / ``--aux-checkpoint``: the MGM batches
    (crops, aux pixels) bit for bit, the logits within 1e-3, the scores
    from the same logits exactly."""
    first = _check_clis(world, lambda root: _mgm_args(world, mgm_world, root),
                        mgm_jax_model, recorded)
    assert first["pixel_values"].shape[1:] == (1, 32, 32, 3)
    assert "aux_pixel_values" in first


# --- the llava_next family ---------------------------------------------------

LLAVA_NEXT_SEQ = 192  # the tiny prompt holds 130 tokens, 88 of the image


@pytest.fixture(scope="module")
def llava_next_world(world, tmp_path_factory):
    """A llava-hf LLaVA-NeXT checkpoint at ``tiny_llava_next`` (the port's
    init from seed 6, ``image_newline`` too) beside the world's SAM
    ``.pth`` (the same tiny SAM), and released-layout trained heads of its
    own (its U-Net reads twice the world's maps)."""
    from flmm_tpu_torch.models.frozen import llava_next as tmln

    cfg, _, _ = registry.resolve_family_setup("llava_next", "tiny",
                                              world["tokenizer"])
    g = torch.Generator().manual_seed(6)
    params = tmln.init_params(cfg, g, "cpu")
    root = tmp_path_factory.mktemp("llava_next_cli")
    torch.save(cw.llava_state_dict(params["frozen"]),
               root / "pytorch_model.bin")
    tra = params["trainable"]
    for leaf in (tra["text_layer_weights"], tra["text_proj"]["b"]):
        leaf.copy_(torch.randn(leaf.shape, generator=g) * 0.5)
    torch.save({"state_dict": cw.released_trained_state_dict(tra)},
               root / "trained.pth")
    return {"checkpoint": str(root), "trained": str(root / "trained.pth")}


def _llava_next_args(world, llava_next_world, root):
    args = _cli_args(world, root)
    args[1], args[5] = "llava_next", llava_next_world["checkpoint"]
    args[args.index("--trained") + 1] = llava_next_world["trained"]
    args[args.index("--seq-len") + 1] = str(LLAVA_NEXT_SEQ)
    return args


def test_eval_clis_at_llava_next_match_jax(world, llava_next_world,
                                           recorded):
    """``eval_png`` and ``eval_refcoco`` at ``--family llava_next --preset
    tiny``: the anyres batches (tiles, their validity, the image block)
    bit for bit against the JAX builder given the config's tiles and
    pinpoints (the JAX scripts bind its defaults, the released 336-px
    tiles), the logits within 1e-3, the scores exactly."""
    spec = registry.get_config("llava_next", "tiny").anyres_spec()
    jmodel = _jax_setup(world, "llava_next", llava_next_world["checkpoint"],
                        dataclasses.asdict(spec), seq=LLAVA_NEXT_SEQ,
                        trained=llava_next_world["trained"])
    first = _check_clis(
        world, lambda root: _llava_next_args(world, llava_next_world, root),
        jmodel, recorded)
    assert first["tiles"].shape[2:] == (32, 32, 3)
    assert first["tile_valid"].sum() > len(first["tile_valid"])
