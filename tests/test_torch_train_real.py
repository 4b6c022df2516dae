"""The port's trainer (``python -m flmm_tpu_torch.train``) against
scripts/train.py on the CPU, over a train layout assembled from the
committed fixtures (tests/train_fixtures.py) with the WordLevel tokenizer
and the tiny checkpoints of tests/cli_fixtures.py.

Covered: the mgm / llava_next synthetic streams against the JAX script's
``synthetic_stream`` batch for batch; the PNG + RefCOCO/+/g joint stream at
``deepseek_vl --preset tiny`` against its ``real_stream`` over more than
an epoch, where no image has more expressions than ``--max-masks`` (the
JAX script draws the subsample unseeded); the port's seeded draw; resume
on the real stream (2 + 2 steps give the 4-step state bit for bit);
``--checkpoint`` / ``--sam-checkpoint`` in the trained tree with ``--epochs``,
``--profile`` and ``--tokenizer``; the builder bindings of the MGM-HD and
LLaVA-NeXT configs; the trainer at ``tiny`` for the other families; the
flags it refuses; and the prefetch loader's batch offset and shutdown.  Batches are equal bit for bit: the port's resample
is PIL's arithmetic.

The torch work runs on one thread: the toy steps are launch-bound, and
contended CPUs run them an order of magnitude slower on eight.
"""

import transformers  # noqa: F401  (before any test stubs torchvision)
from transformers import AutoTokenizer

import argparse
import importlib.util
import json
import math
import pathlib
import shutil
import socket
import sys
import threading

import numpy as np
import pytest
import torch

from flmm_tpu import registry as jregistry
from flmm_tpu.data import mgm as jmgm
from flmm_tpu_torch import registry
from flmm_tpu_torch.configs import deepseek_vl as tds
from flmm_tpu_torch.configs import mgm as mgm_configs
from flmm_tpu_torch.convert import load
from flmm_tpu_torch.data.loader import EpochSampler, PrefetchLoader
from flmm_tpu_torch.models.frozen import grounding
from flmm_tpu_torch.train import __main__ as trainer
from flmm_tpu_torch.train import checkpoint as ckpt
from flmm_tpu_torch.train import loop, streams
from tests import checkpoint_writers as cw
from tests import cli_fixtures as fx
from tests.train_fixtures import JOINT_SAMPLES, MOST_EXPRESSIONS, \
    PNG_SAMPLES, joint_samples, make_train_root

REPO = pathlib.Path(__file__).resolve().parent.parent
BS, SEQ = 2, 256


@pytest.fixture(scope="module", autouse=True)
def one_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture(scope="module")
def jax_script():
    """scripts/train.py as a module."""
    spec = importlib.util.spec_from_file_location(
        "jax_train_script", REPO / "scripts" / "train.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


@pytest.fixture(scope="module")
def world(tmp_path_factory):
    from flmm_tpu.configs.deepseek_vl import tiny

    root = tmp_path_factory.mktemp("train_real")
    jcfg = tiny()
    tok = fx.make_tokenizer(root / "tok")
    # the official SAM layout whole: cli_fixtures' encoder, and a prompt
    # encoder and mask decoder from seed 7 (the trainer's init is seed 0)
    sam = fx.make_sam_checkpoint(root / "sam.pth", jcfg.sam.encoder)
    heads = grounding.init_trainable(
        tds.tiny(), torch.Generator().manual_seed(7), "cpu")["sam"]
    sd = torch.load(sam, weights_only=True)
    sd.update(cw.prompt_encoder_state_dict(heads["prompt"]))
    sd.update(cw.mask_decoder_state_dict(heads["decoder"]))
    torch.save(sd, sam)
    return {"root": root, "tokenizer_dir": str(tok),
            "tokenizer": AutoTokenizer.from_pretrained(str(tok)),
            "data": str(make_train_root(root / "coco")),
            "checkpoint": str(fx.make_deepseek_checkpoint(root / "ckpt",
                                                          jcfg)),
            "sam": str(sam)}


def _equal_batches(got: dict, want: dict) -> None:
    want = {k: v for k, v in want.items() if k != "infos"}
    assert set(got) == set(want)
    for key, w in want.items():
        if isinstance(w, dict):
            assert set(got[key]) == set(w)
            for k in w:
                np.testing.assert_array_equal(got[key][k], w[k], err_msg=k)
        else:
            assert got[key].dtype == w.dtype, key
            np.testing.assert_array_equal(got[key], w, err_msg=key)


def _real_args(world, *extra):
    return ["--family", "deepseek_vl", "--preset", "tiny", "--device", "cpu",
            "--data-root", world["data"], "--batch-size", str(BS),
            "--seq-len", str(SEQ), "--num-workers", "2", *extra]


@pytest.mark.parametrize("family", ["mgm", "llava_next"])
def test_synthetic_stream_matches_jax(jax_script, family):
    steps = 2
    args = argparse.Namespace(family=family, batch_size=BS,
                              synthetic_task="random")
    want = list(jax_script.synthetic_stream(
        args, jregistry.get_config(family, "tiny"), steps))
    got = list(streams.synthetic_stream(
        family, registry.get_config(family, "tiny"), "random", BS, 0,
        steps))
    assert len(got) == len(want) == steps
    for g, w in zip(got, want):
        _equal_batches(g, w)
    # a later start gives the same batches
    later = list(streams.synthetic_stream(
        family, registry.get_config(family, "tiny"), "random", BS, 1,
        steps))
    _equal_batches(later[0], got[1])


def _joint(world, max_masks: int) -> streams.JointStream:
    args = trainer.parse_args(_real_args(world, "--max-masks",
                                         str(max_masks)),
                              world["tokenizer"])
    run = trainer.setup(args, torch.device("cpu"), world["tokenizer"])
    return streams.JointStream(args.data_root, run["tokenizer"],
                               run["prompt"], run["build"], run["spec"],
                               BS, args.num_workers)


def test_repeated_layout_lists_the_narratives_again(world, tmp_path):
    """``make_train_root(png_repeat=4)``, the layout chip_smoke.py times
    steps in (9 batches of 8 an epoch): the PNG narratives 4 times over,
    each copy the same sample, and the referring sets as before."""
    plain = _joint(world, MOST_EXPRESSIONS)
    data = str(make_train_root(tmp_path / "coco", png_repeat=4))
    joint = _joint({**world, "data": data}, MOST_EXPRESSIONS)
    assert len(joint) == joint_samples(4) == 79 and joint_samples(4) // 8 == 9
    assert joint.datasets[0].data == plain.datasets[0].data * 4
    assert [len(d) for d in joint.datasets[1:]] == [
        len(d) for d in plain.datasets[1:]]
    for i in (0, 5):
        a, b = joint.sample(i, 0), joint.sample(i + 3 * PNG_SAMPLES, 0)
        for key in ("input_ids", "mask_ids", "image", "masks"):
            np.testing.assert_array_equal(a[key], b[key], err_msg=key)
    ref = joint.sample(4 * PNG_SAMPLES, 0)
    np.testing.assert_array_equal(
        ref["input_ids"], plain.sample(PNG_SAMPLES, 0)["input_ids"])


def test_real_stream_matches_jax(world, jax_script):
    """Over more than an epoch (15 batches of 2 an epoch), with
    ``--max-masks`` at the most expressions of an image."""
    joint = _joint(world, MOST_EXPRESSIONS)
    assert len(joint) == JOINT_SAMPLES
    steps = joint.batches_per_epoch + 2
    got = list(joint.batches(0, steps))
    args = argparse.Namespace(
        family="deepseek_vl", tokenizer=world["tokenizer_dir"],
        template=None, data_root=world["data"], seq_len=SEQ,
        max_masks=MOST_EXPRESSIONS, batch_size=BS, num_workers=2)
    cfg, prompt, spec_kwargs = jregistry.resolve_family_setup(
        "deepseek_vl", "tiny", world["tokenizer"])
    want = list(jax_script.real_stream(args, cfg, steps,
                                       rendered_prompt=prompt,
                                       spec_kwargs=spec_kwargs))
    assert len(got) == len(want) == steps
    for g, w in zip(got, want):
        _equal_batches(g, w)
    assert sum(b["mask_valid"].sum() for b in got) > 4 * steps
    # resumed inside the second epoch: the same batches, none rebuilt
    _equal_batches(next(joint.batches(steps - 1, steps)), got[-1])


def test_seeded_subsample(world):
    """An image with more expressions than ``--max-masks`` keeps that many,
    each one of its own, drawn the same way in every run."""
    joint = _joint(world, 3)
    png = len(joint.datasets[0])
    for gidx in range(png, len(joint)):
        a, b = joint.sample(gidx, epoch=0), joint.sample(gidx, epoch=0)
        np.testing.assert_array_equal(a["input_ids"], b["input_ids"])
        np.testing.assert_array_equal(a["masks"], b["masks"])
        assert len(a["masks"]) == 3
        di = int(np.searchsorted(joint.offsets, gidx, side="right")) - 1
        item = joint.datasets[di][gidx - int(joint.offsets[di])]
        assert len(item["masks"]) > 3
        for m in a["masks"]:
            assert any(np.array_equal(m, ref) for ref in item["masks"])
    c = [joint.sample(g, epoch=1)["input_ids"] for g in range(png, len(joint))]
    d = [joint.sample(g, epoch=0)["input_ids"] for g in range(png, len(joint))]
    assert any(not np.array_equal(x, y) for x, y in zip(c, d))


def _state(path: pathlib.Path) -> dict:
    return dict(loop.tree_leaves(torch.load(path / ckpt.STATE_FILE,
                                            weights_only=False)))


def test_resume_on_the_real_stream(world, tmp_path):
    """4 straight steps against 2 steps, then a resumed run to 4."""
    common = _real_args(world, "--steps", "4", "--save-steps", "2",
                        "--log-interval", "1")
    straight, resumed = tmp_path / "straight", tmp_path / "resumed"
    trainer.main([*common, "--work-dir", str(straight)],
                 tokenizer=world["tokenizer"])
    resumed.mkdir()
    shutil.copytree(straight / "step_2", resumed / "step_2")
    trainer.main([*common, "--work-dir", str(resumed), "--resume"],
                 tokenizer=world["tokenizer"])
    want, got = _state(straight / "step_4"), _state(resumed / "step_4")
    assert set(got) == set(want) and got["step"] == 4
    for k, w in want.items():
        if isinstance(w, torch.Tensor):
            assert torch.equal(got[k], w), k
        else:
            assert got[k] == w, k
    # and the resumed run did not replay batches 0 and 1
    mid = _state(straight / "step_2")
    assert not torch.equal(mid["params/text_proj/w"], want[
        "params/text_proj/w"])


def test_checkpoints_reach_the_trained_tree(world, tmp_path, monkeypatch,
                                            capsys):
    """``--checkpoint`` / ``--sam-checkpoint`` / ``--tokenizer`` on the
    real stream, steps from ``--epochs 1``: the frozen tree is the
    loader's (less ``lm_head``) and stays so, the trainable SAM starts from
    the checkpoint's prompt encoder and mask decoder, and ``--profile 1``
    writes a trace of step 3."""
    seen = {}
    make = loop.make_train_step

    def recording(loss_fn, opt):
        step = make(loss_fn, opt)

        def run(state, frozen, batch):
            seen.setdefault("sam", {p: t.detach().clone() for p, t in
                                    loop.tree_leaves(state["params"]["sam"])})
            seen["frozen"] = frozen
            return step(state, frozen, batch)
        return run

    monkeypatch.setattr(loop, "make_train_step", recording)
    bs = 8
    work = tmp_path / "wd"
    trainer.main(["--family", "deepseek_vl", "--preset", "tiny", "--device",
                  "cpu", "--data-root", world["data"], "--batch-size",
                  str(bs), "--seq-len", str(SEQ), "--epochs", "1",
                  "--checkpoint", world["checkpoint"], "--sam-checkpoint",
                  world["sam"], "--tokenizer", world["tokenizer_dir"],
                  "--profile", "1", "--log-interval", "1", "--work-dir",
                  str(work)])
    out = capsys.readouterr().out
    rows = [json.loads(x) for x in out.splitlines() if x.startswith("{")]
    assert [r["step"] for r in rows] == [1, 2, 3] == list(
        range(1, JOINT_SAMPLES // bs + 1))
    assert all(math.isfinite(r["loss"]) and r["data_wait_ms"] >= 0
               for r in rows)
    assert (work / "step_3" / ckpt.STATE_FILE).exists()
    trace = work / "trace" / "trace.json"
    assert "aten::" in trace.read_text()

    cfg = registry.resolve_family_setup("deepseek_vl", "tiny",
                                        world["tokenizer"])[0]
    loaded = registry.get_loader("deepseek_vl")(world["checkpoint"], cfg,
                                                world["sam"])
    loaded["llm"].pop("lm_head", None)
    got = dict(loop.tree_leaves(seen["frozen"]))
    want = dict(loop.tree_leaves(loaded))
    assert got.keys() == want.keys() and "sam_encoder/pos_embed" in want
    for k, w in want.items():
        assert got[k].dtype == w.dtype and torch.equal(got[k], w), k
        assert not got[k].requires_grad, k
    sam = dict(loop.tree_leaves(load.sam_trainable(world["sam"], cfg.sam)))
    assert seen["sam"].keys() == sam.keys()
    for k, w in sam.items():
        assert torch.equal(seen["sam"][k], w), k


def test_builders_bind_the_config_spec():
    """MGM-HD's 2 x 2 grid plus the global crop and LLaVA-NeXT's own tiles
    and pinpoints; the JAX script's ``real_stream`` takes the builders'
    defaults, one crop (ROADMAP queue 3)."""
    for cfg in (mgm_configs.tiny_mgm(hd=True),
                mgm_configs.mgm_vicuna_7b_hd()):
        spec = registry.get_batch_builder("mgm", cfg).keywords["mgm"]
        assert (spec.image_grid, spec.image_global) == (2, True)
        assert spec.image_grid ** 2 + spec.image_global == cfg.num_crops
    default = jmgm.MGMProcessSpec()
    assert default.image_grid ** 2 + default.image_global == 1
    cfg = mgm_configs.tiny_mgm(hd=True)
    batch = next(streams.synthetic_stream("mgm", cfg, "random", BS, 0, 1))
    assert batch["pixel_values"].shape[1] == cfg.num_crops == 5
    for preset, tile in (("vicuna_7b", 336), ("tiny", 32)):
        cfg = registry.get_config("llava_next", preset)
        anyres = registry.get_batch_builder("llava_next",
                                            cfg).keywords["anyres"]
        assert anyres == cfg.anyres_spec() and anyres.tile_size == tile


@pytest.mark.parametrize("family", ["llava_next", "mgm", "llava", "hpt"])
def test_trainer_runs_each_family_on_cpu(family, tmp_path, capsys):
    trainer.main(["--family", family, "--preset", "tiny", "--synthetic",
                  "--steps", "2", "--batch-size", "2", "--device", "cpu",
                  "--log-interval", "1", "--work-dir", str(tmp_path)])
    rows = [json.loads(x) for x in capsys.readouterr().out.splitlines()
            if x.startswith("{")]
    assert [r["step"] for r in rows] == [1, 2]
    assert all(math.isfinite(r["loss"]) for r in rows)
    assert (tmp_path / "step_2" / ckpt.STATE_FILE).exists()


@pytest.mark.parametrize("flags, words", [
    (["--synthetic", "--n-model", "2"], "a world of 1"),
    (["--synthetic", "--multihost"], "runs under torchrun"),
    (["--synthetic", "--clip-checkpoint", "c.bin"], "MGM's towers"),
    (["--synthetic", "--sam-checkpoint", "s.pth"], "with --checkpoint"),
    (["--synthetic", "--family", "mgm", "--synthetic-task", "grounding"],
     "grounding takes"),
    ([], "needs --tokenizer"),
])
def test_trainer_refusals(flags, words, capsys, monkeypatch):
    for key in ("RANK", "WORLD_SIZE", "LOCAL_RANK"):
        monkeypatch.delenv(key, raising=False)
    with pytest.raises(SystemExit):
        trainer.main(["--device", "cpu", *flags])
    assert words in capsys.readouterr().err


def _free_port() -> int:
    with socket.socket() as s:
        s.bind(("localhost", 0))
        return s.getsockname()[1]


def test_trainer_multihost_in_a_group_of_one(tmp_path, capsys, monkeypatch):
    """``--multihost`` under a one-rank torchrun environment (gloo on the
    CPU, a store on localhost) trains as the run without it: the logged
    losses and the checkpoint bit for bit."""
    argv = ["--preset", "tiny", "--synthetic", "--steps", "2",
            "--batch-size", "2", "--device", "cpu", "--log-interval", "1"]
    trainer.main(argv + ["--work-dir", str(tmp_path / "one")])
    want = capsys.readouterr().out
    for key, value in (("RANK", "0"), ("WORLD_SIZE", "1"),
                       ("LOCAL_RANK", "0"), ("MASTER_ADDR", "localhost"),
                       ("MASTER_PORT", str(_free_port()))):
        monkeypatch.setenv(key, value)
    trainer.main(argv + ["--multihost", "--work-dir", str(tmp_path / "mh")])
    got = capsys.readouterr().out
    assert not torch.distributed.is_initialized()

    def losses(out):
        return [json.loads(x)["loss"] for x in out.splitlines()
                if x.startswith("{")]
    assert losses(got) == losses(want) and len(losses(want)) == 2
    a, b = (torch.load(tmp_path / run / "step_2" / ckpt.STATE_FILE,
                       weights_only=False) for run in ("one", "mh"))
    for (path, x), (_, y) in zip(loop.tree_leaves(a),
                                 loop.tree_leaves(b)):
        assert torch.equal(torch.as_tensor(x), torch.as_tensor(y)), path


def test_prefetch_loader_stops_its_workers():
    """``PrefetchLoader.epoch`` from a batch offset gives the tail of the
    epoch in order; leaving it early, or on a worker's error, stops and
    joins every worker: 16 workers, a queue of 1, a short switch
    interval, each case bounded by a 60 s join."""
    sampler = EpochSampler(400, seed=1)
    order = sampler.epoch(0)

    def fail_at_7(i):
        if i == order[7]:
            raise ValueError("sample 7")
        return i

    def cases(out):
        loader = PrefetchLoader(lambda i: i, list, sampler, batch_size=2,
                                num_workers=16, prefetch=1)
        out["tail"] = list(loader.epoch(0, start=3))
        it = loader.epoch(0)
        out["first"] = next(it)
        it.close()
        out["after_close"] = threading.active_count()
        bad = PrefetchLoader(fail_at_7, list, sampler, batch_size=2,
                             num_workers=16, prefetch=1)
        try:
            list(bad.epoch(0))
        except ValueError as e:
            out["error"] = str(e)
        out["after_error"] = threading.active_count()

    switch = sys.getswitchinterval()
    sys.setswitchinterval(1e-5)
    try:
        before, out = threading.active_count(), {}
        runner = threading.Thread(target=cases, args=(out,), daemon=True)
        runner.start()
        runner.join(timeout=60)
        assert not runner.is_alive()
    finally:
        sys.setswitchinterval(switch)
    assert out["tail"] == [order[i:i + 2] for i in range(6, 400, 2)]
    assert out["first"] == order[:2]
    assert out["error"] == "sample 7"
    # the runner itself is the one thread above the count before
    assert out["after_close"] == out["after_error"] == before + 1
