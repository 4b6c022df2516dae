"""The port's demo and Visual-CoT CLIs against the JAX scripts on the CPU:
``python -m flmm_tpu_torch.demo.grounded_conversation`` (single shot and
two interactive turns), ``...demo.infer_png --synthetic``,
``...demo.visualize_ranks`` and ``...visual_cot.visual_cot_inference``
(v1, v2, v3) at the tiny DeepSeek-VL preset with ``--device cpu``.

Both sides run in process: the port's ``main(argv, tokenizer=...)`` and the
JAX script's ``main()`` under a patched ``sys.argv``, with
``AutoTokenizer.from_pretrained`` patched to the same word-level stand-in
tokenizer (every id decodes to a word, so a random model's answer holds
noun phrases to ground).  Both load the same on-disk world: the DeepSeek-VL
and SAM checkpoints of tests/cli_fixtures.py and a released-layout
``--trained`` ``.pth``, so every leaf comes from a file; the JAX scripts'
random init is replaced by the port's seeded init carried across with
``convert/from_jax.py`` (it is overwritten by the files, except in
``infer_png``, which runs on the init).

Compared: answers and the JSON's text fields exact, per-phrase pixel
counts within 0.1%, overlay and visualisation PNGs within 0.1% of pixels,
CoT boxes within 1 px, the rank table's stdout identical; and each CLI's
refusals.
"""

import contextlib
import importlib.util
import io
import json
import pathlib
import re
import sys
import types
import zlib

import transformers  # noqa: F401  (before any test stubs torchvision)

import numpy as np
import jax
import jax.numpy as jnp
import pytest
import torch
from PIL import Image

from flmm_tpu import registry as jregistry
from flmm_tpu_torch.configs import deepseek_vl as tds
from flmm_tpu_torch.data.image_io import decode_png
from flmm_tpu_torch.demo import grounded_conversation, infer_png, \
    visualize_ranks
from flmm_tpu_torch.models.frozen import grounding
from flmm_tpu_torch.visual_cot import visual_cot_inference
from tests import checkpoint_writers as cw

REPO = pathlib.Path(__file__).resolve().parent.parent
DATA = REPO / "tests" / "data"
IMAGE = DATA / "refcoco" / "train2014" / "COCO_train2014_000000000009.jpg"
PX_TOL = 1e-3  # share of pixels, and of a phrase's pixel count
BOX_TOL = 1


class WordTokenizer:
    """Word-level stand-in with ids inside the tiny vocabulary (256): BOS 1,
    the DeepSeek stop word 2, ``<image_placeholder>`` 3, the words of
    ``WORDS`` from 10 and any other word a CRC32 above them; every id
    decodes to one word."""

    WORDS = ("dog cat man hat cup table chair book car tree bird road bag "
             "plate the red and on near is").split()
    SPECIAL = {"<｜end▁of▁sentence｜>": 2, "<image_placeholder>": 3}

    def encode(self, text, add_special_tokens=False):
        ids = [1] if add_special_tokens else []
        text = text.replace("<image_placeholder>", " <image_placeholder> ")
        base = 10 + len(self.WORDS)
        for w in text.split():
            if w in self.SPECIAL:
                ids.append(self.SPECIAL[w])
            elif w in self.WORDS:
                ids.append(10 + self.WORDS.index(w))
            else:
                ids.append(base + zlib.crc32(w.encode()) % (250 - base))
        return ids

    def decode(self, ids, **kw):
        names = {v: k for k, v in self.SPECIAL.items()}
        return " ".join(names.get(int(i), self.WORDS[int(i) % len(self.WORDS)])
                        for i in ids)


class ScriptedStdin(io.TextIOBase):
    """Stdin for ``--interactive``: the next question after a ``user> ``
    prompt (end of input when none is left), ``y`` to every ``Ground X?``
    prompt.  ``out`` is where the prompts are written."""

    def __init__(self, out: io.StringIO, questions):
        self.out, self.questions = out, list(questions)

    def readline(self, size=-1):
        if self.out.getvalue().endswith("user> "):
            return self.questions.pop(0) + "\n" if self.questions else ""
        return "y\n"


def _load_script(rel: str):
    spec = importlib.util.spec_from_file_location(
        "jax_" + pathlib.Path(rel).stem, REPO / rel)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def _numpy_tree(tree):
    if isinstance(tree, dict):
        return {k: _numpy_tree(v) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return type(tree)(_numpy_tree(v) for v in tree)
    return tree.detach().numpy().copy()


@pytest.fixture(scope="module")
def world(tmp_path_factory):
    """The on-disk world, written from the port's seeded init: the
    DeepSeek-VL checkpoint (f32 safetensors), the SAM ``.pth`` and the
    released-layout trained heads; the init itself, as numpy."""
    root = tmp_path_factory.mktemp("demo_cli")
    params = grounding.init_params(tds.tiny(),
                                   torch.Generator().manual_seed(0), "cpu")
    w = {"root": root, "checkpoint": str(root / "ckpt"),
         "sam": str(root / "sam.pth"), "trained": str(root / "trained.pth"),
         "init": _numpy_tree(params)}
    fro, tra = params["frozen"], params["trainable"]
    g = torch.Generator().manual_seed(3)
    for leaf in (tra["text_layer_weights"], tra["text_proj"]["b"]):
        leaf.copy_(torch.randn(leaf.shape, generator=g) * 0.5)
    cw.write_shards(root / "ckpt", cw.deepseek_vl_state_dict(
        {k: v for k, v in fro.items() if k != "sam_encoder"}), 1)
    torch.save(cw.sam_encoder_state_dict(fro["sam_encoder"]), w["sam"])
    torch.save({"state_dict": cw.released_trained_state_dict(tra)},
               w["trained"])
    # a VisCoT benchmark of two items: a list image and a string image
    bench = root / "bench"
    bench.mkdir()
    items = [{"image": ["refcoco/train2014/COCO_train2014_000000000009.jpg"],
              "conversations": [
                  {"from": "human", "value": "<image>what is on the table?"},
                  {"from": "gpt", "value": "a red cup"}]},
             {"image": "png/val2017/000000000285.jpg",
              "conversations": [
                  {"from": "human", "value": "where is the dog?"},
                  {"from": "gpt", "value": "near the car"}]}]
    (bench / "toy.json").write_text(json.dumps(items))
    w["bench"] = str(bench)
    return w


def _common(world):
    return ["--family", "deepseek_vl", "--preset", "tiny",
            "--checkpoint", world["checkpoint"],
            "--sam-checkpoint", world["sam"], "--trained", world["trained"],
            "--tokenizer", "stand-in"]


@contextlib.contextmanager
def _jax_side(world, argv, stdin_questions=None):
    """The JAX script's environment: ``sys.argv``, the stand-in tokenizer,
    the port's init in the place of the JAX init, stdout captured (and
    stdin scripted).  Yields the captured stdout."""
    init = jax.tree.map(jnp.asarray, world["init"])
    get_model = jregistry.get_model

    def patched_get_model(family):
        mod = get_model(family)
        return types.SimpleNamespace(**{**vars(mod),
                                        "init_params": lambda *a: init})

    out = io.StringIO()
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(sys, "argv", ["script", *argv])
        mp.setattr(transformers.AutoTokenizer, "from_pretrained",
                   lambda *a, **k: WordTokenizer())
        mp.setattr(jregistry, "get_model", patched_get_model)
        if stdin_questions is not None:
            mp.setattr(sys, "stdin", ScriptedStdin(out, stdin_questions))
        with contextlib.redirect_stdout(out):
            yield out


def _port_side(main, argv, stdin_questions=None, **kw) -> str:
    out = io.StringIO()
    with pytest.MonkeyPatch.context() as mp:
        if stdin_questions is not None:
            mp.setattr(sys, "stdin", ScriptedStdin(out, stdin_questions))
        with contextlib.redirect_stdout(out):
            main(argv, **kw)
    return out.getvalue()


def _pixel_counts(text: str) -> list:
    return re.findall(r": (\d+) px$", text, re.M)


def _same_transcript(got: str, want: str, got_dir, want_dir) -> None:
    """Equal line for line, the pixel counts within ``PX_TOL`` and the
    saved paths up to their directory."""
    g = got.replace(str(got_dir), "DIR").splitlines()
    w = want.replace(str(want_dir), "DIR").splitlines()
    assert len(g) == len(w), (got, want)
    for a, b in zip(g, w):
        ma, mb = (re.fullmatch(r"(.*): (\d+) px", x) for x in (a, b))
        if ma and mb:
            assert ma.group(1) == mb.group(1)
            na, nb = int(ma.group(2)), int(mb.group(2))
            assert abs(na - nb) <= PX_TOL * max(nb, 1), (a, b)
        else:
            assert a == b


def _same_png(got: pathlib.Path, want: pathlib.Path) -> np.ndarray:
    a = decode_png(got.read_bytes())
    b = np.asarray(Image.open(want).convert("RGB"))
    assert a.shape == b.shape
    assert (a != b).any(-1).mean() <= PX_TOL
    return a


@pytest.fixture(scope="module")
def conversation(world, tmp_path_factory):
    """Single shot and two interactive turns on both sides."""
    runs = {}
    jscript = _load_script("scripts/demo/grounded_conversation.py")
    for mode, extra, questions in (
            ("single", ["--text", "what is on the table?"], None),
            ("interactive", ["--interactive"],
             ["what is on the table?", "and what is near it?"])):
        dirs = {s: tmp_path_factory.mktemp(f"{mode}_{s}")
                for s in ("port", "jax")}
        argv = [*_common(world), "--image", str(IMAGE), "--max-new-tokens",
                "8"] + extra
        got = _port_side(grounded_conversation.main,
                         argv + ["--out", str(dirs["port"] / "g.png"),
                                 "--device", "cpu"],
                         questions, tokenizer=WordTokenizer())
        with _jax_side(world, argv + ["--out", str(dirs["jax"] / "g.png")],
                       questions) as out:
            jscript.main()
        runs[mode] = (got, out.getvalue(), dirs)
    return runs


@pytest.mark.parametrize("mode", ["single", "interactive"])
def test_grounded_conversation_matches_jax(conversation, mode):
    got, want, dirs = conversation[mode]
    assert "Answer:" in got and _pixel_counts(got), got
    if mode == "interactive":
        assert got.count("Answer:") == 2 and "Ground " in got
    _same_transcript(got, want, dirs["port"], dirs["jax"])
    names = sorted(p.name for p in dirs["port"].iterdir())
    assert names == sorted(p.name for p in dirs["jax"].iterdir())
    assert names == (["g.png"] if mode == "single" else
                     [f"g_turn{i}.png" for i in range(got.count("saved "))])
    for n in names:
        a = _same_png(dirs["port"] / n, dirs["jax"] / n)
        assert a.shape == (480, 640, 3)


def test_overlay_is_jax_bit_for_bit():
    jscript = _load_script("scripts/demo/grounded_conversation.py")
    rng = np.random.default_rng(0)
    image = rng.integers(0, 256, (7, 9, 3), np.uint8)
    masks = rng.random((10, 7, 9)) > 0.5
    got = grounded_conversation.overlay(image, masks, [""] * 10)
    want = np.asarray(jscript.overlay(Image.fromarray(image), masks,
                                      [""] * 10))
    np.testing.assert_array_equal(got, want)
    assert grounded_conversation.PALETTE == jscript.PALETTE


@pytest.fixture(scope="module")
def cot(world, tmp_path_factory):
    jscript = _load_script("scripts/visual_cot/visual_cot_inference.py")
    runs = {}
    for version in ("v1", "v2", "v3"):
        dirs = {s: tmp_path_factory.mktemp(f"cot_{version}_{s}")
                for s in ("port", "jax")}
        argv = [*_common(world), "--version", version, "--benchmark-dir",
                world["bench"], "--image-root", str(DATA),
                "--max-new-tokens", "6", "--max-thought-tokens", "4"]
        _port_side(visual_cot_inference.main,
                   argv + ["--out", str(dirs["port"]), "--device", "cpu"],
                   tokenizer=WordTokenizer())
        with _jax_side(world, argv + ["--out", str(dirs["jax"])]):
            jscript.main()
        runs[version] = [json.loads((dirs[s] / "toy.json").read_text())
                         for s in ("port", "jax")]
    return runs


@pytest.mark.parametrize("version", ["v1", "v2", "v3"])
def test_visual_cot_matches_jax(cot, version):
    got, want = cot[version]
    assert len(got) == len(want) == 2
    for g, w in zip(got, want):
        assert set(g) == set(w) == {"question", "thought", "bbox", "answer",
                                    "gt", "image"}
        for k in ("question", "thought", "answer", "gt", "image"):
            assert g[k] == w[k], k
        assert len(g["bbox"]) == 4
        assert np.abs(np.subtract(g["bbox"], w["bbox"])).max() <= BOX_TOL
    assert got[0]["image"] == want[0]["image"] == [
        "refcoco/train2014/COCO_train2014_000000000009.jpg"]


def test_infer_png_synthetic_matches_jax(world, tmp_path):
    jscript = _load_script("scripts/demo/infer_png.py")
    got = _port_side(infer_png.main, ["--synthetic", "--out",
                                      str(tmp_path / "port"), "--device",
                                      "cpu"])
    with _jax_side(world, ["--synthetic", "--out",
                           str(tmp_path / "jax")]) as out:
        jscript.main()
    assert got.replace("port", "X") == out.getvalue().replace("jax", "X")
    for b in range(2):
        name = f"synthetic_{b}.png"
        a = np.asarray(Image.open(tmp_path / "port" / name))
        w = np.asarray(Image.open(tmp_path / "jax" / name))
        assert a.shape == w.shape and a.ndim == 2 and a.dtype == np.uint8
        assert (a != w).mean() <= PX_TOL


def test_kmeans2_matches_jax():
    jscript = _load_script("scripts/demo/infer_png.py")
    x = np.random.default_rng(1).random((3, 6, 5)).astype(np.float32)
    for seed in (0, 1):
        np.testing.assert_array_equal(infer_png.kmeans2(x, seed=seed),
                                      jscript.kmeans2(x, seed=seed))


def test_visualize_ranks_matches_jax(tmp_path, monkeypatch):
    jscript = _load_script("scripts/demo/visualize_ranks.py")
    assert visualize_ranks.SCORES == jscript.SCORES
    monkeypatch.chdir(tmp_path)
    outs = []
    for fn in (visualize_ranks.main, jscript.main):
        out = io.StringIO()
        with contextlib.redirect_stdout(out):
            fn()
        outs.append(out.getvalue())
    assert outs[0] == outs[1]
    assert "DeepSeekVL-1.3B" in outs[0]


# -- refusals ----------------------------------------------------------------


@pytest.mark.parametrize("main, argv", [
    (grounded_conversation.main, ["--checkpoint", "x", "--image", "x",
                                  "--text", "q"]),
    (visual_cot_inference.main, ["--checkpoint", "x", "--benchmark-dir", "x",
                                 "--image-root", "x", "--out", "x"]),
    (infer_png.main, ["--synthetic"]),
])
def test_clis_refuse_cuda_without_a_card(main, argv):
    assert not torch.cuda.is_available()
    kw = {} if main is infer_png.main else {"tokenizer": WordTokenizer()}
    with pytest.raises(SystemExit, match="no CUDA device"):
        main(argv, **kw)


def test_visual_cot_refuses_no_sam(world, tmp_path):
    with pytest.raises(NotImplementedError, match="--no-sam is not wired"):
        visual_cot_inference.main(
            [*_common(world), "--benchmark-dir", world["bench"],
             "--image-root", str(DATA), "--out", str(tmp_path), "--no-sam",
             "--device", "cpu"], tokenizer=WordTokenizer())
    assert not any(tmp_path.iterdir())


def test_visual_cot_refuses_a_version_the_grounder_lacks(capsys, tmp_path):
    with pytest.raises(SystemExit) as e:
        visual_cot_inference.main(
            ["--family", "llava_next", "--preset", "tiny", "--version", "v1",
             "--checkpoint", "x", "--benchmark-dir", "x", "--image-root",
             "x", "--out", str(tmp_path), "--device", "cpu"],
            tokenizer=WordTokenizer())
    assert e.value.code == 2
    assert "AnyresGrounder has no visual_cot_v1" in capsys.readouterr().err


@pytest.mark.parametrize("flags", [["--kmeans"], ["--checkpoint", "c"],
                                   ["--sam-checkpoint", "s", "--limit", "3"],
                                   ["--tokenizer", "t"],
                                   ["--data-root", "d"]])
def test_infer_png_refuses_flags_jax_never_reads(capsys, tmp_path, flags):
    with pytest.raises(SystemExit) as e:
        infer_png.main(["--synthetic", "--out", str(tmp_path), "--device",
                        "cpu", *flags])
    assert e.value.code == 2
    err = capsys.readouterr().err
    for f in flags:
        if f.startswith("--"):
            assert f in err
    assert "never read" in err and not any(tmp_path.iterdir())


def test_infer_png_refuses_real_data_as_jax_does():
    with pytest.raises(SystemExit, match="real-data visualisation requires"):
        infer_png.main(["--device", "cpu"])


def test_grounded_conversation_needs_text_or_interactive(world, capsys):
    with pytest.raises(SystemExit) as e:
        grounded_conversation.main([*_common(world), "--image", str(IMAGE),
                                    "--device", "cpu"],
                                   tokenizer=WordTokenizer())
    assert e.value.code == 2
    assert "--text is required" in capsys.readouterr().err
