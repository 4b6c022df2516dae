"""Guards of the port's boundaries, each in a fresh interpreter:

* importing every flmm_tpu_torch module (the anyres data module, the
  eval loop's host modules and the generation slice, which read images,
  included) and chip_smoke
  pulls in neither JAX nor the JAX package nor PIL, transformers or
  torchvision (the machine with the card has no JAX and no PIL, and
  tests/test_grad_parity.py stubs the last two in ``sys.modules``);
* chip_smoke.py refuses to run without a card, and without the rest of the
  repository, and never prints its success line then; so does the trainer
  without a card unless told ``--device cpu``;
* the wrappers of the relayout pair (K11), the raw capture (K9), the
  spatial window attention (K12 v10), the global variants v1, v2, v3, v4,
  v6, v7 and v11 and the window variants v1 to v8 (K12) take
  their plain versions on CPU tensors and launch nothing, and refuse inputs
  that require grad;
* no wrapper or entry point of the bench.py, schedule_bench.py and
  bench_families.py twins catches a failure to give way to another path: the
  only handlers are the bench's batch-size sweep and the size sweep's point,
  for an out-of-memory error, and the family matrix's, for a child that
  outlives its time limit.
"""

import os
import pathlib
import re
import shutil
import subprocess
import sys

import pytest
import torch

from flmm_tpu_torch.ops import boundary, flash_attention
from flmm_tpu_torch.ops import sam_flash_experiments as sfx

REPO = pathlib.Path(__file__).resolve().parent.parent
FORBIDDEN = ("jax", "jaxlib", "flmm_tpu", "PIL", "transformers",
             "torchvision", "safetensors", "orbax")


def _run(code_or_args, cwd=REPO, extra_env=None, timeout=300):
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    env["CUDA_VISIBLE_DEVICES"] = ""  # behave as on a machine without a card
    env.update(extra_env or {})
    args = (["-c", code_or_args] if isinstance(code_or_args, str)
            else code_or_args)
    return subprocess.run([sys.executable, *args], cwd=cwd, env=env,
                          capture_output=True, text=True, timeout=timeout)


def test_port_and_chip_smoke_import_no_jax_pil_or_hf():
    code = (
        "import importlib, pkgutil, sys\n"
        "import flmm_tpu_torch\n"
        "names = [m.name for m in pkgutil.walk_packages(\n"
        "    flmm_tpu_torch.__path__, 'flmm_tpu_torch.')]\n"
        "for n in names: importlib.import_module(n)\n"
        "import chip_smoke\n"
        "import bench_torch\n"
        f"bad = sorted(m for m in sys.modules if m.split('.')[0] in {FORBIDDEN!r})\n"
        "assert 'flmm_tpu_torch.data.llava_next' in names\n"
        "assert 'flmm_tpu_torch.ops.global_block' in names\n"
        "assert 'flmm_tpu_torch.configs.hpt' in names\n"
        "for new in ('ops.boundary', 'ops.sam_flash_experiments',\n"
        "            'kernel_bench', 'bench', 'ops._matmul',\n"
        "            'schedule_bench', 'bench_families',\n"
        "            'data.processors', 'data.collate',\n"
        "            'evalsuite.metrics', 'evalsuite.runner',\n"
        "            'runtime', 'data.image_io', 'data.io', 'data.refcoco',\n"
        "            'data.png', 'data.panoptic', 'data.loader',\n"
        "            'convert.hf_weights', 'convert.sam_weights',\n"
        "            'convert.load', 'evalsuite.cli', 'eval_refcoco',\n"
        "            'eval_png', 'models.vision.sam_tower',\n"
        "            'configs.mgm', 'models.vision.convnext',\n"
        "            'models.frozen.mgm', 'data.mgm', 'data.video',\n"
        "            'train.__main__', 'train.streams',\n"
        "            'models.sam.predictor', 'models.sam.amg',\n"
        "            'convert.export', 'demo.grounded_conversation',\n"
        "            'demo.infer_png', 'demo.visualize_ranks',\n"
        "            'visual_cot.visual_cot_inference'):\n"
        "    assert 'flmm_tpu_torch.' + new in names\n"
        "print(len(names), bad)\n")
    proc = _run(code)
    assert proc.returncode == 0, proc.stderr
    count, bad = proc.stdout.split(" ", 1)
    assert int(count) >= 40
    assert bad.strip() == "[]"


def test_port_sources_never_import_jax():
    pattern = re.compile(
        r"^\s*(import|from)\s+(jax|jaxlib|flmm_tpu|PIL|transformers|"
        r"torchvision|safetensors|orbax)\b", re.M)
    files = sorted((REPO / "flmm_tpu_torch").rglob("*.py"))
    files += [REPO / "chip_smoke.py", REPO / "bench_torch.py"]
    assert len(files) > 20
    for new in ("ops/global_block.py", "configs/hpt.py", "ops/boundary.py",
                "ops/sam_flash_experiments.py", "kernel_bench.py", "bench.py",
                "ops/_matmul.py", "schedule_bench.py", "bench_families.py",
                "data/processors.py", "data/collate.py",
                "evalsuite/metrics.py", "evalsuite/runner.py",
                "runtime/__init__.py", "data/image_io.py", "data/io.py",
                "convert/load.py", "eval_refcoco.py", "eval_png.py",
                "train/__main__.py", "train/streams.py",
                "models/sam/predictor.py", "models/sam/amg.py",
                "convert/export.py", "demo/grounded_conversation.py",
                "demo/infer_png.py", "demo/visualize_ranks.py",
                "visual_cot/visual_cot_inference.py"):
        assert REPO / "flmm_tpu_torch" / new in files
    # the eval CLIs load ``--tokenizer`` through transformers inside the
    # call, as the JAX scripts do; that one import is the only one allowed
    cli = REPO / "flmm_tpu_torch" / "evalsuite" / "cli.py"
    deferred = ("def load_tokenizer(args, tokenizer):\n"
                "    if tokenizer is not None:\n"
                "        return tokenizer\n"
                "    from transformers import AutoTokenizer\n")
    assert cli.read_text().count(deferred) == 1
    for f in files:
        text = f.read_text()
        if f == cli:
            text = text.replace(deferred, "")
        assert not pattern.search(text), f


def test_generation_slice_imports_no_jax_pil_or_hf():
    """The grounder API, noun chunks and the tokenisation module, imported
    alone in a fresh interpreter and called, load none of the forbidden
    modules (spaCy is tried only inside the call, and is absent)."""
    code = (
        "import sys\n"
        "import flmm_tpu_torch.generation.api as api\n"
        "import flmm_tpu_torch.data.tokenization\n"
        "import flmm_tpu_torch.generation.noun_chunks as nc\n"
        "nc.noun_chunks('a red dog on the table')\n"
        "for n in ('generation.decode', 'generation.noun_chunks',\n"
        "          'generation.api', 'data.tokenization'):\n"
        "    assert 'flmm_tpu_torch.' + n in sys.modules, n\n"
        f"print(sorted(m for m in sys.modules if m.split('.')[0] in "
        f"{FORBIDDEN!r}))\n")
    proc = _run(code)
    assert proc.returncode == 0, proc.stderr
    assert proc.stdout.strip() == "[]"
    for f in ("generation/api.py", "generation/decode.py",
              "generation/noun_chunks.py", "data/tokenization.py"):
        assert (REPO / "flmm_tpu_torch" / f).is_file(), f


def test_trainer_imports_no_jax_and_needs_a_card():
    """The trainer and its streams, imported alone in a fresh interpreter,
    load none of the forbidden modules; on the real-data stream as on the
    synthetic one it refuses to start without a card unless given
    ``--device cpu`` (it stops before reading the tokenizer or the data)."""
    code = (
        "import sys\n"
        "import flmm_tpu_torch.train.__main__\n"
        "import flmm_tpu_torch.train.streams\n"
        f"print(sorted(m for m in sys.modules if m.split('.')[0] in "
        f"{FORBIDDEN!r}))\n")
    proc = _run(code)
    assert proc.returncode == 0, proc.stderr
    assert proc.stdout.strip() == "[]"
    for argv in (["--synthetic"], ["--tokenizer", "no/such/tokenizer",
                                   "--data-root", "no/such/root"]):
        proc = _run(["-m", "flmm_tpu_torch.train", *argv])
        assert proc.returncode != 0
        assert "no CUDA device" in proc.stderr, proc.stderr


@pytest.mark.parametrize("module, argv", [
    ("demo.grounded_conversation", ["--checkpoint", "x", "--image", "x",
                                    "--text", "q", "--tokenizer", "t"]),
    ("demo.infer_png", ["--synthetic"]),
    ("visual_cot.visual_cot_inference", [
        "--checkpoint", "x", "--tokenizer", "t", "--benchmark-dir", "x",
        "--image-root", "x", "--out", "x"]),
])
def test_demo_clis_run_as_modules_and_need_a_card(tmp_path, module, argv):
    """``python -m`` of each demo CLI stops without a card unless given
    ``--device cpu``, before it reads a file or a tokenizer."""
    proc = _run(["-m", "flmm_tpu_torch." + module, *argv], cwd=tmp_path,
                extra_env={"PYTHONPATH": str(REPO)})
    assert proc.returncode != 0
    assert "no CUDA device" in proc.stderr, proc.stderr
    assert not any(tmp_path.iterdir())


def test_visualize_ranks_runs_as_a_module(tmp_path):
    proc = _run(["-m", "flmm_tpu_torch.demo.visualize_ranks"], cwd=tmp_path,
                extra_env={"PYTHONPATH": str(REPO)})
    assert proc.returncode == 0, proc.stderr
    assert proc.stdout.splitlines()[0].split() == ["model", "QA", "rank",
                                                   "seg", "rank"]
    assert "MGM-HD-7B" in proc.stdout


def test_chip_smoke_fails_without_a_card():
    proc = _run(["chip_smoke.py"])
    assert proc.returncode != 0
    assert '"ok": true' not in proc.stdout
    assert "no CUDA device" in proc.stderr


def test_chip_smoke_names_the_source_and_tpu_site_of_every_wrapper():
    """Each counted wrapper has a line of the ``kernels`` JSON: a CUDA
    source in the port and the ``file:line`` of the TPU kernel it
    replaces, which holds a ``pallas_call``."""
    code = (
        "import chip_smoke, json\n"
        "from flmm_tpu_torch import bench\n"
        "assert set(chip_smoke.SOURCES) == set(bench.WRAPPERS)\n"
        "print(json.dumps(chip_smoke.SOURCES))\n")
    proc = _run(code)
    assert proc.returncode == 0, proc.stderr
    import json
    sources = json.loads(proc.stdout)
    assert len(sources) == 28
    # every global variant runs on K2's wgmma + TMA core; the first port's
    # rel-pos kernel is gone
    assert not (REPO / "flmm_tpu_torch/csrc/relpos_attention.cu").exists()
    for name in ("sam_global_attention", "sam_global_attention_v2",
                 "sam_global_attention_v3", "sam_global_attention_v4",
                 "sam_global_attention_v6", "sam_global_attention_v7",
                 "sam_global_attention_v11"):
        assert sources[name][0] == \
            "flmm_tpu_torch/csrc/relpos_attention_sm90.cu", name
    # K5 and K9 run the wgmma + TMA capture source; the first port's is gone
    assert not (REPO / "flmm_tpu_torch/csrc/flash_capture.cu").exists()
    for name in ("flash_attention_with_merged_capture",
                 "flash_attention_with_capture"):
        assert sources[name][0] == \
            "flmm_tpu_torch/csrc/flash_capture_sm90.cu", name
    for name, (src, site) in sources.items():
        assert (REPO / src).is_file(), name
        path, line = site.split(":")
        lines = (REPO / path).read_text().splitlines()
        assert "pallas_call" in lines[int(line) - 1], (name, site)


def test_chip_smoke_fails_alone(tmp_path):
    shutil.copy(REPO / "chip_smoke.py", tmp_path / "chip_smoke.py")
    proc = _run(["chip_smoke.py"], cwd=tmp_path)
    assert proc.returncode != 0
    assert '"ok": true' not in proc.stdout
    assert "flmm_tpu_torch" in proc.stderr


@pytest.mark.parametrize("call", ["library()", "launch('flmm_ln_gemm')"])
def test_kernels_build_at_first_use_and_raise_without_nvcc(call):
    """Importing the ops builds nothing; without nvcc, asking for a kernel
    raises instead of falling back."""
    code = (
        "import os, shutil\n"
        "from flmm_tpu_torch.ops import _cuda\n"
        "if shutil.which('nvcc') or os.path.exists("
        "'/usr/local/cuda/bin/nvcc'):\n"
        "    print('HAS_NVCC')\n"
        "else:\n"
        "    try:\n"
        f"        _cuda.{call}\n"
        "    except RuntimeError as e:\n"
        "        print('RAISED', 'nvcc' in str(e))\n")
    proc = _run(code, extra_env={"PATH": "/usr/bin:/bin"})
    assert proc.returncode == 0, proc.stderr
    if "HAS_NVCC" not in proc.stdout:
        assert proc.stdout.strip() == "RAISED True"


WINDOW_VARIANTS = ("sam_window_attention", "sam_window_attention_v2",
                   "sam_window_attention_v6", "sam_window_attention_v7",
                   "sam_window_attention_v8", "sam_window_attention_v3",
                   "sam_window_attention_v4", "sam_window_attention_v5")
GLOBAL_VARIANTS = ("sam_global_attention", "sam_global_attention_v2",
                   "sam_global_attention_v3", "sam_global_attention_v4",
                   "sam_global_attention_v6", "sam_global_attention_v7",
                   "sam_global_attention_v11")


def _wrapper_calls():
    """(wrapper, plain version, CPU arguments, indices of the float
    arguments) of the three modules that hold K9, K11 and K12 v10."""
    x = torch.randn((1, 5, 5, 8))
    xw, geom = boundary.windowize_plain(x, 3)
    q = torch.randn((1, 2, 128, 8))
    qkv = torch.randn((1, 4, 4, 2 * 3 * 8))
    rel = torch.randn((3, 8))
    heads = torch.randn((2, 16, 8))
    rel_g = torch.randn((7, 8))
    variants = {
        name: (getattr(sfx, name), getattr(sfx, name + "_plain"),
               (heads, heads, heads, rel_g, rel_g, 4), (0, 1, 2))
        for name in GLOBAL_VARIANTS}
    window = torch.randn((2, 2, 9, 8))  # (NW, nh, T, hd), side 3
    rel_w = torch.randn((5, 8))
    variants.update({
        name: (getattr(sfx, name), getattr(sfx, name + "_plain"),
               (window, window, window, rel_w, rel_w, 3), (0, 1, 2))
        for name in WINDOW_VARIANTS})
    return {
        **variants,
        "windowize": (boundary.windowize, boundary.windowize_plain,
                      (x, 3), (0,)),
        "dewindowize": (boundary.dewindowize, boundary.dewindowize_plain,
                        (xw, geom, 3), (0,)),
        "flash_attention_with_capture": (
            flash_attention.flash_attention_with_capture,
            flash_attention.flash_attention_with_capture_plain,
            (q, q, q, torch.tensor([100]), 0, 64), (0, 1, 2)),
        "sam_window_attention_v10": (
            sfx.sam_window_attention_v10, sfx.sam_window_attention_v10_plain,
            (qkv, rel, rel, 2, 3), (0, 1, 2)),
    }


WRAPPER_NAMES = ("windowize", "dewindowize", "flash_attention_with_capture",
                 "sam_window_attention_v10") + GLOBAL_VARIANTS \
    + WINDOW_VARIANTS


def _flat(out):
    return [t for t in (out if isinstance(out, tuple) else (out,))
            if isinstance(t, torch.Tensor)]


@pytest.mark.parametrize("name", WRAPPER_NAMES)
def test_new_wrappers_take_the_plain_version_on_cpu_and_launch_nothing(name):
    wrapper, plain, args, _ = _wrapper_calls()[name]
    before = wrapper.launches
    got, want = _flat(wrapper(*args)), _flat(plain(*args))
    assert wrapper.launches == before == 0
    assert len(got) == len(want) >= 1
    for a, b in zip(got, want):
        assert torch.equal(a, b)


@pytest.mark.parametrize("name", WRAPPER_NAMES)
def test_new_wrappers_refuse_inputs_that_require_grad(name):
    wrapper, _, args, floats = _wrapper_calls()[name]
    for i in floats:
        bad = list(args)
        bad[i] = args[i].clone().requires_grad_()
        with pytest.raises(RuntimeError, match="requires grad"):
            wrapper(*bad)
        with torch.no_grad():
            wrapper(*bad)


def test_no_handler_gives_way_to_another_path():
    """The new wrappers, the product helper and the bench twins hold no
    ``try``; the bench's sweep and the size sweep catch an out-of-memory
    error and nothing else, and the root script only calls its ``main``."""
    pkg = REPO / "flmm_tpu_torch"
    for name in ("ops/sam_flash_experiments.py", "ops/_matmul.py",
                 "ops/sam_flash.py", "models/sam/image_encoder.py"):
        assert not re.search(r"^\s*(try|except)\b", (pkg / name).read_text(),
                             re.M), name
    handlers = re.findall(r"^\s*except\b.*$", (pkg / "bench.py").read_text(),
                          re.M)
    assert [h.strip() for h in handlers] == [
        "except torch.cuda.OutOfMemoryError as e:  # retry smaller"]
    handlers = re.findall(r"^\s*except\b.*$",
                          (pkg / "schedule_bench.py").read_text(), re.M)
    assert [h.strip() for h in handlers] == [
        "except torch.cuda.OutOfMemoryError:"]
    handlers = re.findall(r"^\s*except\b.*$",
                          (pkg / "bench_families.py").read_text(), re.M)
    assert [h.strip() for h in handlers] == [
        "except subprocess.TimeoutExpired:"]
    root = (REPO / "bench_torch.py").read_text()
    assert "from flmm_tpu_torch.bench import main" in root
    assert "try" not in root and "except" not in root


def test_readers_loaders_and_clis_hold_no_fallback_handler():
    """The host helpers, the readers, the checkpoint loaders, the eval
    CLIs and the trainer hold no ``try``: a failed build, decode or load
    raises.  The only
    handlers are ``data/io.py``'s, for a missing fsspec (a remote path then
    raises, ``exists`` says False), and the prefetch loader's, which hands a
    worker's exception to the consumer."""
    pkg = REPO / "flmm_tpu_torch"
    for name in ("runtime/__init__.py", "data/image_io.py",
                 "data/refcoco.py", "data/png.py", "data/panoptic.py",
                 "convert/hf_weights.py", "convert/sam_weights.py",
                 "convert/load.py", "evalsuite/cli.py", "eval_refcoco.py",
                 "eval_png.py", "train/checkpoint.py", "train/streams.py",
                 "train/__main__.py"):
        assert not re.search(r"^\s*(try|except)\b", (pkg / name).read_text(),
                             re.M), name
    handlers = [h.strip() for h in re.findall(
        r"^\s*except\b.*$", (pkg / "data/io.py").read_text(), re.M)]
    assert handlers == ["except ImportError as e:", "except ImportError:"]
    handlers = [h.strip() for h in re.findall(
        r"^\s*except\b.*$", (pkg / "data/loader.py").read_text(), re.M)]
    assert handlers == ["except queue.Empty:",
                        "except Exception as e:  # raised again in the "
                        "consumer"]


@pytest.mark.parametrize("call", [
    "image_io.open_image(JPEG)", "image_io.open_image(PNG)",
    "runtime.polygons_fill([[1, 1, 9, 1, 5, 8]], 10, 10)"])
def test_host_helpers_raise_without_gxx(tmp_path, call):
    """With no g++ on PATH and nothing built, decoding a JPEG or a PNG and
    filling a polygon raise; nothing decodes or rasterises another way."""
    data = REPO / "tests" / "data"
    code = (
        "import pathlib\n"
        "from flmm_tpu_torch import runtime\n"
        "from flmm_tpu_torch.data import image_io\n"
        f"runtime.BUILD = pathlib.Path({str(tmp_path / 'build')!r})\n"
        f"JPEG = {str(data / 'png/val2017/000000000139.jpg')!r}\n"
        f"PNG = {str(data / 'png/annotations/panoptic_val2017/'
                     '000000000139.png')!r}\n"
        "try:\n"
        f"    {call}\n"
        "    print('DECODED')\n"
        "except RuntimeError as e:\n"
        "    print('RAISED', 'g++' in str(e))\n")
    empty = tmp_path / "bin"
    empty.mkdir()
    proc = _run(code, extra_env={"PATH": str(empty)})
    assert proc.returncode == 0, proc.stderr
    assert proc.stdout.strip() == "RAISED True"
    assert not (tmp_path / "build").exists()
