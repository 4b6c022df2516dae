"""Guards of the port's boundaries, each in a fresh interpreter:

* importing every flmm_tpu_torch module (the anyres data module included)
  and chip_smoke pulls in neither JAX nor the JAX package nor PIL,
  transformers or torchvision (the machine with the card has no JAX and no
  PIL, and tests/test_grad_parity.py stubs the last two in
  ``sys.modules``);
* chip_smoke.py refuses to run without a card, and without the rest of the
  repository, and never prints its success line then.
"""

import os
import pathlib
import re
import shutil
import subprocess
import sys

import pytest

REPO = pathlib.Path(__file__).resolve().parent.parent
FORBIDDEN = ("jax", "jaxlib", "flmm_tpu", "PIL", "transformers",
             "torchvision")


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
        f"bad = sorted(m for m in sys.modules if m.split('.')[0] in {FORBIDDEN!r})\n"
        "assert 'flmm_tpu_torch.data.llava_next' in names\n"
        "assert 'flmm_tpu_torch.ops.global_block' in names\n"
        "assert 'flmm_tpu_torch.configs.hpt' in names\n"
        "print(len(names), bad)\n")
    proc = _run(code)
    assert proc.returncode == 0, proc.stderr
    count, bad = proc.stdout.split(" ", 1)
    assert int(count) >= 33
    assert bad.strip() == "[]"


def test_port_sources_never_import_jax():
    pattern = re.compile(
        r"^\s*(import|from)\s+(jax|jaxlib|flmm_tpu|PIL|transformers|"
        r"torchvision)\b", re.M)
    files = sorted((REPO / "flmm_tpu_torch").rglob("*.py"))
    files.append(REPO / "chip_smoke.py")
    assert len(files) > 20
    for new in ("ops/global_block.py", "configs/hpt.py"):
        assert REPO / "flmm_tpu_torch" / new in files
    for f in files:
        assert not pattern.search(f.read_text()), f


def test_chip_smoke_fails_without_a_card():
    proc = _run(["chip_smoke.py"])
    assert proc.returncode != 0
    assert '"ok": true' not in proc.stdout
    assert "no CUDA device" in proc.stderr


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
