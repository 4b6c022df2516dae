"""The SAM size sweep (``python -m flmm_tpu_torch.schedule_bench``, the twin
of scripts/schedule_bench.py) on the CPU at the tiny preset: two SAM sizes,
128 (an 8 x 8 grid in 2 x 2 windows, no pad) and 80 (5 x 5, padded to 6 x 6),
batch sizes 1 and 2, the plain versions on host clocks.

The rows' times are host-clock times of plain code here and say so
(``device: cpu ...``); the card's rows come from the module run on the card.
The forward at the padded size is compared with root ``bench.py``'s at 1e-3
(f32, other summation orders through the whole stack, as the other slice
tests hold): on the CPU the JAX forward takes its plain blocks, whose pad
tokens keep ``k = b_k`` and ``v = b_v`` as the port's do on every path.
"""

import contextlib
import io
import json
import pathlib
import subprocess
import sys

import numpy as np
import jax
import pytest
import torch

import bench as jbench
from flmm_tpu import registry as jregistry
from flmm_tpu_torch import bench, schedule_bench
from flmm_tpu_torch.convert.from_jax import from_jax

REPO = pathlib.Path(__file__).resolve().parent.parent
SLICE_TOL = 1e-3
SIZES, BATCH_SIZES = (128, 80), (1, 2)
ARGS = ["--device", "cpu", "--sizes", *map(str, SIZES), "--batch-sizes",
        *map(str, BATCH_SIZES), "--iters", "2"]
BENCH_ENV = ("BENCH_FAMILY", "BENCH_PRESET", "BENCH_SAM_SIZE", "BENCH_BS",
             "BENCH_ITERS", "BENCH_SEQ", "BENCH_GLOBAL_BLOCK",
             "BENCH_GLOBAL_KERNEL", "BENCH_QUANT_LLM")


def _tiny_env(monkeypatch, **extra):
    for key in BENCH_ENV:
        monkeypatch.delenv(key, raising=False)
    for key, value in {"BENCH_PRESET": "tiny", "BENCH_SEQ": "112",
                       **extra}.items():
        monkeypatch.setenv(key, value)


@pytest.fixture(scope="module")
def sweep():
    """(rows, printed lines, launch counts before and after) of one sweep."""
    mp = pytest.MonkeyPatch()
    _tiny_env(mp, BENCH_SAM_SIZE="999")  # overridden by --sizes
    before = {name: fn.launches for name, fn in bench.WRAPPERS.items()}
    try:
        out = io.StringIO()
        with contextlib.redirect_stdout(out):
            rows = schedule_bench.main(ARGS)
    finally:
        mp.undo()
    after = {name: fn.launches for name, fn in bench.WRAPPERS.items()}
    return rows, out.getvalue().strip().splitlines(), before, after


def test_one_json_line_per_point_in_order_then_the_summary(sweep):
    rows, lines, _, _ = sweep
    assert [json.loads(line) for line in lines] == rows
    assert len(rows) == len(SIZES) * len(BATCH_SIZES) + 1
    assert [(r["sam_size"], r["bs"]) for r in rows[:-1]] == [
        (s, b) for s in SIZES for b in BATCH_SIZES]


@pytest.mark.parametrize("i", range(len(SIZES) * len(BATCH_SIZES)))
def test_point_rows_lead_with_the_jax_keys_then_carry_the_bench_row(sweep, i):
    row = sweep[0][i]
    assert list(row)[:4] == ["sam_size", "bs", "img_per_s",
                             "wall_incl_compile_s"]
    src = (REPO / "scripts" / "schedule_bench.py").read_text()
    for key in list(row)[:4]:
        assert f'"{key}"' in src
    assert set(row) == {"img_per_s", "wall_incl_compile_s", "metric", "value",
                        "unit", "vs_baseline", "bs", "ms_mean", "ms_min",
                        "ms_max", "iters", "peak_gb", "plain", "family",
                        "preset", "sam_size", "global_kernel", "launches",
                        "device"}
    assert "error" not in row and "oom" not in row
    assert row["img_per_s"] == row["value"] > 0 and row["plain"]["value"] > 0
    assert row["wall_incl_compile_s"] > 0 and row["iters"] == 2
    assert 0 < row["ms_min"] <= row["ms_mean"] <= row["ms_max"]
    assert (row["family"], row["preset"]) == ("deepseek_vl", "tiny")
    assert row["device"].startswith("cpu")
    assert set(row["launches"]) == set(bench.WRAPPERS)
    assert not any(row["launches"].values())


def test_summary_line_holds_the_best_batch_size_per_size(sweep):
    rows = sweep[0]
    summary = rows[-1]
    assert list(summary) == ["schedule_best_img_per_s", "clock", "iters"]
    assert summary["iters"] == 2 and "bench.run" in summary["clock"]
    for size in SIZES:
        assert summary["schedule_best_img_per_s"][str(size)] == max(
            r["img_per_s"] for r in rows[:-1] if r["sam_size"] == size)
    src = (REPO / "scripts" / "schedule_bench.py").read_text()
    for key in summary:
        assert f'"{key}"' in src


def test_the_cpu_sweep_launches_no_kernel(sweep):
    _, _, before, after = sweep
    # run() sets every counter to 0 before its timed loop; none moved since
    assert not any(after.values())
    assert set(after) == set(before)


def test_flags_and_defaults_are_the_jax_scripts():
    src = (REPO / "scripts" / "schedule_bench.py").read_text()
    port = (REPO / "flmm_tpu_torch" / "schedule_bench.py").read_text()
    for line in ('"--batch-sizes", type=int, nargs="*", default=[4, 8]',
                 '"--iters", type=int, default=6',
                 '"--family", default="deepseek_vl"',
                 "default=[1024, 768, 640, 448]"):
        assert line in src and line in port, line


def test_sizes_and_family_replace_the_environments(monkeypatch):
    _tiny_env(monkeypatch, BENCH_SAM_SIZE="128", BENCH_FAMILY="llava",
              BENCH_GLOBAL_KERNEL="v11")
    seen = []

    def fake_run(bs, iters, knobs, device, seed):
        seen.append((bs, iters, knobs, device.type, seed))
        return {"value": float(bs), "bs": bs, "sam_size": knobs.sam_size}

    monkeypatch.setattr(bench, "run", fake_run)
    rows = schedule_bench.main(["--device", "cpu", "--sizes", "80",
                                "--batch-sizes", "2", "1", "--iters", "3",
                                "--family", "deepseek_vl", "--seed", "5"])
    assert [(s[0], s[1], s[3], s[4]) for s in seen] == [(2, 3, "cpu", 5),
                                                        (1, 3, "cpu", 5)]
    for _, _, knobs, _, _ in seen:
        assert knobs == bench.Knobs("deepseek_vl", "tiny", 80, 112, False,
                                    "v11", False)
    assert rows[-1]["schedule_best_img_per_s"] == {"80": 2.0}


def test_only_out_of_memory_gives_a_row_and_the_sweep_goes_on(
        monkeypatch, capsys):
    _tiny_env(monkeypatch)

    def fake_run(bs, iters, knobs, device, seed):
        if (knobs.sam_size, bs) == (128, 2):
            raise torch.cuda.OutOfMemoryError("out of memory")
        return {"value": 1.0 + bs, "bs": bs, "sam_size": knobs.sam_size}

    monkeypatch.setattr(bench, "run", fake_run)
    rows = schedule_bench.main(ARGS)
    assert rows[1] == {"sam_size": 128, "bs": 2, "oom": True}
    assert [r.get("img_per_s") for r in rows[:-1]] == [2.0, None, 2.0, 3.0]
    assert rows[-1]["schedule_best_img_per_s"] == {"128": 2.0, "80": 3.0}
    assert len(capsys.readouterr().out.strip().splitlines()) == 5

    def broken_run(*args):
        raise RuntimeError("a kernel failed to launch")

    monkeypatch.setattr(bench, "run", broken_run)
    with pytest.raises(RuntimeError, match="failed to launch"):
        schedule_bench.main(ARGS)
    assert '"error"' not in capsys.readouterr().out


def test_module_exits_non_zero_without_a_card():
    env = {"CUDA_VISIBLE_DEVICES": "", "PATH": "/usr/bin:/bin",
           "BENCH_PRESET": "tiny"}
    proc = subprocess.run(
        [sys.executable, "-m", "flmm_tpu_torch.schedule_bench"], cwd=REPO,
        env=env, capture_output=True, text=True, timeout=300)
    assert proc.returncode != 0
    assert "no CUDA device" in proc.stderr and "sam_size" not in proc.stdout


@pytest.fixture(scope="module")
def padded_forward():
    """(port outputs, JAX outputs) of the tiny bench forward with SAM at 80,
    both built through their ``build`` from one environment."""
    mp = pytest.MonkeyPatch()
    _tiny_env(mp, BENCH_SAM_SIZE="80")
    try:
        _, jparams, jbatch = jbench.build(2)
        knobs = bench.Knobs.from_env()
        model, cfg, _, batch = bench.build(2, knobs, "cpu")
    finally:
        mp.undo()
    jcfg = jregistry.with_sam_size(jregistry.get_config(
        "deepseek_vl", "tiny"), 80)
    jparams = jax.device_get(jparams)
    rng = np.random.default_rng(0)
    for bp in jparams["frozen"]["sam_encoder"]["blocks"]:  # zeros hide both
        for key in ("bqkv", "rel_pos_h", "rel_pos_w"):
            bp[key] = (rng.standard_normal(bp[key].shape) * 0.1).astype(
                np.float32)
    want = jax.device_get(jax.jit(
        lambda p, b: jregistry.get_model("deepseek_vl").forward(p, jcfg, b))(
            jparams, jbatch))
    with torch.no_grad():
        got = model.forward(from_jax(jparams), cfg, batch)
    assert cfg.sam.encoder.grid == 5 and cfg.sam.encoder.window_size == 2
    return got, want


@pytest.mark.parametrize("key", ["coarse_logits", "sam_logits", "iou_pred",
                                 "hidden"])
def test_bench_forward_on_a_padded_sam_grid_matches_bench_py(
        padded_forward, key):
    got, want = padded_forward
    assert tuple(got[key].shape) == want[key].shape
    np.testing.assert_allclose(got[key].numpy(), np.asarray(want[key]),
                               atol=SLICE_TOL, rtol=SLICE_TOL, err_msg=key)
