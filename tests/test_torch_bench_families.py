"""The port's family matrix (``python -m flmm_tpu_torch.bench_families``)
against the JAX package's ``scripts/bench_families.py`` on the CPU.

The JAX script is read as text and never imported (it starts ``bench.py``
children of its own).  The children here run ``flmm_tpu_torch.bench`` at the
``tiny`` presets on the CPU, one timed forward each: their times are host
clocks of plain code and mean nothing; the rows' keys, the error rows and
the control flow are what is held.
"""

import ast
import json
import os
import pathlib
import subprocess
import sys

import pytest

from flmm_tpu_torch import bench_families as bf

REPO = pathlib.Path(__file__).resolve().parent.parent
JAX_SCRIPT = (REPO / "scripts" / "bench_families.py").read_text()
TINY_ENV = {"BENCH_PRESET": "tiny", "BENCH_SEQ": "112", "BENCH_BS": "2",
            "BENCH_ITERS": "1"}
BENCH_KEYS = ("BENCH_FAMILY", "BENCH_PRESET", "BENCH_SAM_SIZE", "BENCH_BS",
              "BENCH_ITERS", "BENCH_SEQ", "BENCH_GLOBAL_BLOCK",
              "BENCH_GLOBAL_KERNEL", "BENCH_QUANT_LLM")


def _jax_plan() -> dict:
    """``PLAN`` of the JAX script, from its source."""
    for node in ast.parse(JAX_SCRIPT).body:
        if isinstance(node, ast.Assign) and node.targets[0].id == "PLAN":
            return ast.literal_eval(node.value)
    raise AssertionError("scripts/bench_families.py has no PLAN")


def _set_env(monkeypatch, env):
    for key in BENCH_KEYS:
        monkeypatch.delenv(key, raising=False)
    monkeypatch.setenv("CUDA_VISIBLE_DEVICES", "")
    for key, value in env.items():
        monkeypatch.setenv(key, value)


def test_plan_keeps_the_jax_scripts_families_in_order():
    assert list(bf.PLAN) == list(_jax_plan())


@pytest.mark.parametrize("family", list(_jax_plan()))
def test_plan_puts_bf16_first_and_the_jax_points_after_it(family):
    """One 80 GB card holds every family in bf16, so that point leads; the
    JAX script's points (chosen for 16 GB) follow with their tags, their
    environment and their order."""
    theirs = [(tag, dict(extra)) for tag, extra in _jax_plan()[family]]
    ours = [(tag, dict(extra)) for tag, extra in bf.PLAN[family]]
    assert ours[0] == ("bf16", {})
    assert ours == [("bf16", {})] + [p for p in theirs if p != ("bf16", {})]
    assert len({tag for tag, _ in ours}) == len(ours)


def test_flags_and_defaults_are_the_jax_scripts_but_for_the_out_file():
    ours = (REPO / "flmm_tpu_torch" / "bench_families.py").read_text()
    for line in ('"--families", default=",".join(PLAN)',
                 '"--sam-size", type=int, default=1024',
                 '"--timeout", type=int, default=4200'):
        assert line in JAX_SCRIPT and line in ours
    assert 'REPO / "BENCH_FAMILIES.json"' in JAX_SCRIPT
    assert bf.DEFAULT_OUT == REPO / "BENCH_FAMILIES_TORCH.json"
    assert "BENCH_FAMILIES_TORCH.json" in (
        REPO / ".gitignore").read_text().splitlines()
    assert '"--device", default="cuda"' in ours and '"--seed"' in ours


def test_run_one_on_the_cpu_returns_the_benchs_row_with_family_and_mode(
        monkeypatch):
    """The caller's BENCH_* variables reach the child beside the point's."""
    _set_env(monkeypatch, {**TINY_ENV, "BENCH_GLOBAL_KERNEL": "v4",
                           "BENCH_BS": "4"})
    row = bf.run_one("hpt", "bf16_bs1", {"BENCH_BS": "1"}, 128, 300, "cpu", 3)
    assert "error" not in row, row
    assert (row["family"], row["mode"], row["preset"]) == (
        "hpt", "bf16_bs1", "tiny")
    assert (row["bs"], row["iters"], row["sam_size"],
            row["global_kernel"]) == (1, 1, 128, "v4")
    assert row["metric"] == "grounded_images_per_sec_per_chip"
    assert row["value"] > 0 and row["plain"]["value"] > 0
    assert row["device"].startswith("cpu")
    assert not any(row["launches"].values())
    assert "sam_global_attention_v4" in row["launches"]


@pytest.mark.parametrize("family, extra, words", [
    # the int8 points named the decoder as not ported until it was; they
    # now give their row, the decoder's projections int8
    ("mgm", dict(bf.INT8), ("int8_llm",)),
    ("llava", dict(bf.INT8), ("int8_llm",)),
])
def test_what_is_not_ported_gives_an_error_row_that_says_so(
        family, extra, words, monkeypatch):
    """The ``int8_llm`` points (``BENCH_QUANT_LLM=1``) run at the tiny size:
    llava through the fabricated int8 decoder, mgm quantising its own."""
    _set_env(monkeypatch, TINY_ENV)
    row = bf.run_one(family, words[0], extra, 128, 300, "cpu")
    assert "error" not in row, row
    assert (row["family"], row["mode"], row["preset"], row["bs"]) == (
        family, "int8_llm", "tiny", 4)  # INT8 sets BENCH_BS 4,2,1
    assert row["value"] > 0 and row["plain"]["value"] > 0
    assert not any(row["launches"].values())


def test_mgm_gives_a_bf16_row_on_the_cpu(monkeypatch):
    """The family the JAX script lists first after DeepSeek-VL runs its
    bf16 point: ``synthetic_samples`` through the MGM batch builder, the
    plain path on host clocks."""
    _set_env(monkeypatch, TINY_ENV)
    row = bf.run_one("mgm", "bf16", {}, 128, 300, "cpu")
    assert "error" not in row, row
    assert (row["family"], row["mode"], row["preset"], row["bs"],
            row["sam_size"]) == ("mgm", "bf16", "tiny", 2, 128)
    assert row["value"] > 0 and row["plain"]["value"] > 0
    assert not any(row["launches"].values())


def test_a_child_that_outlives_the_timeout_gives_a_timeout_row(monkeypatch):
    def expired(cmd, **kw):
        assert kw["timeout"] == 7 and kw["cwd"] == str(REPO)
        assert cmd[1:3] == ["-m", "flmm_tpu_torch.bench"]
        assert kw["env"]["BENCH_FAMILY"] == "llava"
        assert kw["env"]["BENCH_SAM_SIZE"] == "448"
        raise subprocess.TimeoutExpired(cmd, kw["timeout"])

    monkeypatch.setattr(bf.subprocess, "run", expired)
    assert bf.run_one("llava", "bf16", {}, 448, 7) == {
        "family": "llava", "mode": "bf16", "error": "timeout"}


def test_the_first_good_point_ends_a_family_and_out_is_merged(
        monkeypatch, tmp_path, capsys):
    """scripts/bench_families.py:68-83: rows of the same (family, mode) are
    replaced, the others kept, the file rewritten after every point."""
    out = tmp_path / "rows.json"
    out.write_text(json.dumps({"sam_size": 1024, "rows": [
        {"family": "deepseek_vl", "mode": "bf16", "value": 1.0},
        {"family": "llava_next", "mode": "int8_llm", "error": "old"},
        {"family": "llava_next", "mode": "bf16_bs1", "value": 2.0}]}))
    calls = []

    def fake(family, tag, extra, sam_size, timeout, device, seed):
        calls.append((family, tag, sam_size, timeout, device, seed))
        assert json.loads(out.read_text())["rows"]  # written as it goes
        if tag == "bf16" and family == "llava_next":
            return {"family": family, "mode": tag, "error": "out of memory"}
        return {"family": family, "mode": tag, "value": 3.0}

    monkeypatch.setattr(bf, "run_one", fake)
    results = bf.main(["--families", "llava_next,hpt", "--out", str(out),
                       "--sam-size", "768", "--timeout", "9", "--seed", "5"])
    assert calls == [("llava_next", "bf16", 768, 9, "cuda", 5),
                     ("llava_next", "int8_llm", 768, 9, "cuda", 5),
                     ("hpt", "bf16", 768, 9, "cuda", 5)]
    assert json.loads(out.read_text()) == results
    assert results["sam_size"] == 1024  # the file's, as in the JAX script
    assert results["rows"] == [
        {"family": "deepseek_vl", "mode": "bf16", "value": 1.0},
        {"family": "llava_next", "mode": "bf16_bs1", "value": 2.0},
        {"family": "llava_next", "mode": "bf16", "error": "out of memory"},
        {"family": "llava_next", "mode": "int8_llm", "value": 3.0},
        {"family": "hpt", "mode": "bf16", "value": 3.0}]
    lines = capsys.readouterr().out.strip().splitlines()
    assert lines[0] == "== llava_next [bf16] ==" and len(lines) == 6
    assert json.loads(lines[-1]) == results["rows"][-1]


def test_a_ported_family_without_a_headline_fails_the_run_and_mgm_does_not(
        monkeypatch, tmp_path):
    """Every family of ``PLAN`` is ported now, mgm too: a family whose
    points all fail ends the run non-zero, after every row is written."""
    monkeypatch.setattr(bf, "run_one", lambda family, tag, *a: {
        "family": family, "mode": tag, "error": "no"})
    out = tmp_path / "rows.json"
    with pytest.raises(SystemExit, match="'mgm'"):
        bf.main(["--families", "mgm", "--out", str(out)])
    with pytest.raises(SystemExit, match="'mgm', 'hpt'"):
        bf.main(["--families", "mgm,hpt", "--out", str(out)])
    rows = json.loads(out.read_text())["rows"]
    assert [(r["family"], r["mode"]) for r in rows] == [
        ("mgm", "bf16"), ("hpt", "bf16"), ("hpt", "int8_llm")]


def test_main_on_the_cpu_runs_children_and_stops_at_the_headline(
        monkeypatch, tmp_path, capsys):
    _set_env(monkeypatch, TINY_ENV)
    out = tmp_path / "rows.json"
    results = bf.main(["--families", "mgm,llava", "--sam-size", "128",
                       "--device", "cpu", "--out", str(out)])
    assert results == json.loads(out.read_text())
    assert results["sam_size"] == 128
    mgm, llava = results["rows"]
    assert "error" not in mgm and (mgm["mode"], mgm["preset"]) == (
        "bf16", "tiny")
    assert (llava["family"], llava["mode"], llava["preset"], llava["bs"]) == (
        "llava", "bf16", "tiny", 2)
    assert "error" not in llava
    assert "== llava [bf16_bs1] ==" not in capsys.readouterr().out


def test_module_gives_error_rows_and_exits_non_zero_without_a_card(tmp_path):
    env = {k: v for k, v in os.environ.items() if k not in BENCH_KEYS}
    env.update(CUDA_VISIBLE_DEVICES="", **TINY_ENV)
    out = tmp_path / "rows.json"
    proc = subprocess.run(
        [sys.executable, "-m", "flmm_tpu_torch.bench_families", "--families",
         "deepseek_vl", "--out", str(out)], cwd=REPO, env=env,
        capture_output=True, text=True, timeout=300)
    assert proc.returncode != 0
    assert "no serving point of ['deepseek_vl'] ran" in proc.stderr
    (row,) = json.loads(out.read_text())["rows"]
    assert "no CUDA device" in row["error"] and '"metric"' not in proc.stdout
