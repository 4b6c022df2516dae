"""The kernel bench entry point (``python -m flmm_tpu_torch.kernel_bench``)
on the CPU: every op at the tiny presets' size with the plain versions
(``--device cpu --tiny``), the row keys of the JAX script, the agreement
rows, the variant resolver and the refusal to run without a card.

The rows' times are host-clock times of plain code here and say so
(``device: cpu``); the card's rows come from chip_smoke.py and from the
module run on the card.
"""

import json
import math
import pathlib
import subprocess
import sys

import pytest
import torch

from flmm_tpu_torch import kernel_bench as kb

REPO = pathlib.Path(__file__).resolve().parent.parent
TIMING = {"ms", "ms_min", "ms_max", "iters", "device"}
# op -> [(variant, the keys beside op / variant / the timing keys)], as
# scripts/kernel_bench.py prints them
ROWS = {
    "window": [("v1", {"max_err_vs_v1"}), ("v6", {"max_err_vs_v1"}),
               ("v7", {"max_err_vs_v1"})],
    "global": [("v3", {"max_err_vs_v1"}), ("v6", {"max_err_vs_v1"})],
    "encoder": [("w=v6,g=v6", set())],
    "wb": [("flash", {"depth", "ms_per_layer"}),
           ("whole_block", {"depth", "ms_per_layer"}),
           ("agreement", {"corr", "max_abs_diff", "scale"})],
    "gb": [("dense", {"depth", "bs", "ms_per_layer"}),
           ("whole_block", {"depth", "bs", "ms_per_layer"}),
           ("agreement", {"corr", "max_abs_diff", "scale"})],
    "boundary": [("plain dewin+win pair", {"bs"}),
                 ("kernel dewin+win pair", {"bs", "max_abs_diff"})],
    "tower": [("total", set()), ("plain", set()), ("pad128", set())],
    "decoder": [("eager S=96", set()), ("eager S=256 aligned", set()),
                ("flash S=256 aligned", set())],
    "window_path": [("v9_path", set()), ("v10_path", set())],
    "heads": [("unet+sam", set())],
    "rtt": [(None, set())],
}


def _run(op, bs=2, **kw):
    g = torch.Generator().manual_seed(0)
    return kb.run([op], bs, torch.device("cpu"), g, iters=1, depth=3,
                  geo=kb.tiny(), **kw)


@pytest.mark.parametrize("op", kb.OPS)
def test_op_rows_at_the_tiny_size(op):
    rows = _run(op)
    assert len(rows) == len(ROWS[op])
    for row, (variant, extra) in zip(rows, ROWS[op]):
        assert row.get("variant") == variant
        timed = variant != "agreement"
        want = {"op"} | extra | (TIMING if timed else set())
        assert set(row) - {"variant"} == want, row
        if timed:
            assert row["device"] == "cpu" and row["iters"] == 1
            assert 0 < row["ms_min"] <= row["ms"] <= row["ms_max"]
            assert math.isfinite(row["ms"])
    json.dumps(rows)  # every value is a plain number or string
    if op in ("wb", "gb"):
        assert rows[-1]["corr"] >= 0.999 and rows[-1]["scale"] > 0
        assert rows[0]["depth"] == 3
    if op == "boundary":
        assert rows[-1]["max_abs_diff"] == 0.0
    if op == "global":
        assert all(r["max_err_vs_v1"] == 0.0 for r in rows)  # v3 is v6
    if op == "window":
        # against v1, the first variant: v6 adds the same bf16 bias rows in
        # another order; v7 keeps f32 bias rows for these f32 inputs
        errs = [r["max_err_vs_v1"] for r in rows]
        assert errs[0] == 0.0 and errs[1] <= 2e-6 and 0 < errs[2] < 2e-2


def test_ops_are_the_jax_scripts():
    src = (REPO / "scripts" / "kernel_bench.py").read_text()
    for op in kb.OPS:
        assert f'"{op}" in what' in src


def test_unported_is_empty():
    assert kb.UNPORTED == {"sam_window_attention": (),
                           "sam_global_attention": ()}
    # every name of the JAX package resolves; another name is no variant at
    # all
    with pytest.raises(ValueError, match="no variant 'v5'"):
        kb.kernel_fn("sam_global_attention", "v5")
    with pytest.raises(ValueError, match="no variant 'v11'"):
        kb.kernel_fn("sam_window_attention", "v11")


@pytest.mark.parametrize("name", ["v8", "v1", "v2", "v3", "v4", "v6", "v7",
                                  "v11"])
def test_the_ported_global_variants_resolve_and_run(name):
    fn = kb.kernel_fn("sam_global_attention", name)
    assert fn.__name__ == ("sam_global_attention" if name == "v1"
                           else f"sam_global_attention_{name}")
    rows = _run("global", global_variants=("v8", name))
    assert [r["variant"] for r in rows] == ["v8", name]
    # f32 at the tiny size; v1 and v2 round their bias rows to bf16, v4 its
    # scores and probabilities
    assert rows[1]["max_err_vs_v1"] < (2e-2 if name in ("v1", "v2", "v4")
                                       else 1e-5)
    assert _run("encoder", global_kernel=name)[0]["variant"] == f"w=v6,g={name}"


@pytest.mark.parametrize("name", ["v9", "v1", "v2", "v6", "v7", "v8", "v3",
                                  "v4", "v5"])
def test_the_ported_window_variants_resolve_and_run(name):
    fn = kb.kernel_fn("sam_window_attention", name)
    assert fn.__name__ == ("sam_window_attention" if name == "v1"
                           else f"sam_window_attention_{name}")
    rows = _run("window", window_variants=("v9", name))
    assert [r["variant"] for r in rows] == ["v9", name]
    # f32 at the tiny size; v1 and v6 round their bias rows to bf16, v2 its
    # dense bias, v4 its scores and probabilities
    assert rows[1]["max_err_vs_v1"] < (2e-2 if name in ("v1", "v2", "v6",
                                                        "v4") else 1e-5)
    assert _run("encoder", window_kernel=name)[0]["variant"] == f"w={name},g=v6"
    assert _run("heads", window_kernel=name)[0]["variant"] == "unet+sam"


def test_unported_variants_raise_before_anything_is_timed(capsys):
    # no name of the JAX package is left unported: what it does not have is
    # no variant
    for flag, name in (("--window-variants", "v11"),
                       ("--window-kernel", "v11"),
                       ("--global-variants", "v5"),
                       ("--global-kernel", "v5")):
        with pytest.raises(ValueError, match=f"no variant '{name}'"):
            kb.main(["--device", "cpu", "--tiny", "--what", "rtt", flag,
                     name])
    assert '"op"' not in capsys.readouterr().out
    with pytest.raises(ValueError, match="window_path"):
        kb.kernel_fn("sam_window_attention", "v10")


def test_cli_prints_the_card_line_then_one_json_line_per_row(capsys):
    rows = kb.main(["--device", "cpu", "--tiny", "--bs", "1", "--iters", "2",
                    "--what", "rtt,boundary,window_path", "--seed", "3"])
    lines = capsys.readouterr().out.strip().splitlines()
    assert lines[0].startswith("cpu")
    assert [json.loads(line) for line in lines[1:]] == rows
    # the JAX script's order, whatever order --what names
    assert [r["op"] for r in rows] == ["boundary"] * 2 + ["window_path"] * 2 \
        + ["rtt_floor"]
    assert all(r["iters"] == 2 for r in rows)


def test_defaults_are_the_jax_scripts_but_for_the_unported_variants():
    """Every flag of scripts/kernel_bench.py:488-494 with its default, the
    window flags included now that v1, v6 and v7 are ported: no default
    names an unported variant."""
    src = (REPO / "scripts" / "kernel_bench.py").read_text()
    for line in ('"--what", default="window,global"',
                 '"--bs", type=int, default=8',
                 '"--depth", type=int, default=12',
                 '"--window-variants", default="v1,v6,v7"',
                 '"--global-variants", default="v3,v6"',
                 '"--window-kernel", default="v6"',
                 '"--global-kernel", default="v6"'):
        assert line in src
        assert line in (REPO / "flmm_tpu_torch" / "kernel_bench.py").read_text()


def test_full_geometry_is_the_jax_scripts():
    geo = kb.full()
    assert (geo.window_side, geo.window_grid, geo.global_side) == (14, 64, 64)
    assert (geo.sam.embed_dim, geo.sam.num_heads, geo.sam.head_dim,
            geo.sam.window_size, geo.sam.grid, geo.sam.depth) == (
                1024, 16, 64, 14, 64, 24)
    assert (geo.seq_len, geo.aligned, geo.masks, geo.text_tokens) == (
        672, (768, 128), 8, 12)
    assert geo.cfg.vision.seq_len == 576 and geo.cfg.llm.head_dim == 128


def test_module_refuses_to_run_without_a_card():
    env = {"CUDA_VISIBLE_DEVICES": "", "PATH": "/usr/bin:/bin"}
    proc = subprocess.run(
        [sys.executable, "-m", "flmm_tpu_torch.kernel_bench", "--what", "rtt"],
        cwd=REPO, env=env, capture_output=True, text=True, timeout=300)
    assert proc.returncode != 0
    assert "no CUDA device" in proc.stderr and '"op"' not in proc.stdout
