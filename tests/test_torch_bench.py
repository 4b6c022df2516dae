"""The port's end-to-end bench (``python bench_torch.py`` =
``flmm_tpu_torch.bench``) against the JAX package's ``bench.py`` on the CPU.

At the ``tiny`` presets both ``build`` functions are driven through the same
BENCH_* environment: the batches must be bit for bit equal, and the port's
forward on ``from_jax`` of the JAX script's parameters must agree with the
JAX forward within 1e-3 (f32, other summation orders through the whole
stack, as the other slice tests hold).  For the flagship presets the config
logic (image-block alignment, sequence bound, SAM size, encoder overrides)
is compared field by field without building parameters.  The rows' times are
host-clock times of plain code here; the card's rows come from the script
run on the card.
"""

import dataclasses
import json
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
from flmm_tpu_torch import bench, registry
from flmm_tpu_torch.convert.from_jax import from_jax

REPO = pathlib.Path(__file__).resolve().parent.parent
SLICE_TOL = 1e-3
TINY_ENV = {"BENCH_PRESET": "tiny", "BENCH_SAM_SIZE": "128",
            "BENCH_SEQ": "112"}
ROW_KEYS = ["metric", "value", "unit", "vs_baseline", "bs", "ms_mean",
            "ms_min", "ms_max", "iters", "peak_gb", "plain", "family",
            "preset", "sam_size", "global_kernel", "launches", "device"]


def _set_env(monkeypatch, env):
    for key in ("BENCH_FAMILY", "BENCH_PRESET", "BENCH_SAM_SIZE", "BENCH_BS",
                "BENCH_ITERS", "BENCH_SEQ", "BENCH_GLOBAL_BLOCK",
                "BENCH_GLOBAL_KERNEL", "BENCH_QUANT_LLM"):
        monkeypatch.delenv(key, raising=False)
    for key, value in env.items():
        monkeypatch.setenv(key, value)


def _assert_same_fields(want, got):
    """Every field of two config dataclasses, nested ones included, but
    dtypes (jnp vs torch)."""
    pairs = [(want, got)]
    while pairs:
        w, g = pairs.pop()
        for f in dataclasses.fields(w):
            a, b = getattr(w, f.name), getattr(g, f.name)
            if dataclasses.is_dataclass(a):
                pairs.append((a, b))
            elif f.name != "dtype":
                assert b == a, (type(w).__name__, f.name, a, b)


def _flat(tree, prefix=""):
    if isinstance(tree, dict):
        for k, v in tree.items():
            yield from _flat(v, f"{prefix}/{k}")
    else:
        yield prefix, tree


@pytest.mark.parametrize("family", ["deepseek_vl", "llava", "hpt", "mgm"])
def test_tiny_build_gives_the_jax_batch_and_forward(family, monkeypatch):
    _set_env(monkeypatch, {"BENCH_FAMILY": family, **TINY_ENV})
    _, jparams, jbatch = jbench.build(2)
    knobs = bench.Knobs.from_env()
    model, cfg, params, batch = bench.build(2, knobs, "cpu")
    assert "lm_head" not in params["frozen"]["llm"]
    assert "lm_head" not in jparams["frozen"]["llm"]

    want = dict(_flat(jax.device_get(jbatch)))
    got = dict(_flat(batch))
    assert sorted(got) == sorted(want)
    for key, value in want.items():
        assert got[key].dtype == from_jax(np.asarray(value)).dtype, key
        np.testing.assert_array_equal(got[key].numpy(), np.asarray(value),
                                      err_msg=key)

    jcfg = jregistry.get_config(family, "tiny")
    _assert_same_fields(jcfg, cfg)
    jout = jax.device_get(jax.jit(
        lambda p, b: jregistry.get_model(family).forward(p, jcfg, b))(
            jparams, jbatch))
    with torch.no_grad():
        out = model.forward(from_jax(jax.device_get(jparams)), cfg, batch)
    for key in ("coarse_logits", "sam_logits", "iou_pred", "hidden"):
        np.testing.assert_allclose(out[key].numpy(), np.asarray(jout[key]),
                                   atol=SLICE_TOL, rtol=SLICE_TOL,
                                   err_msg=key)


@pytest.mark.parametrize("family, img_start, seq_len", [
    ("deepseek_vl", 5, 672),    # the raw prompt layout, eager capture
    ("llava", 35, 672),         # 35 + 576 + 40 fits
    ("hpt", 128, 1280),         # 1024 image tokens: aligned, 1192 -> 1280
    ("llava_next", 128, 672),   # flash capture: aligned; the builder sizes S
    ("mgm", 4, 672),            # single crop: eager; the builder sizes S
])
def test_flagship_config_logic_mirrors_bench_py(family, img_start, seq_len):
    """bench.py:168-198 and :230-240 on the JAX registry, spelled out here
    (its ``build`` cannot be asked without building 1-8B parameters)."""
    preset = jbench.FLAGSHIP[family]
    assert bench.FLAGSHIP == jbench.FLAGSHIP
    knobs = bench.Knobs(family=family, sam_size=448, global_block=True,
                        global_kernel="v11")
    cfg, got_preset, native = bench.resolve_config(knobs)
    assert got_preset == preset

    jcfg = jregistry.get_config(family, preset)
    jbase = jcfg.base if hasattr(jcfg, "base") else jcfg
    assert native == jbase.img_start
    if jbase.img_start != img_start:
        jcfg = jregistry.get_config(family, preset, img_start=img_start)
    jcfg = jregistry.with_sam_size(jcfg, 448)
    jbase = jcfg.base if hasattr(jcfg, "base") else jcfg
    new_base = dataclasses.replace(jbase, sam=dataclasses.replace(
        jbase.sam, encoder=dataclasses.replace(
            jbase.sam.encoder, global_block_fused=True, global_kernel="v11")))
    jcfg = (dataclasses.replace(jcfg, base=new_base)
            if hasattr(jcfg, "base") else new_base)
    _assert_same_fields(jcfg, cfg)
    base = cfg.base if hasattr(cfg, "base") else cfg
    assert base.img_start == img_start
    assert (base.sam.encoder.img_size, base.sam.encoder.global_kernel,
            base.sam.encoder.global_block_fused) == (448, "v11", True)
    assert bench.resolve_seq_len(cfg, family, 672) == seq_len
    # the defaults leave the preset alone
    plain_cfg, _, _ = bench.resolve_config(bench.Knobs(family=family))
    enc = (plain_cfg.base if hasattr(plain_cfg, "base")
           else plain_cfg).sam.encoder
    assert (enc.img_size, enc.global_kernel, enc.global_block_fused) == (
        1024, "v8", False)


def test_seq_len_bound():
    cfg, _, _ = bench.resolve_config(bench.Knobs(family="hpt"))
    assert bench.resolve_seq_len(cfg, "hpt", 2048) == 2048
    tiny, _, _ = bench.resolve_config(bench.Knobs(preset="tiny"))
    # img_start 3 is not aligned: the bound itself, 3 + 64 + 40
    assert bench.resolve_seq_len(tiny, "deepseek_vl", 50) == 107


def test_knobs_read_the_environment_with_bench_pys_names(monkeypatch):
    _set_env(monkeypatch, {})
    assert bench.Knobs.from_env() == bench.Knobs() == bench.Knobs(
        "deepseek_vl", None, 1024, 672, False, None, False)
    _set_env(monkeypatch, {
        "BENCH_FAMILY": "hpt", "BENCH_PRESET": "air", "BENCH_SAM_SIZE": "448",
        "BENCH_SEQ": "900", "BENCH_GLOBAL_BLOCK": "1",
        "BENCH_GLOBAL_KERNEL": "v11", "BENCH_QUANT_LLM": "1"})
    assert bench.Knobs.from_env() == bench.Knobs(
        "hpt", "air", 448, 900, True, "v11", True)
    src = (REPO / "bench.py").read_text()
    for name in ("BENCH_FAMILY", "BENCH_PRESET", "BENCH_SAM_SIZE", "BENCH_BS",
                 "BENCH_ITERS", "BENCH_SEQ", "BENCH_GLOBAL_BLOCK",
                 "BENCH_GLOBAL_KERNEL", "BENCH_QUANT_LLM"):
        assert name in src and name in (
            REPO / "flmm_tpu_torch" / "bench.py").read_text()


def test_main_prints_one_json_row_with_bench_pys_keys_first(
        monkeypatch, capsys):
    _set_env(monkeypatch, {**TINY_ENV, "BENCH_BS": "2,1", "BENCH_ITERS": "2",
                           "BENCH_GLOBAL_KERNEL": "v11"})
    row = bench.main(["--device", "cpu"])
    lines = capsys.readouterr().out.strip().splitlines()
    assert len(lines) == 1 and json.loads(lines[0]) == row
    assert list(row) == ROW_KEYS
    assert list(row)[:5] == ["metric", "value", "unit", "vs_baseline", "bs"]
    assert row["metric"] == "grounded_images_per_sec_per_chip"
    assert (row["unit"], row["bs"], row["iters"]) == ("img/s", 2, 2)
    assert (row["family"], row["preset"], row["sam_size"],
            row["global_kernel"]) == ("deepseek_vl", "tiny", 128, "v11")
    assert list(row["plain"]) == ["value", "unit", "ms_mean", "ms_min",
                                  "ms_max", "iters", "peak_gb"]
    assert row["value"] > 0 and row["plain"]["value"] > 0
    assert row["vs_baseline"] == pytest.approx(
        row["value"] / row["plain"]["value"], abs=2e-3)
    assert 0 < row["ms_min"] <= row["ms_mean"] <= row["ms_max"]
    # on the CPU every wrapper takes its plain version: nothing is launched
    assert set(row["launches"]) == set(bench.WRAPPERS)
    assert not any(row["launches"].values())
    assert row["device"].startswith("cpu")


def test_distinct_inputs_per_forward():
    _, _, _, batch = bench.build(1, bench.Knobs(preset="tiny", sam_size=128,
                                                seq_len=112), "cpu")
    batches = bench.distinct_batches(batch, 3)
    px = [b["pixel_values"] for b in batches]
    assert not torch.equal(px[0], px[1]) and not torch.equal(px[1], px[2])
    assert torch.allclose(px[2], batch["pixel_values"] + 0.003)
    assert batches[0]["input_ids"] is batch["input_ids"]


def test_llava_next_builds_through_the_anyres_batch():
    knobs = bench.Knobs(family="llava_next", preset="tiny", sam_size=128)
    model, cfg, params, batch = bench.build(2, knobs, "cpu")
    assert "tiles" in batch and "pixel_values" not in batch
    batches = bench.distinct_batches(batch, 1)
    assert torch.allclose(batches[0]["tiles"], batch["tiles"] + 0.001)
    with torch.no_grad():
        out = model.forward(params, cfg, batches[0])
    assert out["sam_logits"].shape[:2] == (2, 8)
    assert torch.isfinite(out["sam_logits"]).all()


def test_every_global_kernel_name_runs_through_build():
    for name in ("v8", "v1", "v2", "v3", "v4", "v6", "v7", "v11"):
        cfg, _, _ = bench.resolve_config(bench.Knobs(global_kernel=name))
        assert cfg.sam.encoder.global_kernel == name
    with pytest.raises(NotImplementedError, match="global_kernel 'v5'"):
        bench.resolve_config(bench.Knobs(global_kernel="v5"))


def test_mgm_and_the_int8_decoder_raise(monkeypatch):
    """The int8 decoder raises; the mgm family, ported since, resolves (its
    flagship single-crop preset captures eagerly, the HD preset's 2880-token
    image block moves to 128 and captures through K5)."""
    cfg, preset, start = bench.resolve_config(bench.Knobs(family="mgm"))
    assert (preset, start, cfg.base.img_start) == ("gemma_2b", 4, 4)
    assert not cfg.base.llm.use_flash_capture
    cfg, _, start = bench.resolve_config(bench.Knobs(
        family="mgm", preset="vicuna_7b_hd"))
    assert (start, cfg.base.img_start) == (35, 128)
    assert cfg.base.llm.use_flash_capture and cfg.num_crops == 5
    with pytest.raises(NotImplementedError, match="ROADMAP.md"):
        bench.resolve_config(bench.Knobs(quant_llm=True))
    _set_env(monkeypatch, {"BENCH_QUANT_LLM": "1", **TINY_ENV})
    with pytest.raises(NotImplementedError, match="ROADMAP.md"):
        bench.main(["--device", "cpu"])
    _set_env(monkeypatch, {"BENCH_FAMILY": "nope"})
    with pytest.raises(ValueError, match="BENCH_FAMILY 'nope'"):
        bench.main(["--device", "cpu"])


def test_only_out_of_memory_falls_through_to_the_next_batch_size(
        monkeypatch, capsys):
    _set_env(monkeypatch, {**TINY_ENV, "BENCH_BS": "4,2", "BENCH_ITERS": "1"})
    calls = []

    def fake_run(bs, *args):
        calls.append(bs)
        if bs == 4:
            raise torch.cuda.OutOfMemoryError("out of memory")
        return {"bs": bs}

    monkeypatch.setattr(bench, "run", fake_run)
    monkeypatch.setattr(torch.cuda, "empty_cache", lambda: None)
    assert bench.main(["--device", "cpu"]) == {"bs": 2}
    assert calls == [4, 2]
    assert "ran out of device memory" in capsys.readouterr().err

    def broken_run(bs, *args):
        raise RuntimeError("a kernel failed to launch")

    monkeypatch.setattr(bench, "run", broken_run)
    with pytest.raises(RuntimeError, match="failed to launch"):
        bench.main(["--device", "cpu"])


@pytest.mark.parametrize("args", [["bench_torch.py"],
                                  ["-m", "flmm_tpu_torch.bench"]])
def test_script_exits_non_zero_without_a_card(args):
    env = {"CUDA_VISIBLE_DEVICES": "", "PATH": "/usr/bin:/bin"}
    proc = subprocess.run([sys.executable, *args], cwd=REPO, env=env,
                          capture_output=True, text=True, timeout=300)
    assert proc.returncode != 0
    assert "no CUDA device" in proc.stderr and '"metric"' not in proc.stdout
