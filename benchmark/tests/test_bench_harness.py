"""The benchmark's harness on the CPU: cells, configurations, mixes and
metrics read as data; the traffic generator; the operation counts against
``FlopCounterMode``; the float32 reference against the program's plain
path at the tiny presets; the faults and the control coming out not
correct; no JAX in the run's process."""

from __future__ import annotations

import ast
import json
import pathlib
import shutil
import subprocess
import sys
import time

import numpy as np
import pytest
import torch

from benchmark import run as bench_run
from benchmark.harness import check, core, faults, flops, program, spec
from benchmark.harness import traffic as gen
from benchmark.harness import weights
from benchmark.reference import layers as rnn
from benchmark.reference import model as rmodel
from benchmark.tests import tiny

ROOT = spec.BENCH.parent
MANIFEST = spec.read_json(ROOT / "BENCHMARK.json")
CELL_NAMES = [w["name"] for w in MANIFEST["workloads"]]
SEED = 2**31 + 12345  # larger than 32 signed bits hold


@pytest.fixture(scope="module")
def tiny_root(tmp_path_factory):
    torch.set_num_threads(2)
    root = tmp_path_factory.mktemp("bench")
    return root, tiny.make(root)


def tiny_cell(tiny_root, name):
    root, manifest = tiny_root
    return spec.load_cell(name, manifest, root)


# ------------------------------------------------------------------ data


@pytest.mark.parametrize("name", CELL_NAMES)
def test_cell_loads_as_data(name):
    cell = spec.load_cell(name, MANIFEST)
    assert cell.config["name"] == cell.spec["config"]
    program.config(cell.config)  # the preset matches the file field by field
    assert {m["name"] for m in cell.end_to_end} >= {"setup_s"}
    assert len(cell.end_to_end) >= 2 and cell.per_layer
    for m in cell.per_layer:
        assert m["moves"] in {e["name"] for e in cell.end_to_end}


@pytest.mark.parametrize("name", [m["name"] for m in MANIFEST["per_layer"]])
def test_reader_names_what_it_wraps(name):
    """Each wrapped attribute exists, so a rename fails loudly."""
    import importlib

    reader = spec.load_reader(spec.BENCH, name)
    for target, expect in getattr(reader, "WRAPS", {}).items():
        mod, _, attr = target.partition(":")
        attr = attr.split("().")[0]
        assert callable(getattr(importlib.import_module(mod), attr))
        assert expect == "images" or isinstance(expect, int)
    assert isinstance(getattr(reader, "KERNELS", ()), tuple)


def test_new_cell_mix_and_metric_are_data_only(tmp_path):
    """A cell, a mix and a metric added as files and manifest entries load
    with no change to the harness."""
    root = tmp_path / "benchmark"
    shutil.copytree(spec.BENCH, root, ignore=shutil.ignore_patterns(
        "__pycache__", "tests"))
    (root / "traffic/short.json").write_text(json.dumps(
        {"phrases": {"values": [1, 2], "shares": [0.5, 0.5]},
         "phrase_tokens": {"values": [2, 3], "shares": [0.5, 0.5]},
         "narrative_tokens": None,
         "image_hw": {"values": [[200, 300]], "shares": [1.0]}}))
    (root / "workloads/dsvl13b-serve-short.json").write_text(json.dumps(
        {"config": "deepseek_vl_1_3b", "traffic": "short", "mode": "serve",
         "batch": 4, "pool": 4, "seq_len": 640, "max_masks": 2,
         "text_per_mask": 3, "check_requests": 2, "trace_requests": 2,
         "limits": {}}))
    (root / "metrics/images_a_request.py").write_text(
        'UNIT = "img"\n\n\ndef read(run):\n'
        '    return run.items[0]["images"] if run.items else None\n')
    manifest = json.loads(json.dumps(MANIFEST))
    manifest["workloads"].append({"name": "dsvl13b-serve-short",
                                  "config": "deepseek_vl_1_3b",
                                  "traffic": "short", "chips": 1,
                                  "why": "short"})
    manifest["per_layer"].append({"name": "images_a_request", "unit": "img",
                                  "better": "higher", "source": "host_clock",
                                  "layer": "device",
                                  "moves": "grounded_img_per_s",
                                  "workloads": ["dsvl13b-serve-short"]})
    for m in manifest["end_to_end"]:
        if m["name"] in ("grounded_img_per_s", "request_ms_p90"):
            m["workloads"].append("dsvl13b-serve-short")
    cell = spec.load_cell("dsvl13b-serve-short", manifest, root)
    assert cell.traffic["phrases"]["values"] == [1, 2]
    assert [m["name"] for m in cell.per_layer] == ["images_a_request"]
    assert cell.readers["images_a_request"].UNIT == "img"


# --------------------------------------------------------------- traffic

MIXES = sorted(p.stem for p in (spec.BENCH / "traffic").glob("*.json"))
PROMPT = {"img_start": 5, "n_img": 16, "vocab": 1000}


def _sizes(reqs):
    """Each size's multiset over the requests: phrases an image, tokens a
    phrase, image heights, image widths."""
    samples = [s for r in reqs for s in r]
    return (sorted(len(s["spans"]) for s in samples),
            sorted(b - a for s in samples for a, b in s["spans"]),
            sorted(s["image"].shape[0] for s in samples),
            sorted(s["image"].shape[1] for s in samples))


@pytest.mark.parametrize("mix", MIXES)
def test_traffic_reproducible_and_in_range(mix):
    m = spec.resolve_traffic(spec.BENCH, mix)
    a = gen.requests(m, 3, 4, SEED, PROMPT)
    b = gen.requests(m, 3, 4, SEED, PROMPT)
    c = gen.requests(m, 3, 4, SEED + 1, PROMPT)
    for ra, rb in zip(a, b):
        for sa, sb in zip(ra, rb):
            for key in ("input_ids", "mask_ids", "masks", "image"):
                np.testing.assert_array_equal(sa[key], sb[key])
    # another seed: the same sizes in another order, other content
    assert _sizes(a) == _sizes(c)
    assert not all(np.array_equal(sa["image"], sc["image"])
                   for ra, rc in zip(a, c) for sa, sc in zip(ra, rc))
    parts = m.get("parts") or [{"mix": m}]
    phrases = {v for p in parts for v in p["mix"]["phrases"]["values"]}
    tokens = {v for p in parts for v in p["mix"]["phrase_tokens"]["values"]}
    for r in a:
        assert len(r) == 4
        for s in r:
            assert len(s["spans"]) in phrases
            for lo, hi in s["spans"]:
                assert hi - lo in tokens
                assert (s["mask_ids"][lo:hi] >= 0).all()
            shapes = {tuple(v) for p in parts
                      for v in p["mix"]["image_hw"]["values"]}
            assert s["image"].shape[:2] in shapes
            assert s["masks"].shape == (len(s["spans"]),
                                        *s["image"].shape[:2])
            n = PROMPT["img_start"] + PROMPT["n_img"] + 2
            assert (s["input_ids"][PROMPT["img_start"]:n - 2]
                    == gen.IMAGE_TOKEN).all()


def test_histogram_sizes_follow_their_shares():
    dist = {"values": [1, 2, 3], "shares": [0.04, 0.08, 0.88]}
    for n in (1, 7, 50, 333):
        got = gen.sizes(dist, n)
        assert len(got) == n and list(got) == sorted(got)
        for v, share in zip(dist["values"], dist["shares"]):
            assert abs(int((got == v).sum()) - share * n) < 1
    pairs = gen.sizes({"values": [[480, 640], [640, 427]],
                       "shares": [0.75, 0.25]}, 8)
    assert pairs.tolist() == [[480, 640]] * 6 + [[640, 427]] * 2


def test_mix_of_mixes_keeps_each_share_a_request():
    m = spec.resolve_traffic(spec.BENCH, "png_refcoco")
    for r in gen.requests(m, 4, 8, SEED, PROMPT):
        kinds = [s["file_name"].split("_")[0] for s in r]
        assert kinds.count("png") == kinds.count("refcoco") == 4


# ------------------------------------------------------ counts, reference


def _tiny_batch(tiny_root, cell_name, seed=SEED):
    cell = tiny_cell(tiny_root, cell_name)
    cfg = program.config(cell.config)
    b = program.base(cfg)
    reqs = gen.requests(cell.traffic, 1, cell.spec["batch"], seed,
                        {"img_start": cell.config["prompt_img_start"],
                         "n_img": b.num_img_tokens,
                         "vocab": b.llm.vocab_size})
    s = cell.spec
    sp = program.batch_spec(cell.config["family"], cfg, s["seq_len"],
                            s["max_masks"], s["text_per_mask"])
    return cell, cfg, reqs[0], program.build_batch(
        cell.config["family"], cfg, reqs[0], sp)


@pytest.mark.parametrize("cell_name", ["ds-serve", "ln-serve"])
def test_flop_counts_match_flop_counter(tiny_root, cell_name):
    """The counts of what the unfused path computes against
    FlopCounterMode on the program's plain forward, stage by stage and in
    all."""
    from torch.utils.flop_counter import FlopCounterMode

    from flmm_tpu_torch.models.frozen import grounding
    from flmm_tpu_torch.models.llm import decoder
    from flmm_tpu_torch.models.mask_head import unet
    from flmm_tpu_torch.models.sam import image_encoder
    from flmm_tpu_torch.models.vision import vit

    cell, cfg, _, batch = _tiny_batch(tiny_root, cell_name)
    family = cell.config["family"]
    params = weights.make(program.schema(family, cfg), 3, "cpu")
    tb = {k: ({kk: torch.from_numpy(vv) for kk, vv in v.items()}
              if isinstance(v, dict) else torch.from_numpy(v))
          for k, v in batch.items()}
    got = {}
    stages = {"tower": (vit, "forward"), "decoder": (decoder,
                                                     "forward_capture"),
              "sam_encoder": (image_encoder, "forward"),
              "unet": (unet, "forward")}
    originals = {}
    for stage, (mod, attr) in stages.items():
        fn = getattr(mod, attr)
        originals[stage] = (mod, attr, fn)

        def counted(*a, _fn=fn, _stage=stage, **k):
            with FlopCounterMode(display=False) as fc:
                out = _fn(*a, **k)
            got[_stage] = got.get(_stage, 0) + fc.get_total_flops()
            return out
        setattr(mod, attr, counted)
    try:
        with torch.no_grad():
            program.forward(family, cfg, params, tb)
    finally:
        for mod, attr, fn in originals.values():
            setattr(mod, attr, fn)
    with FlopCounterMode(display=False) as fc, torch.no_grad():
        program.forward(family, cfg, params, tb)
    want = flops.forward(cell.config["model"], family, batch, needed=False)
    for stage in stages:
        assert got[stage] == pytest.approx(want[stage], rel=1e-9), stage
    assert fc.get_total_flops() == pytest.approx(sum(want.values()),
                                                 rel=1e-9)
    needed = flops.forward(cell.config["model"], family, batch, needed=True)
    assert all(needed[k] <= want[k] for k in want)
    assert grounding  # the model module the forward ran


@pytest.mark.parametrize("cell_name", ["ds-serve", "ln-serve"])
def test_reference_matches_program_plain_path(tiny_root, cell_name):
    """The float32 reference, with its own batch built from the raw
    samples, against the program's plain forward at the tiny preset."""
    cell, cfg, raw, batch = _tiny_batch(tiny_root, cell_name)
    family = cell.config["family"]
    params = weights.make(program.schema(family, cfg), 3, "cpu")
    tb = check._tensors(batch, "cpu")
    with torch.no_grad():
        got = program.forward(family, cfg, params, tb)
        rb = check._tensors(check.ref_batch(cell, raw), "cpu")
        for key in ("input_ids", "attn_mask", "mask_ids", "text_idx"):
            assert torch.equal(rb[key], tb[key])
        ref_cfg = rnn.NS(cell.config["model"])
        own = rmodel.forward(weights.to_float32(params), family, ref_cfg, rb)
        want = rmodel.forward(weights.to_float32(params), family, ref_cfg,
                              rb, boxes=got["boxes"])
    # the reference's own boxes are the program's
    assert torch.allclose(own["boxes"], got["boxes"])
    gaps = check.serve_gaps(got, want, tb)
    assert gaps["coarse_gap"] < 1e-4 and gaps["sam_gap"] < 1e-4
    assert gaps["iou_gap"] < 1e-4 and gaps["box_gap"] == 0.0
    assert gaps["hidden_gap"] < 1e-5


def test_reference_loss_matches_program(tiny_root):
    cell, cfg, raw, batch = _tiny_batch(tiny_root, "ds-train")
    family = cell.config["family"]
    params = weights.make(program.schema(family, cfg), 3, "cpu")
    with torch.no_grad():
        got, _ = program.model(family).loss_fn(
            params, cfg, check._tensors(batch, "cpu"))
        want = rmodel.loss(weights.to_float32(params), family,
                           rnn.NS(cell.config["model"]),
                           check._tensors(check.ref_batch(cell, raw), "cpu"))
    assert float(got) == pytest.approx(float(want["loss"]), rel=1e-5)
    assert float(want["loss"]) == pytest.approx(
        float(want["coarse"] + want["sam"]), rel=1e-6)


def test_weights_reproducible_and_aligned():
    from flmm_tpu_torch import registry

    cfg = registry.get_config("deepseek_vl", "tiny")
    schema = program.schema("deepseek_vl", cfg)
    a = weights.make(schema, SEED, "cpu")
    b = weights.make(schema, SEED, "cpu")
    for (pa, ta), (pb, tb) in zip(weights.leaves(a), weights.leaves(b)):
        assert pa == pb and torch.equal(ta, tb)
        assert ta.data_ptr() % 16 == 0
    assert "lm_head" not in a["frozen"]["llm"]
    rel = a["frozen"]["sam_encoder"]["blocks"][0]["rel_pos_h"]
    assert 0.02 < float(rel.float().std()) < 0.1


# ------------------------------------------------------- the whole check


def _run(tiny_root, name, **plant):
    cell = tiny_cell(tiny_root, name)
    return bench_run.run_cell(cell, SEED, 1.0, False, "cpu",
                              time.perf_counter(), **plant)


@pytest.mark.parametrize("name", ["ds-serve", "ln-serve", "ds-train"])
def test_sound_run_is_correct(tiny_root, name):
    result, _ = _run(tiny_root, name)
    assert result["correct"] is True, result["check"]
    assert list(result)[-1] == "check"


@pytest.mark.parametrize("fault", sorted(faults.SERVE_FAULTS))
@pytest.mark.parametrize("name", ["ds-serve", "ln-serve"])
def test_serve_fault_is_not_correct(tiny_root, name, fault):
    with faults.SERVE_FAULTS[fault]():
        result, numbers = _run(tiny_root, name)
    assert result["correct"] is False, numbers


@pytest.mark.parametrize("fault", sorted(faults.TRAIN_FAULTS))
def test_training_fault_is_not_correct(tiny_root, fault):
    result, numbers = _run(tiny_root, "ds-train",
                           fault=faults.TRAIN_FAULTS[fault])
    assert result["correct"] is False, numbers


@pytest.mark.parametrize("name", ["ds-serve", "ln-serve", "ds-train"])
def test_float8_control_is_not_correct(tiny_root, name):
    """The reference with float8 frozen weights in the program's place
    fails at the real cells' limits."""
    result, numbers = _run(tiny_root, name, control=True)
    assert result["correct"] is False, numbers


def test_traced_run_reads_spans_and_the_profile(tiny_root):
    cell = tiny_cell(tiny_root, "ds-serve")
    result, _ = bench_run.run_cell(cell, SEED, 2.0, True, "cpu",
                                   time.perf_counter())
    # CPU: the spans are counted, not timed; the device readers read nothing
    assert "heads_ms.serve" in result["metrics"]
    assert "mfu.serve" in result["metrics"]
    assert "device_idle.serve" not in result["metrics"]
    assert result["device"]["window_s"] > 0


def test_span_counts_hold_the_wrapped_calls(tiny_root):
    cell = tiny_cell(tiny_root, "ds-serve")
    run = core.serve(cell, SEED, 1.0, "cpu", time.perf_counter(),
                     ["flmm_tpu_torch.models.mask_head.refiner:refine"], 1)
    assert run.span_ms({"flmm_tpu_torch.models.mask_head.refiner:refine":
                        "images"}) == 0.0
    assert run.span_ms({"flmm_tpu_torch.models.mask_head.refiner:refine":
                        1}) is None


def test_busy_union_and_idle_gap_labels():
    """The union of device intervals (overlaps counted once, the launch
    queue's records and the spans' own ranges left out) and each gap
    labelled by the innermost host operation at its start."""
    from types import SimpleNamespace as NS

    from torch.autograd import DeviceType

    from benchmark.harness import spans

    def ev(name, a, b, dev):
        return NS(name=name, time_range=NS(start=a, end=b),
                  device_type=DeviceType.CUDA if dev else DeviceType.CPU)

    class Prof:
        def events(self):
            return [ev("k1", 0, 10, True), ev("k2", 5, 20, True),
                    ev("Command Buffer Full", 20, 90, True),
                    ev("k3", 50, 60, True), ev("span", 0, 100, True),
                    ev("forward", 0, 100, False),
                    ev("aten::add", 15, 40, False),
                    ev("cudaLaunchKernel", 62, 64, False),
                    ev("k4", 70, 80, True)]

    out = spans.reduce_profile(Prof(), 1e-4, annotations=("span",))
    assert out["busy_s"] == pytest.approx(40e-6)  # 0-20, 50-60, 70-80
    gaps = dict(out["breakdown"]["idle_gaps"])
    assert gaps["aten::add"] == pytest.approx(30e-6)  # 20-50
    assert gaps["forward"] == pytest.approx(10e-6)  # 60-70: add has ended
    assert out["kernels"]["k2"] == pytest.approx(15e-6)
    assert "span" not in out["kernels"]


# ----------------------------------------------------------- no JAX


def test_no_jax_after_importing_the_harness():
    code = (
        "import sys, pathlib\n"
        "import benchmark.run, benchmark.calibrate\n"
        "from benchmark.harness import check, core, faults, spec\n"
        "import benchmark.reference.model, benchmark.reference.data\n"
        "for p in sorted((spec.BENCH / 'metrics').glob('*.py')):\n"
        "    spec.load_reader(spec.BENCH, p.stem)\n"
        "bad = benchmark.run.forbidden_modules()\n"
        "print(bad)\n"
        "sys.exit(1 if bad else 0)\n")
    out = subprocess.run([sys.executable, "-c", code], cwd=ROOT,
                         capture_output=True, text=True, timeout=300)
    assert out.returncode == 0, out.stdout + out.stderr


def test_reference_imports_nothing_of_the_program():
    banned = {"jax", "jaxlib", "flax", "flmm_tpu", "flmm_tpu_torch"}
    for path in sorted((spec.BENCH / "reference").glob("*.py")):
        for node in ast.walk(ast.parse(path.read_text())):
            names = []
            if isinstance(node, ast.Import):
                names = [a.name for a in node.names]
            elif isinstance(node, ast.ImportFrom):
                names = [node.module or ""]
            for n in names:
                assert n.split(".")[0] not in banned, (path.name, n)


def test_forbidden_names_are_compared_whole():
    sys.modules.setdefault("flmm_tpu_torch_lookalike", sys)
    try:
        assert "flmm_tpu_torch_lookalike" not in bench_run.forbidden_modules()
    finally:
        del sys.modules["flmm_tpu_torch_lookalike"]


def test_run_without_a_card_exits_without_a_result():
    if torch.cuda.is_available():
        pytest.skip("a card is present")
    out = subprocess.run([sys.executable, "-m", "benchmark.run",
                          "--workload", CELL_NAMES[0], "--seed", str(SEED),
                          "--seconds", "1"], cwd=ROOT, capture_output=True,
                         text=True, timeout=300)
    assert out.returncode != 0 and out.stdout.strip() == ""


# --------------------------------------------------------------- card


@pytest.mark.chip
@pytest.mark.parametrize("name", CELL_NAMES)
def test_control_on_the_card_is_not_correct(name, tmp_path):
    """The float8 control at the cell's own size on three seeds: never
    correct (``python -m pytest benchmark/tests -m chip`` on the card)."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    cell = spec.load_cell(name, MANIFEST)
    for seed in (SEED + 101, SEED + 102, SEED + 103):
        result, numbers = bench_run.run_cell(
            cell, seed, 3.0, False, "cuda:0", time.perf_counter(),
            control=True)
        assert result["correct"] is False, numbers
        torch.cuda.empty_cache()
