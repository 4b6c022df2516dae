"""The port's tracer (flmm_tpu_torch/trace.py) on the CPU: off it is a
shared null context and counts nothing; on, the tiny DeepSeek-VL and
LLaVA-NeXT forwards and a tiny training step give the span tree, the
request ids and the heads' counters the layers promise, the same outputs as
with the tracer off, ``flmm.*`` ranges in a ``torch.profiler`` profile
within 1 ms of the tracer's own starts, and ``profile_breakdown`` puts
every idle stretch and launch down to one span."""

import copy
import importlib.util
import json
import pathlib
import types
from unittest import mock

import pytest
import torch

from flmm_tpu_torch import registry, trace
from flmm_tpu_torch.configs import llava_next as llava_next_configs
from flmm_tpu_torch.convert.from_jax import from_jax
from flmm_tpu_torch.data import llava_next as llava_next_data
from flmm_tpu_torch.data.synthetic import synthetic_batch
from flmm_tpu_torch.models.frozen import llava_next
from flmm_tpu_torch.train import diagnostics, loop

FORWARD_CHILDREN = {"tower", "capture", "unet", "sam_encoder", "refine"}


@pytest.fixture(autouse=True)
def clean_tracer():
    trace.collect()
    yield
    trace.disable()
    trace.collect()


@pytest.fixture(scope="module")
def deepseek():
    cfg = registry.get_config("deepseek_vl", "tiny")
    model = registry.get_model("deepseek_vl")
    params = model.init_params(cfg, torch.Generator().manual_seed(0), "cpu")
    batch = from_jax(synthetic_batch(cfg, batch_size=2, seed=1))
    return model, cfg, params, batch


@pytest.fixture(scope="module")
def anyres():
    cfg = llava_next_configs.tiny_llava_next(img_start=5)
    params = llava_next.init_params(cfg, torch.Generator().manual_seed(0),
                                    "cpu")
    batch = from_jax(llava_next_data.synthetic_anyres_batch(
        cfg, ((40, 100), (90, 50)), prompt_len=5, max_masks=3,
        caption_tokens=4))
    return llava_next, cfg, params, batch


def _forward(model, cfg, params, batch):
    with torch.no_grad():
        return model.forward(params, cfg, batch)


def _assert_equal(a: dict, b: dict):
    assert a.keys() == b.keys()
    for k in a:
        assert torch.equal(a[k], b[k]), k


def _tree(spans):
    """{name: [records]} and the records by id."""
    by_name = {}
    for s in spans:
        by_name.setdefault(s["name"], []).append(s)
    return by_name, {s["id"]: s for s in spans}


def _counters(got):
    return {(c["request"], c["name"]): c["value"] for c in got["counters"]}


# ----------------------------------------------------------------- off


def test_off_by_default_span_is_the_shared_null_context():
    assert not trace.enabled()
    first = trace.span("forward")
    assert first is trace.span("tower")
    with first as inner:
        assert inner is None
    assert trace.collect() == {"spans": [], "counters": []}


def test_count_off_calls_no_method_of_its_tensor():
    value = mock.MagicMock(spec=torch.Tensor)
    trace.count("masks_valid", value)
    assert value.mock_calls == []
    assert trace.collect()["counters"] == []


def test_off_profile_has_no_flmm_range_and_on_adds_no_op(deepseek):
    """Off: no ``flmm.*`` event.  On: the forward runs the same operators,
    in the same order, with the ranges between them; the one addition is
    the ``masks_valid`` counter's sum, taken where it is counted."""
    model, cfg, params, batch = deepseek
    acts = [torch.profiler.ProfilerActivity.CPU]

    def ops(prof):
        return [e.name for e in prof.events() if e.name.startswith("aten::")]

    with torch.profiler.profile(activities=acts) as off:
        _forward(model, cfg, params, batch)
    assert not [e for e in off.events() if e.name.startswith(trace.PREFIX)]
    with trace.tracing(), torch.profiler.profile(activities=acts) as on:
        _forward(model, cfg, params, batch)
    with torch.profiler.profile(activities=acts) as alone:
        batch["mask_valid"].detach().sum()
    got, want, counter = ops(on), ops(off), ops(alone)
    i = next(i for i, (a, b) in enumerate(zip(got, want)) if a != b)
    assert got == want[:i] + counter + want[i:]
    assert {e.name for e in on.events() if e.name.startswith(
        trace.PREFIX)} == {trace.PREFIX + n for n in FORWARD_CHILDREN
                           | {"forward"}}


# ------------------------------------------------------------------ on


def test_deepseek_forward_spans_counters_and_outputs(deepseek):
    model, cfg, params, batch = deepseek
    off = _forward(model, cfg, params, batch)
    with trace.tracing():
        on = _forward(model, cfg, params, batch)
        again = _forward(model, cfg, params, batch)
    _assert_equal(off, on)
    _assert_equal(off, again)
    got = trace.collect()
    by_name, by_id = _tree(got["spans"])
    assert {n: len(v) for n, v in by_name.items()} == {
        n: 2 for n in FORWARD_CHILDREN | {"forward"}}
    roots = by_name["forward"]
    assert [r["parent"] for r in roots] == [None, None]
    assert roots[0]["request"] != roots[1]["request"]
    for name in FORWARD_CHILDREN:
        for s in by_name[name]:
            parent = by_id[s["parent"]]
            assert parent["name"] == "forward"
            assert s["request"] == parent["request"]
    for s in got["spans"]:
        assert s["device_ms"] is None and s["host_ms"] >= 0
    counters = _counters(got)
    B, M = batch["mask_valid"].shape
    for r in roots:
        assert counters[(r["request"], "heads_slots")] == B * M
        assert counters[(r["request"], "masks_valid")] == int(
            batch["mask_valid"].sum())


def test_llava_next_forward_spans_frames(anyres):
    model, cfg, params, batch = anyres
    off = _forward(model, cfg, params, batch)
    with trace.tracing():
        on = _forward(model, cfg, params, batch)
    _assert_equal(off, on)
    got = trace.collect()
    by_name, by_id = _tree(got["spans"])
    assert {n: len(v) for n, v in by_name.items()} == {
        n: 1 for n in FORWARD_CHILDREN | {"forward", "frames"}}
    (root,) = by_name["forward"]
    for s in got["spans"]:
        assert s["request"] == root["request"]
        if s is not root:
            assert by_id[s["parent"]] is root
    B, M = batch["mask_valid"].shape
    assert _counters(got) == {
        (root["request"], "heads_slots"): B * M,
        (root["request"], "masks_valid"): int(batch["mask_valid"].sum())}


ONE_RANK = types.SimpleNamespace(  # a 1 x 1 mesh of this process alone
    shape=(1, 1), mesh_dim_names=("data", "model"),
    get_group=lambda axis: None, get_local_rank=lambda axis: 0)


def _train(deepseek, n_steps, traced, sharded=False):
    model, cfg, params, batch = deepseek
    opt = loop.make_optimizer(loop.OptimConfig(lr=1e-3, total_steps=4))
    state = loop.init_state(copy.deepcopy(params["trainable"]), opt)
    loss = lambda p, b: model.loss_fn(p, cfg, b)  # noqa: E731
    step = (loop.make_sharded_train_step(loss, opt, ONE_RANK) if sharded
            else loop.make_train_step(loss, opt))
    losses = []
    with trace.tracing() if traced else torch.enable_grad():
        for _ in range(n_steps):
            state, metrics = step(state, params["frozen"], batch)
            losses.append(metrics["loss"])
    return state, losses


@pytest.mark.parametrize("sharded", [False, True],
                         ids=["train_step", "sharded_train_step"])
def test_train_step_spans_and_outputs(deepseek, sharded, monkeypatch):
    # one rank: the sums over the mesh's axes are the values themselves
    monkeypatch.setattr(loop.mesh_lib, "all_reduce",
                        lambda t, group=None: t)
    plain, plain_losses = _train(deepseek, 2, False, sharded)
    assert trace.collect()["spans"] == []
    traced, traced_losses = _train(deepseek, 2, True, sharded)
    assert [float(v) for v in plain_losses] == [float(v)
                                                for v in traced_losses]
    for (path, a), (_, b) in zip(loop.tree_leaves(plain["params"]),
                                 loop.tree_leaves(traced["params"])):
        assert torch.equal(a, b), path
    got = trace.collect()
    by_name, by_id = _tree(got["spans"])
    assert {n: len(v) for n, v in by_name.items()} == {
        n: 2 for n in FORWARD_CHILDREN | {"forward", "step", "backward",
                                           "optimizer"}}
    steps = by_name["step"]
    assert [s["parent"] for s in steps] == [None, None]
    assert len({s["request"] for s in steps}) == 2
    for name in ("forward", "backward", "optimizer"):
        for s in by_name[name]:
            assert by_id[s["parent"]]["name"] == "step"
    for name in FORWARD_CHILDREN:
        for s in by_name[name]:
            assert by_id[s["parent"]]["name"] == "forward"
    for s in got["spans"]:
        root = s
        while root["parent"] is not None:
            root = by_id[root["parent"]]
        assert root["name"] == "step" and s["request"] == root["request"]
    B, M = deepseek[3]["mask_valid"].shape
    counters = _counters(got)
    for s in steps:
        assert counters[(s["request"], "heads_slots")] == B * M


def test_profile_ranges_start_with_the_tracers_spans(deepseek):
    model, cfg, params, batch = deepseek
    with trace.tracing(), torch.profiler.profile(
            activities=[torch.profiler.ProfilerActivity.CPU]) as prof:
        _forward(model, cfg, params, batch)
    got = trace.collect()
    start_ns = prof.profiler.kineto_results.trace_start_ns()
    ranges = sorted((e.time_range.start, e.name) for e in prof.events()
                    if e.name.startswith(trace.PREFIX))
    spans = sorted(((s["start_ns"] - start_ns) / 1e3,
                    trace.PREFIX + s["name"]) for s in got["spans"])
    assert [n for _, n in ranges] == [n for _, n in spans]
    for (t_prof, _), (t_span, _) in zip(ranges, spans):
        assert abs(t_prof - t_span) < 1e3  # us


def test_collect_resets_and_export_writes_json_lines(deepseek, tmp_path):
    model, cfg, params, batch = deepseek
    with trace.tracing():
        _forward(model, cfg, params, batch)
        got = trace.export(tmp_path / "spans.jsonl")
    assert trace.collect() == {"spans": [], "counters": []}
    lines = [json.loads(ln) for ln in
             (tmp_path / "spans.jsonl").read_text().splitlines()]
    spans = [ln for ln in lines if "span" in ln]
    counters = [ln for ln in lines if "counter" in ln]
    assert len(spans) + len(counters) == len(lines)
    assert [s["span"] for s in spans] == [s["name"] for s in got["spans"]]
    assert {c["counter"] for c in counters} == {"heads_slots", "masks_valid"}
    assert {"id", "parent", "request", "start_ns", "host_ms",
            "device_ms"} <= spans[0].keys()


def test_tensor_counter_is_summed_when_counted():
    """A buffer written over before ``collect`` counts what it held when
    counted."""
    buf = torch.tensor([[True, False, True]])
    with trace.tracing():
        with trace.span("forward"):
            trace.count("masks_valid", buf)
            trace.count("masks_valid", 2)
        buf.fill_(False)
        (counter,) = trace.collect()["counters"]
    assert counter["value"] == 4


def test_trainer_profile_writes_ranges_and_spans(deepseek, tmp_path):
    model, cfg, params, batch = deepseek
    opt = loop.make_optimizer(loop.OptimConfig(total_steps=4))
    state = loop.init_state(copy.deepcopy(params["trainable"]), opt)
    step = loop.make_train_step(lambda p, b: model.loss_fn(p, cfg, b), opt)
    with diagnostics.profile(tmp_path, torch.device("cpu")):
        step(state, params["frozen"], batch)
    assert not trace.enabled()
    chrome = (tmp_path / "trace.json").read_text()
    for name in ("step", "forward", "backward", "optimizer", "refine"):
        assert f'"{trace.PREFIX}{name}"' in chrome, name
    lines = [json.loads(ln) for ln in
             (tmp_path / "spans.jsonl").read_text().splitlines()]
    assert sum(ln.get("span") == "step" for ln in lines) == 1


# ------------------------------------------------------ scripts/trace_cell


def _trace_cell():
    path = pathlib.Path(__file__).resolve().parents[1] / "scripts" \
        / "trace_cell.py"
    spec = importlib.util.spec_from_file_location("trace_cell", path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


@pytest.mark.parametrize("name", ["ds-serve", "ds-train"])
def test_trace_cell_measures_a_tiny_benchmark_cell(name, tmp_path):
    """``scripts/trace_cell.py``'s ``measure`` through the benchmark
    harness's own set-up, at the benchmark tests' tiny cells on the CPU:
    every stretch runs, each request has its spans once, the valid share
    is the pool's, each span has its wrapped twin and the profiled idle
    partitions by span."""
    trace_cell = _trace_cell()  # puts the checkout's root on sys.path
    from benchmark.harness import spec
    from benchmark.tests import tiny

    manifest = tiny.make(tmp_path)
    cell = spec.load_cell(name, manifest, tmp_path)
    got = trace_cell.measure(cell, 2**31 + 12345, 0.01, 2,
                             torch.device("cpu"))
    assert not trace.enabled()
    assert [len(v) for v in got["img_per_s"].values()] == [2, 2]
    names = FORWARD_CHILDREN | {"forward"}
    twins = {"tower", "capture", "sam_encoder", "heads"}
    if cell.mode == "train":
        names |= {"step", "backward", "optimizer"}
        twins = {"backward", "optimizer"}
    assert got["span_calls"] == {n: 1.0 for n in names}
    assert got["heads_valid_share_pct"] == pytest.approx(
        got["pool_valid_share_pct"])
    assert set(got["twins"]) == twins
    assert got["profile"]["requests"] == 2
    assert got["profile"]["idle_partition_gap_ms"] == pytest.approx(
        0.0, abs=1e-6)


# ------------------------------------------------------ profile_breakdown


def _event(name, start, end, device=False):
    kind = torch.autograd.DeviceType.CUDA if device \
        else torch.autograd.DeviceType.CPU
    return types.SimpleNamespace(
        name=name, device_type=kind,
        time_range=types.SimpleNamespace(start=start, end=end))


def test_profile_breakdown_partitions_idle_and_launches():
    """Host: step [0, 100] holding forward [5, 52] holding refine [30, 50],
    then optimizer [70, 95].  Device: kernels at [10, 20], [25, 40], [45,
    55], [80, 90]; the profiler's drawing of the ranges on the device's
    timeline is no work."""
    events = [
        _event("flmm.step", 0, 100), _event("flmm.forward", 5, 52),
        _event("flmm.refine", 30, 50), _event("flmm.optimizer", 70, 95),
        _event("aten::mm", 6, 8),
        _event("cudaLaunchKernel", 7, 8), _event("cudaLaunchKernel", 31, 32),
        _event("cudaLaunchKernel", 33, 34), _event("cuLaunchKernel", 75, 76),
        _event("cudaLaunchKernel", 98, 99),
        _event("gemm_kernel", 10, 20, True), _event("k", 25, 40, True),
        _event("k", 45, 55, True), _event("k", 80, 90, True),
        _event("Command Buffer Full", 56, 79, True),
        _event("flmm.forward", 10, 55, True),
        _event("flmm.optimizer", 80, 90, True),
    ]
    got = trace.profile_breakdown(events)
    assert got["busy_s"] == pytest.approx(45e-6)
    assert got["window_s"] == pytest.approx(80e-6)
    # gaps [20, 25] begun in forward, [40, 45] in refine, [55, 80] in step
    assert got["idle_s"] == pytest.approx(
        {"forward": 5e-6, "refine": 5e-6, "step": 25e-6})
    assert sum(got["idle_s"].values()) == pytest.approx(
        got["window_s"] - got["busy_s"])
    # launches at the window's edges are outside it: 7 and 98 are not
    # counted; 31, 33 in refine, 75 in optimizer
    assert got["launches"] == {"refine": 2, "optimizer": 1}
    wide = trace.profile_breakdown(events, window=(0, 100))
    assert wide["window_s"] == pytest.approx(100e-6)
    # the edges: [0, 10] begun in step, [90, 100] in optimizer
    assert wide["idle_s"] == pytest.approx({
        "step": 35e-6, "forward": 5e-6, "refine": 5e-6, "optimizer": 10e-6})
    assert sum(wide["idle_s"].values()) == pytest.approx(
        wide["window_s"] - wide["busy_s"])
    assert wide["launches"] == {"forward": 1, "refine": 2, "optimizer": 1,
                                "step": 1}
    early = trace.profile_breakdown(events, window=(-20, 90))
    assert early["idle_s"][trace.OUTSIDE] == pytest.approx(30e-6)
    assert early["idle_s"]["step"] == pytest.approx(25e-6)


def test_profile_breakdown_of_a_cpu_profile(deepseek):
    """No device: no busy time, no idle, the forward's launch-free host
    ranges counted nowhere."""
    model, cfg, params, batch = deepseek
    with trace.tracing(), torch.profiler.profile(
            activities=[torch.profiler.ProfilerActivity.CPU]) as prof:
        _forward(model, cfg, params, batch)
    trace.collect()
    got = trace.profile_breakdown(prof.events())
    assert got == {"busy_s": 0.0, "window_s": 0.0, "idle_s": {},
                   "launches": {}}
