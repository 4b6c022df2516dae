"""One run of one cell: set-up, the measured window, and the record the
metric readers reduce.

Serve cells: one client in a closed loop; a request is one batch of the
cell's images, from the start of its host-to-device copy to its
``coarse_logits``, ``sam_logits``, ``iou_pred`` and ``boxes`` back in
pinned host memory.  The requests are built by the program's batch
builder in set-up, into a pool that the window cycles through.

Train cells: the training step is built once, driven through its first
steps in set-up (those the check follows, with the boxes its refiner
made) and handed to the window; a
step is the host-to-device copy, the forward, the backward and the
optimizer's update, ending in a synchronise.
"""

from __future__ import annotations

import concurrent.futures
import dataclasses
import sys
import time

import torch

from benchmark.harness import flops, program, spans, traffic, weights

WARMUP = 2  # requests in set-up on the cell's own shapes
CHECK_STEPS = 3  # training steps the reference follows
TRACE_FIRST = 2  # the window's request where the profiled stretch starts
# the training step's loss terms (models/frozen/base.grounding_losses)
LOSS_TERMS = ("loss", "loss_mask", "loss_dice", "sam_loss_mask",
              "sam_loss_dice")


@dataclasses.dataclass
class Run:
    """What a run leaves for the readers and the check."""
    cell: object
    seed: int
    device: torch.device
    family: str
    cfg: object
    setup_s: float = 0.0
    window_s: float = 0.0
    items: list = dataclasses.field(default_factory=list)
    raw: list = dataclasses.field(default_factory=list)
    pool_flops: list = dataclasses.field(default_factory=list)
    pool_batches: list = dataclasses.field(default_factory=list)
    profile: dict | None = None
    profiled_s: float = 0.0
    outputs: dict = dataclasses.field(default_factory=dict)
    train_seen: dict = dataclasses.field(default_factory=dict)
    memory_peak: int = 0
    counts: dict = dataclasses.field(default_factory=dict)

    # ------------------------------------------------ helpers for readers

    def untraced(self) -> list:
        return [it for it in self.items if not it["traced"]]

    def span_ms(self, wraps: dict):
        """Mean CUDA-event ms a request (or step) of the named targets,
        over the window's items outside the profiled stretch; None if a
        target was not entered as often as ``wraps`` expects."""
        items = self.untraced()
        if not items:
            return None
        total = 0.0
        for it in items:
            for target, expect in wraps.items():
                ms, calls = it["stages"].get(target, (0.0, 0))
                want = it["images"] if expect == "images" else expect
                if calls != want:
                    self.counts[target] = (calls, want)
                    return None
                total += ms
        return total / len(items)

    def mfu(self, backward: bool):
        """The needed operations of the window's items outside the profiled
        stretch, over their seconds, as a share of the bf16 peak (%)."""
        items = self.untraced()
        secs = self.window_s - self.profiled_s
        if not items or secs <= 0:
            return None
        total = 0.0
        for it in items:
            fwd = self.pool_flops[it["pool"]]
            total += sum(fwd.values())
            if backward:
                total += flops.heads_backward(fwd)
        return 100.0 * total / secs / flops.PEAK_FLOPS

    def kernel_roofline(self, symbols, bound_of):
        """Bound time over device time of the kernels whose symbol holds
        one of ``symbols``, over the profiled stretch (%); ``bound_of(pool
        index)`` gives the least seconds of one item's calls."""
        if not self.profile:
            return None
        device = sum(s for name, s in self.profile["kernels"].items()
                     if any(sym in name for sym in symbols))
        traced = [it for it in self.items if it["traced"]]
        if device <= 0 or not traced:
            return None
        bound = sum(bound_of(it["pool"]) for it in traced)
        return 100.0 * bound / device

    def idle_pct(self):
        if not self.profile or self.profile["window_s"] <= 0:
            return None
        busy = self.profile["busy_s"]
        if busy <= 0:
            return None
        return 100.0 * (1.0 - busy / self.profile["window_s"])

    def model_cfg(self):
        return self.cell.config["model"]


def log(msg: str) -> None:
    print(msg, file=sys.stderr, flush=True)


def _sync(device):
    if device.type == "cuda":
        torch.cuda.synchronize(device)


def _build_pool(run: Run, n_requests: int, per_request: int, spec) -> list:
    """The raw requests and their program batches as pinned host tensors
    (built by a few threads: numpy's resamplers release the GIL)."""
    cell = run.cell
    b = program.base(run.cfg)
    prompt = {"img_start": cell.config["prompt_img_start"],
              "n_img": b.num_img_tokens, "vocab": b.llm.vocab_size}
    run.raw = traffic.requests(cell.traffic, n_requests, per_request,
                               run.seed, prompt)
    pin = run.device.type == "cuda"

    def one(req):
        return program.build_batch(run.family, run.cfg, req, spec)

    with concurrent.futures.ThreadPoolExecutor(4) as ex:
        batches = list(ex.map(one, run.raw))
    run.pool_flops = [flops.forward(run.model_cfg(), run.family, bt, True)
                      for bt in batches]
    run.pool_batches = [{k: bt[k] for k in ("attn_mask", "mask_ids",
                                            "mask_valid")} for bt in batches]
    return [program.host(bt, pin) for bt in batches]


def _spec(run: Run):
    s = run.cell.spec
    return program.batch_spec(run.family, run.cfg, s["seq_len"],
                              s["max_masks"], s["text_per_mask"])


def _profiler(device):
    acts = [torch.profiler.ProfilerActivity.CPU]
    if device.type == "cuda":
        acts.append(torch.profiler.ProfilerActivity.CUDA)
    return torch.profiler.profile(activities=acts)


def setup(cell, seed: int, device, t0: float, trace_targets) -> tuple:
    """The parameters on the device and the pool; the spans installed
    first in a traced run, so that set-up runs through them too."""
    device = torch.device(device)
    family = cell.config["family"]
    cfg = program.config(cell.config)
    run = Run(cell=cell, seed=seed, device=device, family=family, cfg=cfg)
    tracer = spans.Spans(trace_targets, device).install() \
        if trace_targets else None
    t_c = time.perf_counter()
    torch.empty(1, device=device)  # the context, apart from the weights
    _sync(device)
    t = time.perf_counter()
    params = weights.make(program.schema(family, cfg), seed, device)
    _sync(device)
    log(f"set-up: device context {t - t_c:.2f} s")
    s = cell.spec
    t_w = time.perf_counter()
    pool = _build_pool(run, s["pool"], s["batch"], _spec(run))
    log(f"set-up: weights {t_w - t:.2f} s, pool of {len(pool)} requests "
        f"{time.perf_counter() - t_w:.2f} s")
    return run, params, pool, tracer


def _window(run: Run, seconds: float, one, n_pool: int, first: int,
            tracer, trace_n: int):
    """Call ``one(pool index)`` back to back for ``seconds``; each item's
    stamps, images, spans; the profiled stretch in a traced run."""
    prof = None
    t_w = time.perf_counter()
    end = t_w + seconds
    i = 0
    t_prof = None
    while time.perf_counter() < end:
        traced = tracer is not None and TRACE_FIRST <= i < TRACE_FIRST \
            + trace_n
        if traced and prof is None:
            prof = _profiler(run.device)
            prof.__enter__()
            t_prof = time.perf_counter()
        k = (first + i) % n_pool
        t0 = time.perf_counter()
        images = one(k)
        t1 = time.perf_counter()
        run.items.append({"t0": t0 - t_w, "t1": t1 - t_w, "images": images,
                          "pool": k, "traced": traced,
                          "stages": tracer.collect() if tracer else {}})
        i += 1
        if prof is not None and i >= TRACE_FIRST + trace_n:
            stopped = _stop(run, prof, t_prof)
            prof = None
    if prof is not None:
        stopped = _stop(run, prof, t_prof)
    run.window_s = run.items[-1]["t1"] if run.items else 0.0
    if any(it["traced"] for it in run.items):
        # the profiled stretch, and the profiler's stop after it, are left
        # out of the untraced items' seconds; the trace is read after the
        # window
        run.profiled_s = sum(it["t1"] - it["t0"] for it in run.items
                             if it["traced"]) + stopped[1]
        run.profile = spans.reduce_profile(stopped[0], stopped[2],
                                           tracer.targets)


def _stop(run: Run, prof, t_prof) -> tuple:
    """Stop the profiler: ``(profiler, seconds its stop took, the traced
    stretch's wall seconds)``."""
    _sync(run.device)
    t = time.perf_counter()
    prof.__exit__(None, None, None)
    return prof, time.perf_counter() - t, t - t_prof


# ------------------------------------------------------------------ serve


def serve(cell, seed: int, seconds: float, device, t0: float,
          trace_targets=(), trace_n: int = 0) -> Run:
    run, params, pool, tracer = setup(cell, seed, device, t0, trace_targets)
    dev = run.device
    bufs = [None] * len(pool)

    def one(k):
        batch = program.to_device(pool[k], dev)
        with torch.no_grad():
            out = program.forward(run.family, run.cfg, params, batch)
        if bufs[k] is None:  # the first warm-up: every entry's buffers
            for j in range(len(pool)):
                bufs[j] = {n: torch.empty(out[n].shape, dtype=out[n].dtype,
                                          pin_memory=dev.type == "cuda")
                           for n in program.SERVED}
                # the layer-weighted hidden states stay on the device for
                # the check
                bufs[j]["hidden"] = torch.empty_like(out["hidden"])
        for n in program.SERVED:
            bufs[k][n].copy_(out[n], non_blocking=True)
        bufs[k]["hidden"].copy_(out["hidden"], non_blocking=True)
        _sync(dev)
        return int(pool[k]["input_ids"].shape[0])

    for k in range(WARMUP):
        one(k % len(pool))
    if tracer:
        tracer.collect()
    if dev.type == "cuda":
        torch.cuda.reset_peak_memory_stats(dev)
    _sync(dev)
    run.setup_s = time.perf_counter() - t0
    log(f"set-up: {run.setup_s:.2f} s in all")
    _window(run, seconds, one, len(pool), 0, tracer, trace_n)
    if dev.type == "cuda":
        run.memory_peak = torch.cuda.max_memory_allocated(dev)
    run.outputs = {"bufs": bufs}
    if tracer:
        tracer.remove()
    del params, pool
    return run


# ------------------------------------------------------------------ train


def train(cell, seed: int, seconds: float, device, t0: float,
          trace_targets=(), trace_n: int = 0, fault=None) -> Run:
    run, params, pool, tracer = setup(cell, seed, device, t0, trace_targets)
    dev = run.device
    tr = program.trainer(run.family, run.cfg, params, cell.spec["optim"])
    if fault is not None:
        tr = fault(tr)
    losses, norms = [], []

    def one(k):
        batch = program.to_device(pool[k], dev)
        metrics = tr.step(batch)
        _sync(dev)
        if len(losses) < CHECK_STEPS:
            losses.append({k: float(metrics[k]) for k in LOSS_TERMS})
            norms.append(float(metrics["grad_norm"]))
        return int(pool[k]["input_ids"].shape[0])

    seen = run.train_seen
    seen["boxes"], made = [], []
    with program.boxes_made(made):
        for k in range(CHECK_STEPS):
            one(k)
            seen["boxes"].append(torch.stack(made))  # (images, masks, 4)
            made.clear()
            if k == 0:  # the optimizer's first moments hold its gradient
                seen["mu1"] = {p: m.detach().clone()
                               for p, m in program.adam_state(tr).items()}
    seen["after"] = {p: t.detach().clone()
                     for p, t in program.leaves(tr.state["params"])}
    seen["losses"] = list(losses)
    seen["grad_norms"] = list(norms)
    if tracer:
        tracer.collect()
    if dev.type == "cuda":
        torch.cuda.reset_peak_memory_stats(dev)
    _sync(dev)
    run.setup_s = time.perf_counter() - t0
    log(f"set-up: {run.setup_s:.2f} s in all")
    _window(run, seconds, one, len(pool), CHECK_STEPS, tracer, trace_n)
    if dev.type == "cuda":
        run.memory_peak = torch.cuda.max_memory_allocated(dev)
    if tracer:
        tracer.remove()
    del tr, params, pool
    return run


def free_cached() -> None:
    """Free what the program left cached on the card before the check."""
    if torch.cuda.is_available():
        torch.cuda.empty_cache()
