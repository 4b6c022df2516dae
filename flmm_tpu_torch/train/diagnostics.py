"""Observability of a training run (flmm_tpu/train/diagnostics.py): a
rolling step timer, a JSONL metric log, the non-finite gradient guard and a
profiler trace of some steps with the program's spans."""

from __future__ import annotations

import contextlib
import json
import pathlib
import time

import torch
from torch.profiler import ProfilerActivity

from flmm_tpu_torch import trace
from flmm_tpu_torch.train.loop import Optimizer


class StepTimer:
    """Seconds between ``tick`` calls, averaged over the last ``window``."""

    def __init__(self, window: int = 50):
        self.window = window
        self.times: list[float] = []
        self._last = time.perf_counter()

    def tick(self) -> float:
        now = time.perf_counter()
        dt = now - self._last
        self._last = now
        self.add(dt)
        return dt

    def add(self, dt: float) -> None:
        """Count a duration measured elsewhere."""
        self.times.append(dt)
        if len(self.times) > self.window:
            self.times.pop(0)

    @property
    def mean(self) -> float:
        return sum(self.times) / max(1, len(self.times))


class MetricLogger:
    """Appends ``{"step": n, ...}`` JSON lines to ``path`` every
    ``interval`` steps."""

    def __init__(self, path: str, interval: int = 10):
        self.interval = interval
        self.file = open(path, "a")

    def log(self, step: int, metrics: dict) -> None:
        if step % self.interval != 0:
            return
        rec = {"step": step}
        rec.update({k: float(v) for k, v in metrics.items()})
        self.file.write(json.dumps(rec) + "\n")
        self.file.flush()

    def close(self) -> None:
        self.file.close()


def nonfinite_guard(inner: Optimizer,
                    max_consecutive_errors: int = 5) -> Optimizer:
    """Skip updates whose gradients hold a NaN or an inf, as
    ``optax.apply_if_finite(inner, max_consecutive_errors)`` does: a skipped
    step changes neither the parameters nor the inner state (the AdamW
    moments and the schedule's count); after more than
    ``max_consecutive_errors`` bad steps in a row the update is applied."""

    def init(params) -> dict:
        return {"notfinite_count": 0, "last_finite": True,
                "total_notfinite": 0, "inner_state": inner.init(params)}

    def update(grads: dict, state: dict, params) -> dict:
        checks = [torch.isfinite(g).all() for g in grads.values()
                  if g is not None]
        finite = bool(torch.stack(checks).all()) if checks else True
        count = 0 if finite else state["notfinite_count"] + 1
        inner_state = state["inner_state"]
        if finite or count > max_consecutive_errors:
            inner_state = inner.update(grads, inner_state, params)
        return {"notfinite_count": count, "last_finite": finite,
                "total_notfinite": state["total_notfinite"] + (not finite),
                "inner_state": inner_state}

    return Optimizer(init, update)


@contextlib.contextmanager
def profile(logdir, device: torch.device):
    """Record what runs inside the block with ``torch.profiler`` (host
    activity, and the card's kernels when ``device`` is one) and the
    program's tracer on (flmm_tpu_torch/trace.py); at the block's end write
    the Chrome trace, ``<logdir>/trace.json``, whose ``flmm.*`` ranges are
    the spans (the counterpart of the JAX package's XLA trace for XProf),
    and the spans and counters as JSON lines, ``<logdir>/spans.jsonl``."""
    logdir = pathlib.Path(logdir)
    logdir.mkdir(parents=True, exist_ok=True)
    activities = [ProfilerActivity.CPU]
    if device.type == "cuda":
        activities.append(ProfilerActivity.CUDA)
    with trace.tracing(), \
            torch.profiler.profile(activities=activities) as prof:
        yield prof
        if device.type == "cuda":
            torch.cuda.synchronize(device)
    prof.export_chrome_trace(str(logdir / "trace.json"))
    trace.export(logdir / "spans.jsonl")
