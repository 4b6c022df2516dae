"""Spans and counters inside the program, off unless switched on.

    from flmm_tpu_torch import trace

    with trace.tracing():            # or trace.enable() / trace.disable()
        out = grounding.forward(params, cfg, batch)
        torch.cuda.synchronize()
        got = trace.collect()        # {"spans": [...], "counters": [...]}

A span (``with trace.span("tower"):``, or ``@trace.spanned("tower")`` on
the function that does the work) records its name, its parent span and its
request: a new request starts at each outermost span (``forward`` served,
``step`` trained) and the spans inside it inherit its number.  Each span
takes host start and end on the clock ``torch.profiler`` stamps its trace
with (Unix time, ``time.time_ns``), a pair of CUDA events on the current
stream when CUDA is initialised (none while a CUDA graph is being captured),
and opens ``torch.profiler.record_function("flmm.<name>")``, so the span
shows in any profile on the same clock as the device's activity.

A counter (``trace.count("heads_slots", 8)``) adds a value under the
current request: a host number, or a tensor whose sum is taken on its
device when counted (so the caller may write over the tensor after) and
read only in :func:`collect`, so counting never synchronises.

Off (the default), :func:`span` returns one shared null context and
:func:`count` returns at once: neither touches a tensor, launches a kernel
or synchronises.  The tracer's state is one host thread's: spans opened
from two threads at once would nest wrongly.

:func:`profile_breakdown` reads a ``torch.profiler`` profile taken with the
tracer on: the device's idle gaps and the kernel launches, each put down to
the innermost ``flmm.*`` range open on the host when it began.
"""

from __future__ import annotations

import bisect
import contextlib
import functools
import json
import time

import torch

PREFIX = "flmm."
# host calls that put work on the device's queue
LAUNCHES = ("cudaLaunchKernel", "cudaLaunchKernelExC", "cuLaunchKernel",
            "cuLaunchKernelEx", "cudaGraphLaunch")
OUTSIDE = "outside"  # the key of what began with no program span open
_NULL = contextlib.nullcontext()


class Tracer:
    """The spans and counters of one process since the last collect."""

    def __init__(self):
        self.on = False
        self.stack = []  # open spans, innermost last
        self.done = []
        self.counters = {}  # (request, name) -> [host sum, device sums]
        self.next_id = 0
        self.next_request = 0

    def span(self, name: str):
        return _Span(self, name) if self.on else _NULL

    def count(self, name: str, value) -> None:
        if not self.on:
            return
        request = self.stack[-1]["request"] if self.stack else None
        slot = self.counters.setdefault((request, name), [0, []])
        if isinstance(value, torch.Tensor):
            slot[1].append(value.detach().sum())
        else:
            slot[0] += value

    def collect(self) -> dict:
        """The finished spans, in the order they opened, and the counters;
        then forget both.  Call after a synchronise: device times are read
        from the spans' events."""
        spans = []
        for rec in sorted(self.done, key=lambda r: r["id"]):
            start, end = rec.pop("events")
            rec["device_ms"] = (start.elapsed_time(end) if start is not None
                                else None)
            spans.append(rec)
        counters = []
        for (request, name), (host, tensors) in self.counters.items():
            value = host + sum(t.item() for t in tensors)
            counters.append({"name": name, "request": request,
                             "value": value})
        self.done, self.counters = [], {}
        return {"spans": spans, "counters": counters}


class _Span:
    __slots__ = ("tracer", "name", "rec", "range")

    def __init__(self, tracer: Tracer, name: str):
        self.tracer, self.name = tracer, name

    def __enter__(self):
        tr = self.tracer
        parent = tr.stack[-1] if tr.stack else None
        if parent is None:
            request = tr.next_request
            tr.next_request += 1
        else:
            request = parent["request"]
        events = (None, None)
        if (torch.cuda.is_initialized()
                and not torch.cuda.is_current_stream_capturing()):
            events = (torch.cuda.Event(enable_timing=True),
                      torch.cuda.Event(enable_timing=True))
        self.rec = {"name": self.name, "id": tr.next_id,
                    "parent": parent["id"] if parent else None,
                    "request": request, "events": events}
        tr.next_id += 1
        tr.stack.append(self.rec)
        self.rec["start_ns"] = time.time_ns()
        self.range = torch.profiler.record_function(PREFIX + self.name)
        self.range.__enter__()
        if events[0] is not None:
            events[0].record()
        return self

    def __exit__(self, *exc):
        rec = self.rec
        if rec["events"][1] is not None:
            rec["events"][1].record()
        self.range.__exit__(*exc)
        end_ns = time.time_ns()
        rec["host_ms"] = (end_ns - rec["start_ns"]) / 1e6
        tr = self.tracer
        tr.stack.pop()
        tr.done.append(rec)
        return False


TRACER = Tracer()


def enable() -> None:
    TRACER.on = True


def disable() -> None:
    TRACER.on = False


def enabled() -> bool:
    return TRACER.on


@contextlib.contextmanager
def tracing():
    """The tracer on inside the block, as it was after."""
    was = TRACER.on
    TRACER.on = True
    try:
        yield TRACER
    finally:
        TRACER.on = was


def span(name: str):
    return TRACER.span(name)


def spanned(name: str):
    """Decorate the function that does a layer's work with span ``name``."""
    def wrap(fn):
        @functools.wraps(fn)
        def inner(*args, **kwargs):
            if not TRACER.on:
                return fn(*args, **kwargs)
            with _Span(TRACER, name):
                return fn(*args, **kwargs)
        return inner
    return wrap


def count(name: str, value) -> None:
    TRACER.count(name, value)


def collect() -> dict:
    return TRACER.collect()


def export(path) -> dict:
    """:func:`collect`, written to ``path`` as JSON lines: one a span
    (``"span"``: its name), then one a counter (``"counter"``)."""
    got = collect()
    with open(path, "w") as f:
        for rec in got["spans"]:
            f.write(json.dumps({"span": rec["name"],
                                **{k: v for k, v in rec.items()
                                   if k != "name"}}) + "\n")
        for rec in got["counters"]:
            f.write(json.dumps({"counter": rec["name"],
                                "request": rec["request"],
                                "value": rec["value"]}) + "\n")
    return got


# ------------------------------------------------------------ the profile


def _innermost(ranges):
    """A function of a host time (us) giving the name of the innermost
    ``flmm.*`` range open then, or ``OUTSIDE``; ``ranges`` are ``(start,
    end, name)`` of properly nested ranges (one thread's)."""
    ranges = sorted(ranges, key=lambda r: (r[0], -r[1]))
    starts = [r[0] for r in ranges]
    parent, open_ = [], []
    for i, (start, _, _) in enumerate(ranges):
        while open_ and ranges[open_[-1]][1] <= start:
            open_.pop()
        parent.append(open_[-1] if open_ else -1)
        open_.append(i)

    def at(t):
        # every range open at t holds the latest-starting range before t,
        # so the innermost is the first of its chain of parents still open
        j = bisect.bisect_right(starts, t) - 1
        while j >= 0:
            if ranges[j][1] >= t:
                return ranges[j][2]
            j = parent[j]
        return OUTSIDE
    return at


def profile_breakdown(events, window=None) -> dict:
    """What a profile taken with the tracer on says of the program's spans.

    ``events``: ``prof.events()``.  ``window``: ``(start, end)`` in the
    profile's microseconds; by default from the first device operation's
    start to the last one's end.  The device is busy where any of its
    operations runs (the ``flmm.*`` ranges the profiler also draws on the
    device's timeline are no work, nor CUPTI's "Command Buffer Full");
    every idle stretch inside the window, the edges included, goes to the
    innermost ``flmm.*`` range open on the host where it began.  Returns
    ``busy_s``, ``window_s``, ``idle_s`` and ``launches`` (each ``{span
    name or OUTSIDE: value}``)."""
    device, host_ranges, launches = [], [], []
    for e in events:
        start, end = e.time_range.start, e.time_range.end
        if e.device_type == torch.autograd.DeviceType.CUDA:
            if not (e.name.startswith(PREFIX)
                    or e.name == "Command Buffer Full"):
                device.append((start, end))
        elif e.name.startswith(PREFIX):
            host_ranges.append((start, end, e.name[len(PREFIX):]))
        elif e.name in LAUNCHES:
            launches.append(start)
    device.sort()
    if window is None:
        window = ((device[0][0], max(d[1] for d in device)) if device
                  else (0.0, 0.0))
    lo, hi = window
    at = _innermost(host_ranges)
    idle, busy, edge = {}, 0.0, lo
    for start, end in device:
        start, end = max(start, lo), min(end, hi)
        if end <= edge:
            continue
        if start > edge:
            name = at(edge)
            idle[name] = idle.get(name, 0.0) + (start - edge) / 1e6
        busy += (end - max(start, edge)) / 1e6
        edge = end
    if hi > edge:
        name = at(edge)
        idle[name] = idle.get(name, 0.0) + (hi - edge) / 1e6
    counted = {}
    for t in launches:
        if lo <= t <= hi:
            name = at(t)
            counted[name] = counted.get(name, 0) + 1
    return {"busy_s": busy, "window_s": (hi - lo) / 1e6, "idle_s": idle,
            "launches": counted}
