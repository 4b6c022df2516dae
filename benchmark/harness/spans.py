"""Spans the traced run records from the benchmark's own side: CUDA events
around calls into the program's layers, installed by wrapping the module
attributes each per-layer metric's file names (``WRAPS``), and the
profiler's reduction to busy time, kernel time by symbol and idle gaps.

A wrap target is ``"package.module:function"``, or
``"package.module:factory().attr"`` for a function the program hands out
in an object (the optimizer's ``update``): the factory is wrapped so that
what it returns carries the timed attribute."""

from __future__ import annotations

import bisect
import functools
import importlib

import torch
from torch.autograd import DeviceType


class Spans:
    """Per request, the CUDA-event time and call count of each target."""

    def __init__(self, targets, device):
        self.targets = sorted(set(targets))
        self.cuda = torch.device(device).type == "cuda"
        self.pending = []
        self.undo = []

    def _timed(self, name, fn):
        @functools.wraps(fn)
        def timed(*args, **kwargs):
            if not self.cuda:
                self.pending.append((name, None, None))
                return fn(*args, **kwargs)
            start = torch.cuda.Event(enable_timing=True)
            end = torch.cuda.Event(enable_timing=True)
            start.record()
            with torch.profiler.record_function(name):
                out = fn(*args, **kwargs)
            end.record()
            self.pending.append((name, start, end))
            return out
        return timed

    def install(self):
        for target in self.targets:
            mod_name, _, attr = target.partition(":")
            mod = importlib.import_module(mod_name)
            if attr.endswith(")") or "()." in attr:
                factory, _, inner = attr.partition("().")
                orig = getattr(mod, factory)

                def make(*a, _orig=orig, _inner=inner, _name=target, **k):
                    obj = _orig(*a, **k)
                    return obj._replace(**{_inner: self._timed(
                        _name, getattr(obj, _inner))})
                setattr(mod, factory, make)
                self.undo.append((mod, factory, orig))
            else:
                orig = getattr(mod, attr)
                setattr(mod, attr, self._timed(target, orig))
                self.undo.append((mod, attr, orig))
        return self

    def remove(self):
        for mod, attr, orig in reversed(self.undo):
            setattr(mod, attr, orig)
        self.undo = []

    def collect(self) -> dict:
        """The spans since the last call, after a synchronise: ``{target:
        [ms, calls]}`` (ms 0 off the card)."""
        out = {t: [0.0, 0] for t in self.targets}
        for name, start, end in self.pending:
            out[name][1] += 1
            if start is not None:
                out[name][0] += start.elapsed_time(end)
        self.pending = []
        return out


def device_busy(events) -> tuple:
    """(busy, window) in seconds of a profile's device events: the union of
    their intervals and the span from the first start to the last end.
    CUPTI's "Command Buffer Full" records (host time blocked on a full
    launch queue) are no device work and are left out.  A frozen copy of
    ``chip_smoke.device_busy_ms`` (chip_smoke.py:2916-2931)."""
    spans = sorted((e.time_range.start, e.time_range.end) for e in events
                   if e.device_type == DeviceType.CUDA
                   and e.name != "Command Buffer Full")
    if not spans:
        return 0.0, 0.0, []
    busy, lo, hi = 0.0, *spans[0]
    gaps = []
    for start, end in spans[1:]:
        if start > hi:
            busy, lo = busy + hi - lo, start
            gaps.append((hi, start))
        hi = max(hi, end)
    busy += hi - lo
    return busy / 1e6, (hi - spans[0][0]) / 1e6, gaps


def reduce_profile(prof, wall_s: float, annotations=()) -> dict:
    """Busy and window seconds, device seconds by kernel symbol, the top
    device operations and the longest idle gaps labelled by the host's
    innermost operation at the gap's start.  ``annotations``: the names of
    the spans' ranges, which the trace also draws on the device's timeline
    and which are no device work."""
    skip = set(annotations)
    events = [e for e in prof.events()
              if not (e.device_type == DeviceType.CUDA and e.name in skip)]
    busy, _, gaps = device_busy(events)
    by_name = {}
    for e in events:
        if e.device_type == DeviceType.CUDA and e.name != "Command Buffer Full":
            by_name[e.name] = by_name.get(e.name, 0.0) + (
                e.time_range.end - e.time_range.start) / 1e6
    host = sorted(((e.time_range.start, e.time_range.end, e.name)
                   for e in events if e.device_type == DeviceType.CPU),
                  key=lambda x: x[0])
    starts = [h[0] for h in host]
    labelled = {}
    for a, b in gaps:
        # the latest-starting host operation still running at the gap's
        # start: the innermost one, as host operations nest
        i = bisect.bisect_right(starts, a) - 1
        label = "no host operation"
        for j in range(i, max(i - SCAN, -1), -1):
            if host[j][1] >= a:
                label = host[j][2]
                break
        labelled[label] = labelled.get(label, 0.0) + (b - a) / 1e6
    top = sorted(by_name.items(), key=lambda kv: -kv[1])[:10]
    idle = sorted(labelled.items(), key=lambda kv: -kv[1])[:10]
    return {"busy_s": busy, "window_s": wall_s, "kernels": by_name,
            "breakdown": {"device_ops": [[n[:NAME_CHARS], s] for n, s in top],
                          "idle_gaps": [[n[:NAME_CHARS], s]
                                        for n, s in idle]}}


NAME_CHARS = 160  # a kernel's templated name, cut for the record
SCAN = 256  # host operations looked back over for a gap's label
