"""The traced run's readings: the device trace, the benchmark's spans
around calls into the port, and each kernel launch's shapes.

Spans and shape records come from wrappers this module sets on the port's
module attributes for the traced window only and takes off after it; no
file of the port changes.  Times are time.time_ns(), the clock the
profiler's events carry, so spans and device events share one timeline.
"""

from __future__ import annotations

import importlib
import threading
import time
from collections import defaultdict
from dataclasses import dataclass, field

#: the port's functions the benchmark times as spans: span name ->
#: (module, attribute)
SPANS = {"cabac_transcode": ("x264vfw_tpu_torch.bitstream.cabac_transcode",
                             "transcode_slice")}


@dataclass
class Readings:
    """What the traced window left for the per-layer readers."""
    window_ns: tuple = (0, 0)
    device: list = field(default_factory=list)   # (start, end, name, kind)
    spans: list = field(default_factory=list)    # (name, start, end)
    launches: dict = field(default_factory=dict)  # kernel -> [args, ...]
    events: int = 0
    process_s: float = 0.0

    @property
    def window_s(self) -> float:
        return (self.window_ns[1] - self.window_ns[0]) / 1e9

    def kernels(self, name: str | None = None) -> list:
        """Device kernel events inside the window, by kernel name
        (substring) or all."""
        t0, t1 = self.window_ns
        return [e for e in self.device
                if e[3] == "kernel" and t0 <= e[0] < t1
                and (name is None or name in e[2])]

    def busy_intervals(self) -> list:
        """Merged intervals in which anything ran on the device, clipped
        to the window."""
        t0, t1 = self.window_ns
        ivs = sorted((max(s, t0), min(e, t1)) for s, e, _, _ in self.device
                     if e > t0 and s < t1)
        merged: list = []
        for s, e in ivs:
            if merged and s <= merged[-1][1]:
                if e > merged[-1][1]:
                    merged[-1][1] = e
            else:
                merged.append([s, e])
        return merged

    def busy_s(self) -> float:
        return sum(e - s for s, e in self.busy_intervals()) / 1e9


class Tracer:
    """Wraps the port's span and kernel functions, runs the profiler over
    the window, and gathers the Readings."""

    def __init__(self, rooflines: dict):
        self.rooflines = rooflines
        self.readings = Readings()
        self._restore: list = []
        self._lock = threading.Lock()
        self._prof = None

    def _wrap(self, module: str, attr: str, make):
        mod = importlib.import_module(module)
        orig = getattr(mod, attr)
        setattr(mod, attr, make(orig))
        self._restore.append((mod, attr, orig))

    def install(self) -> None:
        spans = self.readings.spans

        def span(name):
            def make(orig):
                def timed(*a, **k):
                    t0 = time.time_ns()
                    try:
                        return orig(*a, **k)
                    finally:
                        with self._lock:
                            spans.append((name, t0, time.time_ns()))
                return timed
            return make

        for name, (module, attr) in SPANS.items():
            self._wrap(module, attr, span(name))

        launches = self.readings.launches

        def record(kernel, shape_of):
            def make(orig):
                def recorded(*a, **k):
                    shapes = shape_of(*a, **k)
                    t0 = time.time_ns()
                    out = orig(*a, **k)
                    with self._lock:
                        launches.setdefault(kernel, []).append((t0, shapes))
                    return out
                return recorded
            return make

        for kernel, mod in self.rooflines.items():
            for module, attr in mod.PATCH:
                self._wrap(module, attr, record(kernel, mod.args))

    def uninstall(self) -> None:
        while self._restore:
            mod, attr, orig = self._restore.pop()
            setattr(mod, attr, orig)

    def start(self) -> None:
        import torch
        from torch.profiler import ProfilerActivity, profile

        self._prof = profile(activities=[ProfilerActivity.CUDA])
        self._prof.__enter__()
        torch.cuda.synchronize()

    def stop(self, window_ns: tuple) -> None:
        import torch
        from torch.autograd import DeviceType

        torch.cuda.synchronize()
        self._prof.__exit__(None, None, None)
        t = time.perf_counter()
        r = self.readings
        r.window_ns = window_ns
        dev = r.device
        n = 0
        for e in self._prof.profiler.kineto_results.events():
            n += 1
            if e.device_type() == DeviceType.CUDA:
                name = e.name()
                dev.append((e.start_ns(), e.end_ns(), name, _kind(name)))
        r.events = n
        self._prof = None
        r.process_s = time.perf_counter() - t


def _kind(name: str) -> str:
    """A device event's kind by its name, as CUPTI names copies and sets."""
    if name.startswith("Memcpy"):
        return "memcpy"
    if name.startswith("Memset"):
        return "memset"
    return "kernel"


def breakdown(r: Readings, top: int = 10) -> dict:
    """The device operations that took most time and the longest idle
    gaps, each gap named by the span that covered its middle."""
    by_name: dict = defaultdict(int)
    t0, t1 = r.window_ns
    for s, e, name, _ in r.device:
        if t0 <= s < t1:
            by_name[name] += e - s
    ops = sorted(by_name.items(), key=lambda kv: -kv[1])[:top]
    busy = r.busy_intervals()
    edges = [t0] + [x for iv in busy for x in iv] + [t1]
    gaps = [(edges[i], edges[i + 1]) for i in range(0, len(edges), 2)
            if edges[i + 1] > edges[i]]
    gaps.sort(key=lambda g: g[0] - g[1])
    spans = sorted(r.spans, key=lambda s: s[1])
    named = []
    for s, e in gaps[:top]:
        mid = (s + e) // 2
        what = "host: the benchmark's loop"
        for name, a, b in spans:
            if a <= mid < b:
                what = "host: " + name
        named.append([what, (e - s) / 1e9])
    return {"device_ops": [[n, v / 1e9] for n, v in ops],
            "idle_gaps": named}
