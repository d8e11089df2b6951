"""Reading a ``torch.profiler`` Chrome trace: the device's operations in
the traced window, their busy time as the union of their intervals, the
operations launched inside each of the benchmark's spans, the kernels
that took most time and the longest idle gaps with what the host was
doing meanwhile. Times in the trace are microseconds."""

from __future__ import annotations

import bisect
import json
import os
from collections import defaultdict

DEVICE_CATS = ("kernel", "gpu_memcpy", "gpu_memset")
LAUNCH_CATS = ("cuda_runtime", "cuda_driver")
HOST_CATS = ("cpu_op", "user_annotation", "cuda_runtime", "cuda_driver", "python_function")
WINDOW = "h100bench.window"


def union_us(intervals) -> float:
    """Total length of the union of ``(start, end)`` intervals."""
    total, end = 0.0, float("-inf")
    for s, e in sorted(intervals):
        if e <= end:
            continue
        total += e - max(s, end)
        end = e
    return total


def _merged(intervals):
    out = []
    for s, e in sorted(intervals):
        if out and s <= out[-1][1]:
            out[-1][1] = max(out[-1][1], e)
        else:
            out.append([s, e])
    return out


class Trace:
    """The parsed trace of one profiled window (the ``h100bench.window``
    span, or without one the first to the last device operation): ``ops``
    are ``(name, start, end, span)`` of the device, ``span``
    the index in ``span_names`` of the innermost benchmark span
    (``h100bench.*``) that the operation was launched in, or None."""

    def __init__(self, events: list, spans: bool = True):
        spans = [e for e in events if spans and e.get("cat") == "user_annotation"
                 and "dur" in e and str(e.get("name", "")).startswith("h100bench.")]
        windows = [e for e in spans if e["name"] == WINDOW]
        if windows:
            w = windows[-1]
            self.t0, self.t1 = float(w["ts"]), float(w["ts"]) + float(w["dur"])
            self.main_tid = w.get("tid")
        else:  # device activity alone: the window is the first to the last operation
            dev = [(float(e["ts"]), float(e["ts"]) + float(e["dur"])) for e in events
                   if e.get("cat") in DEVICE_CATS and "dur" in e]
            if not dev:
                raise ValueError("the trace holds no h100bench.window span and no device operation")
            self.t0, self.t1 = min(s for s, _ in dev), max(e for _, e in dev)
            self.main_tid = None
        inner = sorted((float(e["ts"]), float(e["ts"]) + float(e["dur"]), e["name"])
                       for e in spans if e["name"] != WINDOW)
        starts = [s for s, _, _ in inner]
        launch_at = {}
        for e in events:
            if e.get("cat") in LAUNCH_CATS and "correlation" in e.get("args", {}):
                launch_at[e["args"]["correlation"]] = float(e["ts"])
        self.ops = []
        for e in events:
            if e.get("cat") not in DEVICE_CATS or "dur" not in e:
                continue
            s, end = float(e["ts"]), float(e["ts"]) + float(e["dur"])
            if end <= self.t0 or s >= self.t1:
                continue
            span = None
            at = launch_at.get(e.get("args", {}).get("correlation"))
            if at is not None:
                i = bisect.bisect_right(starts, at) - 1
                # the innermost span that holds the launch: spans only nest, so
                # the enclosing ones started a few entries back
                for j in range(i, max(i - 8, -1), -1):
                    if inner[j][0] <= at <= inner[j][1]:
                        span = j
                        break
            self.ops.append((e.get("name", "?"), max(s, self.t0), min(end, self.t1), span))
        self.span_names = [name for _, _, name in inner]
        self.host = sorted((float(e["ts"]), float(e["ts"]) + float(e["dur"]), e.get("name", "?"))
                           for e in events if e.get("cat") in HOST_CATS and "dur" in e
                           and e.get("tid") == self.main_tid)

    @classmethod
    def from_profiler(cls, prof, path: str, spans: bool = True) -> "Trace":
        """The trace of a finished profiler; ``spans=False`` for one that
        recorded CUDA activity alone, whose host spans carry no times."""
        prof.export_chrome_trace(path)
        try:
            with open(path) as f:
                data = json.load(f)
        finally:
            os.remove(path)
        return cls(data["traceEvents"] if isinstance(data, dict) else data, spans)

    @property
    def window_us(self) -> float:
        return self.t1 - self.t0

    @property
    def busy_us(self) -> float:
        return union_us((s, e) for _, s, e, _ in self.ops)

    def span_busy_us(self, span: str):
        """Device busy time of the operations launched in each ``span``, a
        list with one entry per span instance, in order."""
        per = defaultdict(list)
        for _, s, e, j in self.ops:
            if j is not None and self.span_names[j] == span:
                per[j].append((s, e))
        return [union_us(per[j]) for j in sorted(per)]

    def kernel_us(self, substring: str):
        """Durations of the device operations whose name holds ``substring``."""
        return [e - s for name, s, e, _ in self.ops if substring in name]

    def top_ops(self, n: int = 10):
        total = defaultdict(float)
        for name, s, e, _ in self.ops:
            total[name] += e - s
        return sorted(total.items(), key=lambda kv: -kv[1])[:n]

    def idle_gaps(self, n: int = 10):
        """The ``n`` longest gaps in which the device ran nothing, each named
        by the innermost host event of the main thread at its middle."""
        busy = _merged((s, e) for _, s, e, _ in self.ops)
        edges = [self.t0] + [x for iv in busy for x in iv] + [self.t1]
        gaps = [(edges[i], edges[i + 1]) for i in range(0, len(edges), 2)
                if edges[i + 1] > edges[i]]
        gaps.sort(key=lambda g: g[0] - g[1])
        out = []
        for s, e in gaps[:n]:
            mid = (s + e) / 2
            best = None
            for hs, he, name in self.host:
                if hs > mid:
                    break
                if he >= mid and (best is None or he - hs < best[1] - best[0]):
                    best = (hs, he, name)
            out.append((f"host: {best[2]}" if best else "host: outside any traced event", e - s))
        return out
