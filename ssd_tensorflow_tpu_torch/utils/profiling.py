"""Profiling helpers: step timing, the program's spans and ``torch.profiler``
trace capture.

A throughput meter the train CLI reports per epoch; :func:`span`, the
named spans the program opens at its layer boundaries (``ssd.*``), which
cost almost nothing unless a profiler runs, and :func:`counted_span`, a
function's calls inside such a span and counted; :func:`span_device_ms`, which
puts a trace's device time down to those spans; and a context manager
that writes a Chrome trace of the CPU and (on the card) CUDA activity of
its block, in place of the JAX package's ``jax.profiler`` trace.
"""

from __future__ import annotations

import contextlib
import functools
import json
import os
import tempfile
import time
from collections import defaultdict

import torch
from torch.autograd import profiler as _autograd_profiler

#: what :func:`span` returns while no profiler runs
_NO_SPAN = contextlib.nullcontext()

#: the program's span names start with this
PREFIX = "ssd."
#: a trace's events of the device, and of the host calls that launch them
DEVICE_CATS = ("kernel", "gpu_memcpy", "gpu_memset")
LAUNCH_CATS = ("cuda_runtime", "cuda_driver")


def span(name: str):
    """A ``torch.profiler.record_function(name)`` span while a profiler
    runs, else a shared null context: the check is a flag the profiler
    sets on start and clears on stop, so a span costs well under a
    microsecond when nothing records it. A span changes no number: it is
    a ``user_annotation`` event on the profiler's own clock, and the
    device operations launched inside it are put down to it by
    :func:`span_device_ms`."""
    if _autograd_profiler._is_profiler_enabled:
        return torch.profiler.record_function(name)
    return _NO_SPAN


def counted_span(name: str):
    """Decorator: each call of the function runs inside :func:`span`
    ``name`` and counts once in the function's ``calls`` attribute (0 at
    import). The wrapper holds its counter itself, so a test or tool that
    patches the module's name keeps the real function counting."""

    def wrap(fn):
        @functools.wraps(fn)
        def counted(*args, **kwargs):
            counted.calls += 1
            with span(name):
                return fn(*args, **kwargs)

        counted.calls = 0
        return counted

    return wrap


class StepTimer:
    """Steps/s and images/s since the last ``reset``: host wall clock, so
    an end-to-end rate (pipeline and launches included), not device time."""

    def __init__(self):
        self.reset()

    def reset(self):
        self._t0 = time.perf_counter()
        self._steps = 0
        self._images = 0

    def step(self, batch_size: int):
        self._steps += 1
        self._images += batch_size

    @property
    def seconds(self) -> float:
        return time.perf_counter() - self._t0

    def rates(self):
        dt = max(self.seconds, 1e-9)
        return self._steps / dt, self._images / dt


@contextlib.contextmanager
def trace(logdir: str):
    """Profile the block with ``torch.profiler`` (CPU, and CUDA where the
    card is present) and write ``logdir/trace.json`` (Chrome / Perfetto)."""
    from torch.profiler import ProfilerActivity, profile

    activities = [ProfilerActivity.CPU]
    if torch.cuda.is_available():
        activities.append(ProfilerActivity.CUDA)
    os.makedirs(logdir, exist_ok=True)
    with profile(activities=activities) as prof:
        yield prof
        if torch.cuda.is_available():
            torch.cuda.synchronize()
    prof.export_chrome_trace(os.path.join(logdir, "trace.json"))


def profiler_events(prof) -> list:
    """The Chrome trace events of a stopped ``torch.profiler`` profile."""
    with tempfile.TemporaryDirectory() as tmp:
        path = os.path.join(tmp, "trace.json")
        prof.export_chrome_trace(path)
        with open(path) as f:
            data = json.load(f)
    return data["traceEvents"] if isinstance(data, dict) else data


def _span_names(spans, times):
    """For each of ``times``, the name of the latest-starting of ``spans``
    (``(start, end, name)`` of one thread, nested as context managers
    nest) that holds it, or None: a sweep with a stack of the spans open,
    so that any number of siblings may precede a parent's last launch."""
    spans = sorted(spans, key=lambda sp: (sp[0], -sp[1]))
    out = [None] * len(times)
    stack, i = [], 0
    for k in sorted(range(len(times)), key=times.__getitem__):
        t = times[k]
        while i < len(spans) and spans[i][0] <= t:
            while stack and spans[stack[-1]][1] < spans[i][0]:
                stack.pop()
            stack.append(i)
            i += 1
        while stack and spans[stack[-1]][1] < t:
            stack.pop()
        out[k] = spans[stack[-1]][2] if stack else None
    return out


def union_us(intervals) -> float:
    total, end = 0.0, float("-inf")
    for s, e in sorted(intervals):
        if e > end:
            total += e - max(s, end)
            end = e
    return total


def span_ops(events) -> dict:
    """``{span name: [(device operation's name, start us, end us)]}`` of a
    Chrome trace's ``events``: each device operation put down to the
    innermost ``ssd.*`` span open on the thread that launched it (found by
    ``correlation``). An operation launched outside any such span by a
    thread that the profiler followed from the main thread (the autograd
    engine's device threads: their ATen calls are in the trace) goes to
    the main thread's innermost span at the launch, since the main thread
    waits in its span meanwhile; one launched by a thread the profiler did
    not follow (a producer started before it) goes to none. The main
    thread is the one with the most ``ssd.*`` spans."""
    spans, followed = defaultdict(list), set()
    for e in events:
        if e.get("cat") == "user_annotation" and "dur" in e \
                and str(e.get("name", "")).startswith(PREFIX):
            spans[e.get("tid")].append((float(e["ts"]), float(e["ts"]) + float(e["dur"]),
                                        e["name"]))
        elif e.get("cat") == "cpu_op":
            followed.add(e.get("tid"))
    if not spans:
        return {}
    main_tid = max(spans, key=lambda tid: len(spans[tid]))
    launches = {e["args"]["correlation"]: (float(e["ts"]), e.get("tid")) for e in events
                if e.get("cat") in LAUNCH_CATS and "correlation" in e.get("args", {})}
    ops = [launches[e["args"]["correlation"]] + (float(e["ts"]), float(e["ts"]) + float(e["dur"]),
                                                 e.get("name", "?"))
           for e in events if e.get("cat") in DEVICE_CATS and "dur" in e
           and e.get("args", {}).get("correlation") in launches]
    names = _span_names(spans[main_tid], [t for t, _, _, _, _ in ops])
    by_thread = defaultdict(list)
    for k, (_, tid, _, _, _) in enumerate(ops):
        by_thread[tid].append(k)
    for tid, ks in by_thread.items():
        if tid == main_tid:
            continue
        own = _span_names(spans.get(tid, []), [ops[k][0] for k in ks])
        for k, name in zip(ks, own):
            if name is not None or tid not in followed:
                names[k] = name
    per = defaultdict(list)
    for (_, _, s, e, op), name in zip(ops, names):
        if name is not None:
            per[name].append((op, s, e))
    return dict(per)


def span_device_ms(events) -> dict:
    """``{span name: device busy ms}`` of a Chrome trace's ``events``: a
    span's time the union of the intervals of the operations
    :func:`span_ops` puts down to it."""
    return {name: union_us((s, e) for _, s, e in ops) / 1e3
            for name, ops in span_ops(events).items()}
