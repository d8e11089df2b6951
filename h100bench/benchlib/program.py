"""The program's own spans in a traced window, as ``Trace`` keeps them: the
``ssd.*`` spans that ``ssd_tensorflow_tpu_torch`` opens while a profiler
runs are ``user_annotation`` events, and ``Trace.host`` holds the main
thread's host events (spans, ATen calls, runtime calls) by start, end and
name. What reads only those: the main thread's time inside a span, and
the runtime calls that block it, per benchmark span (``h100bench.step``).

Putting each device operation down to the ``ssd.*`` span that launched it
needs the launch's thread and ``correlation``, which ``Trace`` does not
keep (``PERF.md`` §7). A program without these spans reads as None."""

from __future__ import annotations

#: runtime calls that block the host until the device catches up
SYNC_CALLS = frozenset({"cudaStreamSynchronize", "cudaDeviceSynchronize",
                        "cudaEventSynchronize", "cudaMemcpy"})


def _on_main(trace, name: str):
    """``(start, end)`` of the main thread's host events called ``name``,
    within the window."""
    return [(max(s, trace.t0), min(e, trace.t1)) for s, e, n in trace.host
            if n == name and e > trace.t0 and s < trace.t1]


def _steps(trace):
    """How many ``h100bench.step`` spans the window holds, or None."""
    if trace is None or trace.main_tid is None:
        return None
    return len(_on_main(trace, "h100bench.step")) or None


def host_ms_per_step(trace, span: str):
    """The main thread's ms inside ``span`` a step; None where the program
    opened no such span."""
    steps = _steps(trace)
    inside = _on_main(trace, span) if steps else []
    if not inside:
        return None
    return sum(e - s for s, e in inside) / steps / 1e3


def syncs_per_step(trace):
    """Blocking runtime calls of the main thread inside ``h100bench.step``
    spans, per step."""
    steps = _steps(trace)
    if not steps:
        return None
    windows = _on_main(trace, "h100bench.step")
    calls = [s for s, _, n in trace.host if n in SYNC_CALLS]
    return sum(any(a <= t <= b for a, b in windows) for t in calls) / steps
