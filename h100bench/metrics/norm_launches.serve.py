"""Kernel launches a batch inside the program's GroupNorm: the main
thread's kernel-launch runtime calls (``cudaLaunchKernel`` and its kin)
that fall inside the program's ``ssd.group_norm`` spans
(``models/resnet.group_norm``), over the ``h100bench.forward`` spans of
the host phase of a traced window. It reads only ``Trace.host``, as
``benchlib/program.py`` does. None where the program opens no such span,
or the trace holds no launch (a run on the CPU)."""

import bisect

SPAN = "ssd.group_norm"
BATCH = "h100bench.forward"
#: runtime and driver calls that launch a kernel
LAUNCH_PREFIXES = ("cudaLaunch", "cuLaunch")


def _inside(trace, name):
    """``(start, end)`` of the main thread's host events called ``name``,
    within the window, in start order."""
    return sorted((max(s, trace.t0), min(e, trace.t1)) for s, e, n in trace.host
                  if n == name and e > trace.t0 and s < trace.t1)


def read(ctx):
    tr = ctx["trace"]
    if tr is None or tr.main_tid is None:
        return None
    batches, spans = _inside(tr, BATCH), _inside(tr, SPAN)
    launches = [s for s, _, n in tr.host if n.startswith(LAUNCH_PREFIXES)]
    if not batches or not spans or not launches:
        return None
    starts = [s for s, _ in spans]
    n = 0
    for t in launches:
        i = bisect.bisect_right(starts, t) - 1
        n += i >= 0 and t <= spans[i][1]
    return n / len(batches)
