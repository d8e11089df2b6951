"""The reader ``forward_launches.serve`` on hand-written Chrome traces: the
main thread's kernel and graph launches inside the ``h100bench.forward``
spans, per span. Times in microseconds."""

import h100bench_cases as hc  # noqa: F401  (puts benchlib on the path)

from benchlib import registry
from benchlib.trace import Trace

MAIN, OTHER, STREAM = 1, 2, 7


def span(name, ts, end, tid=MAIN):
    return {"ph": "X", "cat": "user_annotation", "name": name, "ts": ts, "dur": end - ts,
            "tid": tid}


def call(corr, ts, name="cudaLaunchKernel", tid=MAIN):
    return {"ph": "X", "cat": "cuda_runtime", "name": name, "ts": ts, "dur": 1, "tid": tid,
            "args": {"correlation": corr}}


def kernel(corr, ts, end):
    return {"ph": "X", "cat": "kernel", "name": "k", "ts": ts, "dur": end - ts, "tid": STREAM,
            "args": {"correlation": corr}}


def eager_forwards():
    """Two forwards of five launches each (one a cluster launch of the
    driver's), a launch between them and one on another thread."""
    ev = [span("h100bench.window", 0, 300),
          span("h100bench.forward", 10, 100), span("h100bench.forward", 150, 240)]
    corr = iter(range(100, 200))
    for t0 in (10, 150):
        for i, name in enumerate(["cudaLaunchKernel"] * 4 + ["cuLaunchKernelEx"]):
            c = next(corr)
            ev += [call(c, t0 + 5 + 15 * i, name), kernel(c, t0 + 7 + 15 * i, t0 + 15 + 15 * i)]
    c = next(corr)
    ev += [call(c, 120), kernel(c, 121, 125), call(c + 1, 30, tid=OTHER)]
    return ev


def read(events, spans=True):
    return registry.reader("metrics", "forward_launches.serve")({"trace": Trace(events, spans)})


def test_kernel_launches_inside_each_forward():
    assert read(eager_forwards()) == 5.0


def test_a_replayed_forward_is_one_graph_launch():
    """A third forward replays a graph: its input copy and output clones
    are copies (no launch), the graph one launch."""
    ev = eager_forwards() + [span("h100bench.forward", 250, 290),
                             call(900, 252, "cudaMemcpyAsync"),
                             call(901, 255, "cudaGraphLaunch_v10000"), kernel(901, 256, 280),
                             call(902, 285, "cudaMemcpyAsync")]
    assert read(ev) == 11 / 3
    graphs_only = [e for e in ev if e.get("ts", 0) >= 250 or e["name"] == "h100bench.window"]
    assert read(graphs_only) == 1.0


def test_nothing_to_read():
    """No trace, a trace of CUDA activity alone, no forward span, no launch."""
    assert registry.reader("metrics", "forward_launches.serve")({"trace": None}) is None
    assert read(eager_forwards(), spans=False) is None
    assert read([e for e in eager_forwards() if e["name"] != "h100bench.forward"]) is None
    assert read([e for e in eager_forwards() if e["cat"] != "cuda_runtime"]) is None
