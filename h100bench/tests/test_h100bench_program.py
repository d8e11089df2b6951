"""``benchlib/program.py`` and its readers on hand-written Chrome
traces, and ``Trace``'s readings with and without the program's spans.

The train trace: a main thread (1) with the window, two
``h100bench.step`` spans and the step's six parts, the forward holding
ten sibling spans before its own last launch; an autograd-like thread (2)
whose ATen calls are in the trace and which opens no span; a producer
thread (3) that copies inside ``ssd.prefetch.put``; a producer (4) that
the profiler did not follow (no span, no ATen call); two
synchronisations, one inside a step. Times in microseconds."""

import h100bench_cases as hc  # noqa: F401  (puts benchlib on the path)
import pytest

from benchlib import program, registry
from benchlib.trace import Trace

MAIN, AUTOGRAD, PRODUCER, UNFOLLOWED, STREAM, COPIES = 1, 2, 3, 4, 7, 8


def span(name, ts, end, tid=MAIN):
    return {"ph": "X", "cat": "user_annotation", "name": name, "ts": ts, "dur": end - ts,
            "tid": tid}


def launch(corr, ts, tid=MAIN, name="cudaLaunchKernel"):
    return {"ph": "X", "cat": "cuda_runtime", "name": name, "ts": ts, "dur": 1, "tid": tid,
            "args": {"correlation": corr}}


def op(corr, name, ts, end, cat="kernel", stream=STREAM):
    return {"ph": "X", "cat": cat, "name": name, "ts": ts, "dur": end - ts, "tid": stream,
            "args": {"correlation": corr}}


def _step(t0, parts, wait):
    """The main thread's spans of one step from ``t0``: the prefetch wait of
    ``wait`` us, then ``parts`` (name, start, end) of ``ssd.step.*``."""
    out = [span("ssd.prefetch.wait", t0, t0 + wait)]
    return out + [span(f"ssd.step.{n}", s, e) for n, s, e in parts]


def train_events():
    ev = [span("h100bench.window", 0, 1000),
          span("h100bench.step", 10, 400), span("h100bench.step", 500, 900)]
    ev += _step(10, [("targets", 30, 50), ("forward", 50, 200), ("loss", 200, 220),
                     ("backward", 220, 350), ("optimizer", 350, 370), ("detect", 370, 395)], 20)
    ev += _step(500, [("targets", 540, 560), ("forward", 560, 700), ("loss", 700, 720),
                      ("backward", 720, 850), ("optimizer", 850, 870), ("detect", 870, 895)], 40)
    # ten siblings inside the forward, the first launching; then the forward itself
    ev += [span("ssd.layer", 52 + 10 * i, 57 + 10 * i) for i in range(10)]
    ev += [launch(1, 35), op(1, "targets_k", 40, 48),
           launch(2, 53), op(2, "layer_k", 60, 70),
           launch(3, 180), op(3, "fwd_k", 185, 215),
           launch(4, 205), op(4, "loss_k", 216, 226),
           {"ph": "X", "cat": "cpu_op", "name": "autograd::engine::evaluate_function: X",
            "ts": 228, "dur": 112, "tid": AUTOGRAD},
           launch(5, 230, AUTOGRAD), op(5, "bwd_k1", 230, 280),
           launch(6, 290, AUTOGRAD), op(6, "bwd_k2", 290, 330),
           span("ssd.prefetch.put", 240, 300, PRODUCER),
           launch(7, 250, PRODUCER, "cudaMemcpyAsync"),
           op(7, "Memcpy HtoD", 280, 290, "gpu_memcpy", COPIES),
           launch(8, 260, UNFOLLOWED, "cudaMemcpyAsync"),
           op(8, "Memcpy HtoD", 330, 345, "gpu_memcpy", COPIES),
           launch(9, 352), op(9, "opt_k", 355, 365),
           launch(10, 372), op(10, "nms_k", 375, 385),
           {"ph": "X", "cat": "cuda_runtime", "name": "cudaStreamSynchronize", "ts": 386,
            "dur": 8, "tid": MAIN},
           launch(11, 545), op(11, "targets_k", 550, 556),
           launch(12, 600), op(12, "fwd_k", 600, 680),
           {"ph": "X", "cat": "cpu_op", "name": "autograd::engine::evaluate_function: X",
            "ts": 725, "dur": 115, "tid": AUTOGRAD},
           launch(13, 730, AUTOGRAD), op(13, "bwd_k1", 730, 800),
           launch(14, 852), op(14, "opt_k", 855, 860),
           launch(15, 872), op(15, "nms_k", 875, 880),
           {"ph": "X", "cat": "cuda_runtime", "name": "cudaDeviceSynchronize", "ts": 950,
            "dur": 5, "tid": MAIN},
           launch(16, 960), op(16, "tail_k", 960, 970)]
    return ev


def serve_events():
    ev = [span("h100bench.window", 0, 300),
          span("h100bench.forward", 10, 140), span("h100bench.forward", 150, 290)]
    corr = iter(range(100, 200))
    for t0 in (10, 150):
        for i, (stage, dur) in enumerate([("quantize", 8), ("im2col", 6), ("gemm", 5),
                                          ("im2col", 6), ("gemm", 5), ("requant", 7)]):
            s = t0 + 5 + 15 * i
            c = next(corr)
            ev += [span(f"ssd.int8.{stage}", s, s + 10), launch(c, s + 1),
                   op(c, f"{stage}_k", s + 2, s + 2 + dur)]
        c = next(corr)  # a pool: inside the forward, in no stage
        ev += [launch(c, t0 + 110), op(c, "pool_k", t0 + 112, t0 + 122)]
    return ev


@pytest.fixture
def train():
    return Trace(train_events())


def ctx(trace):
    return {"trace": trace}


def _bare(events):
    """The same trace from a program that opens no ``ssd.*`` span."""
    return [e for e in events if not str(e.get("name", "")).startswith("ssd.")]


@pytest.mark.parametrize("name, want", [("prefetch_wait_ms.train", 0.03),
                                        ("host_syncs.train", 0.5)])
def test_train_readers(train, name, want):
    assert registry.reader("metrics", name)(ctx(train)) == pytest.approx(want, abs=1e-12)


def test_a_program_without_spans():
    """The parent's program opens no ``ssd.*`` span: no wait to read, no
    error; its blocking calls still count."""
    bare = Trace(_bare(train_events()))
    assert registry.reader("metrics", "prefetch_wait_ms.train")(ctx(bare)) is None
    assert registry.reader("metrics", "host_syncs.train")(ctx(bare)) == 0.5


@pytest.mark.parametrize("name", ["prefetch_wait_ms.train", "host_syncs.train"])
def test_nothing_to_read(name):
    """No trace, a trace of CUDA activity alone, or a serve window."""
    read = registry.reader("metrics", name)
    assert read(ctx(None)) is None
    assert read(ctx(Trace(train_events(), spans=False))) is None
    assert read(ctx(Trace(serve_events()))) is None


def test_only_blocking_calls_inside_a_step_count():
    ev = train_events() + [launch(99, 420, name="cudaMemcpyAsync"),
                           {"ph": "X", "cat": "cuda_runtime", "name": "cudaEventSynchronize",
                            "ts": 600, "dur": 3, "tid": MAIN},
                           {"ph": "X", "cat": "cuda_runtime", "name": "cudaStreamSynchronize",
                            "ts": 260, "dur": 3, "tid": AUTOGRAD}]
    assert program.syncs_per_step(Trace(ev)) == 1.0


@pytest.mark.parametrize("events", [train_events, serve_events])
def test_trace_readings_unchanged_by_the_programs_spans(events):
    """The device side of ``Trace`` reads the same with and without the
    program's spans; only the idle gaps' names may take them."""
    full, bare = Trace(events()), Trace(_bare(events()))
    assert full.busy_us == bare.busy_us and full.ops == bare.ops
    for span in ("h100bench.step", "h100bench.forward"):
        assert full.span_busy_us(span) == bare.span_busy_us(span)
    assert full.top_ops(10) == bare.top_ops(10)
    assert [us for _, us in full.idle_gaps(10)] == [us for _, us in bare.idle_gaps(10)]


def test_idle_gaps_take_the_programs_span_names(train):
    assert train.busy_us == 369.0
    assert train.span_busy_us("h100bench.step") == [193.0, 166.0]
    assert train.idle_gaps(3) == [("host: h100bench.window", 165.0),
                                  ("host: ssd.step.forward", 115.0),
                                  ("host: h100bench.window", 80.0)]
    assert Trace(_bare(train_events())).idle_gaps(3)[1] == ("host: h100bench.step", 115.0)
