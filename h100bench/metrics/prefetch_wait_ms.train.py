"""Host ms a step that the main thread spent inside the program's span
``ssd.prefetch.wait`` (``parallel/prefetch``: blocked on the queue for the
next batch), over the ``h100bench.step`` spans of the host phase of a
traced window (``benchlib/program.py``); None where the program opens no
such span."""

from benchlib import program


def read(ctx):
    return program.host_ms_per_step(ctx["trace"], "ssd.prefetch.wait")
