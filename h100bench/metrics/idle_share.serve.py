"""1 - the union of the device operations' intervals / the traced window,
from the trace of the phase that records CUDA activity alone (the host's
profiler would slow the host and widen the gaps it measures)."""


def read(ctx):
    tr = ctx["device_trace"]
    if tr is None or tr.window_us <= 0 or not tr.ops:
        return None
    return 100.0 * (1.0 - tr.busy_us / tr.window_us)
