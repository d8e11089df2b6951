"""The least time of the forward's convolutions at the cell's shapes
(``benchlib/counts.py``: each the larger of its operations at the
configuration's dense peak and its bytes at 3.35 TB/s), as a share of the
device busy time of the operations launched in the ``h100bench.forward``
span, per batch, from the trace."""


def read(ctx):
    tr = ctx["trace"]
    if tr is None:
        return None
    busy = tr.span_busy_us("h100bench.forward")
    if not busy or sum(busy) <= 0:
        return None
    return 100.0 * ctx["convs_bound_s"] / (sum(busy) / len(busy) / 1e6)
