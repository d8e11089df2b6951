"""The uint8 stem kernel's least time at the cell's shapes
(``benchlib/counts.stem_bound_s``) as a share of its device time per
launch, found in the trace by the kernel's name."""

KERNEL = "stem_uint8_kernel"


def read(ctx):
    tr, bound = ctx["device_trace"] or ctx["trace"], ctx["stem_bound_s"]
    if tr is None or bound is None:
        return None
    times = tr.kernel_us(KERNEL)
    if not times:
        return None
    return 100.0 * bound / (sum(times) / len(times) / 1e6)
