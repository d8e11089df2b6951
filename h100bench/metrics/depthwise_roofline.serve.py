"""The depthwise convs' bound of a batch as a share of the device time a
batch of ``csrc/depthwise_conv.cu``'s kernel, found in the host phase's
trace by name (one launch a depthwise conv), over its ``h100bench.forward``
spans as ``depthwise_ms.serve`` counts them. None where the kernel did not
run.

The bound is ``benchlib/counts.py``'s, summed over the configuration's
depthwise records (``groups`` equal to ``cin``, more than one channel):
each the larger of its operations at the configuration's dense peak and
its map read once, its filter and its output written once at 3.35 TB/s.
At mobilenet320 b64 the 13 convs are byte-bound, ~0.39 ms a batch.

The records come from MobileNet's configuration file, the one cell it
reads; on a cell whose forward is not that configuration's (its
operations an image differ) it raises rather than report another model's
bound."""

import functools
import json
from pathlib import Path

from benchlib import counts

CONFIG = Path(__file__).resolve().parents[1] / "configs" / "ssd320-mobilenetv1-int8.json"
#: the kernel, by a substring of its name
KERNEL = "depthwise3x3_nhwc"
BATCH = "h100bench.forward"


@functools.cache
def described():
    """``(configuration, its forward's operations an image)``."""
    cfg = json.loads(CONFIG.read_text())
    return cfg, counts.forward_ops(cfg)


def config_of(ctx) -> dict:
    cfg, ops = described()
    if abs(ctx["forward_ops_per_item"] - ops) > 1e-9 * ops:
        raise ValueError(f"this reader describes {cfg['name']} ({ops:.6g} operations an "
                         f"image), not a forward of {ctx['forward_ops_per_item']:.6g}")
    return cfg


def bound_s(cfg: dict, batch: int) -> float:
    return sum(counts.conv_bound_s(c, cfg["precision"]) for c in counts.conv_shapes(cfg, batch)
               if c["groups"] == c["cin"] > 1)


def read(ctx):
    tr = ctx["trace"]
    if tr is None or tr.main_tid is None:
        return None
    batches = sum(1 for s, e, n in tr.host if n == BATCH and e > tr.t0 and s < tr.t1)
    us = sum(tr.kernel_us(KERNEL))
    if not batches or us <= 0:
        return None
    return 100.0 * bound_s(config_of(ctx), ctx["batch"]) / (us / batches / 1e6)
