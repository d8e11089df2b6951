"""The NMS bound of a batch as a share of the device time a batch of
``csrc/nms.cu``'s kernels for more than 1,024 candidates an image, found in
the trace by name: the mask kernel and the scan kernel, one launch each a
batch. None where they did not run.

The bound is the larger of two, at ``D = levels x top_k`` candidates an
image (RetinaNet's configuration file: 5 x 1000):

* operations: the ``D (D - 1) / 2`` pairwise +1-pixel canvas IoUs an
  image, each ``OPS_PER_IOU`` float32 operations (the intersection's two
  sides, its area, the union, the quotient and the comparison; the boxes'
  areas are per candidate), at the float32 peak of 67 TFLOP/s;
* bytes: the corners (16 bytes a candidate) and the validity read, the keep
  mask written (a byte each), at 3.35 TB/s.

The greedy scan's dependent chain is not counted: it bounds the kernel by
latency, which no byte or operation count sees.

``D`` comes from RetinaNet's configuration file, the one cell it reads;
on a cell whose forward is not that configuration's (its operations an
image differ) it raises rather than report another model's bound."""

import functools
import json
from pathlib import Path

from benchlib import counts

CONFIG = Path(__file__).resolve().parents[1] / "configs" / "retinanet800-resnext50fpn-bf16.json"


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
#: intersection width and height (2 min, 2 max, 2 sub, 2 add, 2 clamps at 0),
#: its area, the union (add, sub), the quotient and the comparison
OPS_PER_IOU = 15
#: the kernels, by a substring of their names; a batch launches the last once
KERNELS = ("nms_mask_global", "nms_scan_global")


def bound_s(batch: int, d: int) -> float:
    ops = batch * d * (d - 1) / 2 * OPS_PER_IOU
    nbytes = batch * d * (16 + 1 + 1)
    return max(ops / counts.PEAK_OPS["float32"], nbytes / counts.HBM_BYTES_PER_S)


def read(ctx):
    tr = ctx["device_trace"] or ctx["trace"]
    if tr is None:
        return None
    batches = len(tr.kernel_us(KERNELS[-1]))
    us = sum(sum(tr.kernel_us(k)) for k in KERNELS)
    if not batches or us <= 0:
        return None
    cfg = config_of(ctx)
    d = len(cfg["preset"]["maps"]) * cfg["detection"]["top_k"]
    return 100.0 * bound_s(ctx["batch"], d) / (us / batches / 1e6)
