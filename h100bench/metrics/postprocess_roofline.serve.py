"""The least time of RetinaNet's multi-label decode as a share of the device
busy time of the operations launched in the ``h100bench.postprocess`` span
(the harness's own call of ``ops/postprocess.decode_scores``), per batch,
from the trace. The least time is the class logits and box offsets read
once at 3.35 TB/s: ``B x A x (K + 4) x 2`` bytes of bf16, with ``A`` and
``K`` from the RetinaNet configuration's file (the only cell it reads,
whose forward hands the decode 4.1 GB a batch of 64); selection, NMS
and compaction add no bytes of that order. On a cell whose forward is not
that configuration's (its operations an image differ) it raises rather
than report another model's bound."""

import functools
import json
from pathlib import Path

from benchlib import counts

CONFIG = Path(__file__).resolve().parents[1] / "configs" / "retinanet800-resnext50fpn-bf16.json"
SPAN = "h100bench.postprocess"


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
    nbytes = batch * cfg["preset"]["num_anchors"] * (cfg["model"]["num_classes"] + 4) * 2
    return nbytes / counts.HBM_BYTES_PER_S


def read(ctx):
    tr = ctx["trace"]
    if tr is None:
        return None
    busy = tr.span_busy_us(SPAN)
    if not busy or sum(busy) <= 0:
        return None
    cfg = config_of(ctx)
    return 100.0 * bound_s(cfg, ctx["batch"]) / (sum(busy) / len(busy) / 1e6)
