"""Greedy non-maximum suppression, plain PyTorch.

Class separation uses the coordinate-offset trick: shifting each
candidate's canvas corners by ``class_id * 4096`` leaves no overlap
across classes, so one greedy pass equals per-class suppression. This
module is the plain version that ``ops/nms_cuda.py``'s kernel is held
against, bit for bit.
"""

from __future__ import annotations

import torch

from ssd_tensorflow_tpu_torch.ops.iou import pairwise_canvas_iou

#: IoU threshold of the reference protocol.
NMS_THRESHOLD = 0.45

#: Per-class coordinate shift; canvas corners live in [0, 1000], so any
#: shift above 1001 leaves zero cross-class overlap.
_CLASS_OFFSET = 4096.0


def greedy_keep(iou, order_valid, threshold: float):
    """Greedy keep mask of candidates sorted by descending score.

    Args:
      iou: ``(..., D, D)`` pairwise IoU.
      order_valid: ``(..., D)`` bool, the candidates eligible for selection.
      threshold: a kept ``i`` suppresses ``j > i`` when ``IoU(i, j) > threshold``.

    Returns:
      ``(..., D)`` bool keep mask, a subset of ``order_valid``.
    """
    d = iou.shape[-1]
    idx = torch.arange(d, device=iou.device)
    # compare in float32, as the JAX package does (the threshold is a
    # weakly typed Python float there)
    over = iou > torch.tensor(threshold, dtype=iou.dtype, device=iou.device)
    suppressed = torch.zeros_like(order_valid, dtype=torch.bool)
    for i in range(d):
        keep_i = ~suppressed[..., i] & order_valid[..., i]
        newly = keep_i[..., None] & over[..., i, :] & (idx > i)
        suppressed = suppressed | newly
    return ~suppressed & order_valid


def class_shifted(corners, classes):
    """Canvas corners shifted by ``class * 4096`` along both axes."""
    shift = classes.to(corners.dtype) * _CLASS_OFFSET
    return corners + shift[..., None]


def class_aware_keep(corners, classes, order_valid, threshold: float = NMS_THRESHOLD):
    """Per-class greedy NMS of sorted candidates via coordinate offsets.

    ``corners`` is ``(..., D, 4)`` canvas corners, ``classes`` ``(..., D)``
    integer ids and ``order_valid`` ``(..., D)`` bool.
    """
    shifted = class_shifted(corners, classes)
    return greedy_keep(pairwise_canvas_iou(shifted, shifted), order_valid, threshold)
