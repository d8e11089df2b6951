"""Numpy (host) versions of the protocol IoU, in float64.

The port's own copy of the JAX package's ``ops/iou_np.py``: the host-side
check of :func:`ssd_tensorflow_tpu_torch.ops.matching.has_positive_anchor`
uses it, as the data pipeline's resampling rule does.
"""

from __future__ import annotations

import numpy as np

from ssd_tensorflow_tpu_torch.types import CANVAS

#: the square protocol canvas
CANVAS_SIZE = CANVAS.w


def canvas_corners_np(boxes, canvas: int = CANVAS_SIZE):
    """Center-form ``(N, 4)`` boxes -> integerized canvas corners
    ``(xmin, xmax, ymin, ymax)``, truncated toward zero, float64."""
    boxes = np.asarray(boxes, dtype=np.float64)
    cx = boxes[..., 0] * canvas
    cy = boxes[..., 1] * canvas
    w2 = boxes[..., 2] * canvas / 2.0
    h2 = boxes[..., 3] * canvas / 2.0
    return np.trunc(np.stack([cx - w2, cx + w2, cy - h2, cy + h2], axis=-1))


def pairwise_canvas_iou_np(a, b):
    """+1-pixel IoU of canvas corners ``(N, 4)`` x ``(M, 4)`` -> ``(N, M)``."""
    a = np.asarray(a, dtype=np.float64)
    b = np.asarray(b, dtype=np.float64)
    area_a = (a[:, 1] - a[:, 0] + 1) * (a[:, 3] - a[:, 2] + 1)
    area_b = (b[:, 1] - b[:, 0] + 1) * (b[:, 3] - b[:, 2] + 1)
    iw = np.maximum(0.0, np.minimum(a[:, None, 1], b[None, :, 1])
                    - np.maximum(a[:, None, 0], b[None, :, 0]) + 1)
    ih = np.maximum(0.0, np.minimum(a[:, None, 3], b[None, :, 3])
                    - np.maximum(a[:, None, 2], b[None, :, 2]) + 1)
    inter = iw * ih
    return inter / (area_a[:, None] + area_b[None, :] - inter)


def canvas_iou_np(boxes_a, boxes_b):
    """Protocol IoU of center-form boxes ``(N, 4)`` x ``(M, 4)`` on the host."""
    return pairwise_canvas_iou_np(canvas_corners_np(boxes_a), canvas_corners_np(boxes_b))
