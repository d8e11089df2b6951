"""IoU of corner boxes: continuous (:func:`pairwise_iou`) and on canvas
corners with the +1-pixel convention (:func:`pairwise_canvas_iou`,
:func:`canvas_iou`)."""

from __future__ import annotations

import torch

from ssd_tensorflow_tpu_torch.ops.boxes import box_canvas_corners


def _corner_iou(a, b, plus_one: float):
    """IoU of corner boxes ``a (..., N, 4)`` vs ``b (..., M, 4)`` ->
    ``(..., N, M)``, areas and intersections counted with ``plus_one``
    pixel, in the JAX package's operation order."""
    ax_min, ax_max = a[..., :, None, 0], a[..., :, None, 1]
    ay_min, ay_max = a[..., :, None, 2], a[..., :, None, 3]
    bx_min, bx_max = b[..., None, :, 0], b[..., None, :, 1]
    by_min, by_max = b[..., None, :, 2], b[..., None, :, 3]

    area_a = (ax_max - ax_min + plus_one) * (ay_max - ay_min + plus_one)
    area_b = (bx_max - bx_min + plus_one) * (by_max - by_min + plus_one)
    zero = a.new_zeros(())
    iw = torch.maximum(
        zero, torch.minimum(ax_max, bx_max) - torch.maximum(ax_min, bx_min) + plus_one
    )
    ih = torch.maximum(
        zero, torch.minimum(ay_max, by_max) - torch.maximum(ay_min, by_min) + plus_one
    )
    inter = iw * ih
    return inter / (area_a + area_b - inter)


def pairwise_iou(corners_a, corners_b):
    """Continuous IoU of float corner boxes, no pixel convention."""
    return _corner_iou(corners_a, corners_b, plus_one=0.0)


def pairwise_canvas_iou(corners_a, corners_b):
    """IoU of integerized canvas corners ``(..., N, 4)`` vs ``(..., M, 4)``
    -> ``(..., N, M)``, areas and intersections counted with +1 pixel.

    On integer corners below 2^24 only the final division rounds, so the
    result is the JAX package's bit for bit.
    """
    return _corner_iou(corners_a, corners_b, plus_one=1.0)


def canvas_iou(boxes_a, boxes_b):
    """Protocol IoU of proportional center-form boxes ``(..., N, 4)`` vs
    ``(..., M, 4)`` -> ``(..., N, M)``: both integerized onto the
    1000x1000 canvas (truncation toward zero), then the +1-pixel IoU.
    The measure anchor matching uses."""
    return pairwise_canvas_iou(box_canvas_corners(boxes_a), box_canvas_corners(boxes_b))
