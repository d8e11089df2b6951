"""IoU on canvas corners with the +1-pixel convention."""

from __future__ import annotations

import torch

from ssd_tensorflow_tpu_torch.ops.boxes import box_canvas_corners


def pairwise_canvas_iou(corners_a, corners_b):
    """IoU of integerized canvas corners ``(..., N, 4)`` vs ``(..., M, 4)``
    -> ``(..., N, M)``, areas and intersections counted with +1 pixel.

    The operation order is the JAX package's; on integer corners below
    2^24 only the final division rounds, so the result is bit-exact.
    """
    ax_min, ax_max = corners_a[..., :, None, 0], corners_a[..., :, None, 1]
    ay_min, ay_max = corners_a[..., :, None, 2], corners_a[..., :, None, 3]
    bx_min, bx_max = corners_b[..., None, :, 0], corners_b[..., None, :, 1]
    by_min, by_max = corners_b[..., None, :, 2], corners_b[..., None, :, 3]

    area_a = (ax_max - ax_min + 1.0) * (ay_max - ay_min + 1.0)
    area_b = (bx_max - bx_min + 1.0) * (by_max - by_min + 1.0)
    zero = corners_a.new_zeros(())
    iw = torch.maximum(
        zero, torch.minimum(ax_max, bx_max) - torch.maximum(ax_min, bx_min) + 1.0
    )
    ih = torch.maximum(
        zero, torch.minimum(ay_max, by_max) - torch.maximum(ay_min, by_min) + 1.0
    )
    inter = iw * ih
    return inter / (area_a + area_b - inter)


def canvas_iou(boxes_a, boxes_b):
    """Protocol IoU of proportional center-form boxes ``(..., N, 4)`` vs
    ``(..., M, 4)`` -> ``(..., N, M)``: both integerized onto the
    1000x1000 canvas (truncation toward zero), then the +1-pixel IoU.
    The measure anchor matching uses."""
    return pairwise_canvas_iou(box_canvas_corners(boxes_a), box_canvas_corners(boxes_b))
