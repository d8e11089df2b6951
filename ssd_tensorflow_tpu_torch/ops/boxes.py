"""Box-coordinate operations on torch tensors.

Two coordinate systems, as in the JAX package:

* proportional center form ``(cx, cy, w, h)``, floats nominally in [0, 1];
* canvas corners ``(xmin, xmax, ymin, ymax)`` on the integerized
  1000x1000 virtual canvas used by all protocol-sensitive IoU math
  (truncation toward zero, +1-pixel areas).
"""

from __future__ import annotations

import torch

from ssd_tensorflow_tpu_torch.types import CANVAS

#: Virtual canvas edge length.
CANVAS_SIZE = CANVAS.w


def true_div(x, c: float):
    """``x / c`` for a Python number ``c``, divided on every device. On a
    CUDA tensor PyTorch turns ``x / c`` into ``x * (1 / c)``, which can be
    one bit off the division the CPU and the JAX package do; a divisor on
    ``x``'s device keeps the division (and launches no copy)."""
    return x / torch.full((), c, dtype=x.dtype, device=x.device)


def cxcywh_to_corners(boxes, img_w: float = 1.0, img_h: float = 1.0):
    """``(..., 4)`` center-form boxes -> float corners (xmin, xmax, ymin, ymax)."""
    cx = boxes[..., 0] * img_w
    cy = boxes[..., 1] * img_h
    w2 = boxes[..., 2] * img_w * 0.5
    h2 = boxes[..., 3] * img_h * 0.5
    return torch.stack([cx - w2, cx + w2, cy - h2, cy + h2], dim=-1)


def corners_to_cxcywh(corners, img_w: float = 1.0, img_h: float = 1.0):
    """Float corners ``(xmin, xmax, ymin, ymax)`` -> proportional center form."""
    xmin, xmax = corners[..., 0], corners[..., 1]
    ymin, ymax = corners[..., 2], corners[..., 3]
    w = true_div(xmax - xmin, img_w)
    h = true_div(ymax - ymin, img_h)
    cx = true_div(xmin + (xmax - xmin) * 0.5, img_w)
    cy = true_div(ymin + (ymax - ymin) * 0.5, img_h)
    return torch.stack([cx, cy, w, h], dim=-1)


def box_canvas_corners(boxes, canvas: int = CANVAS_SIZE):
    """Center-form boxes -> canvas corners, truncated toward zero and
    kept as float for the IoU arithmetic downstream."""
    return torch.trunc(cxcywh_to_corners(boxes, canvas, canvas))


def clamp_boxes(boxes, canvas: int = CANVAS_SIZE):
    """Integerize onto the canvas, clamp to its bounds (with the
    ``min(xmin, xmax)`` guard for degenerate boxes) and convert back to
    center form. Rows holding NaN or Inf pass through untouched."""
    c = box_canvas_corners(boxes, canvas)
    xmin = torch.clamp_min(c[..., 0], 0.0)
    xmax = torch.clamp_max(c[..., 1], canvas - 1.0)
    ymin = torch.clamp_min(c[..., 2], 0.0)
    ymax = torch.clamp_max(c[..., 3], canvas - 1.0)
    xmin = torch.minimum(xmin, xmax)
    ymin = torch.minimum(ymin, ymax)
    out = corners_to_cxcywh(torch.stack([xmin, xmax, ymin, ymax], dim=-1), canvas, canvas)
    finite = torch.isfinite(boxes).all(dim=-1, keepdim=True)
    return torch.where(finite, out, boxes)
