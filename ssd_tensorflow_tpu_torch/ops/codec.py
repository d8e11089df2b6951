"""SSD box codec: center-form boxes <-> anchor-relative offsets.

The prior variances 0.1 (center) and 0.2 (size) are baked in as x10 /
x5 multipliers; decode clamps offsets at 100 to guard ``exp``.
"""

from __future__ import annotations

import torch

#: Decode clamp on the offsets.
DECODE_CLAMP = 100.0


def encode_locations(boxes, anchors):
    """``(..., 4)`` center-form boxes -> offsets ``(tx, ty, tw, th)``."""
    acx, acy, aw, ah = anchors.unbind(-1)
    cx, cy, w, h = boxes.unbind(-1)
    tx = (cx - acx) / aw * 10.0
    ty = (cy - acy) / ah * 10.0
    tw = torch.log(w / aw) * 5.0
    th = torch.log(h / ah) * 5.0
    return torch.stack([tx, ty, tw, th], dim=-1)


def decode_locations(offsets, anchors):
    """Offsets -> center-form boxes, with the offsets clamped at 100."""
    offsets = torch.clamp_max(offsets, DECODE_CLAMP)
    acx, acy, aw, ah = anchors.unbind(-1)
    tx, ty, tw, th = offsets.unbind(-1)
    cx = tx / 10.0 * aw + acx
    cy = ty / 10.0 * ah + acy
    w = torch.exp(tw / 5.0) * aw
    h = torch.exp(th / 5.0) * ah
    return torch.stack([cx, cy, w, h], dim=-1)
