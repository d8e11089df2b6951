"""Box codecs: center-form boxes <-> anchor-relative offsets.

SSD's: the prior variances 0.1 (center) and 0.2 (size) are baked in as
x10 / x5 multipliers; decode clamps offsets at 100 to guard ``exp``.
The R-CNN decoder (RetinaNet's, torchvision's ``BoxCoder.decode`` with
weights ``(1, 1, 1, 1)``): offsets in units of the anchor's size, the
size offsets clamped at ``log(1000 / 16)`` before ``exp``; RetinaNet only
serves, so it has no encoder here.
"""

from __future__ import annotations

import math

import torch

from ssd_tensorflow_tpu_torch.ops.boxes import true_div

#: Decode clamp on the offsets.
DECODE_CLAMP = 100.0
#: the R-CNN coder's clamp on the width and height offsets (torchvision's
#: ``bbox_xform_clip``)
RCNN_SIZE_CLAMP = math.log(1000.0 / 16)


def _log_rounded_once(x):
    """float32 ``log(x)`` rounded once: the logarithm in float64, then one
    rounding to float32. ``torch.log`` in float32 is within an ulp of it
    but not the same function on the CPU and the card, and training
    targets must not depend on the device."""
    return torch.log(x.double()).to(x.dtype)


def _exp_rounded_once(x):
    """float32 ``exp(x)`` rounded once, as :func:`_log_rounded_once`: the
    card's ``expf`` can sit an ulp from the CPU's, and the decode then
    truncates onto the integer canvas, where an ulp across a pixel edge
    moves a box by a whole pixel."""
    return torch.exp(x.double()).to(x.dtype)


def encode_locations(boxes, anchors):
    """``(..., 4)`` center-form float32 boxes -> offsets ``(tx, ty, tw, th)``.
    Equal bit for bit on the CPU and the card (see :func:`_log_rounded_once`)."""
    acx, acy, aw, ah = anchors.unbind(-1)
    cx, cy, w, h = boxes.unbind(-1)
    tx = (cx - acx) / aw * 10.0
    ty = (cy - acy) / ah * 10.0
    tw = _log_rounded_once(w / aw) * 5.0
    th = _log_rounded_once(h / ah) * 5.0
    return torch.stack([tx, ty, tw, th], dim=-1)


def decode_locations(offsets, anchors):
    """Offsets -> center-form boxes, with the offsets clamped at 100.
    Equal bit for bit on the CPU and the card: the divisions are divisions
    on the card too (``boxes.true_div``) and ``exp`` is rounded once
    (:func:`_exp_rounded_once`)."""
    offsets = torch.clamp_max(offsets, DECODE_CLAMP)
    acx, acy, aw, ah = anchors.unbind(-1)
    tx, ty, tw, th = offsets.unbind(-1)
    cx = true_div(tx, 10.0) * aw + acx
    cy = true_div(ty, 10.0) * ah + acy
    w = _exp_rounded_once(true_div(tw, 5.0)) * aw
    h = _exp_rounded_once(true_div(th, 5.0)) * ah
    return torch.stack([cx, cy, w, h], dim=-1)


def decode_rcnn(offsets, anchors):
    """R-CNN offsets -> center-form boxes, as torchvision's
    ``BoxCoder.decode_single`` with weights 1 in the anchors' units:
    ``c = d * w_a + c_a``, ``w = exp(min(dw, log(1000 / 16))) * w_a``
    (``exp`` rounded once, as :func:`decode_locations`)."""
    acx, acy, aw, ah = anchors.unbind(-1)
    dx, dy, dw, dh = offsets.unbind(-1)
    w = _exp_rounded_once(torch.clamp_max(dw, RCNN_SIZE_CLAMP)) * aw
    h = _exp_rounded_once(torch.clamp_max(dh, RCNN_SIZE_CLAMP)) * ah
    return torch.stack([dx * aw + acx, dy * ah + acy, w, h], dim=-1)
