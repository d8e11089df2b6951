"""Default (anchor) box generation, numpy.

Same contract as ``ssd_tensorflow_tpu/ops/anchors.py``: an ``(A, 4)``
float32 array in proportional center form ``(cx, cy, w, h)``, ordered
map-major, then anchor-shape-major ("heads-major"), then row-major
cells — the order the multibox heads' outputs are concatenated in.

A preset whose maps give ``anchor_sizes`` (RetinaNet) takes torchvision's
``AnchorGenerator`` rule instead (:func:`_pyramid_anchors`), in its
order: level-major, then row-major cells, then the cell's anchors
(ratio-major, then size), the order of an NHWC head output's channels.
"""

from __future__ import annotations

import math
from functools import lru_cache

import numpy as np

from ssd_tensorflow_tpu_torch.presets import SSDPreset, get_preset_by_name


def _box_sizes_for_preset(preset: SSDPreset):
    """Per-map list of ``(w, h)`` anchor shapes: AR=1, each configured
    aspect ratio, then the extra ``s' = sqrt(s_k * s_{k+1})`` box."""
    box_sizes = []
    for i, m in enumerate(preset.maps):
        s = m.scale
        sizes = []
        for ar in (1.0,) + tuple(m.aspect_ratios):
            r = math.sqrt(ar)
            sizes.append((s * r, s / r))
        if i < len(preset.maps) - 1:
            s_prime = math.sqrt(s * preset.maps[i + 1].scale)
        else:
            s_prime = math.sqrt(s * preset.extra_scale)
        sizes.append((s_prime, s_prime))
        box_sizes.append(sizes)
    return box_sizes


def _pyramid_anchors(preset: SSDPreset) -> np.ndarray:
    """torchvision's ``AnchorGenerator`` in float32, as proportional center
    form: per level the base anchors ``round([-w, -h, w, h] / 2)`` with
    ``h = size * sqrt(ratio)`` and ``w = size / sqrt(ratio)`` (ratio-major,
    rounding half to even), shifted to ``(x, y) * (image // grid)`` for
    every cell (the cell's corner, not its centre), in pixels of the
    image, then divided by the image's size."""
    img_w, img_h = preset.image_size.w, preset.image_size.h
    parts = []
    for m in preset.maps:
        h_ratios = np.sqrt(np.asarray(m.aspect_ratios, np.float32))
        w_ratios = np.float32(1) / h_ratios
        sizes = np.asarray(m.anchor_sizes, np.float32)
        ws = (w_ratios[:, None] * sizes[None, :]).reshape(-1)
        hs = (h_ratios[:, None] * sizes[None, :]).reshape(-1)
        base = np.round(np.stack([-ws, -hs, ws, hs], axis=1) / np.float32(2))
        sy, sx = np.meshgrid(np.arange(m.size.h) * (img_h // m.size.h),
                             np.arange(m.size.w) * (img_w // m.size.w), indexing="ij")
        shifts = np.stack([sx.ravel(), sy.ravel()] * 2, axis=1).astype(np.float32)
        xyxy = (shifts[:, None, :] + base[None, :, :]).reshape(-1, 4).astype(np.float64)
        parts.append(np.stack([(xyxy[:, 0] + xyxy[:, 2]) / 2 / img_w,
                               (xyxy[:, 1] + xyxy[:, 3]) / 2 / img_h,
                               (xyxy[:, 2] - xyxy[:, 0]) / img_w,
                               (xyxy[:, 3] - xyxy[:, 1]) / img_h], axis=1))
    return np.concatenate(parts, axis=0).astype(np.float32)


def _ssd_anchors(preset: SSDPreset) -> np.ndarray:
    parts = []
    for k, (m, sizes) in enumerate(zip(preset.maps, _box_sizes_for_preset(preset))):
        fk = m.size.w
        coords = (np.arange(fk, dtype=np.float64) + 0.5) / fk
        cy, cx = np.meshgrid(coords, coords, indexing="ij")
        centers = np.stack([cx.ravel(), cy.ravel()], axis=-1)  # (fk*fk, 2)
        for w, h in sizes:
            wh = np.broadcast_to(np.array([w, h], dtype=np.float64), centers.shape)
            parts.append(np.concatenate([centers, wh], axis=-1))
    return np.concatenate(parts, axis=0).astype(np.float32)


def anchors_for_preset(preset: SSDPreset) -> np.ndarray:
    """All anchors of a preset as an ``(A, 4)`` float32 array."""
    anchors = (_pyramid_anchors if preset.maps[0].anchor_sizes else _ssd_anchors)(preset)
    if anchors.shape != (preset.num_anchors, 4):
        raise ValueError(
            f"anchor count mismatch: {anchors.shape[0]} != {preset.num_anchors}"
        )
    return anchors


@lru_cache(maxsize=None)
def anchors_by_name(preset_name: str) -> np.ndarray:
    """The anchors of a named preset, cached (read-only)."""
    a = anchors_for_preset(get_preset_by_name(preset_name))
    a.setflags(write=False)
    return a


def num_anchors_per_map(preset: SSDPreset):
    """Anchors contributed by each feature map."""
    return [m.size.w * m.size.h * m.num_shapes for m in preset.maps]
