"""Default (anchor) box generation, numpy.

Same contract as ``ssd_tensorflow_tpu/ops/anchors.py``: an ``(A, 4)``
float32 array in proportional center form ``(cx, cy, w, h)``, ordered
map-major, then anchor-shape-major ("heads-major"), then row-major
cells — the order the multibox heads' outputs are concatenated in.
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


def anchors_for_preset(preset: SSDPreset) -> np.ndarray:
    """All anchors of a preset as an ``(A, 4)`` float32 array."""
    parts = []
    for k, (m, sizes) in enumerate(zip(preset.maps, _box_sizes_for_preset(preset))):
        fk = m.size.w
        coords = (np.arange(fk, dtype=np.float64) + 0.5) / fk
        cy, cx = np.meshgrid(coords, coords, indexing="ij")
        centers = np.stack([cx.ravel(), cy.ravel()], axis=-1)  # (fk*fk, 2)
        for w, h in sizes:
            wh = np.broadcast_to(np.array([w, h], dtype=np.float64), centers.shape)
            parts.append(np.concatenate([centers, wh], axis=-1))
    anchors = np.concatenate(parts, axis=0).astype(np.float32)
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
