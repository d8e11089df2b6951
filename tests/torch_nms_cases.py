"""Greedy-NMS inputs that stress a scan working in 32-candidate blocks.

Shared by ``tests/test_torch_nms.py`` (CPU: the plain version against the
JAX package's Pallas kernel in interpret mode, bit for bit) and
``tests/test_torch_cuda.py`` (card: the CUDA kernel against the plain
version). Pure numpy; every case is ``(corners (B, D, 4) float32 canvas
corners (xmin, xmax, ymin, ymax), valid (B, D) bool, threshold,
expected keep mask or None)``.
"""

import numpy as np

#: candidate counts around the 32-wide block edges, and the detection path's
BLOCK_EDGE_SIZES = (1, 31, 32, 33, 64, 65, 200)


def _clustered(rng, b, d):
    """Random boxes, the first half jittered copies of eight of them."""
    w, h = rng.uniform(0.05, 0.5, (2, b, d))
    boxes = np.stack([rng.uniform(w / 2, 1 - w / 2), rng.uniform(h / 2, 1 - h / 2), w, h], -1)
    half = d // 2
    boxes[:, :half] = np.clip(boxes[:, np.arange(half) % 8] + rng.normal(0, 0.01, (b, half, 4)),
                              0.02, 0.98)
    cx, cy, bw, bh = (boxes[..., k] * 1000 for k in range(4))
    corners = np.trunc(np.stack([cx - bw / 2, cx + bw / 2, cy - bh / 2, cy + bh / 2], -1))
    classes = rng.integers(0, 4, (b, d))
    return (corners + classes[..., None] * 4096.0).astype(np.float32)


def _apart(d):
    """``d`` one-pixel boxes that overlap nothing (and no box below y = 5000)."""
    idx = np.arange(d, dtype=np.float32)
    return np.stack([3 * idx, 3 * idx, np.full(d, 9000.0), np.full(d, 9000.0)], -1).astype(np.float32)


def _strip(x0):
    """A 100 x 100 box at x0: neighbours 30 apart overlap by 70 / 130 > 0.45,
    those 60 apart by 40 / 160 < 0.45."""
    return np.array([x0, x0 + 99, 0, 99], dtype=np.float32)


def _chain(d, at):
    """i suppresses j, so j must not suppress k: i, j, k at the indices ``at``."""
    corners = _apart(d)
    for n, idx in enumerate(at):
        corners[idx] = _strip(30.0 * n)
    expected = np.ones(d, dtype=bool)
    expected[at[1]] = False
    return corners[None], np.ones((1, d), dtype=bool), 0.45, expected[None]


def _alternating(d):
    """Every candidate overlaps only its predecessor: kept, gone, kept, ..."""
    corners = np.stack([_strip(30.0 * n) for n in range(d)])
    expected = np.arange(d) % 2 == 0
    return corners[None], np.ones((1, d), dtype=bool), 0.45, expected[None]


def _identical(d, first_valid):
    corners = np.tile(_strip(10.0), (d, 1))
    valid = np.ones(d, dtype=bool)
    valid[0] = first_valid
    expected = np.zeros(d, dtype=bool)
    expected[0 if first_valid else 1] = True
    return corners[None], valid[None], 0.45, expected[None]


def _at_threshold(threshold, rows):
    """A 100 x 100 box, then one inside it of ``rows`` rows: IoU = rows / 100."""
    corners = _apart(40)
    corners[3] = _strip(0.0)
    corners[36] = np.array([0, 99, 0, rows - 1], dtype=np.float32)
    expected = np.ones(40, dtype=bool)
    expected[36] = not rows / 100 > threshold
    return corners[None], np.ones((1, 40), dtype=bool), threshold, expected[None]


def nms_cases():
    """name -> (corners, valid, threshold, expected or None)."""
    cases = {}
    for d in BLOCK_EDGE_SIZES:
        rng = np.random.default_rng(1000 + d)
        valid = np.sort(rng.uniform(0, 1, (2, d)), axis=1)[:, ::-1] > 0.25
        cases[f"clustered_d{d}"] = (_clustered(rng, 2, d), valid.copy(), 0.45, None)
    # suppression chains inside a block, across neighbouring blocks, across two
    cases["chain_in_block"] = _chain(96, (33, 34, 35))
    cases["chain_next_block"] = _chain(96, (30, 40, 70))
    cases["chain_block_edge"] = _chain(96, (31, 32, 64))
    cases["chain_far_blocks"] = _chain(200, (5, 100, 199))
    cases["alternating_d200"] = _alternating(200)
    cases["identical_d65"] = _identical(65, True)
    cases["identical_first_invalid"] = _identical(65, False)
    rng = np.random.default_rng(7)
    cases["all_valid"] = (_clustered(rng, 2, 200), np.ones((2, 200), dtype=bool), 0.45, None)
    cases["none_valid"] = (_clustered(rng, 2, 70), np.zeros((2, 70), dtype=bool), 0.45,
                           np.zeros((2, 70), dtype=bool))
    cases["valid_holes"] = (_clustered(rng, 2, 100), rng.uniform(0, 1, (2, 100)) > 0.4, 0.45, None)
    nan = _clustered(rng, 2, 70)
    nan[0, 5, 0] = np.nan   # a NaN IoU is never > threshold
    nan[1, 40, 3] = np.nan
    cases["nan_corner"] = (nan, np.ones((2, 70), dtype=bool), 0.45, None)
    cases["iou_equals_threshold_0.5"] = _at_threshold(0.5, 50)
    cases["iou_equals_threshold_0.45"] = _at_threshold(0.45, 45)
    cases["iou_above_threshold_0.45"] = _at_threshold(0.45, 46)
    return cases
