"""Anchor matching and target encoding of the PyTorch port against the JAX
package's ``ops/matching.py`` and ``ops/iou.py``, on the CPU.

Bit-exact: the protocol IoU, the assignment (constructed ties over gts and
over anchors, padded gt rows, gts whose best IoU is <= 0.5), the one-hot
and background columns, tx / ty and ``has_positive_anchor``. tw / th take a
logarithm: the port rounds the float64 log once (the same bits on the CPU
and the card), while XLA's CPU log is a polynomial that is not correctly
rounded (two ulps of its own result apart from the port's near log 0),
so those two columns are held to 2^-21 absolute, one float32 ulp of an offset
of magnitude 2 to 4 (measured on test64 and vgg512 batches: 18-26 % of
the positives' tw / th differ, by at most 4.8e-7; ROADMAP.md §3).
"""

import sys
from pathlib import Path

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from ssd_tensorflow_tpu.ops import iou as jax_iou
from ssd_tensorflow_tpu.ops import matching as jax_matching
from ssd_tensorflow_tpu.ops.anchors import anchors_for_preset
from ssd_tensorflow_tpu.presets import get_preset_by_name
from ssd_tensorflow_tpu_torch.ops import iou, iou_np, matching

sys.path.insert(0, str(Path(__file__).resolve().parent))
from reference_impl import random_boxes  # noqa: E402

K = 20


@pytest.fixture(scope="module")
def anchors():
    return anchors_for_preset(get_preset_by_name("test64"))


def _batch(rng, b=4, g=8, pad=True):
    gt = np.stack([random_boxes(rng, g, tight=True) for _ in range(b)]).astype(np.float32)
    labels = rng.integers(0, K, (b, g)).astype(np.int32)
    mask = np.ones((b, g), dtype=bool)
    if pad:
        mask[:, g - 2:] = False
        gt[:, g - 2:] = 0.0  # padded rows: zero boxes, as the pipeline pads
    return gt, labels, mask


def test_canvas_iou_bit_exact(anchors):
    gt, _, _ = _batch(np.random.default_rng(0), pad=False)
    got = iou.canvas_iou(torch.from_numpy(gt), torch.from_numpy(anchors)).numpy()
    want = np.asarray(jax_iou.canvas_iou(gt, anchors))
    assert got.shape == want.shape == (4, 8, anchors.shape[0])
    np.testing.assert_array_equal(got, want)


def _match_both(iou_np_, mask):
    want_gt, want_pos = jax_matching.match_anchors(jnp.asarray(iou_np_), jnp.asarray(mask))
    got_gt, got_pos = matching.match_anchors(torch.from_numpy(iou_np_), torch.from_numpy(mask))
    want_pos = np.asarray(want_pos)
    np.testing.assert_array_equal(got_pos.numpy(), want_pos)
    # the assigned gt matters only where the anchor is positive
    np.testing.assert_array_equal(got_gt.numpy()[want_pos], np.asarray(want_gt)[want_pos])
    return got_gt.numpy(), got_pos.numpy()


def test_match_anchors_ties_over_gts_and_anchors():
    """Constructed ties: two gts of equal IoU on one anchor (the earlier
    wins), one gt whose best IoU sits on two anchors (the earlier is
    claimed), a gt claiming an anchor pass 1 gave another, a padded row
    of the highest IoU, and a gt whose best IoU is exactly 0.5 (matches
    nothing)."""
    iou_m = np.array([
        [0.7, 0.7, 0.2, 0.0, 0.6, 0.1],   # ties with itself over anchors 0, 1
        [0.7, 0.3, 0.2, 0.0, 0.55, 0.1],  # ties gt 0 on anchor 0
        [0.1, 0.2, 0.5, 0.5, 0.0, 0.1],   # best IoU 0.5: nothing
        [0.0, 0.0, 0.0, 0.0, 0.58, 0.3],  # claims anchor 4, which pass 1 gave gt 0
        [0.9, 0.9, 0.9, 0.9, 0.9, 0.9],   # padded
    ], dtype=np.float32)
    mask = np.array([True, True, True, True, False])
    got_gt, got_pos = _match_both(iou_m, mask)
    np.testing.assert_array_equal(got_pos, [True, True, False, False, True, False])
    np.testing.assert_array_equal(got_gt[got_pos], [0, 0, 3])


def test_match_anchors_many_ties_batched():
    """Random IoUs on a coarse grid (ties everywhere) through the batched
    form, against JAX per image."""
    rng = np.random.default_rng(3)
    iou_b = (rng.integers(0, 9, (6, 7, 50)) / 8.0).astype(np.float32)
    mask = rng.uniform(0, 1, (6, 7)) > 0.3
    got_gt, got_pos = matching.match_anchors(torch.from_numpy(iou_b), torch.from_numpy(mask))
    for i in range(6):
        want_gt, want_pos = jax_matching.match_anchors(jnp.asarray(iou_b[i]), jnp.asarray(mask[i]))
        np.testing.assert_array_equal(got_pos[i].numpy(), np.asarray(want_pos))
        pos = np.asarray(want_pos)
        np.testing.assert_array_equal(got_gt[i].numpy()[pos], np.asarray(want_gt)[pos])


def test_torch_argmax_takes_the_first_maximum():
    x = torch.tensor([[0.5, 0.9, 0.9, 0.1], [0.2, 0.2, 0.2, 0.2]])
    assert x.argmax(dim=-1).tolist() == [1, 0]
    assert x.t().argmax(dim=-2).tolist() == [1, 0]


@pytest.mark.parametrize("seed,pad", [(0, True), (1, False), (2, True)])
def test_encode_targets_batch_matches_jax(anchors, seed, pad):
    gt, labels, mask = _batch(np.random.default_rng(seed), pad=pad)
    want = np.asarray(jax_matching.encode_targets_batch(gt, labels, mask, anchors, K))
    got = matching.encode_targets_batch(torch.from_numpy(gt), torch.from_numpy(labels),
                                        torch.from_numpy(mask), torch.from_numpy(anchors), K)
    assert got.dtype == torch.float32
    got = got.numpy()
    assert got.shape == want.shape == (4, anchors.shape[0], K + 5)
    assert (want[..., K] == 0).sum() > 0  # the batch has positives
    np.testing.assert_array_equal(got[..., : K + 3], want[..., : K + 3])
    assert np.abs(got[..., K + 3:] - want[..., K + 3:]).max() <= 2.0 ** -21
    pos = want[..., K] == 0
    assert float((got[pos][:, K + 3:] == want[pos][:, K + 3:]).mean()) >= 0.6
    assert np.isfinite(got).all()


def test_encode_targets_one_image_is_the_batch_row(anchors):
    gt, labels, mask = _batch(np.random.default_rng(5))
    batch = matching.encode_targets_batch(torch.from_numpy(gt), torch.from_numpy(labels),
                                          torch.from_numpy(mask), torch.from_numpy(anchors), K)
    one = matching.encode_targets(torch.from_numpy(gt[2]), torch.from_numpy(labels[2]),
                                  torch.from_numpy(mask[2]), torch.from_numpy(anchors), K)
    assert torch.equal(one, batch[2])


def test_has_positive_anchor_matches_jax(anchors):
    rng = np.random.default_rng(7)
    corners = iou_np.canvas_corners_np(anchors)
    for g in range(12):
        boxes = random_boxes(rng, 3, tight=g % 2 == 0) * (0.15 if g % 3 == 0 else 1.0)
        mask = rng.uniform(0, 1, 3) > 0.4
        want = jax_matching.has_positive_anchor(boxes, mask, anchors)
        assert matching.has_positive_anchor(boxes, mask, anchors) == want
        assert matching.has_positive_anchor(boxes, mask, None, anchor_corners_np=corners) == want
    assert not matching.has_positive_anchor(np.zeros((2, 4)), np.zeros(2, bool), anchors)


def test_iou_np_matches_jax(anchors):
    from ssd_tensorflow_tpu.ops import iou_np as jax_iou_np

    boxes = random_boxes(np.random.default_rng(8), 9)
    np.testing.assert_array_equal(iou_np.canvas_iou_np(boxes, anchors),
                                  jax_iou_np.canvas_iou_np(boxes, anchors))
