"""Box math of the PyTorch port against the JAX package on the same inputs.

Anchors must be identical; the float box functions agree to 1e-6
(float32 on both sides, possibly contracted differently by XLA).
"""

import numpy as np
import pytest
import torch

from ssd_tensorflow_tpu import presets as jax_presets
from ssd_tensorflow_tpu.ops import anchors as jax_anchors
from ssd_tensorflow_tpu.ops import boxes as jax_boxes
from ssd_tensorflow_tpu.ops import codec as jax_codec
from ssd_tensorflow_tpu.ops import iou as jax_iou
from ssd_tensorflow_tpu_torch import presets
from ssd_tensorflow_tpu_torch.ops import anchors, boxes, codec, iou

from reference_impl import random_boxes

ATOL = 1e-6


@pytest.mark.parametrize("name", sorted(jax_presets.SSD_PRESETS))
def test_anchors_identical(name):
    got = anchors.anchors_for_preset(presets.get_preset_by_name(name))
    want = jax_anchors.anchors_for_preset(jax_presets.get_preset_by_name(name))
    assert got.dtype == want.dtype == np.float32
    np.testing.assert_array_equal(got, want)


@pytest.mark.parametrize("name,count", [("vgg512", 24564), ("vgg300", 8732)])
def test_anchor_counts(name, count):
    assert anchors.anchors_for_preset(presets.get_preset_by_name(name)).shape == (count, 4)


def test_presets_are_a_copy():
    assert presets.preset_to_dict(presets.SSD_PRESETS["vgg512"]) == \
        jax_presets.preset_to_dict(jax_presets.SSD_PRESETS["vgg512"])
    assert sorted(presets.SSD_PRESETS) == sorted(jax_presets.SSD_PRESETS)


def _boxes(rng, n=300):
    # some boxes reach past the canvas, so clamping has work to do
    b = random_boxes(rng, n).astype(np.float32)
    b[: n // 4, 2:] *= 1.8
    return b


def test_box_canvas_corners(rng):
    b = _boxes(rng)
    got = boxes.box_canvas_corners(torch.from_numpy(b)).numpy()
    want = np.asarray(jax_boxes.box_canvas_corners(b))
    np.testing.assert_allclose(got, want, atol=ATOL, rtol=0)


def test_corner_conversions_round_trip(rng):
    b = _boxes(rng)
    c = boxes.cxcywh_to_corners(torch.from_numpy(b), 640, 480)
    np.testing.assert_allclose(c.numpy(), np.asarray(jax_boxes.cxcywh_to_corners(b, 640, 480)),
                               atol=1e-4, rtol=0)
    back = boxes.corners_to_cxcywh(c, 640, 480).numpy()
    np.testing.assert_allclose(back, b, atol=ATOL, rtol=0)


def test_clamp_boxes_with_nan_and_inf(rng):
    b = _boxes(rng)
    b[3] = [np.nan, 0.5, 0.2, 0.2]
    b[7] = [0.5, 0.5, np.inf, 0.1]
    b[11] = [-np.inf, np.nan, 0.3, 0.3]
    got = boxes.clamp_boxes(torch.from_numpy(b)).numpy()
    want = np.asarray(jax_boxes.clamp_boxes(b))
    np.testing.assert_allclose(got, want, atol=ATOL, rtol=0, equal_nan=True)
    np.testing.assert_array_equal(np.isnan(got), np.isnan(b))


def test_decode_locations_clamps_offsets(rng):
    a = random_boxes(rng, 200).astype(np.float32)
    off = rng.normal(0, 1.5, (200, 4)).astype(np.float32)
    off[:20, :2] = 150.0  # past the decode clamp of 100
    off[20:30, 2:] = 101.0
    got = codec.decode_locations(torch.from_numpy(off), torch.from_numpy(a)).numpy()
    want = np.asarray(jax_codec.decode_locations(off, a))
    np.testing.assert_allclose(got, want, rtol=1e-6, atol=ATOL)


def test_encode_inverts_decode(rng):
    a = torch.from_numpy(random_boxes(rng, 100).astype(np.float32))
    # boxes near their anchors, so no offset reaches the decode clamp
    b = (a.numpy() * rng.uniform(0.8, 1.25, (100, 4))).astype(np.float32)
    off = codec.encode_locations(torch.from_numpy(b), a)
    np.testing.assert_allclose(off.numpy(), np.asarray(jax_codec.encode_locations(b, a.numpy())),
                               rtol=1e-5, atol=1e-5)
    np.testing.assert_allclose(codec.decode_locations(off, a).numpy(), b, atol=1e-5)


def test_pairwise_canvas_iou_exact(rng):
    c = np.array(jax_boxes.box_canvas_corners(_boxes(rng, 120)))
    got = iou.pairwise_canvas_iou(torch.from_numpy(c), torch.from_numpy(c[:50])).numpy()
    want = np.asarray(jax_iou.pairwise_canvas_iou(c, c[:50]))
    np.testing.assert_array_equal(got, want)
