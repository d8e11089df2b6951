"""NMS and decode of the PyTorch port against the JAX package.

The keep masks must be bit-identical: the IoU is computed in the same
float32 operation order on integer canvas corners (exact below 2^24), so
only the final IEEE division rounds, identically on both sides.
"""

import numpy as np
import pytest
import torch

from ssd_tensorflow_tpu.ops.boxes import box_canvas_corners
from ssd_tensorflow_tpu.ops.nms import class_aware_keep as jax_class_aware_keep
from ssd_tensorflow_tpu.ops.nms_pallas import nms_keep_pallas
from ssd_tensorflow_tpu.ops.postprocess import DetectionConfig as JaxDetectionConfig
from ssd_tensorflow_tpu.ops.postprocess import decode_scores as jax_decode_scores
from ssd_tensorflow_tpu_torch.ops import nms, nms_cuda, postprocess

from reference_impl import random_boxes
from torch_nms_cases import nms_cases

NMS_CASES = nms_cases()


def _candidates(rng, b, d, num_classes=4):
    """Score-sorted candidates with overlap clusters, as tests/test_nms_pallas.py."""
    boxes = np.zeros((b, d, 4), dtype=np.float32)
    classes = np.zeros((b, d), dtype=np.int32)
    valid = np.zeros((b, d), dtype=bool)
    for i in range(b):
        bx = random_boxes(rng, d, tight=True)
        for j in range(d // 2):
            bx[j] = np.clip(bx[j % 8] + rng.normal(0, 0.01, 4), 0.02, 0.98)
        boxes[i] = bx
        classes[i] = rng.integers(0, num_classes, d)
        valid[i] = np.sort(rng.uniform(0, 1, d))[::-1] > 0.3
    return boxes, classes, valid


@pytest.mark.parametrize("seed,d", [(0, 128), (1, 128), (3, 200), (4, 57)])
def test_keep_bit_exact(seed, d):
    rng = np.random.default_rng(seed)
    b = 3
    boxes, classes, valid = _candidates(rng, b, d)
    corners = np.array(box_canvas_corners(boxes))
    shifted = corners + (classes.astype(np.float32) * 4096.0)[..., None]

    got = nms_cuda.nms_keep(torch.from_numpy(shifted), torch.from_numpy(valid), 0.45).numpy()
    pallas = np.asarray(nms_keep_pallas(shifted, valid, threshold=0.45, interpret=True))
    np.testing.assert_array_equal(got, pallas)
    aware = nms.class_aware_keep(torch.from_numpy(corners), torch.from_numpy(classes),
                                 torch.from_numpy(valid), 0.45).numpy()
    np.testing.assert_array_equal(aware, got)
    for i in range(b):
        want = np.asarray(jax_class_aware_keep(corners[i], classes[i], valid[i], 0.45))
        np.testing.assert_array_equal(got[i], want)


@pytest.mark.parametrize("name", list(NMS_CASES))
def test_keep_bit_exact_on_block_scan_cases(name):
    """Inputs that stress a scan in 32-candidate blocks (block-edge sizes,
    suppression chains across blocks, identical boxes, valid holes, a NaN
    corner, an IoU equal to the threshold): the plain version equals the
    JAX package's kernel, run in interpret mode, bit for bit."""
    corners, valid, threshold, expected = NMS_CASES[name]
    got = nms_cuda.nms_keep(torch.from_numpy(corners), torch.from_numpy(valid), threshold).numpy()
    pallas = np.asarray(nms_keep_pallas(corners, valid, threshold=threshold, interpret=True))
    np.testing.assert_array_equal(got, pallas)
    if expected is not None:
        np.testing.assert_array_equal(got, expected)


def test_all_invalid_keeps_nothing():
    corners = torch.zeros((2, 128, 4))
    valid = torch.zeros((2, 128), dtype=torch.bool)
    assert not nms_cuda.nms_keep(corners, valid).any()


def test_wrapper_rejects_other_devices():
    with pytest.raises(ValueError, match="unsupported device"):
        nms_cuda.nms_keep(torch.zeros((1, 8, 4), device="meta"),
                          torch.zeros((1, 8), dtype=torch.bool, device="meta"))


def _scores(rng, b, a, k=3):
    conf = rng.uniform(0, 1, (b, a)).astype(np.float32)
    conf[:, ::7] = conf[:, 3:4]  # ties: top-k must put the lower index first
    cls = rng.integers(0, k, (b, a)).astype(np.int32)
    locs = rng.normal(0, 0.3, (b, a, 4)).astype(np.float32)
    anchors = rng.uniform(0.2, 0.8, (a, 4)).astype(np.float32)
    return conf, cls, locs, anchors


@pytest.mark.parametrize("top_k,max_det", [(200, 200), (200, 50), (64, 200)])
def test_decode_scores_matches_jax(rng, top_k, max_det):
    """Identical inputs -> identical valid masks and classes, boxes and
    scores equal to 1e-6 (exp and the float corners may round apart)."""
    conf, cls, locs, anchors = _scores(rng, 2, 256)
    want = jax_decode_scores(
        conf, cls, locs, anchors,
        JaxDetectionConfig(top_k=top_k, confidence_threshold=0.05, max_detections=max_det,
                           use_pallas_nms=True),
    )
    got = postprocess.decode_scores(
        *(torch.from_numpy(a) for a in (conf, cls, locs, anchors)),
        postprocess.DetectionConfig(top_k=top_k, confidence_threshold=0.05,
                                    max_detections=max_det),
    )
    np.testing.assert_array_equal(got.valid.numpy(), np.asarray(want.valid))
    np.testing.assert_array_equal(got.classes.numpy(), np.asarray(want.classes))
    np.testing.assert_allclose(got.scores.numpy(), np.asarray(want.scores), atol=1e-6)
    np.testing.assert_allclose(got.boxes.numpy(), np.asarray(want.boxes), atol=1e-6)


def test_detections_to_boxes_rows(rng):
    conf, cls, locs, anchors = _scores(rng, 2, 128)
    dets = postprocess.decode_scores(
        *(torch.from_numpy(a) for a in (conf, cls, locs, anchors)),
        postprocess.DetectionConfig(top_k=100, confidence_threshold=0.3),
    )
    rows = postprocess.detections_to_boxes(dets, {0: "a", 1: "b", 2: "c"})
    assert [len(r) for r in rows] == dets.valid.sum(dim=1).tolist()
    conf0, box0 = rows[0][0]
    assert box0.label == {0: "a", 1: "b", 2: "c"}[box0.labelid]
    assert conf0 == pytest.approx(float(dets.scores[0][dets.valid[0]][0]))
