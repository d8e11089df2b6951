"""Pascal VOC average precision (11-point, VOC2007 protocol), as in the
JAX package's ``eval/average_precision.py``.

Kept on the host and bit-compatible with the reference
(average_precision.py:45-192) because the protocol is order-sensitive:
detections are sorted *globally* by confidence across all images, each
greedy-matched to the maximum-IoU not-yet-matched ground-truth box of
its image at IoU >= minoverlap, and AP is the 11-point interpolated
precision over recall thresholds 0.0 .. 1.0. IoU runs on the
integerized 1000-canvas with +1-pixel areas — the same protocol measure
as matching.

Vectorized where the protocol allows: per-class detection/gt arrays are
built in bulk; only the inherently sequential greedy-matching loop
remains a loop.
"""

from __future__ import annotations

from collections import defaultdict

import numpy as np

from ssd_tensorflow_tpu_torch.ops.iou_np import canvas_corners_np, pairwise_canvas_iou_np


def APs2mAP(aps):
    """Mean of per-class APs (reference: average_precision.py:30-42)."""
    if not aps:
        return 0
    return sum(aps.values()) / len(aps)


class APCalculator:
    """Accumulate detections epoch-wide, then compute per-class AP.

    API parity with the reference (average_precision.py:45-192):
    ``add_detections(gt_boxes, boxes)`` per image, ``compute_aps()``,
    ``clear()``.
    """

    def __init__(self, minoverlap=0.5):
        self.minoverlap = minoverlap
        self.clear()

    # -- accumulation ---------------------------------------------------

    def add_detections(self, gt_boxes, boxes):
        """Add one image's ground truth and detections.

        Args:
          gt_boxes: list of Box namedtuples (ground truth, labels set).
          boxes:    list of ``(confidence, Box)`` detections.
        """
        sample_id = len(self.gt_boxes)
        self.gt_boxes.append(gt_boxes)

        for conf, box in boxes:
            arr = canvas_corners_np(
                np.array(
                    [[box.center.x, box.center.y, box.size.w, box.size.h]]
                )
            )[0]
            self.det_params[box.label].append(arr)
            self.det_confidence[box.label].append(conf)
            self.det_sample_ids[box.label].append(sample_id)

    # -- computation ----------------------------------------------------

    def compute_aps(self):
        """Per-class 11-point interpolated AP
        (reference: average_precision.py:84-181)."""
        counts = defaultdict(int)
        gt_map = defaultdict(dict)

        for sample_id, boxes in enumerate(self.gt_boxes):
            by_class = defaultdict(list)
            for box in boxes:
                counts[box.label] += 1
                by_class[box.label].append(box)
            for label, class_boxes in by_class.items():
                arr = canvas_corners_np(
                    np.array(
                        [
                            [b.center.x, b.center.y, b.size.w, b.size.h]
                            for b in class_boxes
                        ]
                    )
                )
                matched = np.zeros(len(class_boxes), dtype=bool)
                gt_map[label][sample_id] = (arr, matched)

        aps = {}
        for label in gt_map:
            params = np.asarray(self.det_params[label], dtype=np.float64)
            confs = np.asarray(self.det_confidence[label], dtype=np.float32)
            sample_ids = np.asarray(self.det_sample_ids[label], dtype=np.int64)
            n = params.shape[0]
            if n:
                order = np.argsort(-confs)
                params = params[order]
                sample_ids = sample_ids[order]

            tps = np.zeros(n)
            fps = np.zeros(n)
            class_gt = gt_map[label]
            for i in range(n):
                sid = sample_ids[i]
                if sid not in class_gt:
                    fps[i] = 1
                    continue
                gt_arr, matched = class_gt[sid]
                iou = pairwise_canvas_iou_np(params[i : i + 1], gt_arr)[0]
                best = int(np.argmax(iou))
                if iou[best] < self.minoverlap or matched[best]:
                    fps[i] = 1
                    continue
                tps[i] = 1
                matched[best] = True

            fps = np.cumsum(fps)
            tps = np.cumsum(tps)
            recall = tps / counts[label]
            prec = tps / np.maximum(tps + fps, 1e-12)
            ap = 0.0
            for r_tilde in np.arange(0, 1.1, 0.1):
                prec_at = prec[recall >= r_tilde]
                if len(prec_at) > 0:
                    ap += np.amax(prec_at)
            aps[label] = ap / 11.0

        return aps

    def clear(self):
        """Reset between epochs (reference: average_precision.py:184-192)."""
        self.det_params = defaultdict(list)
        self.det_confidence = defaultdict(list)
        self.det_sample_ids = defaultdict(list)
        self.gt_boxes = []
