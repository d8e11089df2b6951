"""Fused prediction decoding: per-anchor scores -> final detections.

Per image: top-K by confidence -> box decode -> canvas clamp ->
class-aware greedy NMS (the kernel of ``ops/nms_cuda.py``) -> compaction
of the kept rows. Semantics as in the JAX package: confidence is the
max over foreground classes, candidates keep ``conf >= threshold``, and
decoded boxes are clamped against the 1000-pixel canvas.
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch

from ssd_tensorflow_tpu_torch.ops import nms_cuda
from ssd_tensorflow_tpu_torch.ops.boxes import box_canvas_corners, clamp_boxes
from ssd_tensorflow_tpu_torch.ops.codec import decode_locations
from ssd_tensorflow_tpu_torch.ops.nms import NMS_THRESHOLD, class_shifted
from ssd_tensorflow_tpu_torch.types import Box, Point, Size


@dataclasses.dataclass(frozen=True)
class DetectionConfig:
    """Static knobs of the decode + NMS program."""

    #: pre-NMS candidate cap.
    top_k: int = 200
    #: minimum class confidence.
    confidence_threshold: float = 0.5
    #: NMS IoU threshold.
    nms_threshold: float = NMS_THRESHOLD
    #: post-NMS cap on emitted detections.
    max_detections: int = 200


@dataclasses.dataclass
class Detections:
    """Fixed-size per-image detection tensors (batch-leading)."""

    boxes: torch.Tensor  # (B, D, 4) center-form, canvas-clamped
    scores: torch.Tensor  # (B, D) descending
    classes: torch.Tensor  # (B, D) int32 foreground class ids
    valid: torch.Tensor  # (B, D) bool


def _candidates_from_scores(conf, cls, locs, anchors, cfg: DetectionConfig):
    """Top-K candidates of a batch, pre-NMS.

    A stable descending sort gives ``jax.lax.top_k``'s tie order (the
    lower index first), which ``torch.topk`` does not promise on CUDA.
    ``top_k`` is clamped to the anchor count.
    """
    k = min(cfg.top_k, conf.shape[-1])
    conf_sorted, order = torch.sort(conf, dim=-1, descending=True, stable=True)
    conf_top, idx = conf_sorted[:, :k], order[:, :k]
    cls_top = torch.gather(cls, 1, idx).to(torch.int32)
    loc_top = torch.gather(locs, 1, idx[..., None].expand(-1, -1, 4)).float()
    boxes = clamp_boxes(decode_locations(loc_top, anchors[idx]))
    valid = conf_top >= cfg.confidence_threshold
    return boxes, conf_top, cls_top, valid


def _keep(boxes, cls_top, valid, cfg: DetectionConfig):
    """Class-aware greedy-NMS keep mask of the candidates (the kernel)."""
    shifted = class_shifted(box_canvas_corners(boxes), cls_top).contiguous()
    return nms_cuda.nms_keep(shifted, valid.contiguous(), cfg.nms_threshold)


def _finalize(boxes, conf_top, cls_top, keep, cfg: DetectionConfig):
    """Compact kept rows to the front (they are already sorted by
    confidence) and trim to ``max_detections``."""
    b, n_cand = keep.shape
    if cfg.max_detections >= n_cand:
        return boxes, conf_top, cls_top, keep
    d = cfg.max_detections
    rank = torch.cumsum(keep.to(torch.int64), dim=1) - 1
    # parked rows and kept rows past d land beyond d and are cut off
    dest = torch.where(keep, rank, torch.full_like(rank, n_cand))

    def place(values):
        out = values.new_zeros((b, n_cand + 1) + values.shape[2:])
        index = dest.view(b, n_cand, *([1] * (values.dim() - 2))).expand_as(values)
        return out.scatter(1, index, values)[:, :d]

    return place(boxes), place(conf_top), place(cls_top), place(keep)


def decode_scores(conf, cls, locs, anchors, cfg: DetectionConfig = DetectionConfig()):
    """Batched fused decode + NMS from per-anchor scores.

    Args:
      conf: ``(B, A)`` float32 confidences; cls: ``(B, A)`` int class ids;
      locs: ``(B, A, 4)`` offsets; anchors: ``(A, 4)`` center-form.

    Returns:
      :class:`Detections` with ``D = min(top_k, A, max_detections)`` rows
      per image, confidence-sorted, ``valid`` marking real detections.
    """
    boxes, conf_top, cls_top, valid = _candidates_from_scores(conf, cls, locs, anchors, cfg)
    keep = _keep(boxes, cls_top, valid, cfg)
    boxes, scores, classes, valid = _finalize(boxes, conf_top, cls_top, keep, cfg)
    return Detections(boxes=boxes, scores=scores, classes=classes, valid=valid)


def decode_detections(probs, locs, anchors, cfg: DetectionConfig = DetectionConfig()):
    """Batched fused decode + NMS from class probabilities, as the train
    and eval steps decode their predictions.

    Args:
      probs: ``(B, A, K+1)`` softmax probabilities (background last);
      locs: ``(B, A, 4)`` offsets; anchors: ``(A, 4)`` center-form.

    The candidates' confidence and class are the max and the first argmax
    over the foreground probabilities; the rest is :func:`decode_scores`.
    """
    fg = probs[..., :-1]
    return decode_scores(fg.amax(dim=-1), fg.argmax(dim=-1), locs, anchors, cfg)


def detect(result, anchors, cfg: DetectionConfig = DetectionConfig()):
    """Decode the network's fused ``result`` tensor ``(B, A, K+5)``,
    ``concat(softmax(logits), locations)``: :func:`decode_detections` of its
    ``K+1`` probabilities and 4 offsets."""
    num_vars = result.shape[-1]
    return decode_detections(result[..., : num_vars - 4], result[..., num_vars - 4:], anchors, cfg)


def detections_to_boxes(dets: Detections, lid2name=None):
    """Detections -> per-image host lists of ``(conf, Box)`` tuples."""
    boxes = dets.boxes.cpu().numpy()
    scores = dets.scores.cpu().numpy()
    classes = dets.classes.cpu().numpy()
    valid = dets.valid.cpu().numpy()
    out = []
    for b in range(boxes.shape[0]):
        rows = []
        for i in np.nonzero(valid[b])[0]:
            cid = int(classes[b, i])
            cname = lid2name.get(cid) if lid2name else None
            rows.append((
                float(scores[b, i]),
                Box(cname, cid,
                    Point(float(boxes[b, i, 0]), float(boxes[b, i, 1])),
                    Size(float(boxes[b, i, 2]), float(boxes[b, i, 3]))),
            ))
        out.append(rows)
    return out
