"""Fused prediction decoding: per-anchor scores -> final detections.

Per image: top-K by confidence -> box decode -> canvas clamp ->
class-aware greedy NMS (the kernel of ``ops/nms_cuda.py``) -> compaction
of the kept rows. Semantics as in the JAX package: confidence is the
max over foreground classes, candidates keep ``conf >= threshold``, and
decoded boxes are clamped against the 1000-pixel canvas.

``DetectionConfig.multi_label`` selects RetinaNet's decode instead
(:func:`retina_select`, torchvision's ``postprocess_detections``): every
(anchor, class) pair scored by a sigmoid, per pyramid level the top
``top_k`` pairs above the threshold, decoded and clamped, the levels
merged by score, then the same NMS and compaction. NMS keeps the port's
canvas convention (+1-pixel IoU of the truncated canvas corners, classes
apart by the coordinate shift), where torchvision's ``batched_nms``
takes the continuous IoU of pixel boxes.
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch

from ssd_tensorflow_tpu_torch.ops import nms_cuda
from ssd_tensorflow_tpu_torch.ops.boxes import box_canvas_corners, clamp_boxes
from ssd_tensorflow_tpu_torch.ops.codec import decode_locations, decode_rcnn
from ssd_tensorflow_tpu_torch.ops.nms import NMS_THRESHOLD, class_shifted
from ssd_tensorflow_tpu_torch.types import Box, Point, Size
from ssd_tensorflow_tpu_torch.utils.profiling import span


@dataclasses.dataclass(frozen=True)
class DetectionConfig:
    """Static knobs of the decode + NMS program."""

    #: pre-NMS candidate cap (multi-label: per pyramid level).
    top_k: int = 200
    #: minimum class confidence (multi-label: a candidate's score must
    #: exceed it).
    confidence_threshold: float = 0.5
    #: NMS IoU threshold.
    nms_threshold: float = NMS_THRESHOLD
    #: post-NMS cap on emitted detections.
    max_detections: int = 200
    #: RetinaNet's decode (:func:`retina_select`): every class of every
    #: anchor scored by a sigmoid, selected per level, R-CNN box offsets
    #: (``codec.decode_rcnn``); else SSD's, one softmax class per anchor
    #: and SSD's offsets (``codec.decode_locations``).
    multi_label: bool = False


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


def retina_select(logits, locs, anchors, cfg: DetectionConfig):
    """Multi-label candidates of a batch, pre-NMS, merged over the levels
    and sorted by score (a stable sort: levels in order on ties).

    Args:
      logits: per level ``(B, A_l, K)`` class logits; locs: per level
        ``(B, A_l, 4)`` offsets; anchors: ``(A, 4)``, the levels' anchors
        in order.

    Per level the ``top_k`` largest logits over anchor x class
    (``torch.topk``, order among equal logits unspecified), their
    sigmoid in float32 as the score, valid where it exceeds the
    threshold (the largest scores above it are the largest logits), the
    class the pair's, the box its anchor's R-CNN offsets decoded and
    clipped to the canvas (``clamp_boxes(clip=True)``). Runs inside span ``ssd.retina.select``; the valid candidates
    add up in ``retina_select.candidates``, a device tensor (no host sync;
    read it with ``int()``)."""
    if torch.is_tensor(logits) or len(logits) != len(locs):
        raise ValueError("retina_select: logits and locs must be sequences of the levels' "
                         "tensors (a multi-label model's forward_scores)")
    with span("ssd.retina.select"):
        boxes, scores, classes, start = [], [], [], 0
        for lg, lc in zip(logits, locs):
            b, a, k = lg.shape
            top, idx = torch.topk(lg.reshape(b, a * k), min(cfg.top_k, a * k), dim=1)
            anchor = idx // k
            scores.append(torch.sigmoid(top.float()))
            classes.append((idx % k).to(torch.int32))
            loc = torch.gather(lc, 1, anchor[..., None].expand(-1, -1, 4)).float()
            box = decode_rcnn(loc, anchors[start + anchor])
            boxes.append(clamp_boxes(box, clip=True))
            start += a
        scores, order = torch.sort(torch.cat(scores, dim=1), dim=1, descending=True,
                                   stable=True)
        classes = torch.gather(torch.cat(classes, dim=1), 1, order)
        boxes = torch.gather(torch.cat(boxes, dim=1), 1, order[..., None].expand(-1, -1, 4))
        valid = scores > cfg.confidence_threshold
        retina_select.candidates = retina_select.candidates + valid.sum()
    return boxes, scores, classes, valid


retina_select.candidates = 0


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

    With ``cfg.multi_label``, ``conf`` and ``locs`` are the levels' class
    logits and offsets and ``cls`` is unused (:func:`retina_select`); ``D
    = min(levels x top_k, max_detections)``.
    """
    if cfg.multi_label:
        boxes, conf_top, cls_top, valid = retina_select(conf, locs, anchors, cfg)
    else:
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
    A multi-label configuration raises: it decodes per-level logits.
    """
    if cfg.multi_label:
        raise ValueError("decode_detections takes softmax probabilities; a multi-label "
                         "configuration decodes per-level logits (decode_scores)")
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
