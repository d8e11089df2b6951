"""Anchor matching and ground-truth target encoding as tensor ops.

The port of the JAX package's ``ops/matching.py``. Per image, the
reference's two-pass assignment over the ``(G, A)`` protocol IoU of the
(padded) gt boxes against the anchors:

1. threshold matches: each anchor takes the gt of greatest IoU among
   those above 0.5, the earliest gt on ties;
2. best-anchor forcing: each valid gt whose best IoU exceeds 0.5 claims
   its best anchor (the earliest on ties), overriding pass 1; among gts
   claiming one anchor the higher IoU wins, the earliest gt on ties.

Both passes are argmax / mask algebra with no data-dependent control
flow, and the batch form runs on ``(B, G, A)`` tensors in one go. Ties
are frequent (symmetric anchors give equal IoUs), and every argmax here
relies on ``torch.argmax`` returning the first maximal index, which it
documents, as ``jnp.argmax`` does.
"""

from __future__ import annotations

import numpy as np
import torch
import torch.nn.functional as F

from ssd_tensorflow_tpu_torch.ops.codec import encode_locations
from ssd_tensorflow_tpu_torch.ops.iou import canvas_iou
from ssd_tensorflow_tpu_torch.ops.iou_np import canvas_corners_np, pairwise_canvas_iou_np

#: Matching threshold (strictly greater).
MATCH_THRESHOLD = 0.5


def match_anchors(iou, gt_mask, threshold: float = MATCH_THRESHOLD):
    """Resolve the two-pass assignment from an IoU matrix.

    Args:
      iou: ``(..., G, A)`` protocol IoU of (padded) gt boxes vs anchors.
      gt_mask: ``(..., G)`` bool, True for real gt rows.
      threshold: matching threshold (strictly-greater comparison).

    Returns:
      ``(anchor_gt, positive)``: ``(..., A)`` int64 index of the assigned gt
      (arbitrary where not positive) and ``(..., A)`` bool matched flags.
    """
    iou = torch.where(gt_mask[..., :, None], iou, torch.full_like(iou, -1.0))

    # pass 1: per anchor, the first gt of greatest IoU, thresholded
    best_gt = iou.argmax(dim=-2)
    pass1 = iou.amax(dim=-2) > threshold
    # pass 2: each valid gt claims its first best anchor
    best_anchor = iou.argmax(dim=-1)
    claim_valid = (iou.amax(dim=-1) > threshold) & gt_mask
    a_ids = torch.arange(iou.shape[-1], device=iou.device)
    claims = (best_anchor[..., None] == a_ids) & claim_valid[..., None]  # (..., G, A)
    claimed_iou = torch.where(claims, iou, torch.full_like(iou, -1.0))
    pass2_gt = claimed_iou.argmax(dim=-2)
    pass2 = claimed_iou.amax(dim=-2) > 0.0  # a claim implies IoU > threshold
    # pass 2 overrides pass 1 on contested anchors
    return torch.where(pass2, pass2_gt, best_gt), pass1 | pass2


def encode_targets_batch(gt_boxes, gt_labels, gt_mask, anchors, num_classes: int,
                         threshold: float = MATCH_THRESHOLD):
    """The ``(B, A, K+5)`` float32 training targets of a batch.

    Layout: ``[:K]`` foreground one-hot, ``[K]`` the background bit,
    ``[K+1:]`` the four encoded offsets (zero for background anchors).

    Args:
      gt_boxes: ``(B, G, 4)`` center-form gt boxes (padded rows arbitrary).
      gt_labels: ``(B, G)`` int class ids in ``[0, K)``.
      gt_mask: ``(B, G)`` bool validity of each gt row.
      anchors: ``(A, 4)`` center-form anchors, shared by the batch.
      num_classes: K.
    """
    anchors = anchors.to(gt_boxes.dtype)
    anchor_gt, positive = match_anchors(canvas_iou(gt_boxes, anchors), gt_mask, threshold)
    labels = torch.gather(gt_labels.long(), -1, anchor_gt)
    cls = torch.where(positive, labels, torch.full_like(labels, num_classes))
    onehot = F.one_hot(cls, num_classes + 1).to(torch.float32)
    matched = torch.gather(gt_boxes, -2, anchor_gt[..., None].expand(*anchor_gt.shape, 4))
    # background lanes would take log(0) in the codec: encode the anchor
    # itself there (exact zeros), then mask
    safe = torch.where(positive[..., None], matched, anchors)
    loc = torch.where(positive[..., None], encode_locations(safe, anchors), 0.0)
    return torch.cat([onehot, loc.to(torch.float32)], dim=-1)


def encode_targets(gt_boxes, gt_labels, gt_mask, anchors, num_classes: int,
                   threshold: float = MATCH_THRESHOLD):
    """:func:`encode_targets_batch` of one image: ``(G, 4)``, ``(G,)``,
    ``(G,)`` -> ``(A, K+5)``."""
    return encode_targets_batch(gt_boxes[None], gt_labels[None], gt_mask[None], anchors,
                                num_classes, threshold)[0]


def has_positive_anchor(gt_boxes_np, gt_mask_np, anchors_np, threshold=MATCH_THRESHOLD, *,
                        anchor_corners_np=None) -> bool:
    """Host-side check of the data pipeline's resampling rule: does any
    (valid gt, anchor) protocol IoU exceed ``threshold``? Numpy, float64.
    ``anchor_corners_np`` may hold precomputed
    ``iou_np.canvas_corners_np(anchors)`` (``anchors_np`` is then ignored)."""
    gt_boxes_np = np.asarray(gt_boxes_np)
    if gt_mask_np is not None:
        gt_boxes_np = gt_boxes_np[np.asarray(gt_mask_np)]
    if gt_boxes_np.shape[0] == 0:
        return False
    if anchor_corners_np is None:
        anchor_corners_np = canvas_corners_np(np.asarray(anchors_np))
    iou = pairwise_canvas_iou_np(canvas_corners_np(gt_boxes_np), anchor_corners_np)
    return bool(iou.max() > threshold)
