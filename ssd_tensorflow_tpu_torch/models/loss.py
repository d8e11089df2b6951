"""Multibox loss with hard-negative mining, as in the JAX package's
``models/loss.py``.

* confidence: softmax cross-entropy per anchor; positives summed; hard
  negative mining keeps the ``min(num_neg, 3 * num_pos)`` highest-CE
  negatives of each sample by a full descending sort and a range mask
  (gradients flow through the sorted values); normalized by the
  positives, zero for a sample without any, batch mean;
* localization: smooth-L1 on positive anchors only, same normalization;
* l2: ``0.5 * sum(w^2)`` over every conv filter (not biases, not the
  L2-norm scale), times the weight decay.
"""

from __future__ import annotations

import torch


def smooth_l1(x):
    """Elementwise smooth-L1."""
    absx = x.abs()
    return torch.where(absx < 1.0, 0.5 * x * x, absx - 0.5)


def multibox_loss(logits, locs, labels, num_classes: int):
    """Confidence + localization losses.

    Args:
      logits: ``(B, A, K+1)`` float32 class logits.
      locs: ``(B, A, 4)`` float32 predicted offsets.
      labels: ``(B, A, K+5)`` targets (``ops/matching.encode_targets_batch``).
      num_classes: K.

    Returns:
      ``{"confidence", "localization"}`` float32 scalars.
    """
    gt_cl = labels[:, :, : num_classes + 1]
    gt_loc = labels[:, :, num_classes + 1:]
    num_anchors = gt_cl.shape[1]

    negatives_num = (gt_cl[:, :, -1] != 0).sum(dim=1)
    positives_num = num_anchors - negatives_num
    has_pos = positives_num > 0
    positives_num_safe = torch.where(has_pos, positives_num.to(torch.float32),
                                     torch.tensor(1e-14, device=labels.device))
    positives_mask = gt_cl[:, :, -1] == 0  # (B, A)

    ce = -(gt_cl * torch.log_softmax(logits, dim=-1)).sum(dim=-1)  # (B, A)
    zero = ce.new_zeros(())
    positives_sum = torch.where(positives_mask, ce, zero).sum(dim=-1)
    negatives = torch.where(positives_mask, zero, ce)
    # a stable descending sort keeps ties in anchor order, as the JAX
    # package's -sort(-x) does
    negatives_top = torch.sort(negatives, dim=-1, descending=True, stable=True).values
    negatives_num_max = torch.minimum(negatives_num, 3 * positives_num)
    rng = torch.arange(num_anchors, device=labels.device)[None, :]
    negatives_max_sum = torch.where(rng < negatives_num_max[:, None], negatives_top,
                                    zero).sum(dim=-1)
    confidence = torch.where(has_pos, (positives_sum + negatives_max_sum) / positives_num_safe,
                             zero).mean()

    loc_loss = smooth_l1(locs - gt_loc).sum(dim=-1)  # (B, A)
    loc_sum = torch.where(positives_mask, loc_loss, zero).sum(dim=-1)
    localization = torch.where(has_pos, loc_sum / positives_num_safe, zero).mean()
    return {"confidence": confidence, "localization": localization}


def l2_regularizer(params):
    """``0.5 * sum(w^2)`` over every layer's conv filter ``"w"`` in float32.
    Staged inference leaves (the heads' ``"wb"``) are not parameters and
    are skipped."""
    total = 0.0
    for leaf in params.values():
        if isinstance(leaf, dict) and "w" in leaf:
            w = leaf["w"].float()
            total = total + 0.5 * (w * w).sum()
    return total


def total_loss(logits, locs, labels, params, num_classes: int, weight_decay: float):
    """``confidence + localization + weight_decay * l2``."""
    losses = multibox_loss(logits, locs, labels, num_classes)
    l2 = weight_decay * l2_regularizer(params)
    losses["l2"] = l2
    losses["total"] = losses["confidence"] + losses["localization"] + l2
    return losses
