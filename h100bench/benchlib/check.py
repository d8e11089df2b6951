"""The numbers that decide ``correct``: what the program's timed path
produced, judged by the plain reference of the configuration's family
(``benchlib/family.py``; the SSD families share ``reference/ssd_ref.py``'s
boxes on the canvas).

Serving, per image of the sample, worst over the sample:

* ``det_residual``: each valid detection of the program judged by the
  reference at every anchor: the least, over anchors, of the larger of
  ``|score - p_ref(anchor, class)|`` and the largest corner difference of
  the two boxes (canvas units / 1000). A detection that no anchor of the
  reference explains (a wrong class, box or score) reads high; which of
  two overlapping boxes NMS keeps does not matter to it.
* ``top_score_gap``: the difference between the program's best score and
  the reference's best detection's (0 where there is none). The best
  detection is never suppressed, so NMS decisions at the threshold do not
  move it; an image left unanswered reads its whole score.
* ``missed_residual``: the other way round, each detection of the
  reference judged by the program's output. Greedy NMS drops a candidate
  only for a kept one of its class that overlaps it by more than
  ``nms_threshold``, so a reference detection is explained where a program
  detection of its class overlaps it by more than that (by the program's
  box, or by the reference's box at the anchor that explains the program's
  detection), and reads by how much the best such overlap falls short of
  the threshold otherwise (an NMS decision at the threshold, flipped by
  rounding, reads little). A program detection of another class in its
  place reads by how much the reference scores that class lower at the
  detection's anchor (a tie of two classes, broken by rounding, reads
  little). It reads at most the detection's height above
  the reference's own cut (its ``top_k``-th candidate's score, or the
  confidence threshold), since a candidate at the cut may fall out of the
  program's ``top_k`` by rounding alone. A program that answers with fewer
  detections (a smaller ``top_k``, a raised threshold, NMS that suppresses
  too much, the best detection alone) reads what it left out.
* ``nms_overlap``: the largest IoU between two valid detections of one
  class in the program's output. Greedy NMS guarantees it is at most the
  configuration's ``nms_threshold``, which is its limit.

Training, over the first three steps that the window's own call ran
(``limits/<cell>.json`` says which are compared; PERF.md why):

* ``loss1_gap``: the first step's ``|loss - loss_ref| / |loss_ref|``;
  ``loss_gap`` the worst of the three steps'.
* ``grad_gap``: the first gradient as the optimizer holds it after one
  step (the momentum trace, which starts at zero), by the worst leaf:
  ``| |g| - |g_ref| | / max(|g_ref|, median leaf |g_ref|)``.
* ``change1_gap``: the change of the parameters over the first step, in
  the same measure: ``lr`` times the first trace on both sides, so it
  judges the update itself (a wrong learning rate reads its error).
* ``change_gap``: the change of the parameters over the three steps, by
  the worst leaf in the same measure, leaving out leaves whose reference
  gradient is under a thousandth of the median leaf's (round-off alone
  moves those); ``change_median_gap`` the median leaf's.
"""

from __future__ import annotations

import torch

from reference import ssd_ref


def serving_numbers(prog: list, ref: list, nms_threshold: float) -> dict:
    """``prog``: per image ``(boxes (D, 4), scores (D,), classes (D,),
    valid (D,))`` host tensors; ``ref``: the family's ``detect`` dicts."""
    top_gap = overlap = residual = missed = 0.0
    for (boxes, scores, classes, valid), r in zip(prog, ref):
        dev = r["probs"].device
        valid = valid.bool()
        s_p, b_p, c_p = scores[valid].float().to(dev), boxes[valid].to(dev), classes[valid].to(dev)
        top_p = float(s_p.max()) if len(s_p) else 0.0
        top_r = float(r["scores"].max()) if len(r["scores"]) else 0.0
        top_gap = max(top_gap, abs(top_p - top_r))
        anchor = torch.zeros(0, dtype=torch.long, device=dev)
        if len(s_p):
            worst, anchor = _residual(b_p, s_p, c_p, r)
            residual = max(residual, worst)
            overlap = max(overlap, _overlap(b_p, c_p))
        missed = max(missed, _missed(b_p, c_p, anchor, r, nms_threshold))
    return {"det_residual": residual, "top_score_gap": top_gap, "missed_residual": missed,
            "nms_overlap": overlap}


def _iou(a, b):
    """``(N, M)`` +1-pixel IoU of the boxes ``a`` and ``b``, in float32 on
    their canvas corners, as NMS compares them."""
    a, b = ssd_ref.canvas_corners(a.float()), ssd_ref.canvas_corners(b.float())
    iw = (torch.minimum(a[:, None, 1], b[None, :, 1])
          - torch.maximum(a[:, None, 0], b[None, :, 0]) + 1).clamp_min(0)
    ih = (torch.minimum(a[:, None, 3], b[None, :, 3])
          - torch.maximum(a[:, None, 2], b[None, :, 2]) + 1).clamp_min(0)
    area_a = (a[:, 1] - a[:, 0] + 1) * (a[:, 3] - a[:, 2] + 1)
    area_b = (b[:, 1] - b[:, 0] + 1) * (b[:, 3] - b[:, 2] + 1)
    inter = iw * ih
    return inter / (area_a[:, None] + area_b[None, :] - inter)


def _overlap(boxes, classes) -> float:
    """The largest same-class IoU between two detections."""
    iou = _iou(boxes, boxes)
    same = (classes[:, None] == classes[None, :]) & ~torch.eye(len(classes), dtype=torch.bool,
                                                                device=classes.device)
    return float(iou[same].max()) if bool(same.any()) else 0.0


def _residual(boxes, scores, classes, r, chunk: int = 64):
    """The worst detection's residual, and the reference's anchor that
    explains each detection best."""
    corners_ref = ssd_ref.canvas_corners(r["all_boxes"].float()) / ssd_ref.CANVAS
    worst, best = 0.0, []
    for s in range(0, len(scores), chunk):
        c = ssd_ref.canvas_corners(boxes[s:s + chunk].float()) / ssd_ref.CANVAS
        box_d = (c[:, None, :] - corners_ref[None, :, :]).abs().amax(-1)
        p = r["probs"][:, classes[s:s + chunk].long()].t()
        score_d = (scores[s:s + chunk].float()[:, None] - p).abs()
        least, at = torch.maximum(box_d, score_d).min(dim=1)
        worst = max(worst, float(least.max()))
        best.append(at)
    return worst, torch.cat(best)


def _missed(boxes, classes, anchor, r, nms_threshold: float) -> float:
    """The worst reference detection's reading, by the program's output."""
    if not len(r["scores"]):
        return 0.0
    height = (r["scores"].float() - r["cutoff"]).clamp_min(0)
    if not len(classes):
        return float(height.max())
    near = torch.maximum(_iou(r["boxes"], boxes), _iou(r["boxes"], r["all_boxes"][anchor]))
    same = r["classes"][:, None] == classes[None, :].long()
    short = (nms_threshold - torch.where(same, near, torch.zeros_like(near)).amax(dim=1))
    # a program detection in its place whose class the reference scores
    # about as high there: a tie between two classes, broken by rounding
    tie = (r["scores"].float()[:, None] - r["probs"][r["anchors"]][:, classes.long()])
    tie = torch.where(near > nms_threshold, tie, torch.full_like(tie, float("inf")))
    reading = torch.minimum(height, torch.minimum(short, tie.amin(dim=1)).clamp_min(0))
    return float(reading.max())


def leaf_norms(tree: dict) -> dict:
    return {(n, k): float(v.detach().double().norm()) for n, leaf in tree.items()
            for k, v in leaf.items()}


def _median(values):
    v = sorted(values)
    return v[len(v) // 2] if len(v) % 2 else 0.5 * (v[len(v) // 2 - 1] + v[len(v) // 2])


def train_numbers(prog: dict, ref: dict) -> dict:
    """``prog`` / ``ref``: ``{"losses": [3 floats], "grad": leaf_norms of
    the first gradient, "change1": leaf_norms of params(1) - params(0),
    "change": leaf_norms of params(3) - params(0)}``."""
    gaps = [abs(lp - lr) / abs(lr) for lp, lr in zip(prog["losses"], ref["losses"])]
    grad_gap, change1_gap = (_worst_leaf(prog[key], ref[key]) for key in ("grad", "change1"))
    med = _median(list(ref["grad"].values()))
    moved = [k for k, g in ref["grad"].items() if g >= 1e-3 * med]
    med_c = _median([ref["change"][k] for k in moved])
    change = [abs(prog["change"][k] - ref["change"][k]) / max(ref["change"][k], med_c)
              for k in moved]
    return {"loss1_gap": gaps[0], "loss_gap": max(gaps), "grad_gap": grad_gap,
            "change1_gap": change1_gap, "change_gap": max(change),
            "change_median_gap": _median(change)}


def _worst_leaf(prog: dict, ref: dict) -> float:
    """``max | |p| - |r| | / max(|r|, median leaf |r|)`` over every leaf."""
    med = _median(list(ref.values()))
    return max(abs(prog[k] - v) / max(v, med) for k, v in ref.items())


def worst_leaves(prog: dict, ref: dict, n: int = 3) -> dict:
    """The ``n`` leaves that read worst on ``grad_gap`` and ``change_gap``
    (diagnosis of a reading, not compared)."""
    med = _median(list(ref["grad"].values()))
    g = sorted(((abs(prog["grad"][k] - v) / max(v, med), "/".join(k), v / med)
                for k, v in ref["grad"].items()), reverse=True)[:n]
    moved = [k for k, v in ref["grad"].items() if v >= 1e-3 * med]
    med_c = _median([ref["change"][k] for k in moved])
    c = sorted(((abs(prog["change"][k] - ref["change"][k]) / max(ref["change"][k], med_c),
                 "/".join(k), ref["change"][k] / med_c) for k in moved), reverse=True)[:n]
    return {"grad": g, "change": c}


def judge(numbers: dict, limits: dict):
    """``(correct, {name: {"value", "limit"}})`` over the numbers that
    ``limits`` names: each at or under its limit; one that is missing, or
    NaN, fails."""
    out = {}
    ok = True
    for name, lim in limits.items():
        value = numbers.get(name, float("nan"))
        out[name] = {"value": value, "limit": lim}
        if not value <= lim:
            ok = False
    return ok, out
