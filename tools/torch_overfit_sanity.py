#!/usr/bin/env python3
"""Training-correctness sanity of the PyTorch port: overfit a tiny
synthetic detection set (the counterpart of ``tools/overfit_sanity.py``).

Generates images of coloured rectangles (3 classes), trains vgg300 on the
first ``--batch-size`` of them from the port's ``init_params(cfg, seed=0)``
and reports the train mAP. If the matching, the loss, the gradients, the
optimizer and the decode are right, the model memorizes ~32 images
(mAP -> ~1); a wiring fault (anchor order, codec sign, loss masking) keeps
the mAP near 0. How soon it does varies with the init draw, in either
package (``tests/torch_overfit_witness.py``): from this one vgg300 first
reaches mAP 0.5 near step 350 on an H100 in bf16 and in float32, so the
default 300 steps (the JAX tool's, with its ``--map-target`` 0.5) end
before it; give ``--steps 500`` or more.

    python3 tools/torch_overfit_sanity.py [--steps 300] [--images 32] [--device cuda|cpu]

The JAX tool's flags, output lines and exit codes (1 below
``--map-target``), plus ``--device``: ``cuda`` unless the caller asks for
``cpu``; without a card it raises. ``chip_smoke.py`` phase 16 runs these
functions as :func:`main` wires them. Imports nothing of JAX or of the
JAX package.
"""

from __future__ import annotations

import argparse
import sys
import time
from pathlib import Path

import numpy as np

sys.path.insert(0, str(Path(__file__).resolve().parent.parent))

#: the classes, by colour
LID2NAME = {0: "red", 1: "green", 2: "blue"}


def make_dataset(n, rng, size=300):
    """Images with 1-2 coloured rectangles; class = colour. The JAX tool's
    ``make_dataset``, draw for draw: the same ``rng`` gives the same bytes."""
    colors = [(40, 40, 220), (40, 220, 40), (220, 40, 40)]  # BGR classes
    images = np.zeros((n, size, size, 3), dtype=np.uint8)
    gt_boxes = np.zeros((n, 4, 4), dtype=np.float32)
    gt_labels = np.zeros((n, 4), dtype=np.int32)
    gt_mask = np.zeros((n, 4), dtype=bool)
    for i in range(n):
        images[i] = rng.integers(0, 60, (size, size, 3))
        for j in range(int(rng.integers(1, 3))):
            cls = int(rng.integers(0, 3))
            w = float(rng.uniform(0.2, 0.5))
            h = float(rng.uniform(0.2, 0.5))
            cx = float(rng.uniform(w / 2, 1 - w / 2))
            cy = float(rng.uniform(h / 2, 1 - h / 2))
            x0, x1 = int((cx - w / 2) * size), int((cx + w / 2) * size)
            y0, y1 = int((cy - h / 2) * size), int((cy + h / 2) * size)
            images[i, y0:y1, x0:x1] = colors[cls]
            gt_boxes[i, j] = (cx, cy, w, h)
            gt_labels[i, j] = cls
            gt_mask[i, j] = True
    return images, gt_boxes, gt_labels, gt_mask


def train_config(preset="vgg300", compute_dtype="bfloat16", lr=0.001):
    """3 classes, a constant LR, no detect inside the train step."""
    from ssd_tensorflow_tpu_torch.models.ssd_vgg import ModelConfig
    from ssd_tensorflow_tpu_torch.parallel.train_step import TrainConfig

    return TrainConfig(model=ModelConfig(preset_name=preset, num_classes=3,
                                         compute_dtype=compute_dtype),
                       lr_values=(lr,), lr_boundaries=(), detect=None)


def eval_config(cfg):
    """The train config with the tool's detect: top 64, confidence 0.3."""
    import dataclasses

    from ssd_tensorflow_tpu_torch.ops.postprocess import DetectionConfig

    return dataclasses.replace(cfg, detect=DetectionConfig(top_k=64, confidence_threshold=0.3))


def setup(cfg, params, device):
    """``(state, train_step, eval_step)``: ``params`` on ``device`` with a
    fresh optimizer, and the steps of ``cfg`` and :func:`eval_config`."""
    from ssd_tensorflow_tpu_torch.ops.anchors import anchors_for_preset
    from ssd_tensorflow_tpu_torch.parallel.train_step import (
        make_eval_step,
        make_train_state,
        make_train_step,
    )

    anchors = anchors_for_preset(cfg.model.preset)
    state = make_train_state(params, cfg, device=device)
    return state, make_train_step(cfg, anchors), make_eval_step(eval_config(cfg), anchors)


def first_batch(data, batch_size):
    """The training batch: the first ``batch_size`` images and their boxes."""
    images, gt_boxes, gt_labels, gt_mask = data
    return {"images": images[:batch_size], "gt_boxes": gt_boxes[:batch_size],
            "gt_labels": gt_labels[:batch_size], "gt_mask": gt_mask[:batch_size]}


def train(state, train_step, batch, steps, first=0, t0=None):
    """Steps ``first + 1 .. first + steps`` on ``batch``, printing the
    losses every 50 steps -> ``(state, [(step, losses as floats)])``."""
    t0 = time.time() if t0 is None else t0
    logged = []
    for s in range(first, first + steps):
        state, losses, _ = train_step(state, batch)
        if (s + 1) % 50 == 0:
            host = {k: float(v) for k, v in losses.items()}
            logged.append((s + 1, host))
            print(f"[i] step {s + 1}: total={host['total']:.4f} "
                  f"conf={host['confidence']:.4f} loc={host['localization']:.4f} "
                  f"({(time.time() - t0):.0f}s)")
    return state, logged


def gt_lists(batch):
    """Each image's ground-truth ``Box`` list."""
    from ssd_tensorflow_tpu_torch.types import Box, Point, Size

    gt_boxes, gt_labels, gt_mask = batch["gt_boxes"], batch["gt_labels"], batch["gt_mask"]
    return [[Box(LID2NAME[int(gt_labels[i, j])], int(gt_labels[i, j]),
                 Point(*gt_boxes[i, j, :2]), Size(*gt_boxes[i, j, 2:]))
             for j in range(gt_mask.shape[1]) if gt_mask[i, j]]
            for i in range(len(gt_mask))]


def train_map(boxes_list, batch):
    """``(aps, mAP)`` of per-image detection box lists on ``batch``."""
    from ssd_tensorflow_tpu_torch.eval.average_precision import APCalculator, APs2mAP

    calc = APCalculator()
    for gt, boxes in zip(gt_lists(batch), boxes_list):
        calc.add_detections(gt, boxes)
    aps = calc.compute_aps()
    return aps, APs2mAP(aps)


def evaluate(eval_step, params, batch):
    """The train mAP of ``params`` on ``batch`` (a memorization check) ->
    ``(aps, mAP, per-image box lists)``."""
    from ssd_tensorflow_tpu_torch.ops.postprocess import detections_to_boxes

    _, dets = eval_step(params, batch)
    boxes_list = detections_to_boxes(dets, LID2NAME)
    return (*train_map(boxes_list, batch), boxes_list)


def build_parser():
    parser = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    parser.add_argument("--steps", type=int, default=300)
    parser.add_argument("--images", type=int, default=32)
    parser.add_argument("--batch-size", type=int, default=32)
    parser.add_argument("--lr", type=float, default=0.001)
    parser.add_argument("--compute-dtype", default="bfloat16")
    parser.add_argument("--map-target", type=float, default=0.5)
    parser.add_argument("--device", default="cuda",
                        help="torch device (cuda unless asked for cpu; raises without a card)")
    return parser


def main(argv=None):
    args = build_parser().parse_args(argv)
    from ssd_tensorflow_tpu_torch import resolve_device
    from ssd_tensorflow_tpu_torch.models.ssd_vgg import init_params

    device = resolve_device(args.device)
    batch = first_batch(make_dataset(args.images, np.random.default_rng(7)), args.batch_size)
    cfg = train_config(compute_dtype=args.compute_dtype, lr=args.lr)
    state, train_step, eval_step = setup(cfg, init_params(cfg.model, seed=0), device)
    state, _ = train(state, train_step, batch, args.steps)
    aps, mAP, _ = evaluate(eval_step, state.params, batch)
    print(f"[i] APs: { {k: round(v, 3) for k, v in aps.items()} }")
    print(f"[i] train mAP after {args.steps} steps: {mAP:.4f}")
    if mAP < args.map_target:
        print(f"[!] FAIL: mAP {mAP:.3f} < target {args.map_target}")
        return 1
    print("[i] PASS")
    return 0


if __name__ == "__main__":
    sys.exit(main())
