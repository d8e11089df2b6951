#!/usr/bin/env python3
"""How soon the overfit tool's model memorizes its images, in the port and
in the JAX package, from the port's init draws and from one-ulp nudges of
them.

    # the port, on the card (imports nothing of JAX):
    python3 tests/torch_overfit_witness.py --package port --seeds 0 1 2 3 4 5 \\
        --steps 2000 --every 100 [--dtype bfloat16] [--out runs/witness.json]
    # both packages at test64 on the CPU, from the same draws:
    JAX_PLATFORMS=cpu python3 tests/torch_overfit_witness.py --package port jax \\
        --preset test64 --dtype float32 --images 8 --steps 300 --every 25 --device cpu

Each run starts from the port's ``init_params(cfg, seed)`` (``--nudge n``:
every parameter moved ``n`` float32 ulps up, a perturbation below any
summation-order difference), carried to the JAX package through
``params_to_jax`` for ``--package jax``, and trains the tool's
configuration (3 classes, lr 1e-3, the first ``--images`` of
``make_dataset`` seed 7 in one batch) with that package's own train step.
Every ``--every`` steps it records ``[step, total loss, train mAP]``, the
mAP by the tool's eval (top 64 at 0.3, the VOC AP) for the port and by the
JAX tool's eval code for JAX. Prints one JSON line a run, with the first
recorded step whose mAP reaches 0.5.
"""

from __future__ import annotations

import argparse
import json
import sys
from pathlib import Path

import numpy as np

ROOT = Path(__file__).resolve().parent.parent
sys.path.insert(0, str(ROOT))
sys.path.insert(0, str(ROOT / "tools"))

import torch_overfit_sanity as tool  # noqa: E402

#: the mAP whose first crossing a run reports (the tool's ``--map-target``)
ONSET_MAP = 0.5


def nudged_params(model_cfg, seed: int, nudge: int):
    """The port's ``init_params(model_cfg, seed)``, each leaf moved ``nudge``
    float32 ulps up."""
    import torch

    from ssd_tensorflow_tpu_torch.models.ssd_vgg import init_params

    params = init_params(model_cfg, seed=seed)
    for leaves in params.values():
        for k, v in leaves.items():
            for _ in range(nudge):
                v = torch.nextafter(v, torch.tensor(float("inf")))
            leaves[k] = v
    return params


def port_run(cfg, params, batch, steps: int, every: int, device):
    """The port's run: the tool's ``setup``, ``train`` and ``evaluate``."""
    import contextlib
    import io

    state, train_step, eval_step = tool.setup(cfg, params, device)
    curve = []
    for first in range(0, steps, every):
        last = []

        def step(state, batch):
            out = train_step(state, batch)
            last[:] = [out[1]["total"]]
            return out

        with contextlib.redirect_stdout(io.StringIO()):
            state, _ = tool.train(state, step, batch, min(every, steps - first), first=first)
        curve.append([first + min(every, steps - first), float(last[0]),
                      tool.evaluate(eval_step, state.params, batch)[1]])
    return curve


def jax_tool_eval(params, batch, anchors, model_cfg):
    """The JAX tool's eval code (``tools/overfit_sanity.py:114-136``) ->
    ``(aps, mAP, per-image box lists)``."""
    import jax.numpy as jnp

    from ssd_tensorflow_tpu.eval.average_precision import APCalculator, APs2mAP
    from ssd_tensorflow_tpu.ops.postprocess import DetectionConfig, detections_to_boxes
    from ssd_tensorflow_tpu.parallel import train_step as jax_ts
    from ssd_tensorflow_tpu.types import Box, Point, Size

    eval_step = jax_ts.make_eval_step(
        jax_ts.TrainConfig(model=model_cfg,
                           detect=DetectionConfig(top_k=64, confidence_threshold=0.3)),
        anchors)
    _, dets = eval_step(params, {k: jnp.asarray(v) for k, v in batch.items()})
    lid2name = {0: "red", 1: "green", 2: "blue"}
    boxes_list = detections_to_boxes(dets, lid2name)
    gt_boxes, gt_labels, gt_mask = batch["gt_boxes"], batch["gt_labels"], batch["gt_mask"]
    calc = APCalculator()
    for i in range(len(boxes_list)):
        gt = [Box(lid2name[int(gt_labels[i, j])], int(gt_labels[i, j]),
                  Point(*gt_boxes[i, j, :2]), Size(*gt_boxes[i, j, 2:]))
              for j in range(4) if gt_mask[i, j]]
        calc.add_detections(gt, boxes_list[i])
    aps = calc.compute_aps()
    return aps, APs2mAP(aps), boxes_list


def jax_run(cfg, params, batch, steps: int, every: int):
    """The JAX package's run of the same config from the same parameters:
    its ``make_train_step`` and the JAX tool's eval code."""
    import jax
    import jax.numpy as jnp

    from ssd_tensorflow_tpu.models.ssd_vgg import ModelConfig
    from ssd_tensorflow_tpu.ops.anchors import anchors_for_preset
    from ssd_tensorflow_tpu.parallel import train_step as jax_ts
    from ssd_tensorflow_tpu.presets import get_preset_by_name
    from ssd_tensorflow_tpu_torch.weights import params_to_jax

    model = ModelConfig(preset_name=cfg.model.preset_name, num_classes=3,
                        compute_dtype=cfg.model.compute_dtype)
    jcfg = jax_ts.TrainConfig(model=model, lr_values=cfg.lr_values, lr_boundaries=(),
                              detect=None)
    anchors = anchors_for_preset(get_preset_by_name(model.preset_name))
    state = jax_ts.make_train_state(jax.tree_util.tree_map(jnp.asarray, params_to_jax(params)),
                                    jcfg)
    step = jax_ts.make_train_step(jcfg, anchors)
    jbatch = {k: jnp.asarray(v) for k, v in batch.items()}
    curve = []
    for s in range(1, steps + 1):
        state, losses, _ = step(state, jbatch)
        if s % every == 0 or s == steps:
            curve.append([s, float(losses["total"]),
                          jax_tool_eval(state.params, batch, anchors, model)[1]])
    return curve


def onset(curve):
    """The first recorded step whose mAP reaches :data:`ONSET_MAP`, or None."""
    return next((s for s, _, m in curve if m >= ONSET_MAP), None)


def main(argv=None):
    parser = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    parser.add_argument("--package", nargs="+", choices=("port", "jax"), default=["port"])
    parser.add_argument("--preset", default="vgg300")
    parser.add_argument("--dtype", default="bfloat16")
    parser.add_argument("--images", type=int, default=32)
    parser.add_argument("--seeds", type=int, nargs="+", default=[0])
    parser.add_argument("--nudge", type=int, nargs="+", default=[0])
    parser.add_argument("--steps", type=int, default=300)
    parser.add_argument("--every", type=int, default=50)
    parser.add_argument("--out", default=None)
    parser.add_argument("--device", default="cuda",
                        help="the port's torch device (cuda unless asked for cpu)")
    args = parser.parse_args(argv)

    from ssd_tensorflow_tpu_torch import resolve_device

    device = resolve_device(args.device) if "port" in args.package else None
    batch = tool.first_batch(tool.make_dataset(args.images, np.random.default_rng(7),
                                               size=300 if args.preset == "vgg300" else 64),
                             args.images)
    cfg = tool.train_config(preset=args.preset, compute_dtype=args.dtype)
    rows = []
    for seed in args.seeds:
        for nudge in args.nudge:
            for package in args.package:
                params = nudged_params(cfg.model, seed, nudge)
                curve = (port_run(cfg, params, batch, args.steps, args.every, device)
                         if package == "port" else
                         jax_run(cfg, params, batch, args.steps, args.every))
                rows.append({"package": package, "preset": args.preset, "dtype": args.dtype,
                             "images": args.images, "seed": seed, "nudge": nudge,
                             "onset": onset(curve), "curve": curve})
                print(json.dumps(rows[-1]), flush=True)
    if args.out:
        Path(args.out).parent.mkdir(parents=True, exist_ok=True)
        Path(args.out).write_text(json.dumps(rows, indent=1))
    return 0


if __name__ == "__main__":
    sys.exit(main())
