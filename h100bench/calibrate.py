"""Readings that the limits in ``limits/<cell>.json`` are set from, on the
card at the cell's own size: the program's numbers on many seeds (the
lower reading), the control's (the reference a precision below the
configuration's: int8 -> int4, bf16 -> fp8, as the configuration's family
computes it) and each planted fault's (the upper readings). Not part of a
benchmark run.

    python3 h100bench/calibrate.py --workload <cell> --seeds 12 --control-seeds 3 \\
        --seconds 2 --out chiprun_out/calibrate-<cell>.json

Faults: serving, ``class_shift`` (every detection's class moved by one
where the decode produces it), ``half_batch`` (the second half of each
batch left out, its rows invalid), ``no_nms`` (the NMS keep mask
replaced by the candidates' validity), ``top1`` (each image's best
detection alone) and ``top_k_20`` (the decode's ``top_k`` cut to 20);
training, ``half_batch`` (each step on the first half of its batch, the
mean over the rest) and ``lr_x1.1`` (the program's learning rate 10 %
high). A state left unchanged reads 1 on ``change_gap`` by its definition
and needs no run.

``--look`` (training) reads, on each seed, the reference against itself
started one ulp up, and the program run in float32 with TF32 off, against
the reference: how far the three-step change parts without any fault.
"""

from __future__ import annotations

import argparse
import copy
import dataclasses
import json
import sys
import time
from pathlib import Path

BENCH = Path(__file__).resolve().parent
ROOT = BENCH.parent
for _p in (str(ROOT), str(BENCH)):
    if _p not in sys.path:
        sys.path.insert(0, _p)

import torch  # noqa: E402

from benchlib import check, family, harness, programs, registry  # noqa: E402


def as_program_output(ref_dets: list, rows: int) -> list:
    """Reference detections in the program's layout: ``rows`` rows, the
    detections first, the rest invalid."""
    out = []
    for r in ref_dets:
        n = len(r["scores"])
        boxes = torch.zeros((rows, 4))
        scores, classes = torch.zeros(rows), torch.zeros(rows, dtype=torch.int32)
        valid = torch.zeros(rows, dtype=torch.bool)
        boxes[:n], scores[:n] = r["boxes"].cpu(), r["scores"].cpu()
        classes[:n], valid[:n] = r["classes"].cpu().int(), True
        out.append((boxes, scores, classes, valid))
    return out


def class_shift(model, k: int):
    run_scores = model.run_scores

    def faulty(images):
        dets = run_scores(images)
        dets.classes = torch.where(dets.valid, (dets.classes + 1) % k, dets.classes)
        return dets

    model.run_scores = faulty


def half_batch_serve(model):
    run_scores = model.run_scores

    def faulty(images):
        half = max(1, images.shape[0] // 2)
        d = run_scores(images[:half])
        pad = images.shape[0] - half

        def grow(t):
            return torch.cat([t, torch.zeros((pad, *t.shape[1:]), dtype=t.dtype, device=t.device)])

        d.boxes, d.scores, d.classes, d.valid = map(grow, (d.boxes, d.scores, d.classes, d.valid))
        return d

    model.run_scores = faulty


def top1(model):
    run_scores = model.run_scores

    def faulty(images):
        dets = run_scores(images)
        dets.valid = dets.valid & (torch.arange(dets.valid.shape[1], device=dets.valid.device) < 1)
        return dets

    model.run_scores = faulty


def no_nms():
    """Patch the decode so that every candidate over the threshold is kept."""
    from ssd_tensorflow_tpu_torch.ops import postprocess

    keep = postprocess._keep
    postprocess._keep = lambda boxes, cls_top, valid, cfg: valid
    return lambda: setattr(postprocess, "_keep", keep)


def serve_readings(cell, seed, seconds, device, control: bool, fault=None):
    undo = no_nms() if fault == "no_nms" else None
    try:
        run = harness.DRIVERS["serve"](cell.config, cell.traffic, seed, device)
        if fault == "class_shift":
            class_shift(run.model, cell.config["model"]["num_classes"])
        elif fault == "half_batch":
            half_batch_serve(run.model)
        elif fault == "top1":
            top1(run.model)
        elif fault == "top_k_20":
            run.model.detection = dataclasses.replace(run.model.detection, top_k=20)
        rec = run.window(seconds, 0.0, None)
    finally:
        if undo:
            undo()
    prog, images = run.check_inputs()
    ref = programs.reference_serving(cell.config, run.given, images)
    nms = cell.config["detection"]["nms_threshold"]
    out = {"program": check.serving_numbers(prog, ref, nms), "requests": rec["requests"],
           "cutoffs": [round(r["cutoff"], 4) for r in ref[:4]],
           "top_scores": [round(float(r["scores"][0]), 4) if len(r["scores"]) else 0.0
                          for r in ref[:4]]}
    if control:
        ctrl = programs.reference_serving(cell.config, run.given, images, control=True)
        out["control"] = check.serving_numbers(as_program_output(ctrl, prog[0][0].shape[0]),
                                               ref, nms)
    return out


def train_readings(cell, seed, device, control: bool, fault=None):
    build = programs.train_step
    if fault == "lr_x1.1":
        cfg = copy.deepcopy(cell.config)
        cfg["train"]["lr_values"] = [1.1 * v for v in cfg["train"]["lr_values"]]
        programs.train_step = lambda _, given, dev: build(cfg, given, dev)
    elif fault == "half_batch":
        def half(cfg, given, dev):
            step, state = build(cfg, given, dev)

            def faulty(st, batch):
                n = next(iter(batch.values())).shape[0] // 2
                return step(st, {k: v[:n] for k, v in batch.items()})

            return faulty, state

        programs.train_step = half
    try:
        from benchlib.train import TrainRun

        run = TrainRun(cell.config, cell.traffic, seed, device)
    finally:
        programs.train_step = build
    run.release()
    ref = run.reference()
    out = {"program": check.train_numbers(run.prog, ref),
           "losses": [run.prog["losses"], ref["losses"]],
           "worst": check.worst_leaves(run.prog, ref)}
    if control:
        quant = family.train_reference(cell.config).train_control
        out["control"] = check.train_numbers(run.reference(quant=quant), ref)
    return out


def train_look(cell, seed, device):
    """The reference against itself one ulp up, and the float32 program
    (TF32 off) against the reference, on one seed."""
    from benchlib.train import TrainRun

    cfg = copy.deepcopy(cell.config)
    cfg["model"]["compute_dtype"] = "float32"
    flags = torch.backends.cudnn.allow_tf32, torch.backends.cuda.matmul.allow_tf32
    torch.backends.cudnn.allow_tf32 = torch.backends.cuda.matmul.allow_tf32 = False
    try:
        run = TrainRun(cfg, cell.traffic, seed, device)
    finally:
        torch.backends.cudnn.allow_tf32, torch.backends.cuda.matmul.allow_tf32 = flags
    run.release()
    ref = run.reference()
    up = {n: {k: torch.nextafter(v, torch.full_like(v, float("inf"))) for k, v in leaf.items()}
          for n, leaf in run.given.items()}
    nudged = run.reference(start=up)
    return {"float32_program": check.train_numbers(run.prog, ref),
            "float32_worst": check.worst_leaves(run.prog, ref),
            "reference_ulp": check.train_numbers(nudged, ref),
            "reference_ulp_worst": check.worst_leaves(nudged, ref)}


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seeds", type=int, default=12)
    ap.add_argument("--control-seeds", type=int, default=3)
    ap.add_argument("--fault-seeds", type=int, default=3)
    ap.add_argument("--first-seed", type=int, default=3_000_000_011)
    ap.add_argument("--seconds", type=float, default=2.0)
    ap.add_argument("--faults", default="")
    ap.add_argument("--extra-seeds", default="", help="comma-separated seeds read as well")
    ap.add_argument("--look", default="", help="comma-separated seeds of the training look")
    ap.add_argument("--device", default="cuda")
    ap.add_argument("--out", required=True)
    args = ap.parse_args(argv)
    device = torch.device(args.device)
    cell = registry.cell(ROOT, args.workload)
    rows = []
    t0 = time.time()
    seeds = [args.first_seed + 7919 * i for i in range(args.seeds)]
    seeds += [int(x) for x in args.extra_seeds.split(",") if x]
    for i, seed in enumerate(seeds):
        ctrl = i < args.control_seeds
        if cell.traffic["mode"] == "train":
            r = train_readings(cell, seed, device, ctrl)
        else:
            r = serve_readings(cell, seed, args.seconds, device, ctrl)
        rows.append({"seed": seed, "t": round(time.time() - t0, 1), **r})
        print(json.dumps(rows[-1]), flush=True)
    for fault in filter(None, args.faults.split(",")):
        for i in range(args.fault_seeds):
            seed = args.first_seed + 104729 * (i + 1)
            if cell.traffic["mode"] == "train":
                r = train_readings(cell, seed, device, False, fault)
            else:
                r = serve_readings(cell, seed, args.seconds, device, False, fault)
            rows.append({"seed": seed, "fault": fault, "t": round(time.time() - t0, 1), **r})
            print(json.dumps(rows[-1]), flush=True)
    for seed in [int(x) for x in args.look.split(",") if x]:
        rows.append({"seed": seed, "look": True, "t": round(time.time() - t0, 1),
                     **train_look(cell, seed, device)})
        print(json.dumps(rows[-1]), flush=True)
    sound = [r["program"] for r in rows if "program" in r and "fault" not in r]
    summary = {"lower": {k: max(r[k] for r in sound) for k in sound[0]},
               "median_sound": {k: sorted(r[k] for r in sound)[len(sound) // 2] for k in sound[0]}}
    ctrl = [r["control"] for r in rows if "control" in r]
    if ctrl:
        summary["control_min"] = {k: min(r[k] for r in ctrl) for k in ctrl[0]}
    for fault in filter(None, args.faults.split(",")):
        f = [r["program"] for r in rows if r.get("fault") == fault]
        summary[f"{fault}_min"] = {k: min(r[k] for r in f) for k in f[0]}
    summary["seconds"] = time.time() - t0
    if device.type == "cuda":
        summary["device"] = torch.cuda.get_device_name(device)
    print(json.dumps(summary), flush=True)
    Path(args.out).parent.mkdir(parents=True, exist_ok=True)
    Path(args.out).write_text(json.dumps({"workload": args.workload, "rows": rows,
                                          "summary": summary}, indent=1))


if __name__ == "__main__":
    main()
