#!/usr/bin/env python3
"""Drive the PyTorch port's float detection path on one NVIDIA GPU.

Run from the repository root:

    python3 chip_smoke.py [--seed 0] [--batch 64]

Phases, each printing one JSON line; any failed check raises and exits
non-zero, and the final line is printed only when every phase passed:

1. device: the card's name and power limit (``nvidia-smi``), then the
   build of every kernel from ``ssd_tensorflow_tpu_torch/csrc/``.
2. kernels: each kernel against its plain PyTorch version on the card,
   at the detection path's shapes (vgg512, batch 64): NMS keep masks
   must be identical (D = 200, 57, 256); the stem within one bf16 step
   of the largest output. ``ms`` is the kernel's device time from a
   ``torch.profiler`` window; ``event_ms`` the CUDA-event time per call
   over chained calls, which includes host launch cost.
3. main path: ``InferenceModel.run_scores`` -> ``detections_to_boxes`` on
   vgg512 bf16 with weights made from the seed. Both kernels' launch
   counts must rise in that run, the outputs must be finite with 0..200
   detections per image, and the pre-NMS scores must agree with the same
   model run through the plain stem (conf within 0.02, argmax class on
   >= 99 % of anchors, locs within 0.05). The peak device memory of that
   one run, and images/s over chained batches.

The line before the last lists the kernels with their launches, errors,
times and bounds; the last line is ``{"ok": true, "device": {...}}``.
Imports nothing of JAX or of the JAX package.
"""

from __future__ import annotations

import argparse
import json
import subprocess
import sys
import time
from pathlib import Path
from unittest import mock

#: Published dense peaks of one H100 SXM at its 700 W limit (NVIDIA data sheet).
PEAK_BF16_FLOPS = 989e12
PEAK_F32_FLOPS = 67e12
PEAK_BYTES_PER_S = 3.35e12


def _emit(obj) -> None:
    print(json.dumps(obj), flush=True)


def _bound(n_bytes: float, n_ops: float, peak_ops: float):
    t_bytes = n_bytes / PEAK_BYTES_PER_S * 1e3
    t_ops = n_ops / peak_ops * 1e3
    return (t_ops, "operations") if t_ops >= t_bytes else (t_bytes, "bytes")


def _nms_inputs(rng, b: int, d: int, num_classes: int, device):
    """Score-sorted candidates with overlap clusters, class-shifted corners."""
    import numpy as np
    import torch

    from ssd_tensorflow_tpu_torch.ops.boxes import box_canvas_corners
    from ssd_tensorflow_tpu_torch.ops.nms import class_shifted

    w = rng.uniform(0.05, 0.5, (b, d))
    h = rng.uniform(0.05, 0.5, (b, d))
    cx, cy = rng.uniform(w / 2, 1 - w / 2), rng.uniform(h / 2, 1 - h / 2)
    boxes = np.stack([cx, cy, w, h], axis=-1)
    half = d // 2
    boxes[:, :half] = np.clip(
        boxes[:, np.arange(half) % 8] + rng.normal(0, 0.01, (b, half, 4)), 0.02, 0.98)
    classes = rng.integers(0, num_classes, (b, d))
    valid = np.sort(rng.uniform(0, 1, (b, d)), axis=1)[:, ::-1] > 0.3
    corners = box_canvas_corners(torch.tensor(boxes, dtype=torch.float32))
    shifted = class_shifted(corners, torch.tensor(classes)).contiguous()
    return shifted.to(device), torch.tensor(valid.copy()).to(device)


def check_nms(rng, batch: int, device):
    import torch

    from ssd_tensorflow_tpu_torch.ops import nms_cuda
    from ssd_tensorflow_tpu_torch.timing import cuda_event_ms, kernel_device_ms

    err = 0.0
    for d in (200, 57, 256):
        corners, valid = _nms_inputs(rng, batch, d, 21, device)
        got = nms_cuda.nms_keep(corners, valid)
        want = nms_cuda.nms_keep_plain(corners, valid)
        err = max(err, float((got.int() - want.int()).abs().max()))
        if not torch.equal(got, want):
            raise AssertionError(f"nms_keep differs from its plain version at D={d}: "
                                 f"{int((got != want).sum())} of {got.numel()} flags")
    corners, valid = _nms_inputs(rng, batch, 200, 21, device)
    d = 200
    ms = kernel_device_ms(lambda: nms_cuda.nms_keep(corners, valid), "nms_kernel", iters=50)
    event_ms = cuda_event_ms(lambda: nms_cuda.nms_keep(corners, valid), iters=50)
    plain_ms = cuda_event_ms(lambda: nms_cuda.nms_keep_plain(corners, valid), iters=3, warmup=1)
    # each pair j > i: 4 min/max, 4 add/sub, 2 clamps, mul, add, sub, div, compare
    n_ops = batch * (d * (d - 1) / 2 * 15 + d * 5)
    n_bytes = batch * d * (16 + 1 + 1)
    bound_ms, bound_by = _bound(n_bytes, n_ops, PEAK_F32_FLOPS)
    return {
        "name": "nms_keep", "route": "cuda", "source": "ssd_tensorflow_tpu_torch/csrc/nms.cu",
        "replaces": "ssd_tensorflow_tpu/ops/nms_pallas.py:72",
        "max_abs_err": err, "ms": ms, "event_ms": event_ms, "plain_ms": plain_ms,
        "bound_ms": bound_ms, "bound_by": bound_by, "library_ms": None,
        "shape": [batch, d],
    }


def check_stem(params, images):
    import torch
    import torch.nn.functional as F

    from ssd_tensorflow_tpu_torch.models.vgg16 import conv1_1_unbiased
    from ssd_tensorflow_tpu_torch.ops import stem_cuda
    from ssd_tensorflow_tpu_torch.timing import cuda_event_ms, kernel_device_ms

    c1 = conv1_1_unbiased(params, images)
    b1, w2, b2 = params["conv1_1"]["b"], params["conv1_2"]["w"], params["conv1_2"]["b"]
    got = stem_cuda.fused_stem(c1, b1, w2, b2)
    want = stem_cuda.fused_stem_plain(c1, b1, w2, b2)
    err = float((got.float() - want.float()).abs().max())
    scale = float(want.float().abs().max())
    # both sum exact bf16 products in float32, in different orders: an
    # output may round one bf16 step (2^-7 relative) apart, no more
    tol = scale * 2.0 ** -7
    if not (scale > 0 and err <= tol and torch.isfinite(got.float()).all()):
        raise AssertionError(f"fused_stem differs from its plain version: max err {err} "
                             f"> {tol} (max |ref| {scale})")
    del want
    ms = kernel_device_ms(lambda: stem_cuda.fused_stem(c1, b1, w2, b2), "stem_kernel", iters=10)
    event_ms = cuda_event_ms(lambda: stem_cuda.fused_stem(c1, b1, w2, b2), iters=10)
    plain_ms = cuda_event_ms(lambda: stem_cuda.fused_stem_plain(c1, b1, w2, b2), iters=3,
                             warmup=1)
    c1n = c1.permute(0, 3, 1, 2)
    b1n = b1.to(torch.bfloat16).view(1, -1, 1, 1)
    w2b, b2b = w2.to(torch.bfloat16), b2.to(torch.bfloat16)
    library_ms = cuda_event_ms(
        lambda: F.max_pool2d(F.relu(F.conv2d(F.relu(c1n + b1n), w2b, b2b, padding=1)), 2),
        iters=10)
    b, h, w, c = c1.shape
    n_ops = 2.0 * b * h * w * c * c * 9
    n_bytes = c1.numel() * 2 + got.numel() * 2 + w2.numel() * 2 + 2 * c * 4
    bound_ms, bound_by = _bound(n_bytes, n_ops, PEAK_BF16_FLOPS)
    return {
        "name": "fused_stem", "route": "cuda", "source": "ssd_tensorflow_tpu_torch/csrc/stem.cu",
        "replaces": "ssd_tensorflow_tpu/ops/stem_pallas.py:160",
        "max_abs_err": err, "ms": ms, "event_ms": event_ms, "plain_ms": plain_ms,
        "bound_ms": bound_ms, "bound_by": bound_by, "library_ms": library_ms,
        "shape": [b, h, w, c], "tolerance": tol,
    }


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--batch", type=int, default=64)
    args = ap.parse_args(argv)

    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: torch.cuda.is_available() is False; this check needs a GPU",
              file=sys.stderr)
        return 2
    sys.path.insert(0, str(Path(__file__).resolve().parent))
    import numpy as np

    from ssd_tensorflow_tpu_torch.inference import InferenceModel
    from ssd_tensorflow_tpu_torch.models import ssd_vgg
    from ssd_tensorflow_tpu_torch.ops import _build, nms_cuda, stem_cuda
    from ssd_tensorflow_tpu_torch.ops.postprocess import detections_to_boxes
    from ssd_tensorflow_tpu_torch.timing import cuda_event_ms

    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    device = torch.device("cuda")

    # 1. device and build
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True, check=True).stdout.strip().splitlines()
    print(smi[0], flush=True)
    t0 = time.perf_counter()
    _build.libraries()
    ptxas = {name: [ln.strip() for ln in _build.build_log(name).splitlines()
                    if "registers" in ln or "spill" in ln]
             for name in _build.SOURCES}
    _emit({"phase": "build", "seconds": time.perf_counter() - t0, "ptxas": ptxas,
           "torch": torch.__version__, "cuda": torch.version.cuda})

    cfg = ssd_vgg.ModelConfig(preset_name="vgg512", num_classes=20, compute_dtype="bfloat16")
    model = InferenceModel(ssd_vgg.init_params(cfg, seed=args.seed), cfg, device=device)
    rng = np.random.default_rng(args.seed)
    size = cfg.preset.image_size
    images = torch.from_numpy(
        rng.integers(0, 256, (args.batch, size.h, size.w, 3), dtype=np.uint8)).to(device)

    # 2. each kernel against its plain version at the main path's shapes
    with torch.inference_mode():
        kernels = [
            check_nms(rng, args.batch, device),
            check_stem(model.params, ssd_vgg.preprocess(images, cfg)),
        ]
    _emit({"phase": "kernels", "checked": [k["name"] for k in kernels]})

    # 3. the main path, counted
    nms_cuda.nms_keep.launches = 0
    stem_cuda.fused_stem.launches = 0
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    dets = model.run_scores(images)
    torch.cuda.synchronize()
    peak_mem_gib = torch.cuda.max_memory_allocated() / 2**30
    rows = detections_to_boxes(dets, model.lid2name)
    launches = {"nms_keep": nms_cuda.nms_keep.launches,
                "fused_stem": stem_cuda.fused_stem.launches}
    for k in kernels:
        k["launches"] = launches[k["name"]]
    if min(launches.values()) < 1:
        raise AssertionError(f"a kernel of the path was not launched: {launches}")
    counts = dets.valid.sum(dim=1)
    if len(rows) != args.batch or [len(r) for r in rows] != counts.tolist():
        raise AssertionError("detections_to_boxes rows disagree with the valid mask")
    if not (0 <= int(counts.min()) and int(counts.max()) <= 200):
        raise AssertionError(f"detection counts out of [0, 200]: {counts.tolist()}")
    v = dets.valid
    if not (torch.isfinite(dets.scores[v]).all() and torch.isfinite(dets.boxes[v]).all()):
        raise AssertionError("non-finite detections")

    with torch.inference_mode():
        conf, cls, locs = ssd_vgg.apply_scores(model.params, images, cfg)
        with mock.patch.object(stem_cuda, "fused_stem", stem_cuda.fused_stem_plain):
            conf_p, cls_p, locs_p = ssd_vgg.apply_scores(model.params, images, cfg)
    agree = {
        "conf_max_abs": float((conf - conf_p).abs().max()),
        "cls_share": float((cls == cls_p).float().mean()),
        "locs_max_abs": float((locs - locs_p).abs().max()),
        "locs_max_ref": float(locs_p.abs().max()),
    }
    if not (torch.isfinite(conf).all() and torch.isfinite(locs).all()):
        raise AssertionError("non-finite pre-NMS scores")
    if not (agree["conf_max_abs"] < 0.02 and agree["cls_share"] >= 0.99
            and agree["locs_max_abs"] < 0.05):
        raise AssertionError(f"kernel path and plain path disagree: {agree}")

    iters = 5
    model_ms = cuda_event_ms(lambda: model.run_scores(images), iters=iters, warmup=1)
    t0 = time.perf_counter()
    for _ in range(3):
        detections_to_boxes(model.run_scores(images))
    host_s = (time.perf_counter() - t0) / 3
    _emit({
        "phase": "main_path", "preset": cfg.preset_name, "dtype": cfg.compute_dtype,
        "batch": args.batch, "launches": launches,
        "detections_per_image": {"min": int(counts.min()), "max": int(counts.max()),
                                 "mean": float(counts.float().mean())},
        "plain_stem_agreement": agree,
        "batch_ms": model_ms, "images_per_s": args.batch / model_ms * 1e3,
        "host_images_per_s_with_box_lists": args.batch / host_s,
        "peak_mem_gib": peak_mem_gib,
    })

    _emit({"kernels": kernels})
    _emit({"ok": True, "device": {"platform": "gpu", "kind": torch.cuda.get_device_name(0),
                                  "count": torch.cuda.device_count()}})
    return 0


if __name__ == "__main__":
    sys.exit(main())
