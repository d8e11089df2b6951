"""Small cells for the CPU tests: the benchmark's configurations and
traffic mixes at the ``test64`` preset (64x64 images, 372 anchors), with
an int8 bundle quantized from seeded weights."""

from __future__ import annotations

import copy
import dataclasses
import sys
from pathlib import Path

BENCH = Path(__file__).resolve().parents[1]
ROOT = BENCH.parent
for _p in (str(ROOT), str(BENCH)):
    if _p not in sys.path:
        sys.path.insert(0, _p)

import torch  # noqa: E402

from benchlib import registry  # noqa: E402

# a few threads: many OpenMP threads on a shared CPU thrash
torch.set_num_threads(2)

TEST64 = {"name": "test64", "image_size": [64, 64], "maps": [
    {"size": [8, 8], "scale": 0.15, "aspect_ratios": [2, 0.5]},
    {"size": [4, 4], "scale": 0.4, "aspect_ratios": [2, 3, 0.5, 1.0 / 3.0]},
    {"size": [2, 2], "scale": 0.65, "aspect_ratios": [2, 0.5]},
    {"size": [1, 1], "scale": 0.9, "aspect_ratios": [2, 0.5]}],
    "extra_scale": 1.07, "num_anchors": 372}

SMALL_TRAFFIC = {"batch": 4, "pool_batches": 4, "sample_requests": 2, "warmup_iters": 1,
                 "trace_seconds": 0.5}


def small_config(name: str, bundle: str | None = None) -> dict:
    cfg = copy.deepcopy(registry.config(name))
    cfg["preset"] = copy.deepcopy(TEST64)
    cfg["model"]["preset_name"] = "test64"
    if bundle is not None:
        cfg["weights"] = {"kind": "bundle", "path": bundle}
    return cfg


def small_traffic(name: str) -> dict:
    t = copy.deepcopy(registry.traffic(name))
    t.update({k: v for k, v in SMALL_TRAFFIC.items() if k in t})
    return t


def write_int8_bundle(path: Path, seed: int = 0) -> str:
    """A test64 int8 bundle of seeded weights, calibrated on seeded images
    by the program's own post-training quantization."""
    import torch

    from benchlib import pool
    from ssd_tensorflow_tpu_torch.inference import save_bundle
    from ssd_tensorflow_tpu_torch.models import quantized
    from ssd_tensorflow_tpu_torch.models.ssd_vgg import ModelConfig, init_params

    mc = ModelConfig(preset_name="test64", num_classes=20)
    params = init_params(mc, seed)
    images = pool.images(8, (64, 64), {"crop_scale": [0.6, 1.0], "flip": 0.5,
                                       "brightness": 32}, seed, torch.device("cpu"))
    qm = quantized.QuantizedModel(params, mc, images, device="cpu")
    save_bundle(str(path), qm.qparams, mc, act_scales=qm.act_scales)
    return str(path)


def cell(workload: str, bundle: str | None = None, limits: dict | None = None) -> registry.Cell:
    """The cell ``workload`` of ``BENCHMARK.json`` cut to test64 on the
    CPU, with its committed limits unless ``limits`` is given."""
    c = registry.cell(ROOT, workload)
    w = next(x for x in registry.benchmark(ROOT)["workloads"] if x["name"] == workload)
    cfg = small_config(w["config"], bundle if "int8" in w["config"] else None)
    return dataclasses.replace(c, config=cfg, traffic=small_traffic(w["traffic"]),
                               limits=limits or c.limits)


#: every traffic file with a cell that runs it
CELLS = [w["name"] for w in registry.benchmark(ROOT)["workloads"]]
