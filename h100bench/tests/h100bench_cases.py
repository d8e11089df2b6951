"""Small cells for the CPU tests: the benchmark's traffic mixes at small
batches, the configurations at a small preset of their family (VGG
``test64``, ResNet-34 ``rtest64``: 64x64 images, 372 anchors) with int8
bundles quantized from seeded weights, or as committed (``AS_COMMITTED``)."""

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

from benchlib import family, registry  # noqa: E402

# a few threads: many OpenMP threads on a shared CPU thrash
torch.set_num_threads(2)

TEST64 = {"name": "test64", "image_size": [64, 64], "maps": [
    {"size": [8, 8], "scale": 0.15, "aspect_ratios": [2, 0.5]},
    {"size": [4, 4], "scale": 0.4, "aspect_ratios": [2, 3, 0.5, 1.0 / 3.0]},
    {"size": [2, 2], "scale": 0.65, "aspect_ratios": [2, 0.5]},
    {"size": [1, 1], "scale": 0.9, "aspect_ratios": [2, 0.5]}],
    "extra_scale": 1.07, "num_anchors": 372}

#: the ResNet-34 family's small preset: the same maps
RTEST64 = dict(TEST64, name="rtest64")

#: the small preset of each family
SMALL_PRESETS = {"ssd_ref": TEST64, "ssd_resnet34gn": RTEST64}

#: families whose cells the CPU tests run as committed, at their own preset
#: and bundle: the ResNet-34 bundle (17.7 GFLOP an image) runs a batch of 4 at
#: 320x320 in seconds, and at rtest64 random weights part the int8 program
#: from the float32 reference further (class probabilities by 0.08-0.12)
#: than the limits set for the trained bundle allow
AS_COMMITTED = {"ssd_resnet34gn"}

#: seeded float weights of a family whose configurations ship only a bundle
SEEDED = {"kind": "seed", "bias_range": 0.05, "gn_scale": [0.5, 1.5]}

SMALL_TRAFFIC = {"batch": 4, "pool_batches": 4, "sample_requests": 2, "warmup_iters": 1,
                 "trace_seconds": 0.5}


def small_config(name: str, bundle: str | None = None) -> dict:
    cfg = copy.deepcopy(registry.config(name))
    cfg["preset"] = copy.deepcopy(SMALL_PRESETS[family.name(cfg)])
    cfg["model"]["preset_name"] = cfg["preset"]["name"]
    if bundle is not None:
        cfg["weights"] = {"kind": "bundle", "path": bundle}
    return cfg


def small_traffic(name: str) -> dict:
    t = copy.deepcopy(registry.traffic(name))
    t.update({k: v for k, v in SMALL_TRAFFIC.items() if k in t})
    return t


def write_int8_bundle(path: Path, seed: int = 0, config: str = "ssd512-vgg16-int8") -> str:
    """A small int8 bundle of ``config``'s model from seeded weights (VGG:
    the program's ``init_params``; another family: its reference's
    ``seeded_params``, GroupNorm scales and biases drawn too), calibrated
    on seeded images by the program's own post-training quantization."""
    import torch

    from benchlib import pool
    from ssd_tensorflow_tpu_torch.inference import save_bundle
    from ssd_tensorflow_tpu_torch.models import quantized
    from ssd_tensorflow_tpu_torch.models.ssd_vgg import ModelConfig, init_params

    cfg = small_config(config)
    cpu = torch.device("cpu")
    mc = ModelConfig(preset_name=cfg["model"]["preset_name"],
                     num_classes=cfg["model"]["num_classes"])
    if family.name(cfg) == family.DEFAULT:
        params = init_params(mc, seed)
    else:
        params = family.of(cfg).seeded_params({**cfg, "weights": SEEDED}, seed, cpu)
    images = pool.images(8, tuple(cfg["preset"]["image_size"]),
                         {"crop_scale": [0.6, 1.0], "flip": 0.5, "brightness": 32}, seed, cpu)
    qm = quantized.QuantizedModel(params, mc, images, device="cpu")
    save_bundle(str(path), qm.qparams, mc, act_scales=qm.act_scales)
    return str(path)


def write_bundles(directory: Path) -> dict:
    """``{configuration: bundle path}``: a small int8 bundle for every
    configuration of ``BENCHMARK.json`` that serves one and is cut to its
    family's small preset."""
    out = {}
    for c in registry.benchmark(ROOT)["configs"]:
        cfg = registry.config(c["name"])
        if cfg["weights"]["kind"] == "bundle" and family.name(cfg) not in AS_COMMITTED:
            out[c["name"]] = write_int8_bundle(Path(directory) / f"{c['name']}.npz",
                                               config=c["name"])
    return out


def cell(workload: str, bundles: dict | None = None, limits: dict | None = None) -> registry.Cell:
    """The cell ``workload`` of ``BENCHMARK.json`` on the CPU with small
    batches: cut to its family's small preset, serving the configuration's
    bundle of ``bundles`` (:func:`write_bundles`) where it serves one, or as
    committed where its family is in ``AS_COMMITTED``; with its committed
    limits unless ``limits`` is given."""
    c = registry.cell(ROOT, workload)
    w = next(x for x in registry.benchmark(ROOT)["workloads"] if x["name"] == workload)
    cfg = c.config
    if family.name(cfg) not in AS_COMMITTED:
        bundle = (bundles or {})[w["config"]] if cfg["weights"]["kind"] == "bundle" else None
        cfg = small_config(w["config"], bundle)
    return dataclasses.replace(c, config=cfg, traffic=small_traffic(w["traffic"]),
                               limits=limits or c.limits)


#: every traffic file with a cell that runs it
CELLS = [w["name"] for w in registry.benchmark(ROOT)["workloads"]]
