"""Registers the MobileNetV1 family in the shared small cases
(``h100bench_cases.py``) before any test runs: its small preset
``mntest64`` (64x64 images, 116 anchors) for the reference against the
program on seeded weights, and its cells run as committed, the shipped QAT
bundle at 320x320 and batch 4 (about 3.1 GFLOP an image), since random
weights at the small preset part the int8 program from the float32
reference further than a trained bundle's limits allow."""

import h100bench_cases as hc

MNTEST64 = {"name": "mntest64", "image_size": [64, 64], "maps": [
    {"size": [4, 4], "scale": 0.4, "aspect_ratios": [2, 3, 0.5, 1.0 / 3.0]},
    {"size": [2, 2], "scale": 0.65, "aspect_ratios": [2, 0.5]},
    {"size": [1, 1], "scale": 0.9, "aspect_ratios": [2, 0.5]}],
    "extra_scale": 1.07, "num_anchors": 116}

hc.SMALL_PRESETS.setdefault("ssd_mobilenetv1", MNTEST64)
hc.AS_COMMITTED.add("ssd_mobilenetv1")
