"""Registers the RetinaNet family's small preset ``rxtest64`` in the shared
small cases (``tests/h100bench_cases.py``) before any test under
``h100bench/tests`` runs, as ``tests/conftest.py`` registers the MobileNet
family's, so that every test module (the traffic rehearsals run alone
included) runs the family's cell at it: the whole network at 64x64, levels
8/4/2/1/1, anchor sizes an eighth of retina800's (the program's
``presets.rxtest64``)."""

import sys
from pathlib import Path

sys.path.insert(0, str(Path(__file__).resolve().parent / "tests"))

import h100bench_cases as hc  # noqa: E402

RXTEST64 = {"name": "rxtest64", "image_size": [64, 64], "maps": [
    {"size": [g, g], "scale": 0.0, "aspect_ratios": [0.5, 1.0, 2.0],
     "anchor_sizes": [x, int(x * 2 ** (1 / 3)), int(x * 2 ** (2 / 3))]}
    for g, x in ((8, 4), (4, 8), (2, 16), (1, 32), (1, 64))],
    "extra_scale": 0.0, "num_anchors": 774}
hc.SMALL_PRESETS.setdefault("retinanet_resnext50fpn", RXTEST64)
