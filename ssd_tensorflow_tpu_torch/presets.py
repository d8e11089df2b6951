"""SSD model presets.

The preset registry mirrors the reference's ``SSD_PRESETS``
(reference: ssdutils.py:32-73) so that datasets can be pre-processed
without instantiating the network. ``vgg300`` has 6 feature maps and
8,732 anchors; ``vgg512`` has 7 maps and 24,564 anchors.
``PYRAMID_PRESETS`` holds RetinaNet's: ``retina800`` is five pyramid
levels at 800x800 (9 anchors a cell, sizes in pixels:
``SSDMap.anchor_sizes``), 120,087 anchors.
"""

from __future__ import annotations

import dataclasses
from typing import Sequence, Tuple

from ssd_tensorflow_tpu_torch.types import Size


@dataclasses.dataclass(frozen=True)
class SSDMap:
    """One multibox feature map: grid size, anchor scale, aspect ratios.

    A map with ``anchor_sizes`` (pixels; ``scale`` unused) takes the
    anchor rule of torchvision's ``AnchorGenerator`` instead of SSD's:
    every size at every aspect ratio (``ops/anchors.py``)."""

    size: Size
    scale: float
    aspect_ratios: Tuple[float, ...]
    anchor_sizes: Tuple[int, ...] = ()

    @property
    def num_shapes(self) -> int:
        """Anchor shapes per cell: AR=1, each extra AR, plus s' box
        (reference: ssdutils.py:84-100 and ssdvgg.py:359); or each of
        ``anchor_sizes`` at each aspect ratio."""
        if self.anchor_sizes:
            return len(self.anchor_sizes) * len(self.aspect_ratios)
        return 2 + len(self.aspect_ratios)


@dataclasses.dataclass(frozen=True)
class SSDPreset:
    name: str
    image_size: Size
    maps: Tuple[SSDMap, ...]
    extra_scale: float
    num_anchors: int
    #: which backbone family builds this preset's feature maps: "vgg",
    #: "resnet34", "mobilenetv1" or "resnext50_fpn" (RetinaNet).
    #: Everything anchor-side (generation, codec, NMS) is backbone-agnostic.
    backbone: str = "vgg"

    @property
    def num_maps(self) -> int:
        return len(self.maps)


def _preset(name, image_size, maps, extra_scale, num_anchors,
            backbone="vgg") -> SSDPreset:
    """``maps``: ``(size, scale, aspect ratios[, anchor sizes])`` each."""
    return SSDPreset(
        name=name,
        image_size=Size(*image_size),
        maps=tuple(
            SSDMap(Size(*m[0]), m[1], tuple(m[2]), tuple(m[3]) if len(m) > 3 else ())
            for m in maps
        ),
        extra_scale=extra_scale,
        num_anchors=num_anchors,
        backbone=backbone,
    )


SSD_PRESETS = {
    # Reference: ssdutils.py:37-48
    "vgg300": _preset(
        "vgg300",
        (300, 300),
        [
            ((38, 38), 0.1, (2, 0.5)),
            ((19, 19), 0.2, (2, 3, 0.5, 1.0 / 3.0)),
            ((10, 10), 0.375, (2, 3, 0.5, 1.0 / 3.0)),
            ((5, 5), 0.55, (2, 3, 0.5, 1.0 / 3.0)),
            ((3, 3), 0.725, (2, 0.5)),
            ((1, 1), 0.9, (2, 0.5)),
        ],
        extra_scale=1.075,
        num_anchors=8732,
    ),
    # Tiny 4-map preset for fast tests and demos: same architecture
    # family (VGG trunk + a-trous conv6/7 + truncated extra-layer chain),
    # 64x64 input, 372 anchors. Not part of the reference; exists so the
    # unit-test suite exercises every model contract without paying
    # full-resolution CPU convolutions.
    "test64": _preset(
        "test64",
        (64, 64),
        [
            ((8, 8), 0.15, (2, 0.5)),
            ((4, 4), 0.4, (2, 3, 0.5, 1.0 / 3.0)),
            ((2, 2), 0.65, (2, 0.5)),
            ((1, 1), 0.9, (2, 0.5)),
        ],
        extra_scale=1.07,
        num_anchors=372,
    ),
    # ResNet-34 SSD at 320x320 — the second model family (not in the
    # reference; models/resnet.py documents the design). 320 divides by
    # 64, so the trunk taps land on exact 40/20/10 grids with no ceil
    # padding anywhere; scales mirror vgg300's progression.
    "resnet320": _preset(
        "resnet320",
        (320, 320),
        [
            ((40, 40), 0.1, (2, 0.5)),
            ((20, 20), 0.2, (2, 3, 0.5, 1.0 / 3.0)),
            ((10, 10), 0.375, (2, 3, 0.5, 1.0 / 3.0)),
            ((5, 5), 0.55, (2, 3, 0.5, 1.0 / 3.0)),
            ((3, 3), 0.725, (2, 0.5)),
            ((1, 1), 0.9, (2, 0.5)),
        ],
        extra_scale=1.075,
        num_anchors=9590,
        backbone="resnet34",
    ),
    # Tiny resnet34 preset for fast tests, the rtest64 analog of test64:
    # 64x64 input, trunk taps 8/4/2 + one extra map, 372 anchors.
    "rtest64": _preset(
        "rtest64",
        (64, 64),
        [
            ((8, 8), 0.15, (2, 0.5)),
            ((4, 4), 0.4, (2, 3, 0.5, 1.0 / 3.0)),
            ((2, 2), 0.65, (2, 0.5)),
            ((1, 1), 0.9, (2, 0.5)),
        ],
        extra_scale=1.07,
        num_anchors=372,
        backbone="resnet34",
    ),
    # MobileNetV1 SSD at 320x320 — the third model family (not in the
    # reference; models/mobilenet.py documents the design). Trunk taps
    # are the canonical MobileNet-SSD conv11/conv13 points (stride
    # 16/32 -> 20/10 grids); extras taper 5/3/2/1. Fewer, coarser maps
    # than the VGG/ResNet families is the family's own convention —
    # 2,424 anchors.
    "mobilenet320": _preset(
        "mobilenet320",
        (320, 320),
        [
            ((20, 20), 0.15, (2, 0.5)),
            ((10, 10), 0.3, (2, 3, 0.5, 1.0 / 3.0)),
            ((5, 5), 0.45, (2, 3, 0.5, 1.0 / 3.0)),
            ((3, 3), 0.6, (2, 3, 0.5, 1.0 / 3.0)),
            ((2, 2), 0.75, (2, 0.5)),
            ((1, 1), 0.9, (2, 0.5)),
        ],
        extra_scale=1.075,
        num_anchors=2424,
        backbone="mobilenetv1",
    ),
    # Tiny mobilenetv1 preset for fast tests (the test64/rtest64
    # analog): 64x64 input, trunk taps 4/2 + one extra map, 116 anchors.
    "mntest64": _preset(
        "mntest64",
        (64, 64),
        [
            ((4, 4), 0.4, (2, 3, 0.5, 1.0 / 3.0)),
            ((2, 2), 0.65, (2, 0.5)),
            ((1, 1), 0.9, (2, 0.5)),
        ],
        extra_scale=1.07,
        num_anchors=116,
        backbone="mobilenetv1",
    ),
    # Reference: ssdutils.py:49-61
    "vgg512": _preset(
        "vgg512",
        (512, 512),
        [
            ((64, 64), 0.07, (2, 0.5)),
            ((32, 32), 0.15, (2, 3, 0.5, 1.0 / 3.0)),
            ((16, 16), 0.3, (2, 3, 0.5, 1.0 / 3.0)),
            ((8, 8), 0.45, (2, 3, 0.5, 1.0 / 3.0)),
            ((4, 4), 0.6, (2, 3, 0.5, 1.0 / 3.0)),
            ((2, 2), 0.75, (2, 0.5)),
            ((1, 1), 0.9, (2, 0.5)),
        ],
        extra_scale=1.05,
        num_anchors=24564,
    ),
}

#: RetinaNet's pyramid presets (no counterpart in the reference's registry,
#: which ``SSD_PRESETS`` mirrors): anchors by ``SSDMap.anchor_sizes``
PYRAMID_PRESETS = {
    # RetinaNet at 800x800 (Lin et al. 2017, arXiv:1708.02002; torchvision's
    # retinanet_resnet50_fpn, MLPerf Inference's detector since v2.1): P3-P7
    # of a ResNeXt-50 FPN (models/resnext_fpn.py), 9 anchors a cell,
    # torchvision's sizes (x, int(x 2^(1/3)), int(x 2^(2/3))) for x = 32..512
    # at ratios 0.5, 1, 2; 13,343 cells, 120,087 anchors. ``scale`` and
    # ``extra_scale`` are unused by that anchor rule.
    "retina800": _preset(
        "retina800",
        (800, 800),
        [((g, g), 0.0, (0.5, 1.0, 2.0), (x, int(x * 2 ** (1 / 3)), int(x * 2 ** (2 / 3))))
         for g, x in ((100, 32), (50, 64), (25, 128), (13, 256), (7, 512))],
        extra_scale=0.0,
        num_anchors=120087,
        backbone="resnext50_fpn",
    ),
    # Tiny RetinaNet preset for fast tests: the same network at 64x64,
    # levels 8/4/2/1/1 and anchors an eighth of retina800's, 774 anchors.
    "rxtest64": _preset(
        "rxtest64",
        (64, 64),
        [((g, g), 0.0, (0.5, 1.0, 2.0), (x, int(x * 2 ** (1 / 3)), int(x * 2 ** (2 / 3))))
         for g, x in ((8, 4), (4, 8), (2, 16), (1, 32), (1, 64))],
        extra_scale=0.0,
        num_anchors=774,
        backbone="resnext50_fpn",
    ),
}


def get_preset_by_name(pname: str) -> SSDPreset:
    """Look up a preset (reference: ssdutils.py:70-73), SSD's or RetinaNet's."""
    found = SSD_PRESETS.get(pname) or PYRAMID_PRESETS.get(pname)
    if found is None:
        raise RuntimeError("No such preset: " + pname)
    return found


def preset_to_dict(preset: SSDPreset) -> dict:
    """Serialize a preset to a JSON-friendly dict (declarative config —
    replaces the reference's pickled-preset artifact,
    process_dataset.py:239-252)."""
    return {
        "name": preset.name,
        "image_size": list(preset.image_size),
        "maps": [
            {
                "size": list(m.size),
                "scale": m.scale,
                "aspect_ratios": list(m.aspect_ratios),
                **({"anchor_sizes": list(m.anchor_sizes)} if m.anchor_sizes else {}),
            }
            for m in preset.maps
        ],
        "extra_scale": preset.extra_scale,
        "num_anchors": preset.num_anchors,
        "backbone": preset.backbone,
    }


def preset_from_dict(d: dict) -> SSDPreset:
    """The inverse of :func:`preset_to_dict`; a dict written before the
    ``backbone`` field existed is VGG."""
    return _preset(
        d["name"],
        tuple(d["image_size"]),
        [(tuple(m["size"]), m["scale"], tuple(m["aspect_ratios"]),
          tuple(m.get("anchor_sizes", ()))) for m in d["maps"]],
        d["extra_scale"],
        d["num_anchors"],
        d.get("backbone", "vgg"),
    )
