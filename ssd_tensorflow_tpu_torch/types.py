"""Host-side geometry datatypes.

API-parity with the JAX package's namedtuples. These types only live on
the host; on the device every box is a row of an ``(N, 4)`` float tensor
in proportional center form ``(cx, cy, w, h)``. The dataset pickles that
``process_dataset.py`` writes hold the JAX package's ``Sample``, ``Box``,
``Point`` and ``Size``; ``data/pipeline.py`` reads them as these.
"""

from __future__ import annotations

from collections import namedtuple

Label = namedtuple("Label", ["name", "color"])
Size = namedtuple("Size", ["w", "h"])
Point = namedtuple("Point", ["x", "y"])
Sample = namedtuple("Sample", ["filename", "boxes", "imgsize"])
Box = namedtuple("Box", ["label", "labelid", "center", "size"])

#: The virtual canvas all protocol-sensitive IoU math is computed on.
#: Proportional boxes are integerized onto a 1000x1000 grid and use the
#: +1-pixel area convention, bit for bit as in the JAX package.
CANVAS = Size(1000, 1000)


def abs2prop(xmin, xmax, ymin, ymax, imgsize):
    """Absolute min/max corner bounds -> proportional center/size."""
    width = float(xmax - xmin)
    height = float(ymax - ymin)
    cx = float(xmin) + width / 2
    cy = float(ymin) + height / 2
    return Point(cx / imgsize.w, cy / imgsize.h), Size(width / imgsize.w, height / imgsize.h)


def prop2abs(center, size, imgsize):
    """Proportional center/size -> absolute integer min/max corner bounds,
    truncated toward zero."""
    w2 = size.w * imgsize.w / 2
    h2 = size.h * imgsize.h / 2
    cx = center.x * imgsize.w
    cy = center.y * imgsize.h
    return int(cx - w2), int(cx + w2), int(cy - h2), int(cy + h2)


def rgb2bgr(tpl):
    """RGB color tuple -> BGR."""
    return (tpl[2], tpl[1], tpl[0])


def str2bool(v):
    """Parse a boolean CLI flag."""
    import argparse

    if v.lower() in ("yes", "true", "t", "y", "1"):
        return True
    if v.lower() in ("no", "false", "f", "n", "0"):
        return False
    raise argparse.ArgumentTypeError("Boolean value expected.")
