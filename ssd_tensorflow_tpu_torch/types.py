"""Host-side geometry datatypes.

API-parity with the JAX package's namedtuples. These types only live on
the host; on the device every box is a row of an ``(N, 4)`` float tensor
in proportional center form ``(cx, cy, w, h)``.
"""

from __future__ import annotations

from collections import namedtuple

Size = namedtuple("Size", ["w", "h"])
Point = namedtuple("Point", ["x", "y"])
Box = namedtuple("Box", ["label", "labelid", "center", "size"])

#: The virtual canvas all protocol-sensitive IoU math is computed on.
#: Proportional boxes are integerized onto a 1000x1000 grid and use the
#: +1-pixel area convention, bit for bit as in the JAX package.
CANVAS = Size(1000, 1000)
