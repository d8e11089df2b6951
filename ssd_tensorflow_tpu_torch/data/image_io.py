"""Host image I/O of the serving and evaluation entry points: the one place
where the CLIs, the inference façade, the data sources and the result
writers call OpenCV, exactly as the JAX package calls it (BGR uint8
decode, ``INTER_LINEAR`` resize, the reference's box drawing), so that
both give the same pixels.

Without OpenCV every function raises. ``chip_smoke.py`` replaces these
functions on the card with staged ones that hand out images decoded on
the CPU box (another OpenCV build may decode other pixels), and says so
in its output. The package itself has no stand-in.
"""

from __future__ import annotations

import numpy as np

from ssd_tensorflow_tpu_torch.types import Size, prop2abs

try:
    import cv2
except ImportError:  # pragma: no cover - the card machine has no OpenCV
    cv2 = None


def _require_cv2():
    if cv2 is None:
        raise RuntimeError("OpenCV (cv2) is required for host image I/O "
                           "(ssd_tensorflow_tpu_torch/data/image_io.py)")


def imread(path: str):
    """The image at ``path`` as a ``(H, W, 3)`` uint8 BGR array, or None
    where it cannot be read (as ``cv2.imread``)."""
    _require_cv2()
    return cv2.imread(path)


def resize(img, size):
    """``img`` resized to ``size = (w, h)`` with bilinear interpolation
    (``cv2.INTER_LINEAR``)."""
    _require_cv2()
    return cv2.resize(img, tuple(size), interpolation=cv2.INTER_LINEAR)


def imwrite(path: str, img) -> bool:
    """Write ``img`` (BGR) to ``path``, the format by its extension."""
    _require_cv2()
    return cv2.imwrite(path, img)


def ellipse(img, center, axes, color):
    """Draw a filled axis-aligned ellipse on ``img`` in place."""
    _require_cv2()
    cv2.ellipse(img, center, axes, 0, 0, 360, color, -1)


def draw_box(img, box, color):
    """Draw an annotated detection box on ``img`` in place: its outline, a
    filled label bar and the label, blended at 0.8 (reference
    utils.py:138-148)."""
    _require_cv2()
    img_size = Size(img.shape[1], img.shape[0])
    xmin, xmax, ymin, ymax = prop2abs(box.center, box.size, img_size)
    img_box = np.copy(img)
    cv2.rectangle(img_box, (xmin, ymin), (xmax, ymax), color, 2)
    cv2.rectangle(img_box, (xmin - 1, ymin), (xmax + 1, ymin - 20), color, cv2.FILLED)
    cv2.putText(img_box, str(box.label), (xmin + 5, ymin - 5), cv2.FONT_HERSHEY_SIMPLEX, 0.5,
                (255, 255, 255), 1, cv2.LINE_AA)
    alpha = 0.8
    cv2.addWeighted(img_box, alpha, img, 1.0 - alpha, 0, img)
