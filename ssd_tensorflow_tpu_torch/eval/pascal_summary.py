"""Pascal VOC evaluation-server submission writer, as the JAX package's
``eval/pascal_summary.py``.

Writes ``comp4_det_test_<class>.txt`` files with lines ``fileid conf left
top right bottom`` in 1-based absolute image coordinates, clamped to the
image, the format the official VOC12 server expects.
"""

from __future__ import annotations

import os
from collections import defaultdict, namedtuple

from ssd_tensorflow_tpu_torch.data import image_io
from ssd_tensorflow_tpu_torch.types import Size, prop2abs

Detection = namedtuple(
    "Detection", ["fileid", "confidence", "left", "top", "right", "bottom"]
)


class PascalSummary:
    def __init__(self):
        self.boxes = defaultdict(list)

    def add_detections(self, filename, boxes, img_size: Size | None = None):
        """Add one image's detections.

        Args:
          filename: source image path (its basename becomes the fileid).
          boxes:    list of ``(confidence, Box)``.
          img_size: the image's true size; read from the file
            (``data/image_io.py``) when not given.
        """
        fileid = os.path.basename(filename)
        fileid = "".join(fileid.split(".")[:-1])
        if img_size is None:
            img = image_io.imread(filename)
            img_size = Size(img.shape[1], img.shape[0])

        for conf, box in boxes:
            xmin, xmax, ymin, ymax = prop2abs(box.center, box.size, img_size)
            xmin = min(max(xmin, 0), img_size.w - 1)
            xmax = min(max(xmax, 0), img_size.w - 1)
            ymin = min(max(ymin, 0), img_size.h - 1)
            ymax = min(max(ymax, 0), img_size.h - 1)
            self.boxes[box.label].append(
                Detection(
                    fileid,
                    conf,
                    float(xmin + 1),
                    float(ymin + 1),
                    float(xmax + 1),
                    float(ymax + 1),
                )
            )

    def write_summary(self, target_dir):
        """Write one submission file per class (pascal_summary.py:57-65)."""
        os.makedirs(target_dir, exist_ok=True)
        for label, dets in self.boxes.items():
            path = os.path.join(target_dir, f"comp4_det_test_{label}.txt")
            with open(path, "w") as f:
                for d in dets:
                    f.write(
                        f"{d.fileid} {d.confidence:.6f} {d.left:.6f} "
                        f"{d.top:.6f} {d.right:.6f} {d.bottom:.6f}\n"
                    )
