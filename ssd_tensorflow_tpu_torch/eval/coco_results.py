"""COCO detection-results JSON writer, as the JAX package's
``eval/coco_results.py``: one JSON array of

    {"image_id": int, "category_id": int,
     "bbox": [x, y, width, height], "score": float}

with 0-based absolute pixel ``bbox``, which the official ``COCOeval``
tooling reads. The box math inverts the COCO loader
(``data/source_coco.py`` maps ``[x, y, w, h]`` to the 1-based
inclusive-corner convention by ``xmin = x + 1``, ``xmax = x + w``), so a
ground-truth box round-trips to its original JSON numbers.
"""

from __future__ import annotations

import json
import os

from ssd_tensorflow_tpu_torch.data import image_io
from ssd_tensorflow_tpu_torch.types import Size, prop2abs


class CocoResultsWriter:
    def __init__(self, image_ids=None, cat_ids=None):
        """Args:
          image_ids: filename -> COCO image id (``COCOSource.image_ids``).
            Files missing from the map fall back to the numeric
            basename stem (the COCO ``000000123456.jpg`` convention).
          cat_ids: class name -> COCO category id
            (``COCOSource.cat_ids``: the dataset JSON's own ids, with
            the canonical 80-class table as fallback). Detections whose
            label is missing from the map are skipped — they have no
            expressible ``category_id``.
        """
        self.image_ids = dict(image_ids or {})
        self.cat_ids = dict(cat_ids or {})
        self.results = []
        self.skipped_labels = set()

    def __image_id(self, filename):
        image_id = self.image_ids.get(filename)
        if image_id is not None:
            return image_id
        stem = os.path.basename(filename).rsplit(".", 1)[0]
        return int(stem) if stem.isdigit() else stem

    def add_detections(self, filename, boxes, img_size: Size | None = None):
        """Add one image's detections.

        Args:
          filename: source image path (resolved to ``image_id``).
          boxes:    list of ``(confidence, Box)``.
          img_size: the image's true size; read from the file
            (``data/image_io.py``) when not given.
        """
        if img_size is None:
            img = image_io.imread(filename)
            img_size = Size(img.shape[1], img.shape[0])

        image_id = self.__image_id(filename)
        for conf, box in boxes:
            cat_id = self.cat_ids.get(box.label)
            if cat_id is None:
                self.skipped_labels.add(box.label)
                continue
            xmin, xmax, ymin, ymax = prop2abs(box.center, box.size, img_size)
            # drop boxes lying entirely outside the canvas — clamping
            # them would fabricate 1-px edge slivers at full confidence
            # (the loader drops degenerate gt the same way)
            if (xmax < 1 or xmin > img_size.w
                    or ymax < 1 or ymin > img_size.h):
                continue
            # the decoded corners follow the loader's 1-based
            # inclusive-corner convention (source_coco.py: xmin = x + 1,
            # xmax = x + w); clamp on that canvas, then invert it:
            # x = xmin - 1, w = xmax - xmin + 1
            xmin = min(max(xmin, 1), img_size.w)
            xmax = min(max(xmax, 1), img_size.w)
            ymin = min(max(ymin, 1), img_size.h)
            ymax = min(max(ymax, 1), img_size.h)
            self.results.append(
                {
                    "image_id": image_id,
                    "category_id": cat_id,
                    "bbox": [
                        float(xmin - 1),
                        float(ymin - 1),
                        float(xmax - xmin + 1),
                        float(ymax - ymin + 1),
                    ],
                    "score": float(conf),
                }
            )

    def write_results(self, path):
        """Write the accumulated detections as one COCO results JSON."""
        os.makedirs(os.path.dirname(path) or ".", exist_ok=True)
        with open(path, "w") as f:
            json.dump(self.results, f)
        if self.skipped_labels:
            print(
                "[!] coco-results: skipped labels with no category id: "
                + ", ".join(sorted(self.skipped_labels))
            )
