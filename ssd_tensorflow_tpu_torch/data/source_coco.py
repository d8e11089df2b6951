"""COCO (instances JSON) dataset source, as the JAX package's
``data/source_coco.py``: the same sample lists, label map, colours,
``image_ids`` and ``cat_ids``. Load with ``--data-source coco``.

Expected layout (the standard COCO distribution):

    data_dir/annotations/instances_<split>.json   e.g. train2017
    data_dir/<split>/<file_name>                  the images

Split policy:

* train = every ``instances_train*.json``;
* valid = every ``instances_val*.json`` when present, else a
  deterministic ``valid_fraction`` tail carved off the train list (sorted
  by file name);
* test = ``instances_test*.json``, else ``image_info_test*.json`` (box-less
  test images are kept, with empty ground truth).

Annotations with ``iscrowd=1`` are skipped; boxes are clamped to the image
and converted to the proportional center/size convention
(``types.abs2prop``) on the VOC 1-based inclusive-corner convention.
"""

from __future__ import annotations

import colorsys
import json
import os
from glob import glob

from ssd_tensorflow_tpu_torch.types import Box, Sample, Size, abs2prop

#: The 80 COCO object categories in canonical category-id order
#: (COCO ids 1..90 with gaps; index below = contiguous label id).
COCO_CLASSES = [
    "person", "bicycle", "car", "motorcycle", "airplane", "bus", "train",
    "truck", "boat", "traffic light", "fire hydrant", "stop sign",
    "parking meter", "bench", "bird", "cat", "dog", "horse", "sheep",
    "cow", "elephant", "bear", "zebra", "giraffe", "backpack", "umbrella",
    "handbag", "tie", "suitcase", "frisbee", "skis", "snowboard",
    "sports ball", "kite", "baseball bat", "baseball glove", "skateboard",
    "surfboard", "tennis racket", "bottle", "wine glass", "cup", "fork",
    "knife", "spoon", "bowl", "banana", "apple", "sandwich", "orange",
    "broccoli", "carrot", "hot dog", "pizza", "donut", "cake", "chair",
    "couch", "potted plant", "bed", "dining table", "toilet", "tv",
    "laptop", "mouse", "remote", "keyboard", "cell phone", "microwave",
    "oven", "toaster", "sink", "refrigerator", "book", "clock", "vase",
    "scissors", "teddy bear", "hair drier", "toothbrush",
]

#: Canonical COCO category ids for the 80 classes above (1..90 with the
#: well-known gaps 12, 26, 29, 30, 45, 66, 68, 69, 71, 83) — the
#: fallback ``category_id`` mapping for detection-results output when a
#: dataset JSON's own ``categories`` block is unavailable.
COCO_CATEGORY_IDS = [
    i for i in range(1, 91)
    if i not in (12, 26, 29, 30, 45, 66, 68, 69, 71, 83)
]
assert len(COCO_CATEGORY_IDS) == len(COCO_CLASSES)


def _color_for(i, n):
    """Deterministic visually-spread BGR color per class."""
    # golden-ratio hue walk: adjacent ids get distant hues
    h = (i * 0.618033988749895) % 1.0
    r, g, b = colorsys.hsv_to_rgb(h, 0.85, 0.95)
    return (int(b * 255), int(g * 255), int(r * 255))


class COCOSource:
    def __init__(self):
        self.num_classes = len(COCO_CLASSES)
        self.colors = {
            name: _color_for(i, len(COCO_CLASSES))
            for i, name in enumerate(COCO_CLASSES)
        }
        self.lid2name = dict(enumerate(COCO_CLASSES))
        self.lname2id = {n: i for i, n in enumerate(COCO_CLASSES)}
        self.num_train = 0
        self.num_valid = 0
        self.num_test = 0
        self.train_samples = []
        self.valid_samples = []
        self.test_samples = []
        #: filename -> COCO image id, for every image any loaded split
        #: kept (feeds CocoResultsWriter's ``image_id`` field)
        self.image_ids = {}
        #: class name -> the dataset JSON's own category id (feeds
        #: CocoResultsWriter's ``category_id`` field; canonical-table
        #: fallback when a JSON carries no categories block)
        self.cat_ids = {
            name: COCO_CATEGORY_IDS[i]
            for i, name in enumerate(COCO_CLASSES)
        }

    # -- internals ----------------------------------------------------

    def __split_dir(self, data_dir, json_path):
        """instances_train2017.json -> data_dir/train2017."""
        stem = os.path.basename(json_path)
        for prefix in ("instances_", "image_info_"):
            if stem.startswith(prefix):
                stem = stem[len(prefix):]
        return os.path.join(data_dir, stem.rsplit(".", 1)[0])

    def __load_json(self, data_dir, json_path, keep_empty):
        with open(json_path) as f:
            doc = json.load(f)

        # category id (sparse, 1..90) -> contiguous label id, by name so
        # a fixture with non-standard ids but standard names still maps
        cat2lid = {}
        for cat in doc.get("categories", []):
            lid = self.lname2id.get(cat["name"])
            if lid is not None:
                cat2lid[cat["id"]] = lid
                # remember the dataset's own id for results output
                self.cat_ids[cat["name"]] = cat["id"]

        per_image = {}
        for ann in doc.get("annotations", []):
            if ann.get("iscrowd"):
                continue
            lid = cat2lid.get(ann["category_id"])
            if lid is None:
                continue
            per_image.setdefault(ann["image_id"], []).append((lid, ann["bbox"]))

        image_root = self.__split_dir(data_dir, json_path)
        samples = []
        for im in doc.get("images", []):
            filename = os.path.join(image_root, im["file_name"])
            if not os.path.exists(filename):
                continue
            self.image_ids[filename] = im["id"]
            imgsize = Size(int(im["width"]), int(im["height"]))
            boxes = []
            for lid, (x, y, w, h) in per_image.get(im["id"], []):
                # COCO bboxes are 0-based [x, y, w, h]; convert to the
                # VOC 1-based inclusive-corner convention the whole
                # pipeline is built around (abs2prop, the 1000-canvas
                # +1px IoU — reference utils.py:85-97 semantics), so a
                # COCO box yields exactly the numbers the same physical
                # box would coming from a VOC XML.
                xmin = max(1.0, x + 1.0)
                ymin = max(1.0, y + 1.0)
                xmax = min(float(imgsize.w), x + w)
                ymax = min(float(imgsize.h), y + h)
                if xmax <= xmin or ymax <= ymin:
                    continue
                center, size = abs2prop(xmin, xmax, ymin, ymax, imgsize)
                boxes.append(
                    Box(self.lid2name[lid], lid, center, size)
                )
            if boxes or keep_empty:
                samples.append(Sample(filename, boxes, imgsize))
        return samples

    def __load_split(self, data_dir, pattern, keep_empty=False):
        ann_dir = os.path.join(data_dir, "annotations")
        samples = []
        for json_path in sorted(glob(os.path.join(ann_dir, pattern))):
            samples += self.__load_json(data_dir, json_path, keep_empty)
        return samples

    # -- public API (duck-typed source contract) -----------------------

    def load_trainval_data(self, data_dir, valid_fraction):
        train = self.__load_split(data_dir, "instances_train*.json")
        valid = self.__load_split(data_dir, "instances_val*.json")

        if not valid and valid_fraction > 0:
            # deterministic tail split on the sorted file list
            train = sorted(train, key=lambda s: s.filename)
            n_valid = max(1, int(round(len(train) * valid_fraction)))
            train, valid = train[:-n_valid], train[-n_valid:]

        if not train:
            raise RuntimeError("No training samples found in " + data_dir)
        if valid_fraction > 0 and not valid:
            raise RuntimeError("No validation samples found in " + data_dir)

        self.train_samples = train
        self.valid_samples = valid
        self.num_train = len(train)
        self.num_valid = len(valid)

    def load_test_data(self, data_dir):
        test = self.__load_split(
            data_dir, "instances_test*.json", keep_empty=True
        )
        if not test:
            test = self.__load_split(
                data_dir, "image_info_test*.json", keep_empty=True
            )
        if not test:
            raise RuntimeError("No testing samples found in " + data_dir)
        self.test_samples = test
        self.num_test = len(test)


def get_source():
    return COCOSource()
