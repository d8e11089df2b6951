"""Pascal VOC 2007+2012 dataset source, as the JAX package's
``data/source_pascal_voc.py``: the same split policy, sample lists, label
map and colours.

* train = VOC07-trainval + VOC12-trainval + VOC07-test (the VOC07 test set
  is used as training data, as the reference does);
* valid = the VOC12 annotations that appear in no trainval list;
* test = VOC12 test.

Image sizes come from each annotation's ``<size>`` element; only an
annotation without one has its image decoded (``data/image_io.py``).
"""

from __future__ import annotations

import os
from glob import glob

from ssd_tensorflow_tpu_torch.data import image_io
from ssd_tensorflow_tpu_torch.types import Box, Label, Sample, Size, abs2prop, rgb2bgr

try:
    import lxml.etree as ET
except ImportError:  # pragma: no cover
    import xml.etree.ElementTree as ET

try:
    from tqdm import tqdm
except ImportError:  # pragma: no cover
    def tqdm(x, **kw):
        return x

#: The 20 VOC classes with their display colors (BGR).
label_defs = [
    Label("aeroplane", rgb2bgr((0, 0, 0))),
    Label("bicycle", rgb2bgr((111, 74, 0))),
    Label("bird", rgb2bgr((81, 0, 81))),
    Label("boat", rgb2bgr((128, 64, 128))),
    Label("bottle", rgb2bgr((244, 35, 232))),
    Label("bus", rgb2bgr((230, 150, 140))),
    Label("car", rgb2bgr((70, 70, 70))),
    Label("cat", rgb2bgr((102, 102, 156))),
    Label("chair", rgb2bgr((190, 153, 153))),
    Label("cow", rgb2bgr((150, 120, 90))),
    Label("diningtable", rgb2bgr((153, 153, 153))),
    Label("dog", rgb2bgr((250, 170, 30))),
    Label("horse", rgb2bgr((220, 220, 0))),
    Label("motorbike", rgb2bgr((107, 142, 35))),
    Label("person", rgb2bgr((52, 151, 52))),
    Label("pottedplant", rgb2bgr((70, 130, 180))),
    Label("sheep", rgb2bgr((220, 20, 60))),
    Label("sofa", rgb2bgr((0, 0, 142))),
    Label("train", rgb2bgr((0, 0, 230))),
    Label("tvmonitor", rgb2bgr((119, 11, 32))),
]


class PascalVOCSource:
    def __init__(self):
        self.num_classes = len(label_defs)
        self.colors = {l.name: l.color for l in label_defs}
        self.lid2name = {i: l.name for i, l in enumerate(label_defs)}
        self.lname2id = {l.name: i for i, l in enumerate(label_defs)}
        self.num_train = 0
        self.num_valid = 0
        self.num_test = 0
        self.train_samples = []
        self.valid_samples = []
        self.test_samples = []

    # -- internals ----------------------------------------------------

    def __build_annotation_list(self, root, dataset_type):
        """Annotation files named by an ImageSets/Main list
        (reference: source_pascal_voc.py:75-86)."""
        annot_root = os.path.join(root, "Annotations")
        annot_files = []
        with open(
            os.path.join(root, "ImageSets", "Main", dataset_type + ".txt")
        ) as f:
            for line in f:
                p = os.path.join(annot_root, line.strip() + ".xml")
                if os.path.exists(p):
                    annot_files.append(p)
        return annot_files

    def __parse_annotation(self, fn, image_root):
        doc = ET.parse(fn)
        filename = os.path.join(
            image_root, doc.findall("./filename")[0].text
        )
        if not os.path.exists(filename):
            return None

        size_el = doc.findall("./size")
        if size_el:
            w = int(size_el[0].findall("width")[0].text)
            h = int(size_el[0].findall("height")[0].text)
            imgsize = Size(w, h)
        else:  # pragma: no cover - VOC always carries <size>
            img = image_io.imread(filename)
            imgsize = Size(img.shape[1], img.shape[0])

        boxes = []
        for obj in doc.findall("./object"):
            label = obj.findall("name")[0].text
            if label not in self.lname2id:
                continue
            bb = obj.findall("bndbox")[0]
            xmin = int(float(bb.findall("xmin")[0].text))
            xmax = int(float(bb.findall("xmax")[0].text))
            ymin = int(float(bb.findall("ymin")[0].text))
            ymax = int(float(bb.findall("ymax")[0].text))
            center, size = abs2prop(xmin, xmax, ymin, ymax, imgsize)
            boxes.append(Box(label, self.lname2id[label], center, size))
        if not boxes:
            return None
        return Sample(filename, boxes, imgsize)

    def __build_sample_list(self, root, annot_files, dataset_name):
        image_root = os.path.join(root, "JPEGImages")
        samples = []
        for fn in tqdm(annot_files, desc=dataset_name, unit="samples"):
            sample = self.__parse_annotation(fn, image_root)
            if sample is not None:
                samples.append(sample)
        return samples

    # -- public API (duck-typed source contract) -----------------------

    def load_trainval_data(self, data_dir, valid_fraction):
        """Reference: source_pascal_voc.py:139-187."""
        train_annot = []
        train_samples = []
        for vocid in ("VOC2007", "VOC2012"):
            root = os.path.join(data_dir, "trainval", "VOCdevkit", vocid)
            annot = self.__build_annotation_list(root, "trainval")
            train_annot += annot
            train_samples += self.__build_sample_list(
                root, annot, "trainval_" + vocid
            )

        root = os.path.join(data_dir, "test", "VOCdevkit", "VOC2007")
        annot = self.__build_annotation_list(root, "test")
        train_samples += self.__build_sample_list(root, annot, "test_VOC2007")

        root = os.path.join(data_dir, "trainval", "VOCdevkit", "VOC2012")
        all_annot = set(glob(os.path.join(root, "Annotations", "*.xml")))
        valid_annot = sorted(all_annot - set(train_annot))
        valid_samples = self.__build_sample_list(
            root, valid_annot, "valid_VOC2012"
        )

        self.train_samples = train_samples
        self.valid_samples = valid_samples

        if not self.train_samples:
            raise RuntimeError("No training samples found in " + data_dir)
        if valid_fraction > 0 and not self.valid_samples:
            raise RuntimeError("No validation samples found in " + data_dir)

        self.num_train = len(self.train_samples)
        self.num_valid = len(self.valid_samples)

    def load_test_data(self, data_dir):
        """Reference: source_pascal_voc.py:190-203."""
        root = os.path.join(data_dir, "test", "VOCdevkit", "VOC2012")
        annot = self.__build_annotation_list(root, "test")
        self.test_samples = self.__build_sample_list(
            root, annot, "test_VOC2012"
        )
        if not self.test_samples:
            raise RuntimeError("No testing samples found in " + data_dir)
        self.num_test = len(self.test_samples)


def get_source():
    return PascalVOCSource()
