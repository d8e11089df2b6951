"""Synthetic shapes dataset source, as the JAX package's
``data/source_synthetic.py``: images of coloured rectangles and discs
(class = shape + colour), generated from a seed on first load and cached
under ``<data_dir>/synthetic/``. The same seed gives the same samples and
the same image bytes as the JAX package's. Drawing and writing go through
``data/image_io.py``.
"""

from __future__ import annotations

import os

import numpy as np

from ssd_tensorflow_tpu_torch.data import image_io
from ssd_tensorflow_tpu_torch.types import Box, Label, Point, Sample, Size

label_defs = [
    Label("red_box", (0, 0, 220)),
    Label("green_box", (0, 220, 0)),
    Label("blue_box", (220, 0, 0)),
    Label("yellow_disc", (0, 220, 220)),
    Label("magenta_disc", (220, 0, 220)),
]

_IMG_SIZE = 256


class SyntheticSource:
    """Procedural detection dataset with deterministic content."""

    def __init__(self, num_train=256, num_valid=64, num_test=64, seed=0):
        self.num_classes = len(label_defs)
        self.colors = {l.name: l.color for l in label_defs}
        self.lid2name = {i: l.name for i, l in enumerate(label_defs)}
        self.lname2id = {l.name: i for i, l in enumerate(label_defs)}
        self._counts = (num_train, num_valid, num_test)
        self._seed = seed
        self.num_train = 0
        self.num_valid = 0
        self.num_test = 0
        self.train_samples = []
        self.valid_samples = []
        self.test_samples = []

    def _generate(self, data_dir, split, count, seed):
        out_dir = os.path.join(data_dir, "synthetic", split)
        os.makedirs(out_dir, exist_ok=True)
        rng = np.random.default_rng(seed)
        samples = []
        for i in range(count):
            path = os.path.join(out_dir, f"{split}_{i:05d}.jpg")
            boxes = []
            img = rng.integers(0, 50, (_IMG_SIZE, _IMG_SIZE, 3)).astype(
                np.uint8
            )
            for _ in range(int(rng.integers(1, 4))):
                cls = int(rng.integers(0, len(label_defs)))
                w = float(rng.uniform(0.15, 0.5))
                h = float(rng.uniform(0.15, 0.5))
                cx = float(rng.uniform(w / 2, 1 - w / 2))
                cy = float(rng.uniform(h / 2, 1 - h / 2))
                x0, x1 = int((cx - w / 2) * _IMG_SIZE), int((cx + w / 2) * _IMG_SIZE)
                y0, y1 = int((cy - h / 2) * _IMG_SIZE), int((cy + h / 2) * _IMG_SIZE)
                color = label_defs[cls].color
                if "disc" in label_defs[cls].name:
                    center = ((x0 + x1) // 2, (y0 + y1) // 2)
                    axes = ((x1 - x0) // 2, (y1 - y0) // 2)
                    image_io.ellipse(img, center, axes, color)
                else:
                    img[y0:y1, x0:x1] = color
                boxes.append(
                    Box(
                        label_defs[cls].name,
                        cls,
                        Point(cx, cy),
                        Size(w, h),
                    )
                )
            if not os.path.exists(path):
                image_io.imwrite(path, img)
            samples.append(
                Sample(path, boxes, Size(_IMG_SIZE, _IMG_SIZE))
            )
        return samples

    def load_trainval_data(self, data_dir, valid_fraction):
        n_train, n_valid, _ = self._counts
        self.train_samples = self._generate(
            data_dir, "train", n_train, self._seed
        )
        self.valid_samples = self._generate(
            data_dir, "valid", n_valid, self._seed + 1
        )
        self.num_train = len(self.train_samples)
        self.num_valid = len(self.valid_samples)

    def load_test_data(self, data_dir):
        _, _, n_test = self._counts
        self.test_samples = self._generate(
            data_dir, "test", n_test, self._seed + 2
        )
        self.num_test = len(self.test_samples)


def get_source():
    return SyntheticSource()
