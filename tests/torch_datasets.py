"""A small dataset directory as ``process_dataset.py`` writes it, shared by
the port's CLI and tool tests (``tests/test_torch_train_cli.py``,
``tests/test_torch_qat_finetune.py``): JPEGs of one bright square on dark
noise, one class, the test64 preset. The sample lists pickle the JAX
package's types, which both packages' ``TrainingData`` read."""

import json
import os
import pickle

import numpy as np

from ssd_tensorflow_tpu.presets import get_preset_by_name, preset_to_dict
from ssd_tensorflow_tpu.types import Box, Point, Sample, Size


def make_dataset(root, n_train, n_valid, valid_samples=None, seed=0):
    """A test64 dataset dir like ``tests/test_e2e.py``'s; returns
    ``(data_dir, valid_samples)``."""
    import cv2

    img_dir = os.path.join(root, "images")
    os.makedirs(img_dir, exist_ok=True)
    rng = np.random.default_rng(seed)

    def make_sample(i):
        img = rng.integers(0, 40, (160, 160, 3), dtype=np.uint8)
        cx, cy, s = rng.uniform(0.3, 0.7), rng.uniform(0.3, 0.7), 0.3
        x0, y0 = int((cx - s / 2) * 160), int((cy - s / 2) * 160)
        x1, y1 = int((cx + s / 2) * 160), int((cy + s / 2) * 160)
        img[y0:y1, x0:x1] = (200, 220, 240)
        path = os.path.join(img_dir, f"img{i:03d}.jpg")
        cv2.imwrite(path, img)
        return Sample(path, [Box("square", 0, Point(cx, cy), Size(s, s))], Size(160, 160))

    train = [make_sample(i) for i in range(n_train)]
    if valid_samples is None:
        valid_samples = [make_sample(100 + i) for i in range(n_valid)]
    data_dir = os.path.join(root, "data")
    os.makedirs(data_dir, exist_ok=True)
    with open(os.path.join(data_dir, "train-samples.pkl"), "wb") as f:
        pickle.dump(train, f)
    with open(os.path.join(data_dir, "valid-samples.pkl"), "wb") as f:
        pickle.dump(valid_samples, f)
    with open(os.path.join(data_dir, "training-data.json"), "w") as f:
        json.dump({"preset": preset_to_dict(get_preset_by_name("test64")), "num-classes": 1,
                   "colors": {"square": [0, 0, 255]}, "lid2name": {"0": "square"},
                   "lname2id": {"square": 0},
                   "augmentation": {"sampler_trials": 3, "expand_probability": 0.3}}, f)
    return data_dir, valid_samples
