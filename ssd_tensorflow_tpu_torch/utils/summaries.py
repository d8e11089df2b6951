"""Training summaries, as in the JAX package's ``utils/summaries.py``:
per-class AP and mAP, annotated sample images, per-epoch losses and
filter histograms, pushed from the host to the dependency-free event
writer (``utils/tensorboard.py``). Images need OpenCV and are skipped
without it.
"""

from __future__ import annotations

import numpy as np

from ssd_tensorflow_tpu_torch.data.image_io import draw_box
from ssd_tensorflow_tpu_torch.utils.tensorboard import SummaryWriter


class PrecisionSummary:
    """mAP + per-class AP scalars (reference: utils.py:151-198)."""

    def __init__(self, writer: SummaryWriter, sample_name: str, labels):
        self.writer = writer
        self.sample_name = sample_name
        self.labels = list(labels)

    def push(self, epoch, mAP, APs):
        if not APs:
            return
        self.writer.add_scalar(f"{self.sample_name}_mAP", mAP, epoch)
        for label in self.labels:
            if label in APs:
                self.writer.add_scalar(
                    f"{self.sample_name}_AP_{label}", APs[label], epoch
                )


class ImageSummary:
    """Annotated sample images, 3 per epoch at 512x512
    (reference: utils.py:201-233)."""

    def __init__(self, writer: SummaryWriter, sample_name: str, colors):
        self.writer = writer
        self.sample_name = sample_name
        self.colors = colors

    def push(self, epoch, samples):
        """``samples``: list of (bgr_image, [(conf, Box), ...])."""
        try:
            import cv2
        except ImportError:
            return
        for i, (img, boxes) in enumerate(samples[:3]):
            img = np.clip(np.asarray(img), 0, 255).astype(np.uint8)
            img = cv2.resize(img, (512, 512))
            for _, box in boxes:
                draw_box(img, box, self.colors.get(box.label, (0, 255, 0)))
            rgb = img[..., ::-1]
            self.writer.add_image(f"{self.sample_name}_img/{i}", rgb, epoch)


class LossSummary:
    """Per-epoch averaged loss scalars (reference: utils.py:236-283)."""

    LOSS_NAMES = ("total", "localization", "confidence", "l2")

    def __init__(self, writer: SummaryWriter, sample_name: str, num_samples: int):
        self.writer = writer
        self.sample_name = sample_name
        self.num_samples = num_samples
        self.loss_values = {k: 0.0 for k in self.LOSS_NAMES}
        self.seen = 0

    def add(self, values, num_samples):
        for k in self.LOSS_NAMES:
            self.loss_values[k] += float(values[k]) * num_samples
        self.seen += num_samples

    def push(self, epoch):
        # normalize by the samples actually accumulated — the train
        # generator drops the last partial batch, so dividing by the
        # dataset size would read systematically low
        denom = self.seen or self.num_samples
        for k in self.LOSS_NAMES:
            self.writer.add_scalar(
                f"{self.sample_name}_{k}_loss",
                self.loss_values[k] / max(denom, 1),
                epoch,
            )
            self.loss_values[k] = 0.0
        self.seen = 0


class NetSummary:
    """Filter histograms for every conv + the conv4_3 scale
    (reference: ssdvgg.py:625-649)."""

    def __init__(self, writer: SummaryWriter):
        self.writer = writer

    def push(self, epoch, params):
        for name, leaf in params.items():
            if isinstance(leaf, dict) and "w" in leaf:
                self.writer.add_histogram(
                    f"filters/{name}", np.asarray(leaf["w"]), epoch
                )
            if isinstance(leaf, dict) and "scale" in leaf:
                self.writer.add_histogram(
                    f"scale/{name}", np.asarray(leaf["scale"]), epoch
                )
