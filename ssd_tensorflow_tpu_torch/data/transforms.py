"""Host-side augmentation transforms, as in the JAX package's
``data/transforms.py``.

Each transform maps ``(data, label, gt) -> (data, label, gt)`` where
``data`` is a BGR image array, ``label`` is unused on the host (target
assignment happens on the device) and ``gt`` is a
:class:`~ssd_tensorflow_tpu_torch.types.Sample`. The canonical SSD chain
is built by :func:`build_train_transforms`. Every transform draws from
Python's ``random`` and numpy's global generator in the JAX package's
order and calls OpenCV as it does, so that both give the same batch bit
for bit from the same seeds. The hue and saturation transforms act on the
HSV channel, not on image row 0 as the original SSD-TensorFlow code did.
No transform touches torch or a device: the pipeline's forked workers run
them.
"""

from __future__ import annotations

import random

import numpy as np

from ssd_tensorflow_tpu_torch.ops.iou_np import pairwise_canvas_iou_np
from ssd_tensorflow_tpu_torch.types import Box, Point, Sample, Size, abs2prop, prop2abs

try:
    import cv2
except ImportError:  # pragma: no cover - cv2 is expected in production
    cv2 = None


def _require_cv2():
    if cv2 is None:
        raise RuntimeError("OpenCV (cv2) is required for image transforms")


class Transform:
    """Base: stores kwargs as attributes (reference: transforms.py:32-36)."""

    def __init__(self, **kwargs):
        for arg, val in kwargs.items():
            setattr(self, arg, val)
        self.initialized = False


#: opt-in decoded-image cache (filename -> BGR array). Where JPEG decode
#: dominates the pipeline, re-decoding every image every epoch sets the
#: pace; caching the decoded bytes changes no pixel. Enabled by
#: ``enable_decode_cache()`` (the train CLI's ``--cache-images``).
#: Unbounded: the caller opts in knowing the dataset's decoded size.
_DECODE_CACHE: dict = {}
_DECODE_CACHE_ON = False


def enable_decode_cache(on: bool = True):
    global _DECODE_CACHE_ON
    _DECODE_CACHE_ON = on
    if not on:
        _DECODE_CACHE.clear()


class ImageLoaderTransform(Transform):
    """Load the image file named by the Sample (transforms.py:39-44)."""

    def __call__(self, data, label, gt):
        _require_cv2()
        if _DECODE_CACHE_ON:
            img = _DECODE_CACHE.get(gt.filename)
            if img is None:
                img = cv2.imread(gt.filename)
                if img is not None:
                    _DECODE_CACHE[gt.filename] = img
            if img is not None:
                # downstream transforms may write in place; hand out a copy
                return img.copy(), label, gt
        else:
            img = cv2.imread(gt.filename)
        if img is None:
            # fail loudly with the culprit's name: a silent None here
            # surfaces as an opaque AttributeError in a worker process
            raise ValueError(
                f"cannot decode image {gt.filename!r} (missing or corrupt)"
            )
        return img, label, gt


class ResizeTransform(Transform):
    """Resize with a randomly chosen interpolation algorithm
    (transforms.py:117-125). Parameters: width, height, algorithms."""

    def __call__(self, data, label, gt):
        _require_cv2()
        alg = random.choice(self.algorithms)
        resized = cv2.resize(data, (self.width, self.height), interpolation=alg)
        return resized, label, gt


class RandomTransform(Transform):
    """Apply ``transform`` with probability ``prob`` (transforms.py:128-137)."""

    def __call__(self, data, label, gt):
        if random.uniform(0, 1) < self.prob:
            return self.transform(data, label, gt)
        return data, label, gt


class ComposeTransform(Transform):
    """Serial composition (transforms.py:140-149). Parameters: transforms."""

    def __call__(self, data, label, gt):
        args = (data, label, gt)
        for t in self.transforms:
            args = t(*args)
        return args


class TransformPickerTransform(Transform):
    """Apply one randomly chosen transform (transforms.py:152-159)."""

    def __call__(self, data, label, gt):
        pick = random.randint(0, len(self.transforms) - 1)
        return self.transforms[pick](data, label, gt)


class BrightnessTransform(Transform):
    """Additive brightness in [-delta, delta] (transforms.py:162-174)."""

    def __call__(self, data, label, gt):
        delta = random.randint(-self.delta, self.delta)
        data = np.clip(data.astype(np.float32) + delta, 0, 255).astype(np.uint8)
        return data, label, gt


class ContrastTransform(Transform):
    """Multiplicative contrast in [lower, upper] (transforms.py:177-189)."""

    def __call__(self, data, label, gt):
        delta = random.uniform(self.lower, self.upper)
        data = np.clip(data.astype(np.float32) * delta, 0, 255).astype(np.uint8)
        return data, label, gt


class HueTransform(Transform):
    """Hue shift of +-delta degrees in HSV with wraparound
    (intended semantics of transforms.py:192-206)."""

    def __call__(self, data, label, gt):
        _require_cv2()
        hsv = cv2.cvtColor(data, cv2.COLOR_BGR2HSV).astype(np.float32)
        delta = random.randint(-self.delta, self.delta)
        h = hsv[..., 0] + delta
        # OpenCV uint8 hue lives in [0, 179]; >= 180 wraps to 0 — same
        # rule as the device twin (device_augment.py hsv_pass)
        h = np.where(h >= 180, h - 180, h)
        h = np.where(h < 0, h + 180, h)
        hsv[..., 0] = h
        return (
            cv2.cvtColor(hsv.astype(np.uint8), cv2.COLOR_HSV2BGR),
            label,
            gt,
        )


class SaturationTransform(Transform):
    """Saturation scale in [lower, upper] in HSV
    (intended semantics of transforms.py:209-223)."""

    def __call__(self, data, label, gt):
        _require_cv2()
        hsv = cv2.cvtColor(data, cv2.COLOR_BGR2HSV).astype(np.float32)
        delta = random.uniform(self.lower, self.upper)
        hsv[..., 1] = np.clip(hsv[..., 1] * delta, 0, 255)
        return (
            cv2.cvtColor(hsv.astype(np.uint8), cv2.COLOR_HSV2BGR),
            label,
            gt,
        )


class ReorderChannelsTransform(Transform):
    """Random channel permutation (transforms.py:226-233)."""

    def __call__(self, data, label, gt):
        channels = [0, 1, 2]
        random.shuffle(channels)
        return data[:, :, channels], label, gt


def transform_box(box, orig_size, new_size, h_off, w_off):
    """Remap a box into a shifted/cropped frame; drop it when its integer
    center leaves the new image (reference: transforms.py:236-259)."""
    xmin, xmax, ymin, ymax = prop2abs(box.center, box.size, orig_size)
    xmin += w_off
    xmax += w_off
    ymin += h_off
    ymax += h_off
    new_cx = xmin + int((xmax - xmin) / 2)
    new_cy = ymin + int((ymax - ymin) / 2)
    if not (0 <= new_cx < new_size.w and 0 <= new_cy < new_size.h):
        return None
    center, size = abs2prop(xmin, xmax, ymin, ymax, new_size)
    return Box(box.label, box.labelid, center, size)


def transform_gt(gt, new_size, h_off, w_off):
    """Remap all gt boxes (reference: transforms.py:262-269)."""
    boxes = []
    for box in gt.boxes:
        box = transform_box(box, gt.imgsize, new_size, h_off, w_off)
        if box is not None:
            boxes.append(box)
    return Sample(gt.filename, boxes, new_size)


class ExpandTransform(Transform):
    """Paste the image into an up-to-``max_ratio``x larger mean-filled
    canvas at a random offset (reference: transforms.py:272-299).
    Parameters: max_ratio, mean_value (BGR)."""

    def __call__(self, data, label, gt):
        ratio = random.uniform(1, self.max_ratio)
        orig_size = gt.imgsize
        new_size = Size(int(orig_size.w * ratio), int(orig_size.h * ratio))
        h_off = random.randint(0, new_size.h - orig_size.h)
        w_off = random.randint(0, new_size.w - orig_size.w)

        img = np.empty((new_size.h, new_size.w, 3), dtype=data.dtype)
        img[:, :] = np.asarray(self.mean_value, dtype=data.dtype)
        img[h_off : h_off + orig_size.h, w_off : w_off + orig_size.w] = data
        return img, label, transform_gt(gt, new_size, h_off, w_off)


class SamplerTransform(Transform):
    """SSD random-crop sampler (reference: transforms.py:302-361).

    Up to ``max_trials`` proposals with scale in [min_scale, max_scale]
    and aspect ratio in [min_ar, max_ar] (clamped by scale^2); accepted
    when the best protocol IoU against any gt box reaches
    ``min_jaccard_overlap``. Returns None when no proposal succeeds.
    Parameters: sample, min_scale, max_scale, min_aspect_ratio,
    max_aspect_ratio, min_jaccard_overlap, max_trials.
    """

    def __call__(self, data, label, gt):
        if not self.sample:
            return data, label, gt

        if gt.boxes:
            source_corners = np.stack(
                [
                    np.asarray(
                        prop2abs(b.center, b.size, gt.imgsize), dtype=np.float64
                    )
                    for b in gt.boxes
                ]
            )
        else:
            source_corners = np.zeros((0, 4))

        if source_corners.shape[0] == 0:
            return None

        # All trials proposed and scored at once (the reference iterates
        # one proposal at a time, transforms.py:321-347 — same accept
        # rule, vectorized: first trial whose best protocol IoU against
        # any gt passes the threshold wins).
        t = self.max_trials
        scale = np.random.uniform(self.min_scale, self.max_scale, t)
        ar = np.random.uniform(self.min_aspect_ratio, self.max_aspect_ratio, t)
        # keep width/height <= 1 (reference: transforms.py:330-331)
        ar = np.clip(ar, scale**2, 1.0 / scale**2)
        width = scale * np.sqrt(ar)
        height = scale / np.sqrt(ar)
        cx = 0.5 * width + np.random.uniform(0, 1, t) * (1 - width)
        cy = 0.5 * height + np.random.uniform(0, 1, t) * (1 - height)

        w_img, h_img = gt.imgsize.w, gt.imgsize.h
        trial_corners = np.trunc(
            np.stack(
                [
                    (cx - width / 2) * w_img,
                    (cx + width / 2) * w_img,
                    (cy - height / 2) * h_img,
                    (cy + height / 2) * h_img,
                ],
                axis=-1,
            )
        )
        iou = pairwise_canvas_iou_np(trial_corners, source_corners)  # (T, G)
        best = iou.max(axis=1)
        # compute_overlap(.., threshold=0): best requires iou > 0
        ok = (best > 0) & (best >= self.min_jaccard_overlap)
        if not ok.any():
            return None
        box_arr = trial_corners[int(np.argmax(ok))]

        xmin, xmax, ymin, ymax = (int(v) for v in box_arr)
        new_size = Size(xmax - xmin, ymax - ymin)
        data = data[ymin:ymax, xmin:xmax]
        gt = transform_gt(gt, new_size, -ymin, -xmin)
        return data, label, gt


class SamplePickerTransform(Transform):
    """Run all samplers; return one successful result at random
    (reference: transforms.py:364-375). Parameters: samplers."""

    def __call__(self, data, label, gt):
        samples = []
        for sampler in self.samplers:
            sample = sampler(data, label, gt)
            if sample is not None:
                samples.append(sample)
        return random.choice(samples)


class HorizontalFlipTransform(Transform):
    """Mirror the image and boxes via cx -> 1-cx
    (reference: transforms.py:378-391)."""

    def __call__(self, data, label, gt):
        data = data[:, ::-1]
        boxes = [
            Box(b.label, b.labelid, Point(1 - b.center.x, b.center.y), b.size)
            for b in gt.boxes
        ]
        return data, label, Sample(gt.filename, boxes, gt.imgsize)


class LabelCreatorTransform(Transform):
    """Host-side ground-truth encoder: the ``(A, K+5)`` targets of one
    sample on the CPU (``ops/matching.encode_targets``). Training encodes
    its targets in the step; this is for annotation tools and
    cross-checks. Parameters: preset, num_classes."""

    def initialize(self):
        from ssd_tensorflow_tpu_torch.ops.anchors import anchors_for_preset

        self.anchors = anchors_for_preset(self.preset)
        self.initialized = True

    def __call__(self, data, label, gt):
        import torch

        from ssd_tensorflow_tpu_torch.ops.matching import encode_targets

        if not self.initialized:
            self.initialize()
        boxes, labels, mask = sample_to_arrays(gt, len(gt.boxes) or 1)
        vec = encode_targets(torch.from_numpy(boxes), torch.from_numpy(labels),
                             torch.from_numpy(mask), torch.from_numpy(self.anchors),
                             self.num_classes)
        return data, vec.numpy(), gt


def boxes_to_arrays(box_list, max_gt: int):
    """Box list -> fixed-shape (boxes (G,4), labels (G,), mask (G,)) arrays.

    Truncates past ``max_gt`` (VOC images rarely exceed ~40 objects).
    The single definition of the padded-gt array layout — the training
    pipeline and the annotate/notebook paths both go through it.
    """
    boxes = np.zeros((max_gt, 4), dtype=np.float32)
    labels = np.zeros((max_gt,), dtype=np.int32)
    mask = np.zeros((max_gt,), dtype=bool)
    for i, b in enumerate(box_list[:max_gt]):
        boxes[i] = (b.center.x, b.center.y, b.size.w, b.size.h)
        labels[i] = b.labelid
        mask[i] = True
    return boxes, labels, mask


def sample_to_arrays(gt: Sample, max_gt: int):
    """Sample -> fixed-shape gt arrays (see ``boxes_to_arrays``)."""
    return boxes_to_arrays(gt.boxes, max_gt)


# ---------------------------------------------------------------------------
# Canonical pipelines (reference: process_dataset.py:60-163)
# ---------------------------------------------------------------------------

INTERPOLATIONS = None  # filled lazily; needs cv2


def _interp_algorithms():
    _require_cv2()
    return [
        cv2.INTER_LINEAR,
        cv2.INTER_AREA,
        cv2.INTER_NEAREST,
        cv2.INTER_CUBIC,
        cv2.INTER_LANCZOS4,
    ]


def build_sampler(overlap, trials):
    """Reference: process_dataset.py:60-63."""
    return SamplerTransform(
        sample=True,
        min_scale=0.3,
        max_scale=1.0,
        min_aspect_ratio=0.5,
        max_aspect_ratio=2.0,
        min_jaccard_overlap=overlap,
        max_trials=trials,
    )


def build_train_transforms(preset, num_classes, sampler_trials, expand_prob):
    """The canonical SSD augmentation chain
    (reference: process_dataset.py:66-151). Target assignment is NOT part
    of the host chain anymore — it happens on device."""
    tf_resize = ResizeTransform(
        width=preset.image_size.w,
        height=preset.image_size.h,
        algorithms=_interp_algorithms(),
    )
    tf_rnd_brightness = RandomTransform(
        prob=0.5, transform=BrightnessTransform(delta=32)
    )
    tf_rnd_contrast = RandomTransform(
        prob=0.5, transform=ContrastTransform(lower=0.5, upper=1.5)
    )
    tf_rnd_hue = RandomTransform(prob=0.5, transform=HueTransform(delta=18))
    tf_rnd_saturation = RandomTransform(
        prob=0.5, transform=SaturationTransform(lower=0.5, upper=1.5)
    )
    tf_rnd_reorder = RandomTransform(
        prob=0.5, transform=ReorderChannelsTransform()
    )

    distort_list = [tf_rnd_contrast, tf_rnd_saturation, tf_rnd_hue, tf_rnd_contrast]
    tf_distort = TransformPickerTransform(
        transforms=[
            ComposeTransform(transforms=distort_list[:-1]),
            ComposeTransform(transforms=distort_list[1:]),
        ]
    )

    tf_rnd_expand = RandomTransform(
        prob=expand_prob,
        transform=ExpandTransform(max_ratio=4.0, mean_value=[104, 117, 123]),
    )

    samplers = [SamplerTransform(sample=False)] + [
        build_sampler(ov, sampler_trials)
        for ov in (0.1, 0.3, 0.5, 0.7, 0.9, 1.0)
    ]
    tf_sample_picker = SamplePickerTransform(samplers=samplers)

    tf_rnd_flip = RandomTransform(prob=0.5, transform=HorizontalFlipTransform())

    return [
        ImageLoaderTransform(),
        tf_rnd_brightness,
        tf_distort,
        tf_rnd_reorder,
        tf_rnd_expand,
        tf_sample_picker,
        tf_rnd_flip,
        tf_resize,
    ]


def build_valid_transforms(preset, num_classes):
    """Reference: process_dataset.py:154-163."""
    _require_cv2()
    return [
        ImageLoaderTransform(),
        ResizeTransform(
            width=preset.image_size.w,
            height=preset.image_size.h,
            algorithms=[cv2.INTER_LINEAR],
        ),
    ]


def run_transforms(sample, transforms):
    """Apply a transform chain to a Sample (training_data.py:80-84)."""
    args = (None, None, sample)
    for t in transforms:
        args = t(*args)
    return args
