"""Training-data facade and batch generators, as in the JAX package's
``data/pipeline.py``.

* ``training-data.json`` holds the preset and the augmentation parameters;
  ``{train,valid}-samples.pkl`` the sample lists. ``process_dataset.py``
  writes the pickles with the JAX package's ``Sample``, ``Box``, ``Point``
  and ``Size``; :func:`load_samples` reads them as the port's own
  namedtuples (``types.py``) and imports nothing of the JAX package.
* Batches have fixed shapes: uint8 images ``(B, H, W, 3)`` (the step
  subtracts the mean on the device) and the ground truth padded to
  ``(B, G, 4)`` / ``(B, G)`` / ``(B, G)``, as target assignment runs in
  the step.
* Augmentation runs in forked worker processes (a pool, or the
  shared-memory transport of ``shm_queue.py``), serially at
  ``num_workers=0``. Workers run numpy and OpenCV only, never torch, CUDA
  or the process group.

The >=1-positive resampling rule: a training sample's augmentation chain
runs again, up to 50 times, until some anchor matches one of its boxes
(the host-side max-IoU check, ``ops/matching.has_positive_anchor``).

The shared-memory consumer supervises its workers. When a worker died
(killed, crashed), or every worker exited with chunks still pending (where
the JAX package's consumer waits for ever), the undelivered chunks go to a
new set of workers on fresh queues: a killed worker may have died holding
a queue's lock. After ``3 * num_workers`` replacements, or
``STALL_SECONDS`` without a batch, it raises.
"""

from __future__ import annotations

import json
import math
import os
import pickle
import queue as q
import random
import time

import numpy as np

from ssd_tensorflow_tpu_torch import types as port_types
from ssd_tensorflow_tpu_torch.data import transforms as T
from ssd_tensorflow_tpu_torch.data.device_augment import validate_augmentation_config
from ssd_tensorflow_tpu_torch.ops.anchors import anchors_for_preset
from ssd_tensorflow_tpu_torch.ops.iou_np import canvas_corners_np
from ssd_tensorflow_tpu_torch.ops.matching import has_positive_anchor
from ssd_tensorflow_tpu_torch.presets import preset_from_dict

#: default cap on ground-truth boxes per image; VOC maxes out around 40.
MAX_GT = 60

#: resample attempts of the >=1-positive rule
MAX_RESAMPLE = 50

#: the shared-memory consumer's wait for a batch before it checks its workers
POLL_SECONDS = 5.0

#: the shared-memory consumer's wait for any batch at all before it gives up
STALL_SECONDS = 600.0

#: the module that the dataset pickles name, and the types it holds
_PICKLED_TYPES_MODULE = "ssd_tensorflow_tpu.types"
_PICKLED_TYPES = frozenset({"Sample", "Box", "Point", "Size", "Label"})


class _SampleUnpickler(pickle.Unpickler):
    """Reads the JAX package's dataset types as the port's namedtuples."""

    def find_class(self, module, name):
        if module == _PICKLED_TYPES_MODULE:
            if name not in _PICKLED_TYPES:
                raise pickle.UnpicklingError(f"unexpected type {module}.{name} in a sample list")
            return getattr(port_types, name)
        return super().find_class(module, name)


def load_samples(path: str):
    """A ``{train,valid}-samples.pkl`` sample list, with the port's types."""
    with open(path, "rb") as f:
        return _SampleUnpickler(f).load()


_boxes_to_arrays = T.boxes_to_arrays


class _SampleProcessor:
    """Runs the augmentation chain of one sample, with resampling.
    Built from config, so that it crosses a fork into the workers."""

    def __init__(self, preset, num_classes, aug_config, train: bool, max_gt=MAX_GT):
        self.preset = preset
        self.num_classes = num_classes
        self.train = train
        self.max_gt = max_gt
        if train:
            self.transforms = T.build_train_transforms(
                preset, num_classes,
                sampler_trials=aug_config.get("sampler_trials", 50),
                expand_prob=aug_config.get("expand_probability", 0.5))
        else:
            self.transforms = T.build_valid_transforms(preset, num_classes)
        # anchor canvas corners for the fast positive check
        self._anchor_corners = canvas_corners_np(anchors_for_preset(preset))

    def _has_positive(self, boxes) -> bool:
        if not boxes:
            return False
        arr = np.array([[b.center.x, b.center.y, b.size.w, b.size.h] for b in boxes])
        return has_positive_anchor(arr, None, None, anchor_corners_np=self._anchor_corners)

    def __call__(self, sample):
        if self.train:
            image, gt = None, sample
            for _ in range(MAX_RESAMPLE):
                image, _, gt = T.run_transforms(sample, self.transforms)
                if self._has_positive(gt.boxes):
                    break
        else:
            image, _, gt = T.run_transforms(sample, self.transforms)
        boxes, labels, mask = _boxes_to_arrays(gt.boxes, self.max_gt)
        return image.astype(np.uint8), boxes, labels, mask, gt.boxes


_WORKER_PROC = None


def _seed_worker(seed_base):
    random.seed(seed_base + os.getpid())
    np.random.seed((seed_base + os.getpid()) % 2**31)


def _pool_init(processor, seed_base):
    global _WORKER_PROC
    _WORKER_PROC = processor
    _seed_worker(seed_base)


def _pool_process_batch(samples):
    return [_WORKER_PROC(s) for s in samples]


def _shm_producer(processor, seed_base, sample_queue, batch_queue, image_size, batch_size):
    """Worker loop: augment sample chunks and publish fixed-shape batches
    into shared memory, each with its chunk id, until the sample queue
    stays empty for a second."""
    _seed_worker(seed_base)
    try:
        import cv2

        cv2.setNumThreads(1)
    except ImportError:
        pass
    while True:
        try:
            idx, chunk = sample_queue.get(timeout=1)
        except q.Empty:
            break
        results = [processor(s) for s in chunk]
        batch, gt_lists, n = _collate(results, batch_size, image_size)
        batch_queue.put(batch, aux=(idx, gt_lists, n))


def _collate(results, batch_size, image_size):
    """Stack per-sample results into a fixed-shape batch dict."""
    n = len(results)
    h, w = image_size.h, image_size.w
    g = results[0][1].shape[0]
    batch = {
        "images": np.zeros((batch_size, h, w, 3), dtype=np.uint8),
        "gt_boxes": np.zeros((batch_size, g, 4), dtype=np.float32),
        "gt_labels": np.zeros((batch_size, g), dtype=np.int32),
        "gt_mask": np.zeros((batch_size, g), dtype=bool),
    }
    gt_lists = []
    for i, (img, boxes, labels, mask, gt_boxes) in enumerate(results):
        batch["images"][i] = img
        batch["gt_boxes"][i] = boxes
        batch["gt_labels"][i] = labels
        batch["gt_mask"][i] = mask
        gt_lists.append(gt_boxes)
    return batch, gt_lists, n


def _cv2_single_thread():
    """Set OpenCV to one thread (before forking workers); returns the
    previous count, or ``None`` without OpenCV."""
    try:
        import cv2
    except ImportError:
        return None
    prev = cv2.getNumThreads()
    cv2.setNumThreads(1)
    return prev


def _cv2_restore(prev):
    if prev is not None:
        import cv2

        cv2.setNumThreads(prev)


class TrainingData:
    """Facade over the prepared dataset: ``preset, num_classes,
    label_colors, lid2name, lname2id, augmentation, num_train, num_valid,
    train_samples, valid_samples`` and the batch generators."""

    def __init__(self, data_dir, max_gt: int = MAX_GT):
        try:
            with open(os.path.join(data_dir, "training-data.json")) as f:
                data = json.load(f)
            self.train_samples = load_samples(os.path.join(data_dir, "train-samples.pkl"))
            self.valid_samples = load_samples(os.path.join(data_dir, "valid-samples.pkl"))
        except OSError as e:
            raise RuntimeError(str(e))

        self.preset = preset_from_dict(data["preset"])
        self.num_classes = data["num-classes"]
        self.label_colors = {k: tuple(v) for k, v in data["colors"].items()}
        self.lid2name = {int(k): v for k, v in data["lid2name"].items()}
        self.lname2id = data["lname2id"]
        self.augmentation = validate_augmentation_config(
            data.get("augmentation", {}), os.path.join(data_dir, "training-data.json"))
        self.max_gt = max_gt
        self.num_train = len(self.train_samples)
        self.num_valid = len(self.valid_samples)

    # -- generators -----------------------------------------------------

    def train_generator(self, batch_size, num_workers=0, drop_last=True, use_shm=True,
                        raw=False):
        """Training batches ``(batch, gt_lists, num_real)``. With ``raw=True``
        the host only decodes and resizes (no augmentation, no resampling),
        for the on-device augmentation (``data/device_augment.py``)."""
        return self._generate(self.train_samples, not raw, batch_size, num_workers, drop_last,
                              shuffle=True, use_shm=use_shm)

    def valid_generator(self, batch_size, num_workers=0, use_shm=True):
        return self._generate(self.valid_samples, False, batch_size, num_workers,
                              drop_last=False, shuffle=False, use_shm=use_shm)

    def num_train_batches(self, batch_size, drop_last=True):
        if drop_last:
            return self.num_train // batch_size
        return math.ceil(self.num_train / batch_size)

    def num_valid_batches(self, batch_size):
        return math.ceil(self.num_valid / batch_size)

    def _generate(self, samples, train, batch_size, num_workers, drop_last, shuffle,
                  use_shm=True):
        processor = _SampleProcessor(self.preset, self.num_classes, self.augmentation, train,
                                     self.max_gt)
        order = list(samples)
        if shuffle:
            random.shuffle(order)
        if drop_last:
            order = order[:len(order) - (len(order) % batch_size)]
        chunks = [order[off:off + batch_size] for off in range(0, len(order), batch_size)]

        if num_workers > 0 and use_shm:
            yield from self._generate_shm(processor, chunks, batch_size, num_workers)
        elif num_workers > 0:
            import multiprocessing as mp

            ctx = mp.get_context("fork")
            seed = random.randint(0, 2**30)
            prev = _cv2_single_thread()
            pool = ctx.Pool(num_workers, initializer=_pool_init, initargs=(processor, seed))
            _cv2_restore(prev)
            try:
                for results in pool.imap(_pool_process_batch, chunks):
                    yield _collate(results, batch_size, self.preset.image_size)
            finally:
                pool.terminate()
                pool.join()
        else:
            for chunk in chunks:
                results = [processor(s) for s in chunk]
                yield _collate(results, batch_size, self.preset.image_size)

    def _generate_shm(self, processor, chunks, batch_size, num_workers):
        """Forked workers and the shared-memory batch transport, under
        supervision (the module doc)."""
        import multiprocessing as mp

        from ssd_tensorflow_tpu_torch.data.shm_queue import ShmBatchQueue

        ctx = mp.get_context("fork")
        h, w = self.preset.image_size.h, self.preset.image_size.w
        g = self.max_gt
        specs = {
            "images": ((batch_size, h, w, 3), np.uint8),
            "gt_boxes": ((batch_size, g, 4), np.float32),
            "gt_labels": ((batch_size, g), np.int32),
            "gt_mask": ((batch_size, g), np.bool_),
        }
        seed = random.randint(0, 2**30)

        def start(indices, first_seed):
            """Fresh queues holding ``indices``' chunks, and workers on them
            (a killed worker may have died holding a queue's lock)."""
            batch_queue = ShmBatchQueue(specs, maxsize=num_workers * 5, ctx=ctx)
            sample_queue = ctx.Queue(max(len(indices), 1))
            for i in indices:
                sample_queue.put((i, chunks[i]))
            prev = _cv2_single_thread()
            workers = []
            for k in range(num_workers):
                p = ctx.Process(target=_shm_producer,
                                args=(processor, seed + first_seed + k, sample_queue,
                                      batch_queue, self.preset.image_size, batch_size),
                                daemon=True)
                p.start()
                workers.append(p)
            _cv2_restore(prev)
            return batch_queue, workers

        def stop(batch_queue, workers):
            for p in workers:
                if p.is_alive():
                    p.terminate()
            for p in workers:
                p.join(timeout=10)
            batch_queue.close()

        pending = set(range(len(chunks)))
        batch_queue, workers = start(sorted(pending), 0)
        respawns = 0
        last_delivery = time.monotonic()
        try:
            while pending:
                try:
                    batch, (idx, gt_lists, n) = batch_queue.get(timeout=POLL_SECONDS)
                except q.Empty:
                    if time.monotonic() - last_delivery > STALL_SECONDS:
                        raise RuntimeError(
                            f"augmentation workers delivered no batch for {STALL_SECONDS:.0f} s "
                            f"with {len(pending)} chunks pending; giving up")
                    alive = [p for p in workers if p.is_alive()]
                    dead = [p for p in workers if not p.is_alive() and p.exitcode != 0]
                    if alive and not dead:
                        continue  # a slow batch
                    # workers died, or all left (exit 0) with chunks pending:
                    # the chunks are lost either way
                    if respawns >= 3 * num_workers:
                        raise RuntimeError(
                            f"augmentation workers keep dying or leaving {len(pending)} chunks "
                            f"undelivered ({respawns} respawns); giving up")
                    print(f"[!] {len(dead)} augmentation worker(s) died and "
                          f"{len(workers) - len(alive) - len(dead)} left early; re-queueing "
                          f"{len(pending)} undelivered chunks to {num_workers} new workers")
                    stop(batch_queue, workers)
                    batch_queue, workers = start(sorted(pending), 1000 + respawns)
                    respawns += num_workers
                    continue
                last_delivery = time.monotonic()
                if idx in pending:
                    pending.discard(idx)
                    yield batch, gt_lists, n
            for p in workers:
                p.join(timeout=10)
        finally:
            stop(batch_queue, workers)
