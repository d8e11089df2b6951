"""Shared-memory batch queue for augmentation workers, as in the JAX
package's ``data/shm_queue.py``.

``maxsize`` slots of one ``multiprocessing.shared_memory`` segment each
hold the four fixed-shape batch arrays (images uint8, gt_boxes float32,
gt_labels int32, gt_mask bool), so that batches cross the process
boundary without pickling; only the variable-length per-image gt box
lists travel through the normal (pickling) queue.

Ownership protocol: a slot id lives in exactly one place (the free-slot
queue, a producer between taking and publishing it, the ready queue, or
the consumer between ``get`` and its recycle), so no locks are needed.
Numpy only: the workers that write here never touch torch.
"""

from __future__ import annotations

import multiprocessing as mp
from multiprocessing import shared_memory

import numpy as np


class ShmBatchQueue:
    """A pool of shared-memory slots for fixed-shape batches."""

    def __init__(self, specs: dict, maxsize: int, ctx=None):
        """Args:
        specs: name -> (shape, dtype) of every array in a batch.
        maxsize: number of slots (reference uses workers*5,
          training_data.py:154).
        """
        ctx = ctx or mp.get_context("fork")
        self.specs = {
            k: (tuple(shape), np.dtype(dt)) for k, (shape, dt) in specs.items()
        }
        self.maxsize = maxsize
        self._slot_bytes = sum(
            int(np.prod(shape)) * dt.itemsize
            for shape, dt in self.specs.values()
        )
        self._shm = shared_memory.SharedMemory(
            create=True, size=max(self._slot_bytes, 1) * maxsize
        )
        self._free = ctx.Queue(maxsize)
        self._ready = ctx.Queue(maxsize)
        for i in range(maxsize):
            self._free.put(i)
        self._closed = False

    # -- views ----------------------------------------------------------

    def _views(self, slot: int) -> dict:
        out = {}
        off = slot * self._slot_bytes
        for name, (shape, dt) in self.specs.items():
            nbytes = int(np.prod(shape)) * dt.itemsize
            out[name] = np.ndarray(
                shape, dtype=dt, buffer=self._shm.buf, offset=off
            )
            off += nbytes
        return out

    # -- producer side ----------------------------------------------------

    def put(self, batch: dict, aux=None, timeout=None):
        """Copy a batch into a free slot and publish it.

        Validates shapes/dtypes like the reference's put
        (data_queue.py:63-79). ``aux`` is arbitrary picklable metadata
        (the gt box lists).
        """
        for name, (shape, dt) in self.specs.items():
            arr = batch[name]
            if tuple(arr.shape) != shape or arr.dtype != dt:
                raise ValueError(
                    f"{name}: expected {shape} {dt}, got {arr.shape} {arr.dtype}"
                )
        slot = self._free.get(timeout=timeout)
        views = self._views(slot)
        for name in self.specs:
            np.copyto(views[name], batch[name])
        self._ready.put((slot, aux))

    # -- consumer side ----------------------------------------------------

    def get(self, timeout=None):
        """Take the next published batch (copied out), recycle its slot.

        Returns ``(batch_dict, aux)``.
        """
        slot, aux = self._ready.get(timeout=timeout)
        views = self._views(slot)
        batch = {name: np.array(views[name], copy=True) for name in self.specs}
        self._free.put(slot)
        return batch, aux

    # -- lifecycle ----------------------------------------------------------

    def close(self):
        if not self._closed:
            self._closed = True
            self._shm.close()
            try:
                self._shm.unlink()
            except FileNotFoundError:
                pass

    def __getstate__(self):
        # child processes re-attach to the segment by name
        return {
            "specs": self.specs,
            "maxsize": self.maxsize,
            "_slot_bytes": self._slot_bytes,
            "shm_name": self._shm.name,
            "_free": self._free,
            "_ready": self._ready,
        }

    def __setstate__(self, state):
        self.specs = state["specs"]
        self.maxsize = state["maxsize"]
        self._slot_bytes = state["_slot_bytes"]
        self._shm = shared_memory.SharedMemory(name=state["shm_name"])
        self._free = state["_free"]
        self._ready = state["_ready"]
        self._closed = True  # only the creator unlinks
