"""Host -> device input prefetching.

Overlaps the host data pipeline and the copy of batch N+1 to the device
with the device's work on batch N. A producer thread runs the batch
iterator, pins each batch's arrays in page-locked host memory and copies
them to the card with ``non_blocking=True`` on a side CUDA stream, then
records an event. The consumer makes its current stream wait on that event
and marks every tensor as used on it (``record_stream``), so that the
caching allocator does not hand the memory to another batch while the
consumer's stream may still read it.
"""

from __future__ import annotations

import threading
from queue import Queue

import numpy as np
import torch

from ssd_tensorflow_tpu_torch import resolve_device


def _tree_map(fn, tree):
    if isinstance(tree, dict):
        return {k: _tree_map(fn, v) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return type(tree)(_tree_map(fn, v) for v in tree)
    return fn(tree)


def _leaves(tree):
    if isinstance(tree, dict):
        return [x for v in tree.values() for x in _leaves(v)]
    if isinstance(tree, (list, tuple)):
        return [x for v in tree for x in _leaves(v)]
    return [tree]


def _as_tensor(x):
    return x if torch.is_tensor(x) else torch.from_numpy(np.ascontiguousarray(x))


def prefetch_to_device(iterator, size: int = 2, device="cuda", transform=None, put_fn=None):
    """Wrap a batch iterator so that the copy to the device runs ahead.

    Args:
      iterator: yields items; with ``transform`` an item maps to
        ``(device_part, host_part)`` and only the device part is copied, the
        host part passed through untouched; otherwise the whole item is.
      size: prefetch depth (2 = double buffering).
      device: where the device part goes (a dict / list / tuple of numpy
        arrays or tensors): the card unless the caller asks for the CPU.
        Raises at once when CUDA is asked for and there is none.
      put_fn: replaces the copy entirely (``multihost.make_global_batch``);
        ``device`` is then not used.

    Returns an iterator of the items with their device part on ``device``.
    An error of the iterator or of the copy is raised in the consumer.
    """
    if put_fn is None:
        device = resolve_device(device)
        if device.type == "cuda" and device.index is None:
            device = torch.device("cuda", torch.cuda.current_device())  # the caller's card
    return _prefetch(iterator, size, device, transform, put_fn)


def _prefetch(iterator, size, device, transform, put_fn):
    q: Queue = Queue(maxsize=size)
    done = object()
    err = []

    def put(x, stream):
        if put_fn is not None:
            return put_fn(x), None
        if device.type != "cuda":
            return _tree_map(lambda a: _as_tensor(a).to(device), x), None
        with torch.cuda.stream(stream):
            out = _tree_map(lambda a: _as_tensor(a).pin_memory().to(device, non_blocking=True), x)
            event = torch.cuda.Event()
            event.record(stream)
        return out, event

    def producer():
        try:
            stream = None
            if put_fn is None and device.type == "cuda":
                torch.cuda.set_device(device)
                stream = torch.cuda.Stream(device)
            for item in iterator:
                if transform is not None:
                    dev, host = transform(item)
                    q.put((put(dev, stream), host))
                else:
                    q.put((put(item, stream), done))
        except BaseException as e:  # surfaced in the consumer
            err.append(e)
        finally:
            q.put(done)

    t = threading.Thread(target=producer, daemon=True)
    t.start()
    while True:
        item = q.get()
        if item is done:
            t.join()
            if err:
                raise err[0]
            return
        (dev, event), host = item
        if event is not None:
            current = torch.cuda.current_stream(device)
            current.wait_event(event)
            for x in _leaves(dev):
                x.record_stream(current)
        yield dev if host is done else (dev, host)
