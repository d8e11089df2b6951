"""Multi-process input feeding.

Each process runs its own data pipeline over its shard of the sample lists
(:func:`process_shard`) and feeds its own rows to its own device; the
global batch is the concatenation of every rank's rows in rank order. On
one process this is the whole batch.
"""

from __future__ import annotations

import numpy as np
import torch

from ssd_tensorflow_tpu_torch.parallel.mesh import mesh_device, world


def process_shard(items, process_index=None, process_count=None):
    """This process's contiguous shard of a global work list: the first
    ``len(items) % count`` shards take one item more."""
    rank, size = world()
    pi = rank if process_index is None else process_index
    pc = size if process_count is None else process_count
    n = len(items)
    per = n // pc
    extra = n % pc
    start = pi * per + min(pi, extra)
    end = start + per + (1 if pi < extra else 0)
    return items[start:end]


def local_rows(x):
    """This process's rows of a batch-leading tensor, on the host (numpy)."""
    return local_rows_many([x])[0]


def local_rows_many(arrays):
    """:func:`local_rows` of several tensors with one wait for the device:
    every copy is queued before the one synchronization."""
    staged = []
    for x in arrays:
        if x.is_cuda:
            host = torch.empty(x.shape, dtype=x.dtype, pin_memory=True)
            host.copy_(x, non_blocking=True)
            staged.append(host)
        else:
            staged.append(x.detach())
    if any(x.is_cuda for x in arrays):
        torch.cuda.current_stream(arrays[0].device).synchronize()
    return [np.asarray(x.numpy()) for x in staged]


def make_global_batch(local_batch: dict, mesh, device="cuda") -> dict:
    """This process's rows of the global batch, on its device: the mesh's,
    or ``device`` (the card unless the caller asks for the CPU) where
    ``mesh`` is ``None``. Each rank keeps its own rows; the global batch,
    ``local rows * world size`` long, is their concatenation in rank order."""
    dev = mesh_device(mesh, device)
    return {k: torch.as_tensor(np.asarray(v) if not torch.is_tensor(v) else v).to(dev)
            for k, v in local_batch.items()}
