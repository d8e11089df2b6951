"""How parameters and batches map onto the mesh.

Data parallelism: every process holds the whole parameter set (rank 0's,
broadcast once by :func:`replicate`) and its own rows of the batch, whose
leading dimension is split over the ``data`` dimension
(:func:`batch_rows`); the train step averages the gradients over the
group (:func:`average`).

Tensor parallelism (``model`` > 1) would shard the 1024-channel a-trous
conv6 / conv7 over their output channels by ``_TP_RULES``, as the JAX
package's ``parallel/sharding.py`` does. It is not ported:
``mesh.make_mesh(model > 1)`` and ``shard_state(tensor_parallel=True)``
raise with :func:`tensor_parallel_refusal`, which names these rules
(ROADMAP.md queue 1 item 12).
"""

from __future__ import annotations

import torch
import torch.distributed as dist

from ssd_tensorflow_tpu_torch.parallel.mesh import world

#: params whose conv filters would shard over the model dimension:
#: name -> (filter dim, bias sharded), filters OIHW
_TP_RULES = {
    # output channels (dim 0 of OIHW)
    "mod_conv6": (0, True),
    # conv7 consumes conv6's sharded channels: its input channels (dim 1)
    "mod_conv7": (1, False),
}


def _flat_collective(tensors, collective):
    """Run ``collective`` on one flat float32 buffer of ``tensors`` and copy
    the result back into them (in place)."""
    flat = torch.cat([t.detach().reshape(-1).to(torch.float32) for t in tensors])
    collective(flat)
    off = 0
    for t in tensors:
        t.copy_(flat[off:off + t.numel()].view_as(t))
        off += t.numel()
    return tensors


def replicate(tensors, src: int = 0):
    """Broadcast ``tensors`` (in place) from rank ``src`` over the process
    group, as one flat float32 buffer; no-op without a group."""
    if not dist.is_initialized() or not tensors:
        return tensors
    return _flat_collective(tensors, lambda flat: dist.broadcast(flat, src=src))


def average(tensors):
    """Each tensor's mean over the process group (in place): one
    ``all_reduce`` of a float32 buffer, summed, then divided by the world
    size. No-op without a group."""
    if not dist.is_initialized() or not tensors:
        return tensors

    def mean(flat):
        dist.all_reduce(flat)
        flat.div_(dist.get_world_size())

    return _flat_collective(tensors, mean)


def tensor_parallel_refusal() -> str:
    """The message of every tensor-parallel entry point."""
    return (f"tensor-parallel sharding ({', '.join(sorted(_TP_RULES))} over a model "
            "dimension) is not ported: ROADMAP.md queue 1 item 12 (tensor-parallel conv6/7 "
            "and data-parallel serving)")


def batch_rows(n: int) -> slice:
    """This process's rows of a global batch of ``n`` rows: the ``data``
    dimension splits it into equal contiguous blocks in rank order."""
    rank, size = world()
    if n % size:
        raise ValueError(f"global batch of {n} rows not divisible by {size} processes")
    per = n // size
    return slice(rank * per, (rank + 1) * per)
