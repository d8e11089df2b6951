"""How parameters and batches map onto the mesh, as the JAX package's
``parallel/sharding.py``.

Data parallelism: every process holds the whole parameter set (rank 0's,
broadcast once by :func:`replicate`) and its own rows of the batch, whose
leading dimension is split over the mesh's ``data`` dimension
(:func:`batch_rows`); the train step averages the gradients over the
``data`` group (:func:`average`).

Tensor parallelism (a ``model`` dimension > 1): the 1024-channel a-trous
conv6 / conv7 shard by ``_TP_RULES`` (:func:`param_shardings`); each
process keeps its slice (:func:`shard_params`), the forward runs conv6
column-parallel and conv7 row-parallel (``parallel/tensor_parallel.py``),
and :func:`gather_params` rebuilds the whole leaves. The processes of a
``model`` group take the same rows of the batch.
"""

from __future__ import annotations

import torch
import torch.distributed as dist

from ssd_tensorflow_tpu_torch.parallel.mesh import world

#: params whose conv filters shard over the model dimension:
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


def average(tensors, group=None):
    """Each tensor's mean over ``group`` (the world where ``None``), in
    place: one ``all_reduce`` of a float32 buffer, summed, then divided by
    the group's size. No-op without a process group."""
    if not dist.is_initialized() or not tensors:
        return tensors

    def mean(flat):
        dist.all_reduce(flat, group=group)
        flat.div_(dist.get_world_size(group))

    return _flat_collective(tensors, mean)


def use_tensor_parallel(mesh, tensor_parallel: bool = True) -> bool:
    """Whether ``_TP_RULES`` apply: asked for, on a mesh with ``model`` > 1
    (the JAX package's ``use_tp``)."""
    return bool(tensor_parallel) and mesh is not None and mesh.shape["model"] > 1


def param_shardings(mesh, params, tensor_parallel: bool = True) -> dict:
    """``{layer: {leaf: dim}}`` matching ``params``: the dimension a leaf
    is split on over ``model``, or ``None`` for a whole (replicated) leaf."""
    use_tp = use_tensor_parallel(mesh, tensor_parallel)

    def dim_of(name, key):
        if not (use_tp and name in _TP_RULES and key in ("w", "b")):
            return None
        w_dim, b_sharded = _TP_RULES[name]
        return w_dim if key == "w" else (0 if b_sharded else None)

    return {name: {key: dim_of(name, key) for key in leaves} for name, leaves in params.items()}


def _slice(v, dim: int, mesh):
    m, j = mesh.shape["model"], mesh.coordinate["model"]
    if v.shape[dim] % m:
        raise ValueError(f"dimension {dim} of {tuple(v.shape)} not divisible by model={m}")
    size = v.shape[dim] // m
    return v.narrow(dim, j * size, size)


def shard_params(params, mesh, tensor_parallel: bool = True) -> dict:
    """This process's share of ``params`` (or of a tree that mirrors them,
    such as the momentum): its ``model`` slice of each leaf
    :func:`param_shardings` splits (a contiguous copy), every other leaf
    as it is."""
    dims = param_shardings(mesh, params, tensor_parallel)
    return {name: {key: v if dims[name][key] is None
                   else _slice(v, dims[name][key], mesh).contiguous()
                   for key, v in leaves.items()} for name, leaves in params.items()}


def gather_params(params, mesh) -> dict:
    """The whole leaves of a tree :func:`shard_params` split, on every
    process: each split leaf rebuilt by an ``all_reduce`` over the
    ``model`` group of a zero-filled whole tensor that holds this
    process's slice. Other leaves are returned as they are."""
    dims = param_shardings(mesh, params)
    out = {}
    for name, leaves in params.items():
        out[name] = {}
        for key, v in leaves.items():
            dim = dims[name][key]
            if dim is None:
                out[name][key] = v
                continue
            shape = list(v.shape)
            shape[dim] *= mesh.shape["model"]
            whole = v.new_zeros(shape, dtype=torch.float32)
            _slice(whole, dim, mesh).copy_(v.detach())
            dist.all_reduce(whole, group=mesh.get_group("model"))
            out[name][key] = whole.to(v.dtype)
    return out


def gather_rows(tensors, mesh):
    """The whole batch of each of ``tensors`` (this process's rows of
    it, see :func:`batch_rows`) on every process of ``mesh``'s ``data``
    group: one ``all_reduce`` of a zero-filled float32 buffer that holds
    this process's rows, cast back to each tensor's dtype (exact for
    float32, booleans and integers below 2^24)."""
    d = mesh.shape["data"]
    wholes = [t.new_zeros((t.shape[0] * d, *t.shape[1:]), dtype=torch.float32) for t in tensors]
    for t, whole in zip(tensors, wholes):
        whole[batch_rows(whole.shape[0], mesh)] = t.to(torch.float32)
    _flat_collective(wholes, lambda flat: dist.all_reduce(flat, group=mesh.get_group("data")))
    return [whole.to(t.dtype) for t, whole in zip(tensors, wholes)]


def batch_rows(n: int, mesh=None) -> slice:
    """This process's rows of a global batch of ``n`` rows: the ``data``
    dimension of ``mesh`` (every process of the group where ``None``)
    splits it into equal contiguous blocks in order. The processes of a
    ``model`` group take the same rows."""
    if mesh is None:
        index, size = world()
    else:
        index, size = mesh.coordinate["data"], mesh.shape["data"]
    if n % size:
        raise ValueError(f"global batch of {n} rows not divisible by {size} processes")
    per = n // size
    return slice(index * per, (index + 1) * per)
