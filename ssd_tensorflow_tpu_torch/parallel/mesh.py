"""The process group and the ``("data", "model")`` device mesh.

The JAX package runs one program over a mesh of devices. Here it is one
process per device under ``torch.distributed``: a ``torchrun`` launch
gives each process ``RANK``, ``WORLD_SIZE``, ``LOCAL_RANK``,
``MASTER_ADDR`` and ``MASTER_PORT``, and :func:`make_mesh` joins that
group (NCCL for ``cuda``, gloo for ``cpu``) and lays a
``DeviceMesh`` over it. Without that environment the world is one
process and no group is created.
"""

from __future__ import annotations

import os

import torch
import torch.distributed as dist

from ssd_tensorflow_tpu_torch import resolve_device

#: what a multi-process launch puts in each process's environment
LAUNCH_ENV = ("RANK", "WORLD_SIZE", "MASTER_ADDR", "MASTER_PORT")

def launched() -> bool:
    """Whether this process was started by a multi-process launcher."""
    return all(k in os.environ for k in LAUNCH_ENV)


def local_device(device="cuda") -> torch.device:
    """This process's device: ``cuda:LOCAL_RANK`` for ``cuda`` (made the
    current device), the CPU for ``cpu``. Raises when CUDA is asked for and
    there is none."""
    dev = resolve_device(device)
    if dev.type != "cuda":
        return dev
    index = dev.index if dev.index is not None else int(os.environ.get("LOCAL_RANK", 0))
    torch.cuda.set_device(index)
    return torch.device("cuda", index)


def init_process_group(device="cuda") -> bool:
    """Join the launcher's process group (once per process): NCCL for a
    ``cuda`` device, gloo for the CPU. Returns whether a group exists."""
    if dist.is_initialized():
        return True
    if not launched():
        return False
    dev = local_device(device)
    dist.init_process_group("nccl" if dev.type == "cuda" else "gloo",
                            rank=int(os.environ["RANK"]),
                            world_size=int(os.environ["WORLD_SIZE"]),
                            **({"device_id": dev} if dev.type == "cuda" else {}))
    return True


def world() -> tuple:
    """``(rank, world size)`` of this process; ``(0, 1)`` without a group."""
    if dist.is_initialized():
        return dist.get_rank(), dist.get_world_size()
    return 0, 1


def make_mesh(data: int | None = None, model: int = 1, device="cuda"):
    """A ``DeviceMesh`` of shape ``(data, model)`` with dims ``("data",
    "model")`` over the process group, or ``None`` where there is no group
    (one process).

    ``data`` defaults to the world size divided by ``model``; any other value
    raises, as a mesh that does not hold every process would leave some of
    them out of the collectives. ``model > 1`` (tensor parallelism) is not
    ported and raises ``NotImplementedError``.
    """
    if model > 1:
        from ssd_tensorflow_tpu_torch.parallel.sharding import tensor_parallel_refusal

        raise NotImplementedError(tensor_parallel_refusal())
    init_process_group(device)
    _, n = world()
    if data is None:
        data = n
    if data * model != n:
        raise ValueError(f"mesh {data}x{model} needs {data * model} devices, have {n}")
    if not dist.is_initialized():
        return None
    from torch.distributed.device_mesh import init_device_mesh

    dev = local_device(device)
    return init_device_mesh(dev.type, (data, model), mesh_dim_names=("data", "model"))


def mesh_device(mesh, device="cuda") -> torch.device:
    """The device this process's share of ``mesh`` lives on (``device``
    where ``mesh`` is ``None``)."""
    if mesh is None:
        return resolve_device(device)
    return local_device(mesh.device_type)
