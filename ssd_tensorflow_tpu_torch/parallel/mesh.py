"""The process group and the ``("data", "model")`` mesh.

The JAX package runs one program over a mesh of devices. Here it is one
process per device under ``torch.distributed``: a ``torchrun`` launch
gives each process ``RANK``, ``WORLD_SIZE``, ``LOCAL_RANK``,
``MASTER_ADDR`` and ``MASTER_PORT``, and :func:`make_mesh` joins that
group (NCCL for ``cuda``, gloo for ``cpu``) and lays a :class:`Mesh` over
it. A group the caller has already started is used as it is, whatever
its backend: gloo takes CUDA tensors for ``all_reduce`` and
``broadcast``, so several processes can share one card under it. Without
a launch environment the world is one process and no group is created.
:func:`spawn` starts such a launch's processes on one host.
"""

from __future__ import annotations

import os
import socket
import subprocess
import tempfile
import time

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
    current device; ranks beyond the card count share the cards in turn),
    the CPU for ``cpu``. Raises when CUDA is asked for and there is none."""
    dev = resolve_device(device)
    if dev.type != "cuda":
        return dev
    index = dev.index
    if index is None:
        index = int(os.environ.get("LOCAL_RANK", 0)) % torch.cuda.device_count()
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


class Mesh:
    """Every process of the group on a ``(data, model)`` grid: rank ``r``
    sits at ``(r // model, r % model)``, the order of the JAX package's
    ``devices.reshape(data, model)``. ``shape`` is ``{"data": d, "model":
    m}``; :meth:`get_group` gives this process's group along a dimension
    (its ``model`` peers share the same rows of a batch, its ``data``
    peers the same shard of the parameters)."""

    def __init__(self, data: int, model: int, device_type: str, groups: dict):
        rank = dist.get_rank()
        self.shape = {"data": data, "model": model}
        self.device_type = device_type
        self.coordinate = {"data": rank // model, "model": rank % model}
        self._groups = groups

    def get_group(self, name: str):
        """The process group of this process along ``name``."""
        return self._groups[name]

    def __repr__(self):
        return f"Mesh({self.shape}, {self.device_type!r}, at {self.coordinate})"


def _dim_group(lines):
    """Create the group of each list of ranks in ``lines`` (every process
    creates every group, in the same order) and return this process's."""
    rank, n = world()
    mine = None
    for ranks in lines:
        group = dist.group.WORLD if len(ranks) == n else dist.new_group(ranks)
        if rank in ranks:
            mine = group
    return mine


def make_mesh(data: int | None = None, model: int = 1, device="cuda"):
    """A :class:`Mesh` of shape ``(data, model)`` over the process group,
    or ``None`` where there is no group (one process).

    ``data`` defaults to the world size divided by ``model``. The mesh
    holds every process: ``data * model`` must be the world size, as a
    mesh that left some processes out would leave them out of the
    collectives.
    """
    init_process_group(device)
    _, n = world()
    if data is None:
        if n % model:
            raise ValueError(f"{n} devices not divisible by model={model}")
        data = n // model
    if data * model != n:
        raise ValueError(f"mesh {data}x{model} needs {data * model} devices, have {n}")
    if not dist.is_initialized():
        return None
    dev = local_device(device)
    groups = {
        "data": _dim_group([[i * model + j for i in range(data)] for j in range(model)]),
        "model": _dim_group([[i * model + j for j in range(model)] for i in range(data)]),
    }
    return Mesh(data, model, dev.type, groups)


def mesh_device(mesh, device="cuda") -> torch.device:
    """The device this process's share of ``mesh`` lives on (``device``
    where ``mesh`` is ``None``)."""
    if mesh is None:
        return resolve_device(device)
    return local_device(mesh.device_type)


def free_port() -> int:
    """A TCP port of this host that is free now."""
    with socket.socket() as sock:
        sock.bind(("127.0.0.1", 0))
        return sock.getsockname()[1]


def spawn(n: int, argv, timeout: float, env: dict | None = None, cwd=None,
          capture: bool = False) -> list:
    """Run ``n`` processes of ``argv`` as a ``torchrun --nproc-per-node n``
    launch on this host would: each gets ``RANK`` and ``LOCAL_RANK`` (its
    index), ``WORLD_SIZE`` and a free ``MASTER_PORT`` on ``127.0.0.1``, over
    ``env`` (this process's environment where ``None``) without its own
    launch's variables. Waits for all of them and returns each one's
    output (stdout and stderr, where ``capture``; else they go to this
    process's). Raises, after stopping the others, when one exits
    non-zero or ``timeout`` seconds pass."""
    base = {k: v for k, v in (os.environ if env is None else env).items()
            if k not in LAUNCH_ENV + ("LOCAL_RANK",)}
    base.update(MASTER_ADDR="127.0.0.1", MASTER_PORT=str(free_port()), WORLD_SIZE=str(n))
    logs = [tempfile.TemporaryFile() if capture else None for _ in range(n)]
    procs = [subprocess.Popen(argv, env=dict(base, RANK=str(r), LOCAL_RANK=str(r)), cwd=cwd,
                              stdout=logs[r], stderr=subprocess.STDOUT if capture else None)
             for r in range(n)]

    def output(r):
        if logs[r] is None:
            return ""
        logs[r].seek(0)
        return logs[r].read().decode(errors="replace")

    deadline = time.monotonic() + timeout
    try:
        while True:
            codes = [p.poll() for p in procs]
            failed = [r for r, c in enumerate(codes) if c]
            if failed:
                r = failed[0]
                raise RuntimeError(f"process {r} of {n} exited {codes[r]}:\n{output(r)[-4000:]}")
            if all(c == 0 for c in codes):
                return [output(r) for r in range(n)]
            if time.monotonic() > deadline:
                raise RuntimeError(f"{n} processes not done after {timeout} s")
            time.sleep(0.05)
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.wait()
        for f in logs:
            if f is not None:
                f.close()
