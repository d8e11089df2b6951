"""Command-line entry points, as the JAX package's: ``python -m
ssd_tensorflow_tpu_torch.cli.<name>`` for ``train``, ``process_dataset``,
``infer``, ``export_model`` and ``detect``."""

from __future__ import annotations


def serving_mesh(n: int, batch_size: int, device: str, module: str):
    """``(mesh, error)`` for the serving CLIs' ``--data-parallel n``: the
    JAX CLIs' batch check, then a data-parallel mesh over the launch's
    processes, which must be ``n`` (``torchrun --nproc-per-node n``; one
    process without a launch, where ``n = 1`` is one device and the mesh
    is ``None``). ``error`` is the line to print before exiting 1."""
    if batch_size % n:
        return None, f"[!] --batch-size {batch_size} not divisible by --data-parallel {n}"
    from ssd_tensorflow_tpu_torch.parallel.mesh import init_process_group, make_mesh, world

    init_process_group(device)
    size = world()[1]
    if size != n:
        return None, (f"[!] --data-parallel {n} needs {n} processes, one a device, and this "
                      f"launch has {size}: run torchrun --nproc-per-node {n} -m {module} "
                      f"--data-parallel {n} ...")
    return make_mesh(data=n, device=device), None


def leave_process_group():
    """Leave the process group a serving CLI joined, if any."""
    import torch.distributed as dist

    if dist.is_initialized():
        dist.destroy_process_group()
