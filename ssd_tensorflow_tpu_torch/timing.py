"""Timing on the card for the measurement scripts (``chip_smoke.py``,
``tools/torch_profile.py``). Nothing on the detection path calls it."""

from __future__ import annotations


def cuda_event_ms(fn, iters: int = 5, warmup: int = 2) -> float:
    """Mean ms per call of ``fn``: CUDA events around ``iters`` chained
    calls, after ``warmup`` calls. For a call shorter than its host-side
    launch cost this is the launch rate, not the device time."""
    import torch

    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    end.synchronize()
    return start.elapsed_time(end) / iters


def device_kernels(prof, iters: int = 1):
    """``[(name, device ms per iteration, launches per iteration)]`` of the
    device kernels in a finished ``torch.profiler.profile``, most time
    first."""
    from torch.autograd import DeviceType

    kernels = []
    for evt in prof.key_averages():
        dev_us = getattr(evt, "self_device_time_total", None)
        if dev_us is None:
            dev_us = evt.self_cuda_time_total
        if dev_us > 0 and evt.device_type == DeviceType.CUDA:
            kernels.append((evt.key, dev_us / 1e3 / iters, evt.count / iters))
    kernels.sort(key=lambda k: -k[1])
    return kernels


def per_call_ms(kernels) -> float:
    """Device ms per call summed over ``kernels`` (rows of
    :func:`device_kernels`): each kernel counts as its mean recorded
    launch times its launches per call, so that a record the profiler
    dropped does not shorten the result."""
    return sum(ms / per_call * max(1, round(per_call)) for _, ms, per_call in kernels)


def kernel_device_ms(fn, kernel_name: str, iters: int = 20, warmup: int = 2) -> float:
    """Mean device time (ms) per call of ``fn`` spent in the kernels whose
    name contains ``kernel_name``, from a ``torch.profiler`` window over
    ``iters`` calls (see :func:`per_call_ms`); host launch cost is not in
    it. Raises when the profiler saw no such kernel."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        for _ in range(iters):
            fn()
        torch.cuda.synchronize()
    hits = [k for k in device_kernels(prof, iters) if kernel_name in k[0]]
    if not hits:
        raise RuntimeError(f"the profiler recorded no device time for {kernel_name!r}")
    return per_call_ms(hits)
