"""One run of one cell: set-up (timed as ``setup_s``), the measured
window, the peak memory, then the check of what the window produced
against the plain reference, and the result's line."""

from __future__ import annotations

import os
import sys
import time
from pathlib import Path

import torch

from benchlib import check, counts, programs, registry
from benchlib.serve import ServeRun
from benchlib.train import TrainRun
from benchlib.trace import Trace

#: the traffic drivers by a traffic file's ``mode``
DRIVERS = {"serve": ServeRun, "train": TrainRun}


def device_info(device, count: int) -> dict:
    if device.type != "cuda":
        return {"platform": "cpu", "kind": "cpu", "count": 1,
                "memory_peak_bytes": 0}
    return {"platform": "gpu", "kind": torch.cuda.get_device_name(device), "count": count,
            "memory_peak_bytes": int(torch.cuda.max_memory_allocated(device))}


def profilers(device, tmp: str):
    """The traced run's phases, in order, as ``(name, make, finish)``: on the
    card ``device`` (CUDA activity alone) and ``host`` (host and CUDA
    activity); ``finish`` turns a stopped profiler into its ``Trace``."""
    from torch.profiler import ProfilerActivity, profile

    def make(acts):
        return lambda: profile(activities=acts, record_shapes=False, with_stack=False)

    def finish(spans):
        path = os.path.join(tmp, f"trace-{os.getpid()}.json")
        return lambda prof: Trace.from_profiler(prof, path, spans=spans)

    host = make([ProfilerActivity.CPU] + ([ProfilerActivity.CUDA] if device.type == "cuda"
                                          else []))
    if device.type != "cuda":
        return [("host", host, finish(True))]
    return [("device", make([ProfilerActivity.CUDA]), finish(False)),
            ("host", host, finish(True))]


def layer_context(cell: registry.Cell, rec: dict, traces: dict) -> dict:
    """What the per-layer readers read: the untraced part of a traced
    window (``plain``), the traces of the ``device`` and ``host`` phases,
    and the benchmark's own counts."""
    cfg, b = cell.config, rec["batch"]
    stem = cfg.get("serve_overrides", {}).get("pallas_stem_variant") == "uint8"
    return dict(kind=rec["kind"], batch=b, plain=rec["plain"], trace=traces.get("host"),
                device_trace=traces.get("device"),
                peak_ops=counts.PEAK_OPS[cfg["precision"]],
                forward_ops_per_item=counts.forward_ops(cfg),
                train_ops_per_item=counts.train_ops(cfg),
                convs_bound_s=counts.convs_bound_s(cfg, b),
                stem_bound_s=counts.stem_bound_s(cfg, b) if stem else None)


def checks(run, rec: dict, cell: registry.Cell):
    """The numbers compared and the limits, from the window's own outputs."""
    if rec["kind"] == "train":
        run.release()
        numbers = check.train_numbers(run.prog, run.reference())
    else:
        prog, images = run.check_inputs()
        ref = programs.reference_serving(cell.config, run.given, images)
        numbers = check.serving_numbers(prog, ref, cell.config["detection"]["nms_threshold"])
    return check.judge(numbers, cell.limits)


def run_cell(root, workload: str, seed: int, seconds: float, trace: bool, device="cuda",
             t_start: float | None = None, cell: registry.Cell | None = None):
    """The result dict of one run (``correct``, ``attempted``, ``failed``,
    ``metrics``, ``device``, optionally ``breakdown``, and ``checks``
    last). ``cell`` replaces the one ``BENCHMARK.json`` names (tests)."""
    t_start = time.perf_counter() if t_start is None else t_start
    device = torch.device(device)
    cell = cell or registry.cell(Path(root), workload)
    torch.manual_seed(int(seed) % (1 << 63))
    run = DRIVERS[cell.traffic["mode"]](cell.config, cell.traffic, seed, device)
    setup_s = time.perf_counter() - t_start
    print("setup " + " ".join(f"{k} {v:.3f} s" for k, v in run.setup_laps.items()),
          file=sys.stderr)
    profiled = min(float(cell.traffic.get("trace_seconds", 1.0)), seconds / 2) if trace else 0.0
    tmp = os.environ.get("TMPDIR") or str(Path(root) / ".h100bench_cache")
    if trace:
        os.makedirs(tmp, exist_ok=True)
    rec = run.window(seconds, profiled, profilers(device, tmp))
    dev = device_info(device, cell.chips)
    traces = rec.pop("profilers")
    lat = sorted(rec.get("latencies_s", []))
    if lat:
        print(f"window {rec['requests']} requests, latency ms p50 {1e3 * lat[len(lat) // 2]:.3f} "
              f"p95 {1e3 * lat[int(0.95 * (len(lat) - 1))]:.3f} max {1e3 * lat[-1]:.3f}",
              file=sys.stderr)
    ok, numbers = checks(run, rec, cell)
    if trace:
        ctx = layer_context(cell, rec, traces)
        metrics = {}
        for m in cell.per_layer:
            v = registry.reader("metrics", m["name"])(ctx)
            if v is not None:
                metrics[m["name"]] = {"value": v, "unit": m["unit"]}
        busy = traces.get("device") or traces.get("host")
        if busy is not None:
            dev["busy_s"] = busy.busy_us / 1e6
            dev["window_s"] = busy.window_us / 1e6
    else:
        metrics = {"setup_s": {"value": setup_s, "unit": "s"}}
        for m in cell.end_to_end:
            if m["name"] != "setup_s":
                v = registry.reader("e2e", m["name"])(rec)
                if v is not None:
                    metrics[m["name"]] = {"value": v, "unit": m["unit"]}
    result = {"correct": ok, "attempted": rec["requests"], "failed": 0, "metrics": metrics,
              "device": dev}
    if traces:
        ops = traces.get("device") or traces["host"]
        result["breakdown"] = {"device_ops": [[n, us / 1e6] for n, us in ops.top_ops(10)],
                               "idle_gaps": [[n, us / 1e6] for n, us in
                                             traces["host"].idle_gaps(10)]}
    result["checks"] = numbers
    return result


def check_lines(result: dict):
    return [f"check {name}: {v['value']!r} limit {v['limit']!r}"
            for name, v in result["checks"].items()]
