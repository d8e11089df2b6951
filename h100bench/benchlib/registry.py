"""Finds what ``BENCHMARK.json`` names, by name: a cell's configuration
(``configs/<name>.json``), traffic mix (``traffic/<name>.json``) and limits
(``limits/<cell>.json``), and each metric's reader (``metrics/<name>.py``
for a per-layer metric, ``e2e/<name>.py`` for an end-to-end one). A new
cell or metric is new files; nothing here lists them."""

from __future__ import annotations

import dataclasses
import importlib.util
import json
from pathlib import Path

BENCH_DIR = Path(__file__).resolve().parent.parent


@dataclasses.dataclass(frozen=True)
class Cell:
    name: str
    config: dict
    traffic: dict
    limits: dict
    end_to_end: list
    per_layer: list
    chips: int


def read_json(path: Path) -> dict:
    with open(path) as f:
        return json.load(f)


def benchmark(root: Path) -> dict:
    return read_json(Path(root) / "BENCHMARK.json")


def config(name: str) -> dict:
    return read_json(BENCH_DIR / "configs" / f"{name}.json")


def traffic(name: str) -> dict:
    return read_json(BENCH_DIR / "traffic" / f"{name}.json")


def limits(cell: str) -> dict:
    return read_json(BENCH_DIR / "limits" / f"{cell}.json")


def _applies(metric: dict, cell: str, e2e_names) -> bool:
    if "workloads" in metric:
        return cell in metric["workloads"]
    return metric.get("moves", metric["name"]) in e2e_names


def cell(root: Path, name: str) -> Cell:
    """The workload ``name`` of ``BENCHMARK.json`` with its files read and
    the metrics it reports: every end-to-end metric that lists it (or
    lists no workloads), and every per-layer metric that lists it, or
    lists none and moves one of those."""
    bench = benchmark(root)
    found = [w for w in bench["workloads"] if w["name"] == name]
    if not found:
        raise KeyError(f"no workload {name!r} in BENCHMARK.json")
    w = found[0]
    e2e = [m for m in bench["end_to_end"] if name in m.get("workloads", [name])]
    names = {m["name"] for m in e2e}
    per_layer = [m for m in bench["per_layer"] if _applies(m, name, names)]
    return Cell(name=name, config=config(w["config"]), traffic=traffic(w["traffic"]),
                limits=limits(name), end_to_end=e2e, per_layer=per_layer, chips=w["chips"])


def reader(kind: str, name: str):
    """The ``read`` function of ``<kind>/<name>.py`` (``metrics`` or ``e2e``)."""
    path = BENCH_DIR / kind / f"{name}.py"
    spec = importlib.util.spec_from_file_location(f"h100bench_{kind}_{name}".replace(".", "_")
                                                  .replace("-", "_"), path)
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    return module.read
