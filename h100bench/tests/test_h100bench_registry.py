"""``BENCHMARK.json`` and the files it names: every configuration, traffic
mix, limit and metric reader is found by its name, and the file keeps to
the benchmark's contract."""

import json
import re

import h100bench_cases as hc
import pytest

from benchlib import registry

BENCH = registry.benchmark(hc.ROOT)
NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.-]{1,16}$")


def test_top_level_keys():
    assert set(BENCH) == {"command", "paths", "run_seconds", "configs", "workloads",
                          "end_to_end", "per_layer"}
    assert BENCH["paths"] == ["h100bench"]
    assert 1 <= BENCH["run_seconds"] <= 51
    assert len((hc.ROOT / "BENCHMARK.json").read_bytes()) <= 64 * 1024


@pytest.mark.parametrize("w", [w["name"] for w in BENCH["workloads"]])
def test_every_cell_resolves(w):
    cell = registry.cell(hc.ROOT, w)
    assert cell.config["name"] == next(x["config"] for x in BENCH["workloads"] if x["name"] == w)
    assert cell.traffic["mode"] in ("serve", "train")
    names = {m["name"] for m in cell.end_to_end}
    assert "setup_s" in names and len(names) >= 2
    assert cell.per_layer
    assert {m["moves"] for m in cell.per_layer} <= names
    assert set(cell.limits) and all(v > 0 for v in cell.limits.values())


@pytest.mark.parametrize("m", BENCH["end_to_end"] + BENCH["per_layer"], ids=lambda m: m["name"])
def test_every_metric_has_a_reader(m):
    kind = "metrics" if m in BENCH["per_layer"] else "e2e"
    if m["name"] != "setup_s":
        assert callable(registry.reader(kind, m["name"]))
    assert NAME.match(m["name"]) and UNIT.match(m["unit"])
    assert m["better"] in ("lower", "higher")


def test_configs_are_their_files():
    for c in BENCH["configs"]:
        data = json.loads((hc.ROOT / c["file"]).read_text())
        assert data["name"] == c["name"] and data["reduced"] == c["reduced"]
        assert c["file"].startswith("h100bench/configs/")
        assert all(k in data for k in c["reduced"])


def test_names_and_bounds():
    for group in ("configs", "workloads", "end_to_end", "per_layer"):
        names = [x["name"] for x in BENCH[group]]
        assert len(names) == len(set(names)) and all(NAME.match(n) for n in names)
    for m in BENCH["end_to_end"]:
        assert 0.01 <= m["bound"] <= 0.25 and m["source"] in ("host_clock", "device_trace")
    layers = {m["layer"] for m in BENCH["per_layer"]}
    assert all(len(x) <= 200 and "\n" not in x for x in layers)


def test_discovery_finds_a_new_file_by_name(tmp_path, monkeypatch):
    (tmp_path / "e2e").mkdir()
    (tmp_path / "e2e" / "new_metric.py").write_text("def read(rec):\n    return 7.0\n")
    monkeypatch.setattr(registry, "BENCH_DIR", tmp_path)
    assert registry.reader("e2e", "new_metric")({}) == 7.0
