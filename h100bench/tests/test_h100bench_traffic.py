"""A rehearsal of every cell on the CPU at its family's small preset: each
traffic mix drives the program through set-up, a short window and the
check, with and without tracing, and prints a result of the contract's
shape."""

import json
import math

import h100bench_cases as hc
import pytest

from benchlib import harness, registry

CELLS = hc.CELLS


def test_every_traffic_file_is_rehearsed():
    files = {p.stem for p in (hc.BENCH / "traffic").glob("*.json")}
    cells = {w["traffic"] for w in registry.benchmark(hc.ROOT)["workloads"]}
    assert files == cells


@pytest.fixture(scope="module")
def bundles(tmp_path_factory):
    return hc.write_bundles(tmp_path_factory.mktemp("bundles"))


@pytest.mark.parametrize("trace", [False, True])
@pytest.mark.parametrize("workload", CELLS)
def test_rehearsal(workload, trace, bundles):
    cell = hc.cell(workload, bundles)
    result = harness.run_cell(hc.ROOT, workload, 2**33 + 17, 1.0, trace, "cpu", cell=cell)
    assert list(result)[-1] == "checks"
    assert set(result) >= {"correct", "attempted", "failed", "metrics", "device"}
    assert result["attempted"] > 0 and result["failed"] == 0
    json.dumps(result)
    for v in result["checks"].values():
        assert math.isfinite(v["value"]) and v["limit"] > 0
    names = set(result["metrics"])
    if trace:
        assert "breakdown" in result
        assert names <= {m["name"] for m in cell.per_layer}
        assert any(n.startswith(("mfu.", "forward_ms.")) for n in names)
    else:
        assert names == {m["name"] for m in cell.end_to_end}
        assert all(v["value"] > 0 for v in result["metrics"].values())


def test_same_seed_same_inputs():
    import torch

    from benchlib import pool

    aug = registry.traffic("serve-b64")["augment"]
    a = pool.images(6, (64, 64), aug, 2**40 + 3, torch.device("cpu"))
    b = pool.images(6, (64, 64), aug, 2**40 + 3, torch.device("cpu"))
    c = pool.images(6, (64, 64), aug, 2**40 + 4, torch.device("cpu"))
    assert torch.equal(a, b) and not torch.equal(a, c)
    boxes, labels, mask = pool.gt_boxes(32, [1, 8], [0.1, 0.6], 20, 5)
    assert mask.sum(1).min() >= 1 and mask.sum(1).max() <= 8
    assert (boxes[..., :2] - boxes[..., 2:] / 2 >= 0).all()
    assert (boxes[..., :2] + boxes[..., 2:] / 2 <= 1).all()
