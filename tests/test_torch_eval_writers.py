"""The port's result writers (``eval/pascal_summary.py``,
``eval/coco_results.py``) against the JAX package's: the same detections
and image sizes give byte-identical Pascal eval-server files and COCO
results JSON; without a size, both read it from the image (the port
through ``data/image_io.py``)."""

import json
from pathlib import Path

import numpy as np
import pytest

pytest.importorskip("cv2")

from ssd_tensorflow_tpu.eval.coco_results import CocoResultsWriter as JaxCoco  # noqa: E402
from ssd_tensorflow_tpu.eval.pascal_summary import PascalSummary as JaxSummary  # noqa: E402
from ssd_tensorflow_tpu_torch.eval.coco_results import CocoResultsWriter  # noqa: E402
from ssd_tensorflow_tpu_torch.eval.pascal_summary import PascalSummary  # noqa: E402
from ssd_tensorflow_tpu_torch.types import Box, Point, Size  # noqa: E402

JPEGS = sorted((Path(__file__).resolve().parent / "fixtures" / "minivoc" / "test").rglob("*.jpg"))
LABELS = ["person", "dog", "car", "no-category"]


def _detections(seed, n_images=5, per_image=7):
    """``[(filename, [(conf, Box)], Size)]`` with boxes partly off the image
    (clamped or dropped by the writers) and a label without a COCO id."""
    rng = np.random.default_rng(seed)
    out = []
    for i in range(n_images):
        boxes = []
        for _ in range(per_image):
            lid = int(rng.integers(0, len(LABELS)))
            cx, cy = rng.uniform(-0.2, 1.2, 2)
            w, h = rng.uniform(0.01, 0.8, 2)
            boxes.append((float(rng.uniform(0.01, 1.0)),
                          Box(LABELS[lid], lid, Point(float(cx), float(cy)),
                              Size(float(w), float(h)))))
        size = Size(int(rng.integers(40, 900)), int(rng.integers(40, 900)))
        out.append((f"/data/img/{i:012d}.jpg" if i % 2 else f"/data/img/frame_{i}.jpg",
                    boxes, size))
    return out


def _files(directory):
    return {p.name: p.read_bytes() for p in sorted(Path(directory).iterdir())}


@pytest.mark.parametrize("seed", [0, 1])
def test_pascal_summary_files_equal_jax(tmp_path, seed):
    port, jax_w = PascalSummary(), JaxSummary()
    for fname, boxes, size in _detections(seed):
        port.add_detections(fname, boxes, size)
        jax_w.add_detections(fname, boxes, size)
    port.write_summary(str(tmp_path / "port"))
    jax_w.write_summary(str(tmp_path / "jax"))
    got, want = _files(tmp_path / "port"), _files(tmp_path / "jax")
    assert got == want and len(got) == len(LABELS)


@pytest.mark.parametrize("seed", [0, 1])
def test_coco_results_equal_jax(tmp_path, seed, capsys):
    dets = _detections(seed)
    image_ids = {dets[0][0]: 77}
    cat_ids = {"person": 1, "dog": 18, "car": 3}
    port, jax_w = CocoResultsWriter(image_ids, cat_ids), JaxCoco(image_ids, cat_ids)
    for fname, boxes, size in dets:
        port.add_detections(fname, boxes, size)
        jax_w.add_detections(fname, boxes, size)
    port.write_results(str(tmp_path / "port" / "coco_results.json"))
    jax_w.write_results(str(tmp_path / "jax" / "coco_results.json"))
    got = (tmp_path / "port" / "coco_results.json").read_bytes()
    assert got == (tmp_path / "jax" / "coco_results.json").read_bytes()
    results = json.loads(got)
    assert port.skipped_labels == jax_w.skipped_labels == {"no-category"}
    assert {r["image_id"] for r in results} >= {77, 1}
    assert "skipped labels" in capsys.readouterr().out


def test_writers_read_the_size_from_the_image(tmp_path):
    """No size given: both writers decode the file for it."""
    rows = [(str(p), boxes) for p, (_, boxes, _) in zip(JPEGS[:3], _detections(2, 3))]
    port_s, jax_s = PascalSummary(), JaxSummary()
    port_c, jax_c = CocoResultsWriter(cat_ids={"person": 1, "dog": 18}), \
        JaxCoco(cat_ids={"person": 1, "dog": 18})
    for fname, boxes in rows:
        for w in (port_s, jax_s, port_c, jax_c):
            w.add_detections(fname, boxes)
    port_s.write_summary(str(tmp_path / "port"))
    jax_s.write_summary(str(tmp_path / "jax"))
    assert _files(tmp_path / "port") == _files(tmp_path / "jax")
    assert port_c.results == jax_c.results and port_c.results
