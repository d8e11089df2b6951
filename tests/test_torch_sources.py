"""The port's dataset sources (``data/sources.py``, ``data/source_*.py``)
against the JAX package's, on the same data: the sample lists (file names,
boxes, sizes) equal, the label maps and colours equal, and for COCO the
``image_ids`` and ``cat_ids``; the synthetic source's images byte for
byte. Exact equality throughout: both parse the same files with the same
float64 arithmetic."""

import os
import sys
from pathlib import Path

import pytest

pytest.importorskip("cv2")

from ssd_tensorflow_tpu.data.source_synthetic import SyntheticSource as JaxSynthetic  # noqa: E402
from ssd_tensorflow_tpu.data.sources import load_data_source as jax_source  # noqa: E402
from ssd_tensorflow_tpu_torch.data import sources  # noqa: E402
from ssd_tensorflow_tpu_torch.data.source_synthetic import SyntheticSource  # noqa: E402

sys.path.insert(0, str(Path(__file__).resolve().parent))
from test_coco_source import coco_dir  # noqa: E402,F401  (the COCO fixture tree)

MINIVOC = str(Path(__file__).resolve().parent / "fixtures" / "minivoc")
SPLITS = ("train_samples", "valid_samples", "test_samples")
COUNTS = ("num_train", "num_valid", "num_test", "num_classes")


def _same_source(port, jax_src):
    for name in SPLITS:
        assert getattr(port, name) == getattr(jax_src, name), name
    for name in COUNTS + ("lid2name", "lname2id", "colors"):
        assert getattr(port, name) == getattr(jax_src, name), name


def _types_are_the_ports(src):
    for s in src.train_samples + src.valid_samples + src.test_samples:
        assert type(s).__module__ == "ssd_tensorflow_tpu_torch.types"
        assert all(type(b).__module__ == "ssd_tensorflow_tpu_torch.types" for b in s.boxes)


def test_load_data_source_resolves_to_the_ports_modules():
    for name in ("pascal_voc", "coco", "synthetic"):
        assert type(sources.load_data_source(name)).__module__ == \
            f"ssd_tensorflow_tpu_torch.data.source_{name}"
    with pytest.raises(ImportError, match="no data source"):
        sources.load_data_source("no_such_source")


@pytest.mark.parametrize("valid_fraction", [0.0, 0.025])
def test_pascal_voc_matches_jax(valid_fraction):
    port, jax_src = sources.load_data_source("pascal_voc"), jax_source("pascal_voc")
    for src in (port, jax_src):
        src.load_trainval_data(MINIVOC, valid_fraction)
        src.load_test_data(MINIVOC)
    _same_source(port, jax_src)
    _types_are_the_ports(port)
    assert (port.num_train, port.num_valid, port.num_test) == (150, 20, 30)
    assert port.colors["person"] == (52, 151, 52) and port.colors["bicycle"] == (0, 74, 111)


def test_pascal_voc_refuses_an_empty_tree(tmp_path):
    with pytest.raises(FileNotFoundError):
        sources.load_data_source("pascal_voc").load_trainval_data(str(tmp_path), 0.1)


def test_coco_matches_jax(coco_dir):  # noqa: F811
    port, jax_src = sources.load_data_source("coco"), jax_source("coco")
    for src in (port, jax_src):
        src.load_trainval_data(coco_dir, 0.0)
        src.load_test_data(coco_dir)
    _same_source(port, jax_src)
    _types_are_the_ports(port)
    assert port.image_ids == jax_src.image_ids and port.cat_ids == jax_src.cat_ids
    assert port.cat_ids["dog"] == 18 and len(port.image_ids) == 10


def test_coco_carved_validation_matches_jax(coco_dir, tmp_path):  # noqa: F811
    """Without a val JSON, both carve the same deterministic tail."""
    os.symlink(os.path.join(coco_dir, "train2017"), tmp_path / "train2017")
    (tmp_path / "annotations").mkdir()
    os.symlink(os.path.join(coco_dir, "annotations", "instances_train2017.json"),
               tmp_path / "annotations" / "instances_train2017.json")
    port, jax_src = sources.load_data_source("coco"), jax_source("coco")
    for src in (port, jax_src):
        src.load_trainval_data(str(tmp_path), 0.5)
    _same_source(port, jax_src)
    assert port.num_valid >= 1


def test_synthetic_matches_jax_byte_for_byte(tmp_path):
    port, jax_src = SyntheticSource(6, 3, 3, seed=4), JaxSynthetic(6, 3, 3, seed=4)
    port.load_trainval_data(str(tmp_path / "port"), 0.1)
    port.load_test_data(str(tmp_path / "port"))
    jax_src.load_trainval_data(str(tmp_path / "jax"), 0.1)
    jax_src.load_test_data(str(tmp_path / "jax"))
    for name in COUNTS + ("lid2name", "lname2id", "colors"):
        assert getattr(port, name) == getattr(jax_src, name), name
    _types_are_the_ports(port)
    n = 0
    for name in SPLITS:
        for p, j in zip(getattr(port, name), getattr(jax_src, name), strict=True):
            assert p.boxes == j.boxes and p.imgsize == j.imgsize
            assert os.path.relpath(p.filename, tmp_path / "port") == \
                os.path.relpath(j.filename, tmp_path / "jax")
            assert Path(p.filename).read_bytes() == Path(j.filename).read_bytes()
            n += 1
    assert n == 12
    assert type(sources.load_data_source("synthetic")) is SyntheticSource
