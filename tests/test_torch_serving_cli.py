"""The port's serving and evaluation CLIs (``cli/process_dataset.py``,
``cli/export_model.py``, ``cli/infer.py``, ``cli/detect.py``) against the
JAX package's CLIs on the same inputs, on the CPU (``--device cpu``),
test64 checkpoints made from seeded parameters with the checkpoint writer
(no training), the shipped vgg512 int8 bundle on two miniVOC JPEGs.

- process_dataset: ``training-data.json`` byte for byte, the pickled
  samples equal once unpickled, the annotated images byte for byte; the
  port's train CLI takes one epoch from its output.
- export_model: the float bundle leaf for leaf bit for bit with the same
  metadata; ``--quantize`` on miniVOC calibration images: the int8 leaves
  bit for bit, ``act_scales`` within 1 % relative (the largest gap is
  printed; 1.03e-6 relative, conv4_1, when written); a QAT checkpoint's stored
  scales exported as they are; without images rc 1, with
  ``--allow-noise-calibration`` the JAX CLI's noise batch.
  ``--torch-export``: float32 within 1e-5 of the eager forward (as the JAX
  package's StableHLO round trip holds), bf16 equal to the eager port on
  the CPU bit for bit, the graph holding the stem kernel's operator;
  ``--stablehlo`` rc 1.
- infer (a float32 test64 checkpoint over the miniVOC test split with the
  VOC source, threshold 0.01): the ``.npy`` dumps within 1e-5 of the
  largest value of JAX's (``test_torch_serving_facade.py``'s float32
  bound), mAP and per-class AP within 1e-4, the Pascal summary rows equal
  where the detections are: >= 99 % of each side's rows have a twin with a
  score within 1e-5 and coordinates within one pixel (JAX's jitted decode
  truncates some clamped candidates' canvas corners a pixel below its
  op-by-op decode, which the port follows, and so moves a few NMS
  decisions near IoU 0.45: 3 of ~5,300 rows here, ROADMAP section 3);
  the COCO results rows likewise with the COCO source; ``--bundle`` with the shipped int8 bundle:
  the detections against JAX's at ``chip_smoke.py`` real_images' bounds
  (conf >= 0.1 matched both ways by class with IoU >= 0.95 and conf
  within 0.02).
- detect: the ``.txt`` dumps line by line against JAX's at those bounds,
  annotated images written.
- ``--data-parallel 1`` in one process runs as ``--data-parallel 0``; the
  CLIs default to ``cuda`` and raise without a card.
"""

import io
import json
import os
import pickle
import shutil
import sys
from contextlib import redirect_stdout
from pathlib import Path

import numpy as np
import pytest
import torch

cv2 = pytest.importorskip("cv2")

import jax  # noqa: E402

import ssd_tensorflow_tpu.cli.detect as jax_detect  # noqa: E402
import ssd_tensorflow_tpu.cli.export_model as jax_export  # noqa: E402
import ssd_tensorflow_tpu.cli.infer as jax_infer  # noqa: E402
import ssd_tensorflow_tpu.cli.process_dataset as jax_process  # noqa: E402
from ssd_tensorflow_tpu.eval.average_precision import APCalculator as JaxAP  # noqa: E402
from ssd_tensorflow_tpu.models import quantized as jq  # noqa: E402
from ssd_tensorflow_tpu.models import ssd_vgg as jax_ssd  # noqa: E402
import ssd_tensorflow_tpu_torch.cli.detect as port_detect  # noqa: E402
import ssd_tensorflow_tpu_torch.cli.export_model as port_export  # noqa: E402
import ssd_tensorflow_tpu_torch.cli.infer as port_infer  # noqa: E402
import ssd_tensorflow_tpu_torch.cli.process_dataset as port_process  # noqa: E402
import ssd_tensorflow_tpu_torch.cli.train as port_train  # noqa: E402
from ssd_tensorflow_tpu_torch import inference  # noqa: E402
from ssd_tensorflow_tpu_torch.models import ssd_vgg  # noqa: E402
from ssd_tensorflow_tpu_torch.parallel.train_step import TrainConfig, make_train_state  # noqa: E402
from ssd_tensorflow_tpu_torch.utils.checkpoint import save_checkpoint  # noqa: E402

ROOT = Path(__file__).resolve().parent.parent
sys.path.insert(0, str(ROOT))
sys.path.insert(0, str(ROOT / "tests"))
import chip_smoke  # noqa: E402
from test_coco_source import coco_dir  # noqa: E402,F401  (the COCO fixture tree)

MINIVOC = str(ROOT / "tests" / "fixtures" / "minivoc")
BUNDLE = str(ROOT / chip_smoke.INT8_BUNDLE)
JPEGS = [str(p) for p in sorted((ROOT / "tests" / "fixtures" / "minivoc" / "test").rglob("*.jpg"))]
VOC_NAMES = {0: "aeroplane", 1: "bicycle", 2: "bird"}
DET_FIELDS = ("boxes", "scores", "classes", "valid")


def _run(cli, argv):
    """``cli.main(argv)`` with its output captured: ``(rc, output)``."""
    buf = io.StringIO()
    with redirect_stdout(buf):
        rc = cli.main([str(a) for a in argv])
    return rc, buf.getvalue()


def _ok(cli, argv):
    rc, out = _run(cli, argv)
    assert rc == 0, out[-3000:]
    return out


def _checkpoint(path, dtype="float32", seed=0, num_classes=3, extra=None):
    """A test64 training checkpoint of seeded parameters (nonzero biases),
    written by the checkpoint writer both packages read."""
    cfg = ssd_vgg.ModelConfig(preset_name="test64", num_classes=num_classes, compute_dtype=dtype)
    params = ssd_vgg.init_params(cfg, seed=seed)
    rng = np.random.default_rng(seed + 100)
    for leaf in params.values():
        if "b" in leaf and leaf["b"].dim() == 1:
            leaf["b"] = torch.tensor(rng.normal(0, 0.3, leaf["b"].shape), dtype=torch.float32)
    state = make_train_state(params, TrainConfig(model=cfg), device="cpu")
    config = {"model": inference.model_config_to_dict(cfg), "epoch": 1,
              "lid2name": {str(k): v for k, v in VOC_NAMES.items()}, **(extra or {})}
    os.makedirs(os.path.dirname(path), exist_ok=True)
    save_checkpoint(str(path), state, config)
    return str(path)


def _npz(path):
    with np.load(path) as data:
        return {k: data[k] for k in data.files}


def _same_npz(got, want):
    a, b = _npz(got), _npz(want)
    assert sorted(a) == sorted(b)
    assert json.loads(bytes(a.pop("__meta__"))) == json.loads(bytes(b.pop("__meta__")))
    for k in a:
        assert a[k].dtype == b[k].dtype and np.array_equal(a[k], b[k]), k


def _tree(path):
    return {str(p.relative_to(path)): p.read_bytes() for p in sorted(Path(path).rglob("*"))
            if p.is_file()}


# ---------------------------------------------------------------------------
# process_dataset
# ---------------------------------------------------------------------------


def test_process_dataset_matches_jax_and_feeds_the_train_cli(tmp_path):
    data = tmp_path / "voc"
    data.mkdir()
    for split in ("trainval", "test"):
        os.symlink(os.path.join(MINIVOC, split), data / split)
    argv = ["--data-dir", data, "--preset", "test64", "--annotate", "yes",
            "--validation-fraction", "0.05"]
    _ok(jax_process, argv)
    outputs = ("train-samples.pkl", "valid-samples.pkl", "training-data.json")
    jax_out = {n: (data / n).read_bytes() for n in outputs}
    jax_annotated = _tree(data / "annotated")
    for n in outputs:
        (data / n).unlink()
    shutil.rmtree(data / "annotated")

    _ok(port_process, argv)
    assert (data / "training-data.json").read_bytes() == jax_out["training-data.json"]
    for n in ("train-samples.pkl", "valid-samples.pkl"):
        got = pickle.loads((data / n).read_bytes())
        want = pickle.loads(jax_out[n])
        assert got == want and len(got) > 0
        assert type(got[0]).__module__ == "ssd_tensorflow_tpu_torch.types"
    annotated = _tree(data / "annotated")
    assert annotated == jax_annotated and len(annotated) == 170

    rc, out = _run(port_train, ["--data-dir", data, "--name", tmp_path / "run", "--epochs", 1,
                                "--batch-size", 32, "--num-workers", 0, "--device", "cpu",
                                "--compute-dtype", "float32", "--tensorboard-dir",
                                tmp_path / "tb"])
    assert rc == 0, out[-3000:]
    assert "Epoch 1" in out and (tmp_path / "run" / "final.ckpt.npz").exists()
    shutil.rmtree(tmp_path / "run")


def test_process_dataset_unknown_source_fails(tmp_path):
    rc, out = _run(port_process, ["--data-source", "no_such_source", "--data-dir", tmp_path])
    assert rc == 1 and "Unable to load data source" in out


# ---------------------------------------------------------------------------
# export_model
# ---------------------------------------------------------------------------


def test_export_float_bundle_matches_jax(tmp_path):
    ckpt = _checkpoint(tmp_path / "run" / "e1.ckpt.npz", dtype="bfloat16")
    _ok(jax_export, ["--checkpoint-file", ckpt, "--output-file", tmp_path / "jax.npz"])
    _ok(port_export, ["--checkpoint-file", ckpt, "--output-file", tmp_path / "port.npz",
                      "--device", "cpu"])
    _same_npz(tmp_path / "port.npz", tmp_path / "jax.npz")


def test_export_quantize_matches_jax(tmp_path, capsys):
    ckpt = _checkpoint(tmp_path / "run" / "e1.ckpt.npz", seed=2)
    calib = JPEGS[:6]
    _ok(jax_export, ["--checkpoint-file", ckpt, "--output-file", tmp_path / "jax.npz",
                     "--quantize", "--calibration-images", *calib])
    _ok(port_export, ["--checkpoint-file", ckpt, "--output-file", tmp_path / "port.npz",
                      "--quantize", "--calibration-images", *calib, "--device", "cpu"])
    got, want = _npz(tmp_path / "port.npz"), _npz(tmp_path / "jax.npz")
    meta, jax_meta = json.loads(bytes(got.pop("__meta__"))), json.loads(bytes(want.pop("__meta__")))
    scales, jax_scales = meta.pop("act_scales"), jax_meta.pop("act_scales")
    assert meta == jax_meta and meta["format"].endswith("int8.v1")
    assert sorted(scales) == sorted(jax_scales)
    gaps = {k: abs(scales[k] - jax_scales[k]) / jax_scales[k] for k in scales}
    with capsys.disabled():
        print(f"\n[export --quantize] largest act_scales gap, relative: {max(gaps.values()):.3g} "
              f"({max(gaps, key=gaps.get)})")
    assert max(gaps.values()) <= 0.01
    for k in want:
        assert got[k].dtype == want[k].dtype and np.array_equal(got[k], want[k]), k


def test_export_quantize_without_images(tmp_path):
    ckpt = _checkpoint(tmp_path / "run" / "e1.ckpt.npz", seed=3)
    for cli, extra in ((jax_export, []), (port_export, ["--device", "cpu"])):
        rc, out = _run(cli, ["--checkpoint-file", ckpt, "--output-file", tmp_path / "x.npz",
                             "--quantize", *extra])
        assert rc == 1 and "--calibration-images" in out
        assert not (tmp_path / "x.npz").exists()
    _ok(jax_export, ["--checkpoint-file", ckpt, "--output-file", tmp_path / "jax.npz",
                     "--quantize", "--allow-noise-calibration"])
    _ok(port_export, ["--checkpoint-file", ckpt, "--output-file", tmp_path / "port.npz",
                      "--quantize", "--allow-noise-calibration", "--device", "cpu"])
    got = json.loads(bytes(_npz(tmp_path / "port.npz")["__meta__"]))["act_scales"]
    want = json.loads(bytes(_npz(tmp_path / "jax.npz")["__meta__"]))["act_scales"]
    assert sorted(got) == sorted(want)
    assert all(abs(got[k] - want[k]) <= 0.01 * want[k] for k in want)


def test_export_qat_checkpoint_keeps_its_scales(tmp_path):
    """A QAT checkpoint exports its stored scales with no images, in both."""
    jcfg = jax_ssd.ModelConfig(preset_name="test64", num_classes=3)
    stored = {k: 0.05 + 0.001 * i for i, k in enumerate(jq.calibrate_activation_scales(
        jax_ssd.init_params(jax.random.PRNGKey(0), jcfg),
        np.zeros((1, 64, 64, 3), np.uint8), jcfg))}
    ckpt = _checkpoint(tmp_path / "run" / "e1.ckpt.npz", seed=4,
                       extra={"qat_act_scales": stored})
    _ok(jax_export, ["--checkpoint-file", ckpt, "--output-file", tmp_path / "jax.npz",
                     "--quantize"])
    out = _ok(port_export, ["--checkpoint-file", ckpt, "--output-file", tmp_path / "port.npz",
                            "--quantize", "--device", "cpu"])
    assert "no recalibration" in out
    _same_npz(tmp_path / "port.npz", tmp_path / "jax.npz")
    assert json.loads(bytes(_npz(tmp_path / "port.npz")["__meta__"]))["act_scales"] == stored


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_torch_export_round_trip(tmp_path, dtype):
    ckpt = _checkpoint(tmp_path / "run" / "e1.ckpt.npz", dtype=dtype, seed=5)
    program_path = tmp_path / "model.pt2"
    _ok(port_export, ["--checkpoint-file", ckpt, "--output-file", tmp_path / "port.npz",
                      "--torch-export", program_path, "--torch-export-batch-size", 2,
                      "--device", "cpu"])
    program = torch.export.load(str(program_path))
    targets = {str(n.target) for n in program.graph.nodes if n.op == "call_function"}
    # the bf16 forward runs the stem kernel's operator, never its plain version
    assert ("ssd_torch.fused_stem.default" in targets) == (dtype == "bfloat16"), targets
    model = inference.InferenceModel.from_checkpoint(ckpt, device="cpu")
    images = torch.from_numpy(
        np.random.default_rng(5).integers(0, 256, (2, 64, 64, 3), dtype=np.uint8))
    got = program.module()(images)
    want = ssd_vgg.apply_result(model.params, images, model.config)
    assert got.shape == (2, model.preset.num_anchors, 8)
    if dtype == "bfloat16":
        torch.testing.assert_close(got, want, rtol=0, atol=0)
    else:
        torch.testing.assert_close(got, want, rtol=0, atol=1e-5)
    with pytest.raises(Exception):
        program.module()(images[:1])  # the batch is baked in


def test_stablehlo_is_refused(tmp_path):
    ckpt = _checkpoint(tmp_path / "run" / "e1.ckpt.npz")
    rc, out = _run(port_export, ["--checkpoint-file", ckpt, "--output-file", tmp_path / "p.npz",
                                 "--stablehlo", tmp_path / "m.hlo", "--device", "cpu"])
    assert rc == 1 and "--torch-export" in out and not (tmp_path / "p.npz").exists()


# ---------------------------------------------------------------------------
# infer
# ---------------------------------------------------------------------------


class RecordingAP(JaxAP):
    """The JAX CLI's AP calculator, keeping what ``compute_aps`` returned."""

    last = None

    def compute_aps(self):
        RecordingAP.last = super().compute_aps()
        return RecordingAP.last


def _port_ap(monkeypatch):
    from ssd_tensorflow_tpu_torch.eval.average_precision import APCalculator

    class PortAP(APCalculator):
        last = None

        def compute_aps(self):
            PortAP.last = super().compute_aps()
            return PortAP.last

    monkeypatch.setattr(port_infer, "APCalculator", PortAP)
    monkeypatch.setattr(jax_infer, "APCalculator", RecordingAP)
    return PortAP


def _summary_rows(directory):
    """``{class file: [(fileid, conf, left, top, right, bottom)]}``."""
    out = {}
    for p in sorted(Path(directory).glob("comp4_det_test_*.txt")):
        out[p.name] = [(f[0], *map(float, f[1:])) for f in
                       (line.split() for line in p.read_text().splitlines())]
    return out


def _unmatched(got, want, score_tol, box_tol):
    """Rows of ``got`` ``(key, score, *coordinates)`` with no unused row of
    ``want`` of the same key, a score within ``score_tol`` and coordinates
    within ``box_tol``."""
    used, missing = set(), []
    for g in got:
        hit = next((i for i, w in enumerate(want) if i not in used and w[0] == g[0]
                    and abs(w[1] - g[1]) <= score_tol
                    and max(abs(a - b) for a, b in zip(w[2:], g[2:])) <= box_tol), None)
        if hit is None:
            missing.append(g)
        else:
            used.add(hit)
    return missing


def _rows_agree(got, want, score_tol=1e-5, box_tol=1.0, share=0.99):
    """Where the detections are equal, so are the rows: at least ``share``
    of each side's rows have their twin on the other side (an NMS decision
    near IoU 0.45 that JAX's jitted corner truncation moves, see the module
    doc, or a near-tie that a 1e-6 difference moves into or out of an
    image's top 200, with a random model's many near-equal scores at
    threshold 0.01)."""
    for a, b in ((got, want), (want, got)):
        assert len(_unmatched(a, b, score_tol, box_tol)) <= (1 - share) * len(a)


def test_infer_matches_jax(tmp_path, monkeypatch):
    PortAP = _port_ap(monkeypatch)
    _checkpoint(tmp_path / "run" / "e1.ckpt.npz", seed=6)
    common = ["--name", tmp_path / "run", "--data-source", "pascal_voc", "--data-dir", MINIVOC,
              "--threshold", "0.01", "--batch-size", 8, "--dump-predictions", "yes",
              "--pascal-summary", "yes", "--coco-results", "yes", "--annotate", "yes",
              "--training-data", tmp_path / "none.json"]
    _ok(jax_infer, common + ["--output-dir", tmp_path / "jax"])
    _ok(port_infer, common + ["--output-dir", tmp_path / "port", "--device", "cpu"])

    # the raw predictions
    dumps = sorted(p.name for p in (tmp_path / "jax").glob("*.npy"))
    assert len(dumps) == 30 and dumps == sorted(p.name for p in (tmp_path / "port").glob("*.npy"))
    for name in dumps:
        got, want = np.load(tmp_path / "port" / name), np.load(tmp_path / "jax" / name)
        assert got.shape == want.shape == (372, 8) and got.dtype == np.float32
        np.testing.assert_allclose(got, want, rtol=0, atol=1e-5 * max(1.0, np.abs(want).max()))

    # mAP and per-class AP
    got, want = PortAP.last, RecordingAP.last
    assert sorted(got) == sorted(want) and len(want) >= 1
    for k in want:
        assert abs(got[k] - want[k]) <= 1e-4, k

    # the Pascal summary and COCO results: the same rows, scores within 1e-5,
    # boxes within one canvas pixel in image pixels (the images are <= 500 wide)
    got, want = _summary_rows(tmp_path / "port"), _summary_rows(tmp_path / "jax")
    assert sorted(got) == sorted(want) and sum(map(len, want.values())) > 0
    for name in want:
        _rows_agree(got[name], want[name])
    # the VOC source maps no label to a COCO category id: both write an
    # empty results list (test_infer_coco_results_match_jax holds the rows)
    got = json.loads((tmp_path / "port" / "coco_results.json").read_text())
    want = json.loads((tmp_path / "jax" / "coco_results.json").read_text())
    assert got == want == []
    # annotated images, one per file
    assert sorted(p.name for p in (tmp_path / "port").glob("*.jpg")) == \
        sorted(p.name for p in (tmp_path / "jax").glob("*.jpg"))
    shutil.rmtree(tmp_path / "run")


def test_infer_coco_results_match_jax(tmp_path, coco_dir):  # noqa: F811
    """With the COCO source, the results JSON carries its image and category
    ids: the rows of both CLIs agree as the Pascal summary's do."""
    names = {0: "person", 1: "dog", 2: "car"}
    ckpt = _checkpoint(tmp_path / "run" / "e1.ckpt.npz", seed=7)
    with np.load(ckpt) as data:
        arrays = {k: data[k] for k in data.files}
    meta = json.loads(bytes(arrays["__meta__"]))
    meta["config"]["lid2name"] = {str(k): v for k, v in names.items()}
    arrays["__meta__"] = np.frombuffer(json.dumps(meta).encode(), dtype=np.uint8)
    np.savez(ckpt, **arrays)
    common = ["--name", tmp_path / "run", "--data-source", "coco", "--data-dir", coco_dir,
              "--sample", "trainval", "--threshold", "0.01", "--batch-size", 4,
              "--coco-results", "yes", "--training-data", tmp_path / "none.json"]
    _ok(jax_infer, common + ["--output-dir", tmp_path / "jax"])
    _ok(port_infer, common + ["--output-dir", tmp_path / "port", "--device", "cpu"])
    got = json.loads((tmp_path / "port" / "coco_results.json").read_text())
    want = json.loads((tmp_path / "jax" / "coco_results.json").read_text())
    assert len(want) > 0 and {r["category_id"] for r in want} <= {1, 18, 3}
    _rows_agree([((r["image_id"], r["category_id"]), r["score"], *r["bbox"]) for r in got],
                [((r["image_id"], r["category_id"]), r["score"], *r["bbox"]) for r in want])
    shutil.rmtree(tmp_path / "run")


def _iou(a, b):
    lo, hi = np.maximum(a[:2], b[:2]), np.minimum(a[2:], b[2:])
    inter = np.prod(np.clip(hi - lo, 0, None))
    return inter / (np.prod(a[2:] - a[:2]) + np.prod(b[2:] - b[:2]) - inter)


def _matched(a, b, min_score=0.1, min_iou=0.95, score_tol=0.02):
    """The detections ``(image, class, conf, corners)`` of ``a`` of conf >=
    ``min_score`` with none in ``b`` of the same image and class, IoU >=
    ``min_iou`` and conf within ``score_tol``."""
    missing = []
    for img, cls, conf, box in a:
        if conf < min_score:
            continue
        if not any(i == img and c == cls and abs(s - conf) <= score_tol
                   and _iou(np.array(box), np.array(bx)) >= min_iou for i, c, s, bx in b):
            missing.append((img, cls, conf))
    return missing


def _summary_detections(directory):
    return [(r[0], name, r[1], r[2:]) for name, rows in _summary_rows(directory).items()
            for r in rows]


def test_infer_bundle_matches_jax(tmp_path):
    common = [*JPEGS[:2], "--bundle", BUNDLE, "--batch-size", 2, "--pascal-summary", "yes",
              "--threshold", "0.01"]
    _ok(jax_infer, common + ["--output-dir", tmp_path / "jax"])
    _ok(port_infer, common + ["--output-dir", tmp_path / "port", "--device", "cpu"])
    got, want = _summary_detections(tmp_path / "port"), _summary_detections(tmp_path / "jax")
    assert sum(1 for d in want if d[2] >= 0.1) >= 2
    assert _matched(want, got) == [] and _matched(got, want) == []


# ---------------------------------------------------------------------------
# detect
# ---------------------------------------------------------------------------


def _txt_detections(directory):
    """``(image, label, 1.0, corners)`` of every ``.txt`` dump line (the
    format carries no score: all are matched)."""
    out = []
    for p in sorted(Path(directory).glob("*.txt")):
        for line in p.read_text().splitlines():
            label, _, cx, cy, w, h = line.split()
            cx, cy, w, h = map(float, (cx, cy, w, h))
            out.append((p.name, label, 1.0, [cx - w / 2, cy - h / 2, cx + w / 2, cy + h / 2]))
    return out


def test_detect_matches_jax(tmp_path):
    common = [*JPEGS[:2], "--model", BUNDLE, "--batch-size", 2, "--threshold", "0.1"]
    _ok(jax_detect, common + ["--output-dir", tmp_path / "jax"])
    out = _ok(port_detect, common + ["--output-dir", tmp_path / "port", "--device", "cpu"])
    assert out.count("detections") == 2
    got, want = _txt_detections(tmp_path / "port"), _txt_detections(tmp_path / "jax")
    assert len(got) == len(want) >= 2
    for a, b in ((want, got), (got, want)):
        assert _matched(a, b, min_score=0.0, score_tol=1.0) == []
    # line by line: the same labels in the same (score) order
    for name in {d[0] for d in want}:
        assert [d[1] for d in got if d[0] == name] == [d[1] for d in want if d[0] == name]
    for jpeg in JPEGS[:2]:
        img = cv2.imread(str(tmp_path / "port" / os.path.basename(jpeg)))
        assert img is not None and img.shape == cv2.imread(jpeg).shape


# ---------------------------------------------------------------------------
# refusals and defaults
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("cli,argv", [
    (port_infer, [JPEGS[0], "--bundle", BUNDLE]),
    (port_detect, [JPEGS[0], "--model", BUNDLE]),
])
def test_data_parallel_is_left_for_item_12(cli, argv, tmp_path):
    """``--data-parallel 1`` without a launch is one device, as the JAX
    CLIs' one-device mesh: rc 0 and the files of ``--data-parallel 0``
    (2 ranks: ``tests/test_torch_multichip.py``)."""
    extra = ["--annotate", "true"] if cli is port_infer else []
    outs = []
    # on 2 threads: with more, the first torch.exp of a process was seen
    # 1e-4 off on some runs, which would tell the two runs apart
    threads = torch.get_num_threads()
    torch.set_num_threads(2)
    try:
        for n in (0, 1):
            out_dir = tmp_path / str(n)
            rc, out = _run(cli, argv + extra + ["--data-parallel", n, "--device", "cpu",
                                                "--batch-size", 1, "--output-dir", out_dir])
            assert rc == 0, out[-3000:]
            assert ("Data-parallel mesh" in out) == (n == 1)
            outs.append(_tree(out_dir))
    finally:
        torch.set_num_threads(threads)
    assert outs[0] == outs[1] and outs[0]


def test_serving_clis_default_to_cuda(tmp_path):
    if torch.cuda.is_available():
        pytest.skip("a GPU is present; the no-CUDA error cannot occur")
    ckpt = _checkpoint(tmp_path / "run" / "e1.ckpt.npz")
    for cli, argv in ((port_infer, [JPEGS[0], "--bundle", BUNDLE]),
                      (port_detect, [JPEGS[0], "--model", BUNDLE]),
                      (port_export, ["--checkpoint-file", ckpt, "--output-file",
                                     tmp_path / "b.npz"])):
        with pytest.raises(RuntimeError, match="cuda"):
            _run(cli, argv)
