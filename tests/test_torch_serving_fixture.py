"""The card's serving-phase fixture, ``tests/torch_fixtures/serving_images.npz``
(``chip_smoke.py`` phase serving_cli): 8 miniVOC test images decoded and
resized to 512 x 512 by the JAX package's ``preprocess_files``, with their
sizes; the shipped vgg512 int8 bundle's detections on them at threshold
0.01 through the JAX package's ``run_scores`` (what detect runs) and
``run`` (what infer runs with ``--dump-predictions``), the latter's AP per
class against the images' annotations; the activation scales the JAX
package's calibration gives on them for seeded vgg512 parameters. The file
must equal a fresh JAX run, and the port's image I/O on the CPU must give
its images: the card, which may have no OpenCV, is handed them in place of
a decode. ``python tests/test_torch_serving_fixture.py`` rewrites it.
"""

import os
import sys
from pathlib import Path

import jax
import numpy as np
import pytest

pytest.importorskip("cv2")

from ssd_tensorflow_tpu import inference as jax_inference  # noqa: E402
from ssd_tensorflow_tpu.data.sources import load_data_source as jax_source  # noqa: E402
from ssd_tensorflow_tpu.eval.average_precision import APCalculator as JaxAP  # noqa: E402
from ssd_tensorflow_tpu.models import quantized as jq  # noqa: E402
from ssd_tensorflow_tpu.models import ssd_vgg as jax_ssd  # noqa: E402
from ssd_tensorflow_tpu.ops.postprocess import DetectionConfig as JaxDetectionConfig  # noqa: E402
from ssd_tensorflow_tpu.ops.postprocess import detections_to_boxes as jax_to_boxes  # noqa: E402
from ssd_tensorflow_tpu_torch import inference  # noqa: E402
from ssd_tensorflow_tpu_torch.models import ssd_vgg  # noqa: E402
from ssd_tensorflow_tpu_torch.weights import params_to_jax  # noqa: E402

ROOT = Path(__file__).resolve().parent.parent
sys.path.insert(0, str(ROOT))
import chip_smoke  # noqa: E402

BUNDLE = str(ROOT / chip_smoke.INT8_BUNDLE)
FIXTURE = ROOT / chip_smoke.SERVING_IMAGES
DET_FIELDS = ("boxes", "scores", "classes", "valid")
#: the seed of the vgg512 parameters the card's export calibrates
CALIBRATION_SEED = chip_smoke.SERVING_SEED


def serving_fixture_arrays(tmp: Path) -> dict:
    """The serving phase's inputs and the JAX package's results on them:
    the miniVOC images decoded and resized to 512 x 512 by JAX's
    ``preprocess_files`` with their sizes; the shipped vgg512 int8 bundle's
    detections at threshold 0.01 by ``run_scores`` (what detect runs) and
    by ``run`` (what infer with ``--dump-predictions`` runs), the latter's
    per-class AP and mAP against the images' annotations; the activation
    scales JAX's calibration gives on them for vgg512 bf16 parameters made
    by the port's ``init_params`` from ``CALIBRATION_SEED``."""
    names = chip_smoke.serving_names(ROOT)
    data_dir = chip_smoke.staged_voc_dir(ROOT, tmp, names)
    jm = jax_inference.InferenceModel.from_bundle(
        BUNDLE, detection=JaxDetectionConfig(top_k=200, confidence_threshold=0.01))
    files = [str(Path(data_dir) / "test" / "VOCdevkit" / "VOC2012" / "JPEGImages" / f"{n}.jpg")
             for n in names]
    images, sizes = jm.preprocess_files(files)
    out = {"names": np.array(names), "images": images, "sizes": np.array(sizes, np.int32)}
    scores = jm._run_scores(jm.params, jm._to_device(images))
    _, dets = jm.run(images)
    for prefix, d in (("detect", scores), ("infer", dets)):
        for f in DET_FIELDS:
            out[f"{prefix}_{f}"] = np.asarray(getattr(d, f))
    src = jax_source("pascal_voc")
    src.load_test_data(data_dir)
    gt = {os.path.basename(s.filename): s.boxes for s in src.test_samples}
    ap = JaxAP()
    for name, boxes in zip(names, jax_to_boxes(dets, jm.lid2name)):
        ap.add_detections(gt[f"{name}.jpg"], boxes)
    aps = ap.compute_aps()
    out["ap_names"] = np.array(sorted(aps))
    out["ap_values"] = np.array([aps[k] for k in sorted(aps)], np.float64)
    cfg = ssd_vgg.ModelConfig(preset_name="vgg512", num_classes=20)
    jp = params_to_jax(ssd_vgg.init_params(cfg, seed=CALIBRATION_SEED))
    scales = jq.calibrate_activation_scales(
        jp, images, jax_ssd.ModelConfig(preset_name="vgg512", num_classes=20))
    out["calibration_names"] = np.array(sorted(scales))
    out["calibration_scales"] = np.array([scales[k] for k in sorted(scales)], np.float64)
    return out


def test_serving_fixture_is_the_jax_packages(tmp_path):
    with np.load(FIXTURE) as data:
        fixture = {k: data[k] for k in data.files}
    want = serving_fixture_arrays(tmp_path)
    assert sorted(fixture) == sorted(want)
    for k, v in want.items():
        assert fixture[k].dtype == v.dtype and fixture[k].shape == v.shape, k
        np.testing.assert_array_equal(fixture[k], v, err_msg=k)
    assert fixture["images"].shape == (chip_smoke.SERVING_COUNT, 512, 512, 3)
    assert list(fixture["names"][:2]) == ["009000", "009001"]
    # the two real_images JPEGs lead it, decoded alike
    with np.load(ROOT / chip_smoke.REAL_IMAGES) as data:
        np.testing.assert_array_equal(fixture["images"][:2], data["images_512"])
    assert os.path.getsize(FIXTURE) < 6 * 2**20


def test_port_image_io_gives_the_fixture_images(tmp_path):
    """What the card's serving phase stages in place of ``data/image_io``
    (decode + resize) is what the port's own image I/O gives on the CPU."""
    with np.load(FIXTURE) as data:
        names, images, sizes = data["names"], data["images"], data["sizes"]
    files = [str(ROOT / chip_smoke.MINIVOC_TEST / "JPEGImages" / f"{n}.jpg") for n in names]
    model = inference.InferenceModel.from_bundle(BUNDLE, device="cpu")
    got, got_sizes = model.preprocess_files(files)
    np.testing.assert_array_equal(got, images)
    assert got_sizes == [tuple(s) for s in sizes.tolist()]
    np.testing.assert_array_equal(inference.load_calibration_images(files, 512, 512), images)



def test_staged_image_io_hands_out_the_fixture_images(tmp_path):
    """``chip_smoke.StagedImageIO``, which the card's serving phase puts in
    place of ``data/image_io``: through the port's ``preprocess_files`` it
    gives the fixture's pixels and each file's own size, in any order;
    another size or file raises; writing and drawing only record."""
    from ssd_tensorflow_tpu_torch.data import image_io

    with np.load(FIXTURE) as data:
        names, images, sizes = data["names"], data["images"], data["sizes"]
    staged = chip_smoke.StagedImageIO(names, images, sizes)
    files = [str(tmp_path / f"{n}.jpg") for n in names]
    order = [3, 0, 7, 7, 1]
    model = inference.InferenceModel.from_bundle(BUNDLE, device="cpu")
    with staged.patched():
        got, got_sizes = model.preprocess_files([files[i] for i in order])
        img = image_io.imread(files[2])
        with pytest.raises(AssertionError):
            image_io.resize(img, (64, 64))
        with pytest.raises(AssertionError):
            image_io.imread(str(tmp_path / "other.jpg"))
        image_io.draw_box(img, None, (0, 255, 0))
        assert image_io.imwrite(str(tmp_path / "x.jpg"), img)
    np.testing.assert_array_equal(got, images[order])
    assert got_sizes == [tuple(sizes[i]) for i in order]
    assert img.shape == (sizes[2][1], sizes[2][0], 3)
    assert staged.reads == 6 and staged.boxes == 1 and not (tmp_path / "x.jpg").exists()
    assert staged.writes == [(str(tmp_path / "x.jpg"), img.shape)]

if __name__ == "__main__":
    import tempfile

    jax.config.update("jax_platforms", "cpu")
    FIXTURE.parent.mkdir(exist_ok=True)
    with tempfile.TemporaryDirectory() as tmp:
        np.savez_compressed(FIXTURE, **serving_fixture_arrays(Path(tmp)))
    print(f"wrote {FIXTURE} ({os.path.getsize(FIXTURE)} bytes)")
