"""The façade pieces of the serving and evaluation CLIs against the JAX
package's, on the CPU, test64 (K = 3):

- ``InferenceModel.preprocess_files`` and ``load_calibration_images`` on
  miniVOC JPEGs of three sizes: the uint8 batch and the sizes bit for bit.
- ``InferenceModel.run``: the raw ``(B, A, K+5)`` result against JAX's
  ``run`` on the same weights and images: float32 within 1e-5 of the
  largest magnitude of the probabilities (1) and of the offsets (~1.3
  here; the largest gap found, 1.0014e-5, is on an offset); bf16 (the
  JAX side with its Pallas stem in interpret mode) within
  ``tests/test_torch_slice.py``'s bounds (probabilities within 0.01,
  argmax class on >= 99.5 % of anchors, offsets within 0.04); int8 within
  ``tests/test_torch_quantized.py``'s (0.02, 99 %, 0.05). Its
  ``Detections`` equal ``postprocess.detect`` of its result, and that
  decode equals the JAX package's ``detect`` on the same result: scores,
  classes and the valid mask bit for bit, boxes within 1e-6 (the port's
  decode rounds ``exp`` once from float64, XLA's float32 ``exp`` is not
  correctly rounded: an ulp apart, ROADMAP.md section 3). In float32
  its detections are JAX's rows, scores within 1e-5 and boxes within one
  pixel of the 1000-pixel canvas.
"""

from pathlib import Path

import jax
import numpy as np
import pytest
import torch

pytest.importorskip("cv2")

from ssd_tensorflow_tpu import inference as jax_inference  # noqa: E402
from ssd_tensorflow_tpu.models import quantized as jq  # noqa: E402
from ssd_tensorflow_tpu.models import ssd_vgg as jax_ssd  # noqa: E402
from ssd_tensorflow_tpu.ops import postprocess as jax_post  # noqa: E402
from ssd_tensorflow_tpu_torch import inference  # noqa: E402
from ssd_tensorflow_tpu_torch.models import ssd_vgg  # noqa: E402
from ssd_tensorflow_tpu_torch.ops import postprocess  # noqa: E402
from ssd_tensorflow_tpu_torch.weights import params_from_jax, qparams_from_jax  # noqa: E402

ROOT = Path(__file__).resolve().parent
JPEGS = sorted((ROOT / "fixtures" / "minivoc").rglob("*.jpg"))
DET_FIELDS = ("boxes", "scores", "classes", "valid")
CFG = dict(preset_name="test64", num_classes=3)


def _jpegs_of_three_widths():
    import cv2

    picked, seen = [], set()
    for p in JPEGS:
        w = cv2.imread(str(p)).shape[1]
        if w not in seen:
            seen.add(w)
            picked.append(str(p))
        if len(seen) == 3:
            return picked
    raise AssertionError(f"fixture widths: {seen}")


@pytest.fixture(scope="module")
def files():
    return _jpegs_of_three_widths() + [str(p) for p in JPEGS[:3]]


@pytest.mark.parametrize("preset", ["test64", "vgg300"])
def test_preprocess_files_matches_jax(files, preset):
    jcfg = jax_ssd.ModelConfig(preset_name=preset, num_classes=3, compute_dtype="float32")
    jm = jax_inference.InferenceModel(jax_ssd.init_params(jax.random.PRNGKey(0), jcfg), jcfg)
    cfg = ssd_vgg.ModelConfig(preset_name=preset, num_classes=3, compute_dtype="float32")
    tm = inference.InferenceModel(ssd_vgg.init_params(cfg), cfg, device="cpu")
    want, want_sizes = jm.preprocess_files(files)
    got, sizes = tm.preprocess_files(files)
    assert got.dtype == np.uint8 and got.shape == want.shape
    np.testing.assert_array_equal(got, want)
    assert sizes == want_sizes and len(set(sizes)) >= 3
    with pytest.raises(FileNotFoundError):
        tm.preprocess_files([str(ROOT / "no_such.jpg")])


@pytest.mark.parametrize("hw", [(64, 64), (300, 500)])
def test_load_calibration_images_matches_jax(files, hw):
    got = inference.load_calibration_images(files, *hw)
    np.testing.assert_array_equal(got, jax_inference.load_calibration_images(files, *hw))
    with pytest.raises(ValueError, match="no calibration"):
        inference.load_calibration_images([], *hw)
    with pytest.raises(ValueError, match="cannot read"):
        inference.load_calibration_images([str(ROOT / "no_such.jpg")], *hw)


def _params(seed):
    """JAX test64 params with seeded nonzero biases (init gives zeros)."""
    jcfg = jax_ssd.ModelConfig(**CFG)
    jp = jax_ssd.init_params(jax.random.PRNGKey(seed), jcfg)
    rng = np.random.default_rng(50 + seed)
    for name, leaf in jp.items():
        if "w" in leaf:
            jp[name] = dict(leaf, b=rng.normal(0, 0.3, leaf["b"].shape).astype(np.float32))
    return jp


def _models(kind, seed=3):
    """``(JAX InferenceModel, port InferenceModel, images)`` of one kind."""
    jp = _params(seed)
    img = np.random.default_rng(seed).integers(0, 256, (3, 64, 64, 3), dtype=np.uint8)
    det = dict(top_k=200, confidence_threshold=0.01)
    if kind == "int8":
        jcfg = jax_ssd.ModelConfig(**CFG)
        scales = jq.calibrate_activation_scales(jp, img, jcfg)
        jqp = jq.quantize_weights(jp)
        jm = jax_inference.InferenceModel(jqp, jcfg, act_scales=scales,
                                          detection=jax_post.DetectionConfig(**det))
        tm = inference.InferenceModel(qparams_from_jax(jqp), ssd_vgg.ModelConfig(**CFG),
                                      act_scales=scales, device="cpu",
                                      detection=postprocess.DetectionConfig(**det))
        return jm, tm, img
    jcfg = jax_ssd.ModelConfig(**CFG, compute_dtype=kind)
    overrides = {"pallas_stem": True} if kind == "bfloat16" else None
    jm = jax_inference.InferenceModel(jp, jcfg, overrides=overrides,
                                      detection=jax_post.DetectionConfig(**det))
    tm = inference.InferenceModel(params_from_jax(jp), ssd_vgg.ModelConfig(**CFG, compute_dtype=kind),
                                  device="cpu", detection=postprocess.DetectionConfig(**det))
    return jm, tm, img


#: (probabilities, argmax share, offsets) bounds of the raw result, by kind
RESULT_BOUNDS = {"float32": (1e-5, 1.0, 1e-5), "bfloat16": (0.01, 0.995, 0.04),
                 "int8": (0.02, 0.99, 0.05)}


@pytest.mark.parametrize("kind", list(RESULT_BOUNDS))
def test_run_matches_jax(kind):
    jm, tm, img = _models(kind)
    want, jdets = jm.run(img)
    want = np.asarray(want)
    result, dets = tm.run(img)
    got = result.numpy()
    assert got.shape == want.shape == (3, tm.preset.num_anchors, 8) and got.dtype == np.float32
    k = tm.config.num_classes + 1
    prob_tol, share, loc_tol = RESULT_BOUNDS[kind]
    assert float(np.abs(got[..., :k] - want[..., :k]).max()) <= prob_tol
    assert float(np.mean(got[..., :k].argmax(-1) == want[..., :k].argmax(-1))) >= share
    loc_scale = max(1.0, float(np.abs(want[..., k:]).max())) if kind == "float32" else 1.0
    assert float(np.abs(got[..., k:] - want[..., k:]).max()) <= loc_tol * loc_scale

    # the detections are the decode of the returned result, as JAX's
    again = postprocess.detect(result, tm.anchors, tm.detection)
    jax_again = jax_post.detect(got, jax.numpy.asarray(tm.anchors.numpy()), jm.detection)
    for f in DET_FIELDS:
        torch.testing.assert_close(getattr(dets, f), getattr(again, f), rtol=0, atol=0)
        np.testing.assert_allclose(getattr(dets, f).numpy(), np.asarray(getattr(jax_again, f)),
                                   rtol=0, atol=1e-6 if f == "boxes" else 0)
    assert int(dets.valid.sum()) > 0
    if kind == "float32":
        # JAX's own detections: the same rows, scores within 1e-5, boxes within
        # one pixel of the 1000-pixel canvas that the decode truncates them to
        # (a 1e-6 offset moves a corner across a pixel edge)
        for f, atol in zip(DET_FIELDS, (1e-3 + 1e-6, 1e-5, 0, 0)):
            np.testing.assert_allclose(getattr(dets, f).numpy(), np.asarray(getattr(jdets, f)),
                                       rtol=0, atol=atol)


def test_run_accepts_tensors_and_matches_run_scores():
    """``run`` takes a uint8 tensor as ``run_scores`` does; on the float32
    model the result path's detections are the scores path's."""
    _, tm, img = _models("float32", seed=4)
    _, dets = tm.run(torch.from_numpy(img))
    scores = tm.run_scores(img)
    for f in DET_FIELDS:
        torch.testing.assert_close(getattr(dets, f), getattr(scores, f), rtol=0, atol=1e-6)
