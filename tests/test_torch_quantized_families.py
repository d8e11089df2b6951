"""The port's int8 path of the ResNet-34 and MobileNetV1 families, and its
percentile calibration, against the JAX package's ``models/quantized.py``
on the CPU.

Exact: ``quantize_weights_folded`` bit for bit; ``_qconv_folded``'s
quantized input, integer sums and requantized output; the first conv's
calibrated maxima (its input is the preprocessed image).

Within float32 rounding: the other calibrated maxima, within 1e-5 of each
layer's largest (float32 forwards summed in other orders; found 2.3e-6),
and chunked against whole likewise (oneDNN's float32 convolutions sum in
an order that depends on the batch; found 2.3e-6). ``percentile_of`` against ``jnp.percentile``:
within one float32 ulp of the result, per tensor, per channel and over
more than 2^24 elements.

The int8 forwards: the families normalize with GroupNorm between int8
convs, so a GroupNorm output that two float32 computations round to
different bf16 values moves the next quantized input by a step, and the
scores drift as they do between two compilations of the JAX package's
own forward (jit against op by op on the shipped bundles: conf 0.028 /
0.030, argmax 99.4 / 98.7 %, locs 0.063 / 0.10; ROADMAP.md section 3).
``test_family_int8_drift_is_the_group_norms`` isolates that cause: with
JAX's GroupNorm outputs handed to the port, every other step matches JAX
bit for bit and the scores within 1e-6. Bounds of the whole forwards:
conf within 0.05, argmax on >= 98 % of the anchors, locs within 0.15 of
the JAX package's; on the fixture JPEGs the same detection counts, and
detections matched both ways (each detection of conf >= 0.1 has one of
the same class with IoU >= 0.95 and conf within 0.02 on the other side).

``tests/torch_fixtures/bundle_detections.npz`` holds the first two
miniVOC test JPEGs decoded and resized by the JAX package's
``InferenceModel.preprocess_files`` (512x512 and 320x320) and the JAX
package's int8 ``run_scores`` detections of the three shipped bundles on
them; ``chip_smoke.py`` holds the card to it. Write it with
``python tests/test_torch_quantized_families.py``; a test recomputes it and
requires every array to equal the committed file.
"""

import json
import os
import subprocess
import sys
from pathlib import Path
from unittest import mock

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from ssd_tensorflow_tpu import inference as jax_inference
from ssd_tensorflow_tpu.models import mobilenet as jax_mobilenet
from ssd_tensorflow_tpu.models import quantized as jq
from ssd_tensorflow_tpu.models import resnet as jax_resnet
from ssd_tensorflow_tpu.ops import postprocess as jax_post
from ssd_tensorflow_tpu.ops.anchors import anchors_for_preset
from ssd_tensorflow_tpu_torch import inference
from ssd_tensorflow_tpu_torch.models import mobilenet, resnet
from ssd_tensorflow_tpu_torch.models import quantized as tq
from ssd_tensorflow_tpu_torch.ops import postprocess
from ssd_tensorflow_tpu_torch.weights import (
    params_from_jax,
    qparams_from_jax,
    qparams_to_jax,
    stage_qparams,
)

import torch_family_checks as fc

ROOT = Path(__file__).resolve().parent.parent
ASSETS = ROOT / "assets"
JPEGS = sorted((ROOT / "tests" / "fixtures" / "minivoc" / "test").rglob("*.jpg"))[:2]
FIXTURE = ROOT / "tests" / "torch_fixtures" / "bundle_detections.npz"
#: the shipped bundles, by the name the fixture file gives them
BUNDLES = {"vgg512": "vgg512_int8_minivoc.ssdtpu.npz",
           "resnet320": "resnet320_int8_minicoco.ssdtpu.npz",
           "mobilenet320": "mobilenet320_int8_qat_minivoc.ssdtpu.npz"}
FAMILY_PRESETS = ["rtest64", "mntest64"]
DET_FIELDS = ("boxes", "scores", "classes", "valid")


def bundle_detection_arrays() -> dict:
    """The fixture file's arrays, from the JPEGs and the JAX package."""
    out = {}
    for name, fname in BUNDLES.items():
        jm = jax_inference.InferenceModel.from_bundle(str(ASSETS / fname))
        images, _ = jm.preprocess_files([str(p) for p in JPEGS])
        out.setdefault(f"images_{images.shape[1]}", images)
        dets = jm._run_scores(jm.params, jm._to_device(images))
        for field in DET_FIELDS:
            out[f"{name}_{field}"] = np.asarray(getattr(dets, field))
    return out


def _setup(preset):
    jp = fc.jax_params(preset)
    jcfg, tcfg = fc.configs(preset, "bfloat16")
    return jp, jcfg, tcfg, fc.images(5, 4)


@pytest.fixture(scope="module", params=FAMILY_PRESETS)
def family(request):
    jp, jcfg, tcfg, img = _setup(request.param)
    return jp, jcfg, tcfg, img, jq.calibrate_activation_amax(jp, img, jcfg)


def _as_numpy(tree):
    return {n: {k: np.asarray(v) for k, v in d.items()} for n, d in tree.items()}


@pytest.mark.parametrize("calibrated", [False, True], ids=["unit", "calibrated"])
def test_quantize_weights_folded_bit_for_bit(family, calibrated):
    jp, _, _, _, amax = family
    amax = amax if calibrated else None
    want = _as_numpy(jq.quantize_weights_folded(jp, amax))
    got = qparams_to_jax(tq.quantize_weights_folded(params_from_jax(jp), amax))
    assert set(got) == set(want)
    for name in want:
        assert set(got[name]) == set(want[name]), name
        for key in want[name]:
            assert got[name][key].dtype == want[name][key].dtype, (name, key)
            np.testing.assert_array_equal(got[name][key], want[name][key], err_msg=f"{name}/{key}")
    assert not any("a_scale" in d for n, d in got.items() if n.endswith("_dw"))


def test_calibrate_activation_amax_matches_jax_and_chunks(family):
    jp, _, tcfg, img, amax = family
    params = params_from_jax(jp)
    whole = tq.calibrate_activation_amax(params, torch.from_numpy(img), tcfg, batch_size=4)
    chunked = tq.calibrate_activation_amax(params, torch.from_numpy(img), tcfg, batch_size=3)
    assert set(whole) == set(chunked) == set(amax)
    assert not any(k.endswith("_dw") for k in whole)
    np.testing.assert_array_equal(whole["stem_conv"], amax["stem_conv"])
    for k in amax:
        assert whole[k].dtype == np.float32 and whole[k].shape == amax[k].shape, k
        assert fc.rel(whole[k], amax[k]) <= 1e-5, k
        assert fc.rel(chunked[k], whole[k]) <= 1e-5, k


def test_percentile_family_calibration_matches_jax(family):
    """A sub-100 percentile runs the calibration set as one chunk, per
    channel over all of a conv input's values."""
    jp, jcfg, tcfg, img, _ = family
    want = jq.calibrate_activation_amax(jp, img, jcfg, percentile=99.9)
    got = tq.calibrate_activation_amax(params_from_jax(jp), torch.from_numpy(img), tcfg,
                                       percentile=99.9, batch_size=1)
    np.testing.assert_array_equal(got["stem_conv"], want["stem_conv"])
    for k in want:
        assert fc.rel(got[k], want[k]) <= 1e-5, k


def _jnp_percentile(a, q, axis=None):
    """``jnp.percentile`` as the JAX package's calibrators call it: inside
    ``jit`` with ``q`` a compile-time constant (with ``q`` traced, XLA
    picks the rank of 2^24 + 4097 elements one lower at 99.9)."""
    return jax.jit(lambda x: jnp.percentile(x, q, axis=axis))(jnp.asarray(a))


def _ulps(got, want):
    """Largest distance in float32 ulps of the reference."""
    got, want = np.asarray(got, np.float32), np.asarray(want, np.float32)
    return float((np.abs(got - want) / np.spacing(np.abs(want))).max())


@pytest.mark.parametrize("q", [99.9, 99.99, 50.0, 0.0, 37.5])
def test_percentile_of_matches_jnp_percentile(q):
    rng = np.random.default_rng(int(q * 100))
    a = np.abs(rng.standard_t(3, (37, 41, 8))).astype(np.float32)
    a[0, 0, :3] = 0.0  # post-ReLU zeros and ties
    whole = tq.percentile_of(torch.from_numpy(a), q)
    assert whole.dtype == torch.float32 and whole.shape == ()
    assert _ulps(whole, _jnp_percentile(a, q)) <= 1
    flat = a.reshape(-1, 8)
    per_channel = tq.percentile_of(torch.from_numpy(flat), q, dim=0)
    assert per_channel.shape == (8,)
    assert _ulps(per_channel, _jnp_percentile(flat, q, axis=0)) <= 1


def test_percentile_of_beyond_two_to_the_24():
    """More than 2^24 elements (``torch.quantile`` refuses them): the rank
    arithmetic in float32 as JAX's (the count rounds to float32)."""
    n = 2 ** 24 + 4097
    a = np.random.default_rng(0).exponential(1.0, n).astype(np.float32)
    with pytest.raises(RuntimeError):
        torch.quantile(torch.from_numpy(a), 0.999)
    got = tq.percentile_of(torch.from_numpy(a), 99.9)
    assert _ulps(got, _jnp_percentile(a, 99.9)) <= 1


def test_percentile_scales_match_jax():
    """The VGG calibrator takes each chunk's percentile of |x| over the
    tensor and the max over the chunks, as the JAX package's."""
    from ssd_tensorflow_tpu.models import ssd_vgg as jax_ssd
    from ssd_tensorflow_tpu_torch.models import ssd_vgg

    jcfg = jax_ssd.ModelConfig(preset_name="test64", num_classes=3)
    jp = _as_numpy(jax_ssd.init_params(jax.random.PRNGKey(3), jcfg))
    img = fc.images(6, 4)
    want = jq.calibrate_activation_scales(jp, img, jcfg, percentile=99.9, batch_size=3)
    got = tq.calibrate_activation_scales(params_from_jax(jp), torch.from_numpy(img),
                                         ssd_vgg.ModelConfig(preset_name="test64", num_classes=3),
                                         percentile=99.9, batch_size=3)
    assert set(got) == set(want)
    assert got["conv1_1"] == want["conv1_1"]
    for k in want:
        assert got[k] == pytest.approx(want[k], rel=1e-5), k


@pytest.mark.parametrize("layer,hw,stride,padding", [
    ("stem_conv", 16, 2, "SAME"), ("s1b0_proj", 9, 2, "SAME"), ("s0b0_conv1", 8, 1, "SAME"),
    ("extra0_2", 3, 1, "VALID"), ("classifier1", 4, 1, "SAME")])
def test_qconv_folded_matches_jax(layer, hw, stride, padding):
    jp, jcfg, _, img = _setup("rtest64")
    jqp = jq.quantize_weights_folded(jp, jq.calibrate_activation_amax(jp, img, jcfg))[layer]
    cin = jqp["wq"].shape[2]
    rng = np.random.default_rng(hw)
    amax = np.asarray(jqp["a_scale"]) * 127
    x = jnp.asarray(rng.uniform(-1.2, 1.2, (2, hw, hw, cin)) * amax, jnp.bfloat16)
    want = np.asarray(jax.jit(lambda qp, v: jq._qconv_folded(qp, v, stride, padding))(jqp, x),
                      np.float32)
    staged = stage_qparams(qparams_from_jax({layer: _as_numpy({layer: jqp})[layer]}), {}, "cpu")
    xt = torch.from_numpy(np.asarray(x, np.float32)).to(torch.bfloat16)
    xq = tq.quantize(xt, staged[layer]["inv"])
    want_xq = jnp.clip(jnp.round(x.astype(jnp.float32) * (1.0 / jqp["a_scale"])), -127, 127)
    np.testing.assert_array_equal(xq.numpy(), np.asarray(want_xq).astype(np.int8))
    from ssd_tensorflow_tpu_torch.ops.int8_conv import int8_conv

    sums = int8_conv(xq, staged[layer]["w"], stride, padding)
    want_sums = jax.lax.conv_general_dilated(
        jnp.asarray(xq.numpy()), jqp["wq"], (stride, stride), padding,
        dimension_numbers=jq._DIMNUMS, preferred_element_type=jnp.int32)
    np.testing.assert_array_equal(sums.numpy(), np.asarray(want_sums))
    got = tq._qconv_folded(staged[layer], xt, stride, padding)
    assert got.dtype == torch.bfloat16
    np.testing.assert_array_equal(got.float().numpy(), want)


def test_forward_scores_match_jax(family):
    """The whole int8 family forward at the small preset, the JAX package's
    folded q-params on both sides (found: rtest64 conf 0.041, argmax
    99.7 %, locs 0.16 of 11; mntest64 conf 0.0043, argmax 100 %, locs
    0.016 of 2.5)."""
    jp, jcfg, tcfg, img, amax = family
    jqp = jq.quantize_weights_folded(jp, amax)
    want = [np.asarray(v) for v in
            jax.jit(lambda qp, x: jq._forward_scores(qp, {}, x, jcfg))(jqp, img)]
    staged = stage_qparams(qparams_from_jax(_as_numpy(jqp)), {}, "cpu")
    with torch.inference_mode():
        got = [v.numpy() for v in tq._forward_scores(staged, torch.from_numpy(img), tcfg)]
    assert float(np.abs(got[0] - want[0]).max()) < 0.05
    assert float(np.mean(got[1] == want[1])) >= 0.98
    assert fc.rel(got[2], want[2]) <= 0.05
    result = tq._forward(staged, torch.from_numpy(img), tcfg).numpy()
    k = tcfg.num_classes
    np.testing.assert_array_equal(got[1], result[..., :k].argmax(-1))


def test_quantized_model_calibrates_and_folds(family):
    jp, _, tcfg, img, amax = family
    qm = tq.QuantizedModel(params_from_jax(jp), tcfg, img, device="cpu")
    assert qm.act_scales == {}
    want = _as_numpy(jq.quantize_weights_folded(jp, amax))
    got = qparams_to_jax(qm.qparams)
    # the scales from the port's calibration: the first conv's exactly
    np.testing.assert_array_equal(got["stem_conv"]["a_scale"], want["stem_conv"]["a_scale"])
    for name in want:
        if "a_scale" in want[name]:
            assert fc.rel(got[name]["a_scale"], want[name]["a_scale"]) <= 1e-5, name
    assert qm.result(img).shape == (img.shape[0], tcfg.preset.num_anchors, tcfg.num_vars)


def _iou(a, b):
    """IoU of a center-form box ``a`` with each row of ``b``."""
    lo = np.maximum(a[:2] - a[2:] / 2, b[:, :2] - b[:, 2:] / 2)
    hi = np.minimum(a[:2] + a[2:] / 2, b[:, :2] + b[:, 2:] / 2)
    inter = np.prod(np.clip(hi - lo, 0, None), axis=1)
    return inter / (np.prod(a[2:]) + np.prod(b[:, 2:], axis=1) - inter)


def matched_detections(a, b, min_score=0.1, min_iou=0.95, score_tol=0.02):
    """The detections of ``a`` (dict of per-image arrays) of conf >=
    ``min_score`` that have none in ``b`` of the same class with IoU >=
    ``min_iou`` and conf within ``score_tol``: ``[(image, row)]``."""
    missing = []
    for i in range(a["valid"].shape[0]):
        va, vb = a["valid"][i], b["valid"][i]
        for r in np.flatnonzero(va & (a["scores"][i] >= min_score)):
            same = vb & (b["classes"][i] == a["classes"][i][r]) & \
                (np.abs(b["scores"][i] - a["scores"][i][r]) <= score_tol)
            if not (same.any() and _iou(a["boxes"][i][r], b["boxes"][i][same]).max() >= min_iou):
                missing.append((i, int(r)))
    return missing


@pytest.fixture(scope="module")
def fixture_file():
    with np.load(FIXTURE) as data:
        return {k: data[k] for k in data.files}


@pytest.mark.parametrize("name", ["resnet320", "mobilenet320"])
def test_family_bundle_matches_jax_on_fixture_jpegs(fixture_file, name):
    """The shipped family bundle on the two fixture JPEGs through both
    packages' CPU ``_forward_scores`` and ``run_scores`` (the JAX side's
    detections are the fixture file's, which the last test holds to the
    JAX package)."""
    jm = jax_inference.InferenceModel.from_bundle(str(ASSETS / BUNDLES[name]))
    images = fixture_file["images_320"]
    want = [np.asarray(v) for v in jax.jit(
        lambda qp, x: jq._forward_scores(qp, jm.act_scales, x, jm.config))(jm.params, images)]
    tm = inference.InferenceModel.from_bundle(str(ASSETS / BUNDLES[name]), device="cpu")
    assert tm.act_scales == {} and tm.config.preset_name == name
    with torch.inference_mode():
        got = [v.numpy() for v in tm.forward_scores(torch.from_numpy(images))]
    assert float(np.abs(got[0] - want[0]).max()) < 0.05
    assert float(np.mean(got[1] == want[1])) >= 0.98
    assert float(np.abs(got[2] - want[2]).max()) < 0.15
    td = tm.run_scores(images)
    port = {f: getattr(td, f).numpy() for f in DET_FIELDS}
    jax_dets = {f: fixture_file[f"{name}_{f}"] for f in DET_FIELDS}
    np.testing.assert_array_equal(port["valid"].sum(1), jax_dets["valid"].sum(1))
    assert (jax_dets["valid"] & (jax_dets["scores"] >= 0.1)).sum() >= 4
    assert matched_detections(jax_dets, port) == []
    assert matched_detections(port, jax_dets) == []


#: the int8 family forwards whose GroupNorms are traced: the small presets
#: (JAX-initialised, calibrated on ``_setup``'s images) and the shipped
#: bundles (on the fixture JPEGs)
GN_CASES = [*FAMILY_PRESETS, "resnet320", "mobilenet320"]
#: XLA's CPU compiler may keep a bf16 value in float32 across a cast when
#: it fuses the producer into the consumer ("excess precision"): the
#: compiled JAX forward then skips roundings its code asks for (a
#: depthwise conv's bf16 sum before its bias add, a GroupNorm's bf16
#: input). With it off, XLA rounds where the code says.
XLA_ROUNDS_AS_WRITTEN = "--xla_allow_excess_precision=false"


def record_group_norms(out_dir: str) -> None:
    """For each of ``GN_CASES``: the JAX package's jit-compiled int8
    ``_forward_scores`` with every GroupNorm's input and output returned
    beside the scores, into ``out_dir/<case>.npz`` (with the images, and
    for a small preset the folded q-params as ``q/<layer>/<leaf>``)."""
    real = jax_resnet.group_norm
    for case in GN_CASES:
        if case in BUNDLES:
            jm = jax_inference.InferenceModel.from_bundle(str(ASSETS / BUNDLES[case]))
            qp, cfg = jm.params, jm.config
            with np.load(FIXTURE) as data:
                images = data["images_320"]
            extra = {}
        else:
            jp, cfg, _, images = _setup(case)
            qp = jq.quantize_weights_folded(jp, jq.calibrate_activation_amax(jp, images, cfg))
            extra = {f"q/{n}/{k}": np.asarray(v) for n, d in qp.items() for k, v in d.items()}

        def forward(qp, x):
            calls = []

            def traced(x, gn, *args, **kwargs):
                y = real(x, gn, *args, **kwargs)
                calls.append((x, y))
                return y

            with mock.patch.object(jax_resnet, "group_norm", traced), \
                    mock.patch.object(jax_mobilenet, "group_norm", traced):
                return jq._forward_scores(qp, {}, x, cfg), calls

        (conf, cls, locs), calls = jax.jit(forward)(qp, images)
        gns = {f"gn_{io}_{i}": np.asarray(v, np.float32)
               for i, pair in enumerate(calls) for io, v in zip(("in", "out"), pair)}
        np.savez(Path(out_dir) / f"{case}.npz", images=images, conf=np.asarray(conf),
                 cls=np.asarray(cls), locs=np.asarray(locs), **gns, **extra)


@pytest.fixture(scope="module")
def jax_group_norms(tmp_path_factory):
    out = tmp_path_factory.mktemp("group_norms")
    flags = f"{os.environ.get('XLA_FLAGS', '')} {XLA_ROUNDS_AS_WRITTEN}".strip()
    path = os.pathsep.join([str(ROOT), os.environ.get("PYTHONPATH", "")]).rstrip(os.pathsep)
    subprocess.run([sys.executable, __file__, "--group-norms", str(out)], check=True, timeout=600,
                   env=dict(os.environ, XLA_FLAGS=flags, JAX_PLATFORMS="cpu", PYTHONPATH=path))
    return out


@pytest.mark.parametrize("case", GN_CASES)
def test_family_int8_drift_is_the_group_norms(jax_group_norms, case):
    """Where the port's int8 family forward parts from the JAX package's:
    every GroupNorm of the port's forward is handed the JAX package's
    output of the same GroupNorm, and then every other step matches JAX
    with XLA rounding as its code says (``XLA_ROUNDS_AS_WRITTEN``): each
    GroupNorm's input bit for bit, the scores within 1e-6 (the softmax's
    float32 rounding), argmax equal and the detections (threshold 0.01)
    equal, scores and boxes within 1e-6. The port's own GroupNorm on
    JAX's input equals JAX's output on >= 99.8 % of elements and stays
    within one bf16 step (2^-7) of the largest (found: >= 99.919 %, at
    most 0.0040 of the largest; the float32 sums run in another order
    and XLA's rsqrt is not correctly rounded)."""
    with np.load(jax_group_norms / f"{case}.npz") as data:
        rec = {k: data[k] for k in data.files}
    if case in BUNDLES:
        tm = inference.InferenceModel.from_bundle(str(ASSETS / BUNDLES[case]), device="cpu")
        staged, tcfg = tm.params, tm.config
    else:
        tcfg = fc.configs(case, "bfloat16")[1]
        tree = {}
        for key, v in rec.items():
            if key.startswith("q/"):
                _, layer, leaf = key.split("/")
                tree.setdefault(layer, {})[leaf] = v
        staged = stage_qparams(qparams_from_jax(tree), {}, "cpu")
    n = sum(k.startswith("gn_in_") for k in rec)
    order, own_gaps = iter(range(n)), []
    real = resnet.group_norm

    def jax_output(x, gn, *args, **kwargs):
        i = next(order)
        np.testing.assert_array_equal(x.float().numpy(), rec[f"gn_in_{i}"],
                                      err_msg=f"GroupNorm {i}'s input")
        own = real(x, gn, *args, **kwargs).float().numpy()
        want = rec[f"gn_out_{i}"]
        own_gaps.append((float(np.mean(own == want)), fc.rel(own, want)))
        return torch.from_numpy(want).to(x.dtype)

    with mock.patch.object(resnet, "group_norm", jax_output), \
            mock.patch.object(mobilenet, "group_norm", jax_output), torch.inference_mode():
        got = tq._forward_scores(staged, torch.from_numpy(rec["images"]), tcfg)
    assert next(order, None) is None and n == {"r": 36, "m": 27}[case[0]]
    assert min(share for share, _ in own_gaps) >= 0.998
    assert max(gap for _, gap in own_gaps) <= 2.0 ** -7
    conf, cls, locs = (v.numpy() for v in got)
    assert float(np.abs(conf - rec["conf"]).max()) <= 1e-6
    np.testing.assert_array_equal(cls, rec["cls"])
    assert float(np.abs(locs - rec["locs"]).max()) <= 1e-6
    detect = postprocess.DetectionConfig(top_k=200, confidence_threshold=0.01)
    td = postprocess.decode_scores(*got, torch.from_numpy(anchors_for_preset(tcfg.preset)), detect)
    jd = jax_post.decode_scores(
        *(jnp.asarray(rec[k]) for k in ("conf", "cls", "locs")),
        jnp.asarray(anchors_for_preset(tcfg.preset)),
        jax_post.DetectionConfig(top_k=200, confidence_threshold=0.01))
    np.testing.assert_array_equal(td.valid.numpy(), np.asarray(jd.valid))
    assert td.valid.any()
    np.testing.assert_array_equal(td.classes.numpy(), np.asarray(jd.classes))
    for field in ("scores", "boxes"):
        assert float(np.abs(getattr(td, field).numpy() - np.asarray(getattr(jd, field))).max()) <= 1e-6


@pytest.mark.parametrize("preset", FAMILY_PRESETS)
def test_family_int8_bundle_round_trips(tmp_path, preset):
    """A family int8 bundle written by either package loads in the other
    with every leaf (``a_scale`` included) and the meta equal."""
    jp, jcfg, tcfg, img = _setup(preset)
    jqp = _as_numpy(jq.quantize_weights_folded(jp, jq.calibrate_activation_amax(jp, img, jcfg)))
    a, b = str(tmp_path / "jax.npz"), str(tmp_path / "port.npz")
    jax_inference.save_bundle(a, jqp, jcfg, {0: "cat"}, act_scales={})
    qp, cfg, lid2name, scales = inference.load_bundle(a)
    assert scales == {} and lid2name == {0: "cat"}
    assert inference.model_config_to_dict(cfg) == jax_inference.model_config_to_dict(jcfg)
    inference.save_bundle(b, qp, cfg, lid2name, act_scales=scales)
    back, jcfg2, lid2, jscales = jax_inference.load_bundle(b)
    assert jscales == {} and lid2 == {0: "cat"} and jcfg2 == jcfg
    for name in jqp:
        for key in jqp[name]:
            np.testing.assert_array_equal(np.asarray(back[name][key]), jqp[name][key])
            assert np.asarray(back[name][key]).dtype == jqp[name][key].dtype
    with np.load(a) as x, np.load(b) as y:
        assert json.loads(bytes(x["__meta__"])) == json.loads(bytes(y["__meta__"]))
        assert x.files == y.files and all(np.array_equal(x[k], y[k]) for k in x.files)


@pytest.mark.parametrize("name", ["resnet320", "mobilenet320"])
def test_shipped_family_bundle_saves_back_identically(tmp_path, name):
    """Loading the JAX package's bundle and saving it from the port gives
    identical leaves and meta."""
    src = str(ASSETS / BUNDLES[name])
    qp, cfg, lid2name, scales = inference.load_bundle(src)
    out = str(tmp_path / "again.npz")
    inference.save_bundle(out, qp, cfg, lid2name, act_scales=scales)
    with np.load(src) as x, np.load(out) as y:
        assert json.loads(bytes(x["__meta__"])) == json.loads(bytes(y["__meta__"]))
        assert sorted(x.files) == sorted(y.files)
        for k in x.files:
            assert x[k].dtype == y[k].dtype and np.array_equal(x[k], y[k]), k


def test_fixture_file_is_the_jax_packages(fixture_file):
    want = bundle_detection_arrays()
    assert sorted(fixture_file) == sorted(want)
    for k, v in want.items():
        assert fixture_file[k].dtype == v.dtype and fixture_file[k].shape == v.shape, k
        np.testing.assert_array_equal(fixture_file[k], v, err_msg=k)
    assert fixture_file["images_512"].shape == (2, 512, 512, 3)
    assert fixture_file["images_320"].shape == (2, 320, 320, 3)


if __name__ == "__main__":
    jax.config.update("jax_platforms", "cpu")
    if sys.argv[1:2] == ["--group-norms"]:
        record_group_norms(sys.argv[2])
    else:
        FIXTURE.parent.mkdir(exist_ok=True)
        np.savez_compressed(FIXTURE, **bundle_detection_arrays())
        print(f"wrote {FIXTURE}")
