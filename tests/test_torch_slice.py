"""The port's detection paths as a whole against the JAX package:
test64, bf16, the JAX model with its Pallas stem and Pallas NMS switched
on (interpret mode), the port's InferenceModel on the CPU; once with the
split stem ("dma") and once with the whole uint8 stem (both sides'
``overrides`` choose ``pallas_stem_variant="uint8"``).

Pre-NMS scores: conf within 0.01, argmax class equal on >= 99.5 % of the
anchors, locs within 0.04 (one bf16 step of a loc of magnitude 4 to 8):
half of tests/test_stem_pallas.py's bounds for two bf16 stems that differ
in summation order only, which the heads' one-rounding bias now allows.
The head biases are nonzero and seeded (the JAX init gives zeros).

Detections: a bf16 rounding step apart in conf reorders near-tied
candidates (random weights make many), which changes the top-200 set and
so some NMS decisions. The measure is therefore set agreement: at least
95 % of each side's detections find one on the other side with the same
class, a box within 2e-3 and a score within 0.02, and the counts differ
by at most 5 %. Decode itself is bit-exact on identical scores
(tests/test_torch_nms.py).

Bundles: float and int8 bundles written by either package load in the
other with every leaf equal; the committed vgg512 int8 bundle loads in
the port as in the JAX package and its ``run_scores`` detections agree
by the same set measure (``tests/test_torch_quantized.py`` holds its
scores).
"""

import dataclasses
from pathlib import Path

import jax
import numpy as np
import pytest
import torch

from ssd_tensorflow_tpu import inference as jax_inference
from ssd_tensorflow_tpu.models import quantized as jq_mod
from ssd_tensorflow_tpu.models import ssd_vgg as jax_ssd
from ssd_tensorflow_tpu.ops.postprocess import DetectionConfig as JaxDetectionConfig
from ssd_tensorflow_tpu_torch import inference
from ssd_tensorflow_tpu_torch.models import ssd_vgg
from ssd_tensorflow_tpu_torch.weights import (
    params_from_jax,
    params_to_jax,
    qparams_from_jax,
    qparams_to_jax,
)

CFG = dict(preset_name="test64", num_classes=3)
ASSETS = Path(__file__).resolve().parent.parent / "assets"


@pytest.fixture(scope="module", params=[(1, "dma"), (2, "dma"), (1, "uint8"), (2, "uint8")],
                ids=lambda p: f"seed{p[0]}-{p[1]}")
def models(request):
    seed, variant = request.param
    jcfg = jax_ssd.ModelConfig(**CFG)
    jp = jax_ssd.init_params(jax.random.PRNGKey(seed), jcfg)
    # nonzero float32 head biases (init gives zeros), so that where the bias
    # joins the head convs' sums is part of what the slice holds
    rng = np.random.default_rng(100 + seed)
    for i in range(len(jcfg.preset.maps)):
        hp = jp[f"classifier{i}"]
        jp[f"classifier{i}"] = dict(hp, b=rng.normal(0, 0.5, hp["b"].shape).astype(np.float32))
    jm = jax_inference.InferenceModel(
        jp, jcfg, overrides={"pallas_stem": True, "pallas_stem_variant": variant},
        detection=JaxDetectionConfig(top_k=200, confidence_threshold=0.01, use_pallas_nms=True),
    )
    tm = inference.InferenceModel(params_from_jax(jp), ssd_vgg.ModelConfig(**CFG),
                                  overrides={"pallas_stem_variant": variant}, device="cpu")
    assert tm.config.pallas_stem_variant == jm.config.pallas_stem_variant == variant
    img = np.random.default_rng(seed).integers(0, 255, (2, 64, 64, 3), dtype=np.uint8)
    return jp, jm, tm, img


def test_pre_nms_scores(models):
    jp, jm, tm, img = models
    jconf, jcls, jlocs = jax_ssd.apply_scores(jp, img, jm.config)
    tconf, tcls, tlocs = ssd_vgg.apply_scores(tm.params, torch.from_numpy(img), tm.config)
    assert float(np.abs(tconf.numpy() - np.asarray(jconf)).max()) < 0.01
    assert float(np.mean(tcls.numpy() == np.asarray(jcls))) >= 0.995
    assert float(np.abs(tlocs.numpy() - np.asarray(jlocs)).max()) < 0.04


def _matched_share(a, b):
    """Share of a's valid detections with a match among b's."""
    hits = 0
    for box, cls, score in zip(*a):
        ok = (b[1] == cls) & (np.abs(b[0] - box).max(axis=1) < 2e-3) & (np.abs(b[2] - score) < 0.02)
        hits += bool(ok.any())
    return hits / max(len(a[0]), 1)


def test_detections(models):
    _, jm, tm, img = models
    jd = jm._run_scores(jm.params, jm._to_device(img))
    td = tm.run_scores(img)
    assert td.boxes.shape == tuple(jd.boxes.shape) == (2, 200, 4)
    for b in range(img.shape[0]):
        jv, tv = np.asarray(jd.valid[b]), td.valid[b].numpy()
        j = (np.asarray(jd.boxes[b])[jv], np.asarray(jd.classes[b])[jv], np.asarray(jd.scores[b])[jv])
        t = (td.boxes[b].numpy()[tv], td.classes[b].numpy()[tv], td.scores[b].numpy()[tv])
        assert abs(len(t[0]) - len(j[0])) <= 0.05 * max(len(j[0]), 1)
        assert _matched_share(t, j) >= 0.95
        assert _matched_share(j, t) >= 0.95


def test_detect_boxes_rows(models):
    _, _, tm, img = models
    rows = tm.detect_boxes(img)
    assert len(rows) == 2 and all(0 <= len(r) <= 200 for r in rows)
    assert all(0.01 <= conf <= 1.0 for r in rows for conf, _ in r)


def test_float_bundle_from_jax(tmp_path):
    jcfg = jax_ssd.ModelConfig(**CFG)
    jp = jax_ssd.init_params(jax.random.PRNGKey(7), jcfg)
    path = str(tmp_path / "m.npz")
    jax_inference.save_bundle(path, jp, jcfg, {0: "cat", 1: "dog", 2: "bird"})
    params, cfg, lid2name, act_scales = inference.load_bundle(path)
    assert inference.model_config_to_dict(cfg) == jax_inference.model_config_to_dict(jcfg)
    assert lid2name == {0: "cat", 1: "dog", 2: "bird"} and act_scales is None
    ref = params_from_jax(jp)
    for name in ref:
        for key in ref[name]:
            torch.testing.assert_close(params[name][key], ref[name][key], rtol=0, atol=0)
    img = np.random.default_rng(0).integers(0, 255, (1, 64, 64, 3), dtype=np.uint8)
    a = inference.InferenceModel.from_bundle(path, device="cpu").run_scores(img)
    b = inference.InferenceModel(ref, cfg, device="cpu").run_scores(img)
    for field in ("boxes", "scores", "classes", "valid"):
        torch.testing.assert_close(getattr(a, field), getattr(b, field), rtol=0, atol=0)


def test_float_bundle_to_jax(tmp_path):
    cfg = dataclasses.replace(ssd_vgg.ModelConfig(**CFG), l2_norm_eps=1e-3)
    params = ssd_vgg.init_params(cfg, seed=3)
    path = str(tmp_path / "m.npz")
    inference.save_bundle(path, params, cfg, {1: "dog"})
    jp, jcfg, lid2name, act_scales = jax_inference.load_bundle(path)
    assert act_scales is None and lid2name == {1: "dog"}
    assert jcfg.l2_norm_eps == 1e-3
    want = params_to_jax(params)
    for name in want:
        for key in want[name]:
            np.testing.assert_array_equal(np.asarray(jp[name][key]), want[name][key])


@pytest.fixture(scope="module")
def int8_bundle():
    path = str(ASSETS / "vgg512_int8_minivoc.ssdtpu.npz")
    return path, jax_inference.load_bundle(path), inference.load_bundle(path)


def test_int8_bundle_loads_like_jax(int8_bundle):
    _, (jq, jcfg, jlid, jscales), (tq, cfg, lid, scales) = int8_bundle
    assert inference.model_config_to_dict(cfg) == jax_inference.model_config_to_dict(jcfg)
    assert lid == jlid and len(lid) == 20
    assert scales == jscales and len(scales) == 32
    got = qparams_to_jax(tq)
    assert set(got) == set(jq)
    n = 0
    for name in jq:
        assert set(got[name]) == set(jq[name])
        for key in jq[name]:
            want = np.asarray(jq[name][key])
            assert got[name][key].dtype == want.dtype, (name, key)
            np.testing.assert_array_equal(got[name][key], want)
            n += 1
    assert n == 97 and tq["conv1_1"]["wq"].shape == (3, 3, 3, 64)


def test_family_int8_bundle_names_its_queue_item():
    """The family int8 bundles load (they raised, naming ROADMAP queue 1
    item 7, before it was ported): every leaf as the JAX package loads it,
    the folded ``a_scale`` beside each quantized conv but the depthwise
    ones, and ``act_scales == {}``."""
    for fname, n_leaves in (("resnet320_int8_minicoco.ssdtpu.npz", 264),
                            ("mobilenet320_int8_qat_minivoc.ssdtpu.npz", 205)):
        path = str(ASSETS / fname)
        jq_, jcfg, jlid, jscales = jax_inference.load_bundle(path)
        tq_, cfg, lid, scales = inference.load_bundle(path)
        assert scales == jscales == {} and lid == jlid
        assert inference.model_config_to_dict(cfg) == jax_inference.model_config_to_dict(jcfg)
        got, n = qparams_to_jax(tq_), 0
        assert set(got) == set(jq_)
        for name in jq_:
            assert set(got[name]) == set(jq_[name]), name
            assert ("a_scale" in got[name]) == ("wq" in got[name] and not name.endswith("_dw"))
            for key in jq_[name]:
                np.testing.assert_array_equal(got[name][key], np.asarray(jq_[name][key]))
                n += 1
        assert n == n_leaves


def _int8_test64(seed):
    jcfg = jax_ssd.ModelConfig(**CFG)
    jp = jax_ssd.init_params(jax.random.PRNGKey(seed), jcfg)
    img = np.random.default_rng(seed).integers(0, 255, (2, 64, 64, 3), dtype=np.uint8)
    return jcfg, jq_mod.quantize_weights(jp), jq_mod.calibrate_activation_scales(jp, img, jcfg)


def test_int8_bundle_to_jax(tmp_path):
    jcfg, jqp, scales = _int8_test64(4)
    path = str(tmp_path / "q.npz")
    inference.save_bundle(path, qparams_from_jax(jqp), ssd_vgg.ModelConfig(**CFG), {2: "bird"},
                          act_scales=scales)
    got, cfg, lid2name, got_scales = jax_inference.load_bundle(path)
    assert lid2name == {2: "bird"} and got_scales == scales
    assert jax_inference.model_config_to_dict(cfg) == jax_inference.model_config_to_dict(jcfg)
    for name in jqp:
        for key in jqp[name]:
            np.testing.assert_array_equal(np.asarray(got[name][key]), np.asarray(jqp[name][key]))
            assert np.asarray(got[name][key]).dtype == np.asarray(jqp[name][key]).dtype


def test_int8_bundle_from_jax(tmp_path):
    jcfg, jqp, scales = _int8_test64(5)
    path = str(tmp_path / "q.npz")
    jax_inference.save_bundle(path, jqp, jcfg, {0: "cat"}, act_scales=scales)
    qp, cfg, lid2name, got_scales = inference.load_bundle(path)
    assert lid2name == {0: "cat"} and got_scales == scales
    want = qparams_from_jax(jqp)
    for name in want:
        for key in want[name]:
            torch.testing.assert_close(qp[name][key], want[name][key], rtol=0, atol=0)


def test_int8_run_scores_matches_jax(int8_bundle):
    """The committed bundle through both façades' ``run_scores`` on two
    random images: the same detections (the int8 sums are exact on both
    sides, so the scores agree to float32 rounding)."""
    path = int8_bundle[0]
    img = np.random.default_rng(9).integers(0, 256, (2, 512, 512, 3), dtype=np.uint8)
    jm = jax_inference.InferenceModel.from_bundle(path)
    jd = jm._run_scores(jm.params, jm._to_device(img))
    tm = inference.InferenceModel.from_bundle(path, device="cpu")
    assert tm.act_scales is not None
    td = tm.run_scores(img)
    for b in range(2):
        jv, tv = np.asarray(jd.valid[b]), td.valid[b].numpy()
        j = (np.asarray(jd.boxes[b])[jv], np.asarray(jd.classes[b])[jv], np.asarray(jd.scores[b])[jv])
        t = (td.boxes[b].numpy()[tv], td.classes[b].numpy()[tv], td.scores[b].numpy()[tv])
        assert abs(len(t[0]) - len(j[0])) <= 0.05 * max(len(j[0]), 1)
        assert _matched_share(t, j) >= 0.95
        assert _matched_share(j, t) >= 0.95


def test_int8_bundle_drops_stem_overrides(int8_bundle, capsys):
    path = int8_bundle[0]
    m = inference.InferenceModel.from_bundle(
        path, device="cpu", overrides={"pallas_stem": True, "pallas_stem_variant": "uint8"})
    assert m.config.pallas_stem_variant == "dma"
    assert "pallas_stem override ignored: this int8 bundle" in capsys.readouterr().out


def test_overrides_reject_a_bad_variant():
    with pytest.raises(ValueError, match="pallas_stem_variant"):
        ssd_vgg.ModelConfig(**CFG, pallas_stem_variant="bogus")
    cfg = ssd_vgg.ModelConfig(**CFG)
    with pytest.raises(ValueError, match="pallas_stem_variant"):
        inference.InferenceModel(ssd_vgg.init_params(cfg), cfg,
                                 overrides={"pallas_stem_variant": "bogus"}, device="cpu")
    with pytest.raises(ValueError, match="bfloat16"):
        ssd_vgg.ModelConfig(**CFG, compute_dtype="float32", pallas_stem_variant="uint8")


def test_overrides_pallas_stem_true_is_a_no_op_and_false_raises():
    cfg = ssd_vgg.ModelConfig(**CFG)
    params = ssd_vgg.init_params(cfg)
    m = inference.InferenceModel(params, cfg, overrides={"pallas_stem": True}, device="cpu")
    assert m.config == cfg
    with pytest.raises(ValueError, match="always runs a stem kernel"):
        inference.InferenceModel(params, cfg, overrides={"pallas_stem": False}, device="cpu")


@pytest.mark.parametrize("variant", ["dma", "uint8"])
def test_overrides_padded_heads_is_a_no_op(variant):
    """``padded_heads`` (which ``cli/detect.py`` passes to the JAX façade)
    is accepted, True or False, and changes no bit of the detections."""
    cfg = ssd_vgg.ModelConfig(**CFG)
    params = ssd_vgg.init_params(cfg, seed=4)
    img = np.random.default_rng(4).integers(0, 255, (2, 64, 64, 3), dtype=np.uint8)
    base = {"pallas_stem_variant": variant}
    want = inference.InferenceModel(params, cfg, overrides=base, device="cpu").run_scores(img)
    for padded in (True, False):
        m = inference.InferenceModel(params, cfg, overrides=dict(base, padded_heads=padded),
                                     device="cpu")
        assert m.config == dataclasses.replace(cfg, pallas_stem_variant=variant)
        got = m.run_scores(img)
        for field in ("boxes", "scores", "classes", "valid"):
            assert torch.equal(getattr(got, field), getattr(want, field)), field
    with pytest.raises(ValueError, match="padded_heads"):
        inference.InferenceModel(params, cfg, overrides={"padded_heads": "yes"}, device="cpu")
    with pytest.raises(ValueError, match="padded_heads"):
        inference.InferenceModel(params, cfg, overrides={"bogus": 1}, device="cpu")


def test_overrides_dropped_on_a_float32_bundle(capsys):
    cfg = ssd_vgg.ModelConfig(**CFG, compute_dtype="float32")
    m = inference.InferenceModel(ssd_vgg.init_params(cfg), cfg, device="cpu",
                                 overrides={"pallas_stem": True, "pallas_stem_variant": "uint8"})
    assert m.config == cfg
    assert "pallas_stem override ignored: this float32 bundle" in capsys.readouterr().out


def test_stem_variant_is_not_serialized():
    cfg = ssd_vgg.ModelConfig(**CFG, pallas_stem_variant="uint8")
    d = inference.model_config_to_dict(cfg)
    assert "pallas_stem_variant" not in d
    assert d == jax_inference.model_config_to_dict(jax_ssd.ModelConfig(**CFG))
    assert inference.model_config_from_dict(d).pallas_stem_variant == "dma"


@pytest.mark.parametrize("fname", ["resnet320_int8_minicoco.ssdtpu.npz",
                                   "mobilenet320_int8_qat_minivoc.ssdtpu.npz"])
def test_family_bundle_run_scores_and_overrides(fname, capsys):
    """A family int8 bundle's ``run_scores`` runs on the CPU (the QAT
    bundle deploys the scales it carries; nothing recalibrates), and the
    stem overrides are dropped with the JAX package's message."""
    m = inference.InferenceModel.from_bundle(
        str(ASSETS / fname), device="cpu",
        overrides={"pallas_stem": True, "pallas_stem_variant": "uint8", "padded_heads": True})
    assert "pallas_stem override ignored: this int8 bundle" in capsys.readouterr().out
    assert m.config.pallas_stem_variant == "dma" and m.act_scales == {}
    img = np.random.default_rng(3).integers(0, 256, (2, 320, 320, 3), dtype=np.uint8)
    d = m.run_scores(img)
    assert d.boxes.shape == (2, 200, 4) and torch.isfinite(d.scores[d.valid]).all()
    qp = inference.load_bundle(str(ASSETS / fname))[0]
    staged = m.params
    for name, leaves in qp.items():
        if "a_scale" in leaves:
            assert torch.equal(staged[name]["inv"], torch.ones_like(leaves["a_scale"]) / leaves["a_scale"])


@pytest.mark.parametrize("preset,backbone", [("rtest64", "resnet34"), ("mntest64", "mobilenetv1")])
def test_family_float_model_and_overrides(tmp_path, capsys, preset, backbone):
    """A family float model runs ``run_scores``; its stem overrides are
    dropped (a family has no VGG stem), ``padded_heads`` is a no-op, and
    its float bundle round-trips through the JAX package."""
    cfg = ssd_vgg.ModelConfig(preset_name=preset, num_classes=3)
    params = ssd_vgg.init_params(cfg, seed=2)
    img = np.random.default_rng(2).integers(0, 256, (2, 64, 64, 3), dtype=np.uint8)
    want = inference.InferenceModel(params, cfg, device="cpu").run_scores(img)
    m = inference.InferenceModel(params, cfg, device="cpu", overrides={
        "pallas_stem": True, "pallas_stem_variant": "uint8", "padded_heads": False})
    assert f"pallas_stem override ignored: this {backbone} bundle" in capsys.readouterr().out
    assert m.config == cfg
    got = m.run_scores(img)
    for field in ("boxes", "scores", "classes", "valid"):
        assert torch.equal(getattr(got, field), getattr(want, field)), field
    # every conv but the depthwise ones is staged with its bias channels
    assert all(("wb" in p) == (not name.endswith("_dw")) for name, p in m.params.items()
               if "w" in p)
    path = str(tmp_path / "f.npz")
    inference.save_bundle(path, params, cfg, {0: "a"})
    jp, jcfg, _, scales = jax_inference.load_bundle(path)
    assert scales is None and jcfg.preset_name == preset
    back = params_from_jax({n: {k: np.asarray(v) for k, v in d.items()} for n, d in jp.items()})
    for name in params:
        for key in params[name]:
            assert torch.equal(back[name][key], params[name][key]), (name, key)
