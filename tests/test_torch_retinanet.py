"""RetinaNet with a ResNeXt-50 32x4d FPN (``models/resnext_fpn.py``) on the CPU.

The port's forward against the benchmark's plain float32 reference
(``h100bench/reference/retinanet_resnext50fpn.py``, written from the papers
and torchvision's definitions) on its seeded weights at the tiny preset
``rxtest64`` (the full network at 64x64, 6 classes); the grouped and
symmetric-padded conv executor against ``F.conv2d``; the anchors of
``retina800`` by torchvision's rule; the R-CNN codec; the multi-label decode
and NMS against the reference's ``detect``; the routes without a grouped
conv; the spans and counters."""

import json
import math
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest
import torch
import torch.nn.functional as F

from ssd_tensorflow_tpu_torch.inference import (
    InferenceModel,
    load_bundle,
    model_config_from_dict,
    model_config_to_dict,
    save_bundle,
)
from ssd_tensorflow_tpu_torch.models import layers, qat, quantized, resnext_fpn, ssd_vgg
from ssd_tensorflow_tpu_torch.ops import codec, postprocess
from ssd_tensorflow_tpu_torch.ops.anchors import anchors_for_preset
from ssd_tensorflow_tpu_torch.ops.postprocess import DetectionConfig, decode_scores
from ssd_tensorflow_tpu_torch.presets import get_preset_by_name, preset_from_dict, preset_to_dict

BENCH = Path(__file__).resolve().parents[1] / "h100bench"
if str(BENCH) not in sys.path:
    sys.path.insert(0, str(BENCH))

from benchlib import check  # noqa: E402
from reference import retinanet_resnext50fpn as ref  # noqa: E402

CONFIG = json.loads((BENCH / "configs" / "retinanet800-resnext50fpn-bf16.json").read_text())
K = 6


def _tiny_config(dtype="float32"):
    cfg = json.loads(json.dumps(CONFIG))
    cfg["preset"] = preset_to_dict(get_preset_by_name("rxtest64"))
    cfg["model"].update(preset_name="rxtest64", num_classes=K, compute_dtype=dtype)
    # 774 anchors x 6 classes (retina800: 31.7 M pairs): a steeper class conv
    # so that every image has detections above the threshold
    cfg["weights"]["class_gain"] = 4.0
    return cfg


@pytest.fixture(scope="module")
def case():
    """The tiny configuration, the reference's seeded parameters and 2 staged
    images."""
    from benchlib import pool

    torch.manual_seed(0)
    cfg = _tiny_config()
    params = ref.seeded_params(cfg, 2**33 + 5, torch.device("cpu"))
    traffic = json.loads((BENCH / "traffic" / "serve-b64.json").read_text())
    images = pool.images(2, (64, 64), traffic["augment"], 7, torch.device("cpu"))
    with torch.no_grad():
        want = ref.serving_forward(cfg, params)(images)
    return cfg, params, images, want


def test_forward_matches_the_reference(case):
    """The port's float32 forward against the reference's: both float32, so
    they differ by the order of their sums alone, over ~70 layers: within
    1e-5 of the largest logit / offset."""
    cfg, params, images, (want_l, want_c) = case
    mc = model_config_from_dict(cfg["model"])
    with torch.no_grad():
        got_l, got_c = ssd_vgg.apply_model(params, images, mc)
    assert got_l.shape == want_l.shape == (2, 774, K) and got_c.shape == (2, 774, 4)
    assert float((got_l - want_l).abs().max()) <= 1e-5 * float(want_l.abs().max())
    assert float((got_c - want_c).abs().max()) <= 1e-5 * float(want_c.abs().max())


def test_the_family_serves_and_does_not_train(case):
    """RetinaNet has the inference route alone: ``apply_model(inference=
    False)`` raises, as the training executor's grouped convs and skips and
    the family's own initialization do."""
    cfg, params, images, _ = case
    mc = model_config_from_dict(cfg["model"])
    with pytest.raises(ValueError, match="no training route"):
        ssd_vgg.apply_model(params, images, mc, inference=False)
    train_conv = layers.float_conv_executor(params, inference=False)
    x = torch.zeros((1, 8, 8, 128))
    with pytest.raises(ValueError, match="inference route alone"):
        train_conv("s0b0_conv2", x, padding=1, relu=True, groups=32)
    with pytest.raises(ValueError, match="inference route alone"):
        train_conv("s0b0_conv3", x, padding=0, relu=True, skip=torch.zeros((1, 8, 8, 256)))
    with pytest.raises(NotImplementedError, match="no initialization"):
        ssd_vgg.init_params(mc, 3)


def test_per_level_scores_are_views_in_the_anchor_order(case):
    """``apply_scores`` hands the decode each level's head output reshaped
    (no copy), the levels in the anchor order that ``apply_model``
    concatenates."""
    cfg, params, images, _ = case
    mc = model_config_from_dict(cfg["model"])
    with torch.no_grad():
        logits, cls, locs = ssd_vgg.apply_scores(params, images, mc)
        whole_l, whole_c = ssd_vgg.apply_model(params, images, mc)
    assert cls is None and len(logits) == len(locs) == 5
    assert [lg.shape[1] for lg in logits] == [64 * 9, 16 * 9, 4 * 9, 9, 9]
    assert torch.equal(torch.cat(logits, 1), whole_l) and torch.equal(torch.cat(locs, 1), whole_c)


def test_bf16_forward_rounds_near_the_reference(case):
    """The served precision on the CPU: scores (sigmoid) within 0.05 of the
    float32 reference's (bf16 activations over ~70 layers)."""
    cfg, params, images, (want_l, _) = case
    mc = model_config_from_dict({**cfg["model"], "compute_dtype": "bfloat16"})
    model = InferenceModel(params, mc, device="cpu")
    with torch.inference_mode():
        got_l, _ = ssd_vgg.apply_model(model.params, images, mc)
    assert float((torch.sigmoid(got_l) - torch.sigmoid(want_l)).abs().max()) <= 0.05


@pytest.mark.parametrize("stride", [1, 2])
def test_grouped_symmetric_executor_matches_f_conv2d(stride):
    """``conv(..., groups=32, padding=1)`` of the float executor is
    ``F.conv2d(groups=32, padding=1)`` + bias + ReLU, counted once in
    ``grouped_conv.calls``; in bf16 it rounds once."""
    g = torch.Generator().manual_seed(stride)
    x = torch.randn((2, 9, 9, 64), generator=g)
    p = {"w": torch.randn((64, 2, 3, 3), generator=g) / 4, "b": torch.randn(64, generator=g)}
    before = layers.grouped_conv.calls
    got = layers.float_conv_executor({"c": p})("c", x, stride=stride, padding=1, relu=True,
                                               groups=32)
    assert layers.grouped_conv.calls == before + 1
    want = torch.relu(F.conv2d(x.permute(0, 3, 1, 2), p["w"], p["b"], stride, 1, 1, 32))
    assert torch.allclose(got, want.permute(0, 2, 3, 1), atol=1e-5)
    pb = {"w": p["w"].bfloat16(), "b": p["b"]}
    got16 = layers.float_conv_executor({"c": pb})("c", x.bfloat16(), stride=stride, padding=1,
                                                  relu=True, groups=32)
    want16 = torch.relu(F.conv2d(x.bfloat16().float().permute(0, 3, 1, 2), pb["w"].float(),
                                 p["b"], stride, 1, 1, 32)).bfloat16()
    assert torch.equal(got16, want16.permute(0, 2, 3, 1))


def test_executor_skip_and_padding():
    """``skip``: ``relu(conv + b + skip)`` rounded once; an int padding pads
    every side, where TF SAME would pad a stride-2 conv on an even map at
    the bottom alone; a grouped conv or a skip without ReLU raises."""
    g = torch.Generator().manual_seed(3)
    x, skip = torch.randn((1, 8, 8, 16), generator=g), torch.randn((1, 4, 4, 32), generator=g)
    p = {"w": torch.randn((32, 16, 3, 3), generator=g) / 8, "b": torch.randn(32, generator=g)}
    conv = layers.float_conv_executor({"c": p})
    got = conv("c", x, stride=2, padding=1, relu=True, skip=skip)
    want = torch.relu(F.conv2d(x.permute(0, 3, 1, 2), p["w"], p["b"], 2, 1)
                      + skip.permute(0, 3, 1, 2)).permute(0, 2, 3, 1)
    assert torch.allclose(got, want, atol=1e-5)
    same = conv("c", x, stride=2, padding="SAME", relu=True)
    assert not torch.allclose(same, torch.relu(want - skip), atol=1e-3)
    pb = {"w": p["w"].bfloat16(), "b": p["b"]}
    got16 = layers.conv_add_relu(pb, x.bfloat16(), skip.bfloat16(), 2, 1)
    want16 = torch.relu(F.conv2d(x.bfloat16().float().permute(0, 3, 1, 2), pb["w"].float(),
                                 p["b"], 2, 1) + skip.bfloat16().float().permute(0, 3, 1, 2))
    assert torch.equal(got16, want16.bfloat16().permute(0, 2, 3, 1))
    for kwargs in ({"groups": 2}, {"skip": skip}):
        with pytest.raises(ValueError, match="with its ReLU"):
            conv("c", x, stride=2, padding=1, **kwargs)


def test_pool_and_upsample():
    x = torch.randn((2, 7, 6, 3))
    got = layers.max_pool(x, 3, 2, padding=1)
    assert torch.equal(got, F.max_pool2d(x.permute(0, 3, 1, 2), 3, 2, 1).permute(0, 2, 3, 1))
    up = layers.upsample_nearest(x, (14, 12))
    assert torch.equal(up, x.repeat_interleave(2, 1).repeat_interleave(2, 2))


def test_retina800_anchors_by_torchvisions_rule():
    """120,087 anchors; the first is P3's cell (0, 0) at ratio 0.5 and size
    32 (base ``round([-22.6, -11.3, 22.6, 11.3])``), the last P7's cell (6,
    6), shift 6 x (800 // 7) = 684, at ratio 2 and size 812 (base
    ``round([-287.1, -574.2, 287.1, 574.2])``); all equal to the
    reference's, written from torchvision's ``AnchorGenerator``."""
    preset = get_preset_by_name("retina800")
    a = anchors_for_preset(preset)
    assert a.shape == (120087, 4) and preset.num_anchors == 120087
    np.testing.assert_array_equal(a[0] * 800, np.float32([0, 0, 46, 22]))
    np.testing.assert_allclose(a[-1] * 800, [684, 684, 574, 1148], rtol=1e-6)
    r = ref.anchors(CONFIG["preset"]).numpy()
    assert r.shape == (120087, 5)
    assert np.array_equal(np.bincount(r[:, 4].astype(int)), [90000, 22500, 5625, 1521, 441])
    xy = r[:, :4]
    cen = np.stack([(xy[:, 0] + xy[:, 2]) / 2, (xy[:, 1] + xy[:, 3]) / 2,
                    xy[:, 2] - xy[:, 0], xy[:, 3] - xy[:, 1]], 1)
    np.testing.assert_allclose(cen, a, atol=1e-6)


def test_preset_and_model_config_round_trip():
    preset = get_preset_by_name("retina800")
    assert preset_from_dict(preset_to_dict(preset)) == preset
    assert [m.num_shapes for m in preset.maps] == [9] * 5
    mc = model_config_from_dict(CONFIG["model"])
    assert mc.std_bgr == (57.375, 57.12, 58.395)
    d = model_config_to_dict(mc)
    assert d["std_bgr"] == list(mc.std_bgr) and model_config_from_dict(d) == mc
    assert "std_bgr" not in model_config_to_dict(ssd_vgg.ModelConfig())


def test_rcnn_decode_matches_the_reference():
    """``codec.decode_rcnn`` then ``clamp_boxes(clip=True)`` against the
    reference's ``decode`` (torchvision's coder, clipped, on the canvas) at
    retina800's anchors: the same canvas corners, but where float32's order
    of operations moves a corner across a pixel edge (one pixel, rarely);
    the size offsets clamped at ``log(1000 / 16)``."""
    from ssd_tensorflow_tpu_torch.ops.boxes import box_canvas_corners, clamp_boxes

    rng = np.random.default_rng(1)
    anc = ref.anchors(CONFIG["preset"])[::97]
    anchors = torch.from_numpy(anchors_for_preset(get_preset_by_name("retina800")))[::97]
    offsets = torch.tensor(rng.normal(0, 0.6, (len(anc), 4)), dtype=torch.float32)
    offsets[::50, 2:] = 9.0
    got = box_canvas_corners(clamp_boxes(codec.decode_rcnn(offsets, anchors), clip=True))
    # SSD's clamp leaves a box wholly above or left of the canvas off it
    ssd = box_canvas_corners(clamp_boxes(codec.decode_rcnn(offsets, anchors)))
    assert float(ssd.min()) < 0 and float(got.min()) == 0
    want = ref.canvas_corners(ref.decode(offsets, anc[:, :4]))
    assert float((got - want).abs().max()) <= 1.0
    assert float((got == want).float().mean()) >= 0.999
    huge = codec.decode_rcnn(torch.tensor([[0.0, 0.0, 50.0, 50.0]]), anchors[:1])
    assert torch.allclose(huge[0, 2:], anchors[0, 2:] * 1000 / 16, rtol=1e-6)


@pytest.mark.parametrize("top_k", [30, 1000])
def test_multi_label_decode_matches_the_reference(case, top_k, monkeypatch):
    """The multi-label decode + NMS of the port's float32 outputs against
    the reference's ``detect`` of its own, by the benchmark's own check
    (``benchlib/check.serving_numbers``) at float32's tolerances; each
    image answers with ``min(max_detections, NMS survivors)`` rows (the
    benchmark's check does not count them)."""
    cfg, params, images, (want_l, want_c) = case
    det = dict(cfg["detection"], top_k=top_k, max_detections=40)
    mc = model_config_from_dict(cfg["model"])
    model = InferenceModel(params, mc, detection=DetectionConfig(**det), device="cpu")
    postprocess.retina_select.candidates = 0
    kept, keep = [], postprocess._keep
    monkeypatch.setattr(postprocess, "_keep", lambda *a: kept.append(keep(*a)) or kept[-1])
    dets = model.run_scores(images)
    sent = int(postprocess.retina_select.candidates)
    survivors = kept[0].sum(1)
    assert int(survivors.max()) > 40
    assert torch.equal(dets.valid.sum(1), survivors.clamp_max(40))
    ref_dets = ref.detect(want_l, want_c, ref.anchors(cfg["preset"]), det)
    rows = min(sum(min(top_k, n * K) for n in (576, 144, 36, 9, 9)), 40)
    assert dets.boxes.shape == (2, rows, 4)
    with torch.no_grad():
        logits, _, _ = ssd_vgg.apply_scores(model.params, images, mc)
    above = [(torch.sigmoid(lg) > det["confidence_threshold"]).sum((1, 2)) for lg in logits]
    assert sent == sum(int(torch.clamp_max(a, top_k).sum()) for a in above)
    # judged as the benchmark judges the card: each detection against the
    # reference at every anchor, each reference detection against the
    # port's; both are float32, so within a canvas pixel and 1e-5 of a
    # score (an NMS decision at IoU 0.5 may flip on a pixel: a flip reads
    # the overlap's shortfall, and one at the cap its height above the cut)
    prog = [(dets.boxes[i], dets.scores[i], dets.classes[i], dets.valid[i]) for i in range(2)]
    numbers = check.serving_numbers(prog, ref_dets, det["nms_threshold"])
    assert all(int(dets.valid[i].sum()) > 0 for i in range(2))
    assert numbers["det_residual"] <= 1.001e-3 and numbers["top_score_gap"] <= 1e-5
    assert numbers["missed_residual"] <= 1e-3 and numbers["nms_overlap"] <= 0.5
    assert isinstance(ref_dets[0]["cutoff"], ref.PerDetection)
    assert len(round(ref_dets[0]["cutoff"], 4)) == len(ref_dets[0]["scores"])


def test_multi_label_configuration_is_chosen_by_its_fields(case):
    cfg, params, _, _ = case
    mc = model_config_from_dict(cfg["model"])
    model = InferenceModel(params, mc, device="cpu")
    assert model.detection == resnext_fpn.DETECTION and model.detection.multi_label
    with pytest.raises(ValueError, match="run_scores"):
        model.run(torch.zeros((1, 64, 64, 3), dtype=torch.uint8))
    with pytest.raises(ValueError, match="sequences"):
        decode_scores(torch.zeros((1, 10)), None, torch.zeros((1, 10, 4)),
                      torch.zeros((10, 4)), model.detection)
    with pytest.raises(ValueError, match="softmax"):
        postprocess.decode_detections(torch.zeros((1, 10, 3)), torch.zeros((1, 10, 4)),
                                      torch.zeros((10, 4)), model.detection)


def test_int8_and_fake_quant_routes_raise_on_grouped_convs():
    x = torch.zeros((1, 4, 4, 64), dtype=torch.bfloat16)
    with pytest.raises(NotImplementedError, match="grouped"):
        quantized._qconv_executor({"c": {}})("c", x, padding=1, relu=True, groups=32)
    with pytest.raises(NotImplementedError, match="grouped"):
        qat._fq_executor({"c": {}}, {"c": 1.0})("c", x.float(), padding=1, relu=True, groups=32)


def test_spans_and_counters(case):
    """A forward opens ``ssd.grouped_conv`` 16 times (one a bottleneck),
    ``ssd.fpn`` once and ``ssd.retina.heads`` 10 times (two subnets on
    five levels); the decode ``ssd.retina.select`` once."""
    from torch.profiler import ProfilerActivity, profile

    cfg, params, images, _ = case
    mc = model_config_from_dict(cfg["model"])
    model = InferenceModel(params, mc, detection=DetectionConfig(**dict(cfg["detection"],
                                                                        top_k=20)),
                           device="cpu")
    calls = layers.grouped_conv.calls, resnext_fpn.retina_head.calls
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        model.run_scores(images[:1])
    assert layers.grouped_conv.calls - calls[0] == 16
    assert resnext_fpn.retina_head.calls - calls[1] == 10
    names = [e.name for e in prof.events() if e.name.startswith("ssd.")]
    assert {n: names.count(n) for n in set(names)} == {
        "ssd.grouped_conv": 16, "ssd.fpn": 1, "ssd.retina.heads": 10, "ssd.retina.select": 1}


def test_param_shapes_and_bundle_round_trip(tmp_path, case):
    """The family's parameter shapes are the reference's seeded weights',
    which a bundle holds and gives back."""
    cfg, params, _, _ = case
    mc = model_config_from_dict(cfg["model"])
    shapes = ssd_vgg.param_shapes(mc)
    assert set(params) == set(shapes) and len(shapes) == 1 + 16 * 3 + 4 + 8 + 10
    for name, leaves in shapes.items():
        kh, kw, cin, cout = leaves["w"]
        assert tuple(params[name]["w"].shape) == (cout, cin, kh, kw), name
    assert shapes["s0b0_conv2"]["w"] == (3, 3, 4, 128)
    # the seeded class bias at the paper's prior 0.01
    assert float(params["cls_logits"]["b"][0]) == pytest.approx(-math.log(99))
    path = str(tmp_path / "retina.npz")
    save_bundle(path, params, mc)
    back, mc2, _, scales = load_bundle(path)
    assert mc2 == mc and scales is None
    assert all(torch.equal(back[n]["w"], params[n]["w"]) for n in params)


def test_the_reference_imports_nothing_of_the_port():
    code = ("import sys; sys.path.insert(0, %r); import reference.retinanet_resnext50fpn; "
            "print(sorted(m for m in sys.modules if m.split('.')[0] in "
            "('ssd_tensorflow_tpu_torch', 'ssd_tensorflow_tpu', 'jax')))" % str(BENCH))
    out = subprocess.run([sys.executable, "-c", code], capture_output=True, text=True,
                         check=True)
    assert out.stdout.strip() == "[]"
