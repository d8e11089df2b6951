"""Model families (``benchlib/family.py``): the lookup; the VGG-16 cells
read what they read before families were added, to the bit
(``vgg_frozen.json`` holds the harness's readings from before, on this
CPU at test64); and the ResNet-34 family's reference against the program
at rtest64 on seeded random weights."""

import hashlib
import json

import h100bench_cases as hc
import pytest
import torch

from benchlib import counts, family, pool, programs, registry, train

FROZEN = json.loads((hc.BENCH / "tests" / "vgg_frozen.json").read_text())
CPU = torch.device("cpu")
SEED = 2**33 + 17


def digest(tensors) -> str:
    h = hashlib.sha256()
    for t in tensors:
        t = t.detach().cpu().contiguous()
        h.update(str(t.dtype).encode())
        h.update(str(tuple(t.shape)).encode())
        h.update(t.numpy().tobytes())
    return h.hexdigest()


def dets_digest(dets) -> list:
    return [[digest([r[k] for k in ("probs", "all_boxes", "boxes", "scores", "classes",
                                     "anchors")]), repr(r["cutoff"])] for r in dets]


# ---- the lookup -----------------------------------------------------------

def test_no_family_key_is_the_vgg_family():
    cfg = registry.config("ssd512-vgg16-int8")
    assert "family" not in cfg
    assert family.of(cfg).__name__ == "reference.ssd_ref"


def test_the_resnet_family_is_found():
    cfg = registry.config("ssd320-resnet34gn-int8")
    assert family.of(cfg).__name__ == "reference.ssd_resnet34gn"


@pytest.mark.parametrize("name", ["no_such_family", "../benchlib/family"])
def test_an_unknown_family_raises_with_its_path(name):
    cfg = dict(registry.config("ssd512-vgg16-int8"), family=name)
    with pytest.raises(ValueError, match=r"reference/.*\.py"):
        family.of(cfg)


def test_a_family_without_a_train_reference_never_falls_back():
    cfg = hc.small_config("ssd320-resnet34gn-int8")
    with pytest.raises(ValueError, match="no train reference"):
        family.train_reference(cfg)
    with pytest.raises(ValueError, match="no train reference"):
        train.TrainRun(cfg, hc.small_traffic("train-b32"), SEED, CPU)


# ---- the VGG cells read the same --------------------------------------------

@pytest.mark.parametrize("name", ["ssd512-vgg16-int8", "ssd512-vgg16-bf16"])
def test_vgg_counts_unchanged(name):
    cfg, want = registry.config(name), FROZEN["counts"][name]
    assert counts.forward_ops(cfg) == want["forward_ops"]
    assert counts.train_ops(cfg) == want["train_ops"]
    assert counts.convs_bound_s(cfg, 64) == want["convs_bound_s_b64"]
    assert counts.convs_bound_s(cfg, 32) == want["convs_bound_s_b32"]
    got = counts.conv_shapes(cfg, 64)
    assert [{k: c[k] for k in w} for c, w in zip(got, want["conv_shapes_b64"])] == \
        want["conv_shapes_b64"] and len(got) == len(want["conv_shapes_b64"])
    assert [counts.conv_bound_s(c, cfg["precision"]) for c in got] == want["conv_bound_s_b64"]
    assert [c["name"] for c in got if c["reads_image"]] == ["conv1_1"]


def test_vgg_stem_bound_unchanged():
    cfg = registry.config("ssd512-vgg16-bf16")
    assert counts.stem_bound_s(cfg, 64) == FROZEN["counts"]["stem_bound_s_b64"]


@pytest.mark.parametrize("seed", [2**32 + 5, 7])
def test_vgg_seeded_params_unchanged(seed):
    p = programs.weights(hc.small_config("ssd512-vgg16-bf16"), seed, CPU)
    assert digest([v for n in p for v in p[n].values()]) == FROZEN["seeded"][str(seed)]


@pytest.fixture(scope="module")
def vgg_bundle(tmp_path_factory):
    return hc.write_int8_bundle(tmp_path_factory.mktemp("vgg") / "test64_int8.npz")


@pytest.mark.parametrize("control", [False, True])
@pytest.mark.parametrize("label", ["int8", "bf16"])
def test_vgg_reference_detections_unchanged(label, control, vgg_bundle):
    name = {"int8": "ssd512-vgg16-int8", "bf16": "ssd512-vgg16-bf16"}[label]
    cfg = hc.small_config(name, vgg_bundle if label == "int8" else None)
    images = pool.images(4, (64, 64), registry.traffic("serve-b64")["augment"], SEED, CPU)
    ref = programs.reference_serving(cfg, programs.weights(cfg, SEED, CPU), images, control)
    assert dets_digest(ref) == FROZEN["serving"][f"{label}_control{int(control)}"]


@pytest.mark.parametrize("control", [False, True])
def test_vgg_train_reference_unchanged(control):
    cfg, traffic = hc.small_config("ssd512-vgg16-bf16"), hc.small_traffic("train-b32")
    b = traffic["batch"]
    given = programs.weights(cfg, SEED, CPU)
    imgs = pool.images(b * 3, cfg["preset"]["image_size"], traffic["augment"], SEED, CPU)
    boxes, labels, mask = pool.gt_boxes(b * 3, traffic["gt_per_image"], traffic["gt_size"],
                                        cfg["model"]["num_classes"], SEED)
    checked = [{"images": imgs[i * b:(i + 1) * b],
                "gt_boxes": torch.from_numpy(boxes[i * b:(i + 1) * b]),
                "gt_labels": torch.from_numpy(labels[i * b:(i + 1) * b]),
                "gt_mask": torch.from_numpy(mask[i * b:(i + 1) * b])} for i in range(3)]
    quant = family.train_reference(cfg).train_control if control else None
    got = train.reference_steps(cfg, given, checked, CPU, quant)
    want = FROZEN["train"][f"control{int(control)}"]
    assert got["losses"] == want["losses"]
    for key in ("grad", "change1", "change"):
        assert {"/".join(k): v for k, v in got[key].items()} == want[key], key


# ---- the ResNet-34 family against the program -----------------------------

def _resnet(precision: str, weights: dict) -> dict:
    cfg = hc.small_config("ssd320-resnet34gn-int8")
    cfg["precision"], cfg["weights"] = precision, weights
    return cfg


@pytest.fixture(scope="module")
def resnet_case(tmp_path_factory):
    """Seeded float weights, the program's int8 bundle of them, and images."""
    cfg = _resnet("bfloat16", hc.SEEDED)
    params = family.of(cfg).seeded_params(cfg, 5, CPU)
    path = tmp_path_factory.mktemp("resnet") / "rtest64_int8.npz"
    bundle = hc.write_int8_bundle(path, seed=5, config="ssd320-resnet34gn-int8")
    images = pool.images(8, (64, 64), registry.traffic("serve-b64")["augment"], 11, CPU)
    return cfg, params, bundle, images


def test_resnet_float_reference_matches_the_program(resnet_case):
    """The program's float32 forward (``layers.float_conv_executor``:
    each conv with its bias carried in as input channels, GroupNorm's sums
    in float64) against the reference's float32 walk. Both are float32
    with TF32 off, so they differ by the order of their sums alone: within
    1e-5 of the largest logit (read: 2.6e-6)."""
    from ssd_tensorflow_tpu_torch.models.ssd_vgg import ModelConfig, apply_model

    cfg, params, _, images = resnet_case
    mc = ModelConfig(preset_name="rtest64", num_classes=80, compute_dtype="float32")
    with torch.no_grad():
        logits_p, locs_p = apply_model(params, images, mc)
        logits_r, locs_r = family.of(cfg).serving_forward(cfg, params)(images)
    scale = float(logits_r.abs().max())
    assert float((logits_p - logits_r).abs().max()) <= 1e-5 * scale
    assert float((locs_p - locs_r).abs().max()) <= 1e-5 * float(locs_r.abs().max())


def _int8_gaps(cfg, bundle, images, control: bool):
    from ssd_tensorflow_tpu_torch.inference import InferenceModel
    from ssd_tensorflow_tpu_torch.models import quantized

    model = InferenceModel.from_bundle(bundle, device="cpu")
    with torch.inference_mode():
        result = quantized._forward(model.params, images, model.config)
    icfg = _resnet("int8", {"kind": "bundle", "path": bundle})
    with torch.no_grad():
        logits, locs = family.of(icfg).serving_forward(icfg, bundle, control)(images)
    k = cfg["model"]["num_classes"] + 1
    probs_gap = float((result[..., :k] - torch.softmax(logits, -1)).abs().max())
    return probs_gap, float((result[..., k:] - locs).abs().max())


# The program rounds every conv output and GroupNorm to bf16 and quantizes
# that; the reference quantizes float32. Through 48 convs the two part where
# an activation lies near a rounding boundary of its int8 grid: over eight
# seeds the program read a worst class-probability gap of 0.084-0.119 and a
# worst offset gap of 0.38-0.47 (offsets reach ~10); the int4 control read
# 0.71-0.84 and 4.4-5.3.
PROBS_GAP, LOCS_GAP = 0.25, 1.5


def test_resnet_int8_reference_matches_the_program(resnet_case):
    cfg, _, bundle, images = resnet_case
    probs_gap, locs_gap = _int8_gaps(cfg, bundle, images, control=False)
    assert probs_gap <= PROBS_GAP and locs_gap <= LOCS_GAP


def test_resnet_int4_control_fails(resnet_case):
    cfg, _, bundle, images = resnet_case
    probs_gap, locs_gap = _int8_gaps(cfg, bundle, images, control=True)
    assert probs_gap > PROBS_GAP or locs_gap > LOCS_GAP
