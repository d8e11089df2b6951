"""The port's MobileNetV1 family (``models/mobilenet.py``,
``layers.depthwise_conv2d``) against the JAX package's
``models/mobilenet.py`` on the CPU, at ``mntest64`` (and
``mobilenet320``'s shapes). Tolerances as in ``test_torch_resnet.py``;
found: float32 maps within 9.4e-7 of the largest value, bf16 maps 68-89 %
of elements equal to JAX's, one float32 step's losses within 2.2e-7
relative.

``depthwise_conv2d`` in bf16: the inference form (``f32_out=True``) and
the two-rounding form both equal the JAX package's on >= 99.9 % of
elements, the rest one bf16 step (2^-7 of the largest output) apart: nine
exact products summed in float32 in another order may round the other
way.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from ssd_tensorflow_tpu.models import layers as jax_layers
from ssd_tensorflow_tpu.models import mobilenet as jax_mobilenet
from ssd_tensorflow_tpu.presets import get_preset_by_name as jax_preset
from ssd_tensorflow_tpu_torch import get_preset_by_name
from ssd_tensorflow_tpu_torch.models import layers, mobilenet, ssd_vgg

import torch_family_checks as fc

PRESET = "mntest64"


@pytest.mark.parametrize("preset", ["mobilenet320", "mntest64"])
def test_map_channels_and_extra_layers(preset):
    assert mobilenet.map_channels(get_preset_by_name(preset)) == \
        jax_mobilenet.map_channels(jax_preset(preset))
    assert mobilenet.extra_layer_defs(get_preset_by_name(preset)) == \
        jax_mobilenet.extra_layer_defs(jax_preset(preset))


def test_too_many_maps_raise():
    import dataclasses

    preset = get_preset_by_name("mobilenet320")
    longer = dataclasses.replace(preset, maps=preset.maps + preset.maps[-1:])
    with pytest.raises(ValueError, match="EXTRA_DEFS"):
        mobilenet.extra_layer_defs(longer)


def test_param_shapes_match_jax_init():
    cfg = ssd_vgg.ModelConfig(preset_name=PRESET, num_classes=fc.K)
    jp = fc.jax_params(PRESET)
    shapes = ssd_vgg.param_shapes(cfg)
    assert list(shapes) == list(jp)
    for name, leaves in jp.items():
        assert shapes[name] == {k: v.shape for k, v in leaves.items()}, name
    port = ssd_vgg.init_params(cfg, seed=1)
    assert port["b1_dw"]["w"].shape == (32, 1, 3, 3)  # OIHW of HWIO (3, 3, 1, 32)


@pytest.mark.parametrize("inference_route", [True, False], ids=["inference", "training"])
def test_float32_feature_maps_match_jax(inference_route):
    want, got = fc.feature_maps(PRESET, "float32", inference_route)
    assert len(got) == 3
    for g, w in zip(got, want):
        assert fc.rel(g, w) <= 1e-5


@pytest.mark.parametrize("inference_route", [True, False], ids=["inference", "training"])
def test_bf16_maps_track_the_float32_model(inference_route):
    truth, _ = fc.feature_maps(PRESET, "float32", inference_route)
    want, got = fc.feature_maps(PRESET, "bfloat16", inference_route)
    for t, w, g in zip(truth, want, got):
        assert fc.rel(g, t) <= 2 * fc.rel(w, t) + 0.01
        assert float(np.mean(g == w)) >= 0.5  # found 0.68-0.89


def test_scores_and_detections_match_jax():
    want, got, jd, td = fc.scores(PRESET)
    conf, cls, locs = got
    # found: conf 0.0028, argmax 99.6 %, locs 0.016
    assert float(np.abs(conf - want[0]).max()) < 0.02
    assert float(np.mean(cls == want[1])) >= 0.99
    assert fc.rel(locs, want[2]) <= 0.05
    counts = td.valid.sum(dim=1).numpy()
    assert (np.abs(counts - np.asarray(jd.valid).sum(axis=1)) <= 0.05 * counts.max()).all()


def test_one_float32_train_step_matches_jax():
    (ju, jl), (tu, tl) = fc.one_float32_step(PRESET)
    for k in jl:
        assert abs(float(tl[k]) - float(jl[k])) <= 1e-6 * abs(float(jl[k])), k
    jp = fc.jax_params(PRESET, 2)
    for n in ju:
        for k in ju[n]:
            tol = max(1e-3 * float(np.abs(ju[n][k]).max()), 2.0 ** -22 * float(np.abs(jp[n][k]).max()))
            assert float(np.abs(tu[n][k] - ju[n][k]).max()) <= tol, (n, k)


def test_l2_regularizer_sums_every_filter_and_skips_group_norms():
    from ssd_tensorflow_tpu.models.loss import l2_regularizer as jax_l2
    from ssd_tensorflow_tpu_torch.models.loss import l2_regularizer
    from ssd_tensorflow_tpu_torch.weights import params_from_jax

    jp = fc.jax_params(PRESET)
    got = float(l2_regularizer(params_from_jax(jp)))
    assert got == pytest.approx(float(jax_l2(jp)), rel=1e-6)
    assert got == pytest.approx(sum(0.5 * float((v["w"].astype(np.float64) ** 2).sum())
                                    for v in jp.values() if "w" in v), rel=1e-6)


def test_mobilenet320_map_shapes():
    cfg = ssd_vgg.ModelConfig(preset_name="mobilenet320", num_classes=20, compute_dtype="float32")
    img = torch.from_numpy(fc.images(0, 1, 320))
    with torch.no_grad():
        maps = ssd_vgg._feature_maps(ssd_vgg.init_params(cfg), img, cfg)
    assert [tuple(m.shape) for m in maps] == [
        (1, m.size.h, m.size.w, c) for m, c in zip(cfg.preset.maps, ssd_vgg.map_channels(cfg.preset))]
    assert all(torch.isfinite(m).all() for m in maps)


@pytest.mark.parametrize("f32_out", [True, False])
@pytest.mark.parametrize("size,stride", [(10, 1), (10, 2), (9, 2)])
def test_depthwise_conv2d_matches_jax(size, stride, f32_out):
    rng = np.random.default_rng(size * stride + f32_out)
    c = 48
    x = jnp.asarray(rng.normal(0, 2, (2, size, size + 1, c)), jnp.bfloat16)
    w = rng.normal(0, 0.4, (3, 3, 1, c)).astype(np.float32)
    b = rng.normal(0, 1, c).astype(np.float32)
    want = np.asarray(jax_layers.depthwise_conv2d(x, w, b, stride, f32_out=f32_out), np.float32)
    got = layers.depthwise_conv2d(torch.from_numpy(np.asarray(x, np.float32)).to(torch.bfloat16),
                                  torch.from_numpy(w.transpose(3, 2, 0, 1).copy()),
                                  torch.from_numpy(b), stride, f32_out=f32_out)
    assert got.dtype == torch.bfloat16
    got = got.float().numpy()
    assert got.shape == want.shape
    assert float(np.mean(got == want)) >= 0.999
    assert float(np.abs(got - want).max()) <= 2.0 ** -7 * float(np.abs(want).max())


def test_depthwise_conv2d_float32_matches_jax():
    rng = np.random.default_rng(3)
    x = rng.normal(0, 1, (2, 7, 6, 16)).astype(np.float32)
    w = rng.normal(0, 0.4, (3, 3, 1, 16)).astype(np.float32)
    b = rng.normal(0, 1, 16).astype(np.float32)
    want = np.asarray(jax_layers.depthwise_conv2d(x, w, b, 2))
    got = layers.depthwise_conv2d(torch.from_numpy(x), torch.from_numpy(w.transpose(3, 2, 0, 1).copy()),
                                  torch.from_numpy(b), 2)
    assert fc.rel(got, want) <= 1e-6
    with pytest.raises(ValueError, match="depthwise"):
        layers.depthwise_conv2d(torch.from_numpy(x), torch.zeros((16, 2, 3, 3)))


def test_relu6_bounds():
    x = torch.tensor([-3.0, -0.0, 0.5, 5.96875, 6.0, 6.03125, 1e4], dtype=torch.bfloat16)
    got = mobilenet.relu6(x)
    assert got.dtype == torch.bfloat16
    want = np.asarray(jax_mobilenet.relu6(jnp.asarray(x.float().numpy(), jnp.bfloat16)), np.float32)
    np.testing.assert_array_equal(got.float().numpy(), want)
    assert float(got.min()) == 0.0 and float(got.max()) == 6.0
