"""The port's ResNet-34 family (``models/resnet.py``, the generalised
``layers.conv2d_bias_in``) against the JAX package's ``models/resnet.py``
on the CPU, at ``rtest64`` (and ``resnet320``'s shapes).

Tolerances:
- ``group_norm`` in float32: within 1e-6 of the largest output (the port
  takes its statistics as float64 sums rounded once, JAX as float32 sums
  in XLA's order);
- float32 feature maps, inference and training routes: within 1e-5 of
  each map's largest value (found: 2.2e-6);
- bf16 maps and scores: every bf16 GroupNorm output that two float32
  computations round differently moves the next conv's inputs, so the two
  packages' bf16 maps drift apart through 16 residual blocks (found at
  rtest64: 36-53 % of map elements equal, the rest within 1.4 % of the
  largest). They are held against the float32 model instead: the port's
  bf16 distance from it no more than twice the JAX package's bf16 distance
  plus 1 % of the largest value;
- one float32 train step: each loss within 1e-6 relative (found 4.5e-7),
  each leaf's update within 1e-3 of its largest update or two float32
  ulps of its largest parameter (the resolution of ``p_new - p_old``).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from ssd_tensorflow_tpu.models import layers as jax_layers
from ssd_tensorflow_tpu.models import resnet as jax_resnet
from ssd_tensorflow_tpu.models import ssd_vgg as jax_ssd
from ssd_tensorflow_tpu.presets import get_preset_by_name as jax_preset
from ssd_tensorflow_tpu_torch import get_preset_by_name
from ssd_tensorflow_tpu_torch.models import layers, resnet, ssd_vgg

import torch_family_checks as fc

PRESET = "rtest64"


@pytest.mark.parametrize("c", [64, 3], ids=["g32", "g1"])
def test_group_norm_matches_jax(c):
    rng = np.random.default_rng(c)
    x = rng.normal(0.5, 2, (2, 9, 7, c)).astype(np.float32)
    gn = {"scale": rng.normal(1, 0.3, c).astype(np.float32),
          "bias": rng.normal(0, 0.3, c).astype(np.float32)}
    want = np.asarray(jax.jit(jax_resnet.group_norm)(x, gn))
    got = resnet.group_norm(torch.from_numpy(x), {k: torch.from_numpy(v) for k, v in gn.items()})
    assert got.dtype == torch.float32
    assert fc.rel(got, want) <= 1e-6


def test_group_norm_keeps_bf16_and_groups():
    x = torch.randn((1, 4, 4, 64), generator=torch.Generator().manual_seed(0)).to(torch.bfloat16)
    gn = {"scale": torch.ones(64), "bias": torch.zeros(64)}
    y = resnet.group_norm(x, gn).float().reshape(1, 16, 32, 2)
    assert resnet.group_norm(x, gn).dtype == torch.bfloat16
    # each group of 2 channels is normalized on its own
    assert float(y.mean(dim=(1, 3)).abs().max()) < 0.02
    assert float((y.square().mean(dim=(1, 3)) - 1).abs().max()) < 0.02


@pytest.mark.parametrize("preset", ["resnet320", "rtest64"])
def test_map_channels_and_extra_layers(preset):
    assert resnet.map_channels(get_preset_by_name(preset)) == \
        jax_resnet.map_channels(jax_preset(preset))
    assert resnet.extra_layer_defs(get_preset_by_name(preset)) == \
        jax_resnet.extra_layer_defs(jax_preset(preset))


def test_param_shapes_match_jax_init():
    cfg = ssd_vgg.ModelConfig(preset_name=PRESET, num_classes=fc.K)
    jp = fc.jax_params(PRESET)
    shapes = ssd_vgg.param_shapes(cfg)
    assert list(shapes) == list(jp)  # init order
    for name, leaves in jp.items():
        assert shapes[name] == {k: v.shape for k, v in leaves.items()}, name
    port = ssd_vgg.init_params(cfg, seed=1)
    assert float(port["s0b0_gn2"]["scale"].abs().max()) == 0.0  # zero-init residual
    assert float(port["s0b0_gn1"]["scale"].min()) == 1.0


@pytest.mark.parametrize("inference_route", [True, False], ids=["inference", "training"])
def test_float32_feature_maps_match_jax(inference_route):
    want, got = fc.feature_maps(PRESET, "float32", inference_route)
    assert len(got) == 4
    for g, w in zip(got, want):
        assert fc.rel(g, w) <= 1e-5


def test_bf16_inference_maps_track_the_float32_model():
    truth, _ = fc.feature_maps(PRESET, "float32", True)
    want, got = fc.feature_maps(PRESET, "bfloat16", True)
    for t, w, g in zip(truth, want, got):
        assert fc.rel(g, t) <= 2 * fc.rel(w, t) + 0.01
        assert float(np.mean(g == w)) >= 0.3  # found 0.36-0.53


def test_scores_and_detections_match_jax():
    want, got, jd, td = fc.scores(PRESET)
    conf, cls, locs = got
    assert conf.shape == want[0].shape and locs.shape == want[2].shape
    # found: conf 0.022, argmax 99.6 %, locs 0.125 of at most ~4
    assert float(np.abs(conf - want[0]).max()) < 0.05
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


def test_resnet320_map_shapes():
    cfg = ssd_vgg.ModelConfig(preset_name="resnet320", num_classes=80, compute_dtype="float32")
    img = torch.from_numpy(fc.images(0, 1, 320))
    with torch.no_grad():
        maps = ssd_vgg._feature_maps(ssd_vgg.init_params(cfg), img, cfg)
    assert [tuple(m.shape) for m in maps] == [
        (1, m.size.h, m.size.w, c) for m, c in zip(cfg.preset.maps, ssd_vgg.map_channels(cfg.preset))]
    assert all(torch.isfinite(m).all() for m in maps)


#: (input H, W, cin, cout, kernel, stride, padding): every conv geometry of
#: the two families, SAME with even and odd inputs (TF pads 0/1 and 1/1, the
#: 7x7 stem 2/3 and 3/3), 1x1 at strides 1 and 2, and VALID
BIAS_IN_CASES = [
    (32, 32, 3, 16, 7, 2, "SAME"), (33, 31, 3, 16, 7, 2, "SAME"),
    (10, 9, 16, 24, 3, 1, "SAME"), (10, 10, 16, 24, 3, 2, "SAME"), (5, 5, 16, 24, 3, 2, "SAME"),
    (3, 3, 16, 24, 3, 2, "SAME"), (2, 2, 16, 24, 3, 2, "SAME"),
    (8, 8, 16, 24, 1, 1, "SAME"), (8, 7, 16, 24, 1, 2, "SAME"),
    (3, 3, 16, 24, 3, 1, "VALID"), (5, 6, 16, 24, 3, 1, "VALID"),
]


@pytest.mark.parametrize("h,w,cin,cout,k,stride,padding", BIAS_IN_CASES)
def test_conv2d_bias_in_rounds_once_at_every_family_geometry(h, w, cin, cout, k, stride, padding):
    """``conv2d_bias_in`` at any stride and padding: on a zero input every
    output, borders included, is ``bf16(b)`` (the centre tap never reads
    padding); on random inputs it equals the float32 one-rounding
    reference ``bf16(conv_f32 + b)`` and the JAX package's
    ``conv2d(..., f32_out=True)`` on >= 99.9 % of elements, the rest one
    bf16 step (2^-7 of the largest output) apart."""
    rng = np.random.default_rng(h * w + k * stride)
    wt = torch.tensor(rng.normal(0, 0.3, (cout, cin, k, k)), dtype=torch.bfloat16)
    b = torch.tensor(rng.normal(0, 1, cout), dtype=torch.float32)
    wb = layers.widen_bias(wt, b)
    zero = layers.conv2d_bias_in(torch.zeros((2, h, w, cin), dtype=torch.bfloat16), wb, stride,
                                 padding)
    assert torch.equal(zero, b.to(torch.bfloat16).expand_as(zero))
    x = torch.tensor(rng.normal(0, 1, (2, h, w, cin)), dtype=torch.bfloat16)
    got = layers.conv2d_bias_in(x, wb, stride, padding).float().numpy()
    xn, pad = layers._same_input(x, wt, stride, padding, 1)
    ref = (torch.nn.functional.conv2d(xn.float(), wt.float(), None, stride, pad)
           + b.view(1, -1, 1, 1)).to(torch.bfloat16).permute(0, 2, 3, 1).float().numpy()
    jax_out = np.asarray(jax_layers.conv2d(
        jnp.asarray(x.float().numpy(), jnp.bfloat16), wt.float().permute(2, 3, 1, 0).numpy(),
        b.numpy(), stride, padding, f32_out=True), np.float32)
    for want in (ref, jax_out):
        assert got.shape == want.shape
        assert float(np.mean(got == want)) >= 0.999
        assert float(np.abs(got - want).max()) <= 2.0 ** -7 * float(np.abs(want).max())


def test_family_presets_take_no_stem_kernel():
    with pytest.raises(ValueError, match="VGG conv1-block"):
        ssd_vgg.ModelConfig(preset_name=PRESET, pallas_stem_variant="uint8")
    jcfg = jax_ssd.ModelConfig(preset_name=PRESET)
    with pytest.raises(ValueError, match="pallas_stem"):
        jax_ssd.ModelConfig(preset_name=PRESET, pallas_stem=True)
    assert ssd_vgg.ModelConfig(preset_name=PRESET).preset.backbone == jcfg.preset.backbone
