"""The port's int8 (W8A8) deploy path against the JAX package's
``models/quantized.py``, on the same numpy inputs, on the CPU.

Unit tests run the test64 preset with float parameters from a seed (and
seeded nonzero biases). What must be equal, is: ``quantize_weights``
bit for bit; the quantized activations ``xq``; the integer sums of
``int8_conv`` (its plain version, and its im2col + ``torch._int_mm``
route run on the CPU) against ``lax.conv_general_dilated`` with int32
accumulation, for every layer kind of the walk. The requantized bf16
outputs of ``_qconv`` may differ where the two libraries round the
multiply-add differently: equal on >= 99.9 % and within one bf16 step of
the largest output. The forwards are held to the float slice tests'
bounds (conf within 0.02, argmax class on >= 99 % of anchors, locs
within 0.05) and calibration to rtol 1e-5 (float32 convolutions summed
in other orders), chunked to whole to rtol 1e-6.

Full size: the committed vgg512 bundle on two fixture JPEGs decoded and
resized with cv2 as the JAX package's ``preprocess_files`` does. Found
when written: ``cls`` equal on every anchor, ``conf`` within 3e-7,
``locs`` equal; required: ``cls`` on >= 99.5 % of the anchors, ``conf``
within 0.01, ``locs`` within 0.05, and every detection with conf >= 0.5
matched on the other side by label and box within 1e-3 (one pixel of
the 1000-pixel canvas that decode clamps to).
"""

from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax import lax

from ssd_tensorflow_tpu import inference as jax_inference
from ssd_tensorflow_tpu.models import quantized as jq
from ssd_tensorflow_tpu.models import ssd_vgg as jax_ssd
from ssd_tensorflow_tpu.ops import postprocess as jax_post
from ssd_tensorflow_tpu_torch import inference
from ssd_tensorflow_tpu_torch.models import quantized as tq
from ssd_tensorflow_tpu_torch.models import ssd_vgg
from ssd_tensorflow_tpu_torch.ops import int8_conv as ic
from ssd_tensorflow_tpu_torch.ops import postprocess
from ssd_tensorflow_tpu_torch.ops.anchors import anchors_for_preset
from ssd_tensorflow_tpu_torch.weights import params_from_jax, qparams_to_jax, stage_qparams

CFG = dict(preset_name="test64", num_classes=3)
ROOT = Path(__file__).resolve().parent.parent
BUNDLE = ROOT / "assets" / "vgg512_int8_minivoc.ssdtpu.npz"
JPEGS = sorted((ROOT / "tests" / "fixtures" / "minivoc" / "test").rglob("*.jpg"))[:2]


def _bf16_step_close(got, want, share=0.999):
    got, want = np.asarray(got, np.float32), np.asarray(want, np.float32)
    scale = float(np.abs(want).max())
    assert scale > 0
    assert float(np.abs(got - want).max()) <= scale * 2.0 ** -7
    assert float(np.mean(got == want)) >= share


@pytest.fixture(scope="module")
def model():
    """JAX float params with seeded nonzero biases, the port's copy, four
    test64 images, and JAX-calibrated activation scales."""
    jcfg = jax_ssd.ModelConfig(**CFG)
    jp = jax_ssd.init_params(jax.random.PRNGKey(3), jcfg)
    rng = np.random.default_rng(5)
    for name, leaf in jp.items():
        if "w" in leaf:
            jp[name] = dict(leaf, b=rng.normal(0, 0.3, leaf["b"].shape).astype(np.float32))
    images = rng.integers(0, 256, (4, 64, 64, 3), dtype=np.uint8)
    scales = jq.calibrate_activation_scales(jp, images, jcfg)
    return jcfg, jp, params_from_jax(jp), images, scales


def test_quantize_weights_bit_for_bit(model):
    _, jp, tp, _, _ = model
    want = jq.quantize_weights(jp)
    got = qparams_to_jax(tq.quantize_weights(tp))
    assert set(got) == set(want)
    for name in want:
        assert set(got[name]) == set(want[name])
        for key in want[name]:
            w = np.asarray(want[name][key])
            assert got[name][key].dtype == w.dtype, (name, key)
            np.testing.assert_array_equal(got[name][key], w, err_msg=f"{name}/{key}")


#: (name, input (B, H, W, cin), (kh, kw, cout), stride, padding, dilation)
CONV_KINDS = [
    ("same3x3", (2, 9, 11, 16), (3, 3, 24), 1, "SAME", 1),
    ("1x1", (2, 7, 5, 32), (1, 1, 16), 1, "SAME", 1),
    ("stride2_same", (2, 9, 8, 16), (3, 3, 24), 2, "SAME", 1),
    ("valid", (3, 5, 6, 16), (3, 3, 8), 1, "VALID", 1),
    ("dilation6", (2, 14, 13, 8), (3, 3, 16), 1, "SAME", 6),
    ("cin3", (2, 12, 12, 3), (3, 3, 64), 1, "SAME", 1),
    ("head_n100", (2, 6, 6, 32), (3, 3, 100), 1, "SAME", 1),
]


def _conv_case(shape, kernel, seed):
    rng = np.random.default_rng(seed)
    x = rng.integers(-127, 128, shape, dtype=np.int8)
    w = rng.integers(-127, 128, (*kernel[:2], shape[-1], kernel[2]), dtype=np.int8)
    return x, w


def _lax_sums(x, w, stride, padding, dilation):
    return np.asarray(lax.conv_general_dilated(
        jnp.asarray(x), jnp.asarray(w), (stride, stride), padding,
        rhs_dilation=(dilation, dilation), dimension_numbers=jq._DIMNUMS,
        preferred_element_type=jnp.int32))


@pytest.mark.parametrize("name,shape,kernel,stride,padding,dilation", CONV_KINDS,
                         ids=[k[0] for k in CONV_KINDS])
def test_int8_conv_plain_sums_equal_lax(name, shape, kernel, stride, padding, dilation):
    x, w = _conv_case(shape, kernel, len(name))
    got = ic.int8_conv(torch.from_numpy(x), ic.stage_int8_weight(w), stride, padding, dilation)
    assert got.dtype == torch.int32
    np.testing.assert_array_equal(got.numpy(), _lax_sums(x, w, stride, padding, dilation))


@pytest.mark.parametrize("name,shape,kernel,stride,padding,dilation", CONV_KINDS,
                         ids=[k[0] for k in CONV_KINDS])
def test_int8_conv_im2col_route_sums_equal_lax(name, shape, kernel, stride, padding, dilation):
    """The card route's im2col, K / N / M padding and chunking (one image
    a chunk here, so that every batch has a tail), run on the CPU."""
    x, w = _conv_case(shape, kernel, 7 * len(name))
    wt = ic.stage_int8_weight(w)
    got = ic.int8_conv_im2col(torch.from_numpy(x), wt, stride, padding, dilation, chunk_bytes=1)
    want = _lax_sums(x, w, stride, padding, dilation)
    np.testing.assert_array_equal(got.numpy(), want)
    whole = ic.int8_conv_im2col(torch.from_numpy(x), wt, stride, padding, dilation)
    np.testing.assert_array_equal(whole.numpy(), want)


def test_stage_int8_weight_layout():
    w = np.random.default_rng(0).integers(-127, 128, (3, 3, 3, 100), dtype=np.int8)
    wt = ic.stage_int8_weight(w)
    # cin 3 -> 4 zero channels, K = 36 -> 48, N = 100 -> 112
    assert wt.wk.shape == (112, 48) and wt.wk.is_contiguous() and wt.cp == 4
    assert not wt.wk[100:].any() and not wt.wk[:, 36:].any()
    np.testing.assert_array_equal(wt.hwio().numpy(), w)
    taps = wt.wk[:100, :36].numpy().T.reshape(3, 3, 4, 100)
    np.testing.assert_array_equal(taps[:, :, :3], w)
    assert not taps[:, :, 3].any()


def test_int8_conv_rejects_bad_input():
    wt = ic.stage_int8_weight(np.zeros((3, 3, 8, 8), np.int8))
    with pytest.raises(ValueError, match="int8"):
        ic.int8_conv(torch.zeros((1, 4, 4, 8)), wt)
    with pytest.raises(ValueError, match="padding"):
        ic.int8_conv(torch.zeros((1, 4, 4, 8), dtype=torch.int8), wt, padding="FULL")
    with pytest.raises(ValueError, match="does not fit"):
        ic.int8_conv(torch.zeros((1, 2, 2, 8), dtype=torch.int8), wt, padding="VALID")


#: (layer, input (B, H, W) — cin from the layer, stride, padding, dilation, relu)
QCONV_CASES = [
    ("conv2_1", (2, 16, 16), 1, "SAME", 1, True),
    ("conv8_2", (2, 8, 8), 2, "SAME", 1, True),
    ("mod_conv6", (2, 8, 8), 1, "SAME", 6, True),
    ("classifier1", (2, 4, 4), 1, "SAME", 1, False),
]


@pytest.mark.parametrize("layer,hw,stride,padding,dilation,relu", QCONV_CASES,
                         ids=[c[0] for c in QCONV_CASES])
def test_qconv_matches_jax(model, layer, hw, stride, padding, dilation, relu):
    _, jp, tp, _, _ = model
    jqp = jq.quantize_weights(jp)[layer]
    cin = jqp["wq"].shape[2]
    rng = np.random.default_rng(len(layer))
    x = (rng.normal(0, 2, (*hw, cin)) * (rng.uniform(0, 1, (*hw, cin)) > 0.4)).astype(np.float32)
    xb = jnp.asarray(x, jnp.bfloat16)
    act_scale = float(np.abs(np.asarray(xb, np.float32)).max()) * 0.8 / 127 + 1e-12
    want_xq = jax.jit(lambda v: jq._quantize_lanes(v, act_scale))(xb)
    want = jax.jit(lambda qp, v: jq._qconv(qp, v, act_scale, stride, padding, dilation, relu))(
        jqp, xb)
    staged = stage_qparams({layer: tq.quantize_weights(tp)[layer]}, {layer: act_scale}, "cpu")
    xt = torch.from_numpy(np.asarray(xb, np.float32)).to(torch.bfloat16)
    np.testing.assert_array_equal(ic.quantize(xt, staged[layer]["inv"]).numpy(),
                                  np.asarray(want_xq))
    got = tq._qconv_executor(staged)(layer, xt, stride=stride, padding=padding,
                                     dilation=dilation, relu=relu)
    assert got.dtype == torch.bfloat16 and got.shape == want.shape
    _bf16_step_close(got.float().numpy(), np.asarray(want, np.float32))


def _staged(model):
    jcfg, jp, tp, _, scales = model
    return stage_qparams(tq.quantize_weights(tp), scales, "cpu")


def test_forward_matches_jax(model):
    jcfg, jp, _, images, scales = model
    want = np.asarray(jax.jit(lambda qp, x: jq._forward(qp, scales, x, jcfg))(
        jq.quantize_weights(jp), images))
    got = tq._forward(_staged(model), torch.from_numpy(images), ssd_vgg.ModelConfig(**CFG))
    assert got.shape == want.shape
    k = jcfg.num_classes + 1
    assert float(np.abs(got[..., :k].numpy() - want[..., :k]).max()) < 0.02
    assert float(np.mean(got[..., :k].numpy().argmax(-1) == want[..., :k].argmax(-1))) >= 0.99
    assert float(np.abs(got[..., k:].numpy() - want[..., k:]).max()) < 0.05


def test_forward_scores_matches_jax(model):
    jcfg, jp, _, images, scales = model
    jconf, jcls, jlocs = jax.jit(lambda qp, x: jq._forward_scores(qp, scales, x, jcfg))(
        jq.quantize_weights(jp), images)
    conf, cls, locs = tq._forward_scores(_staged(model), torch.from_numpy(images),
                                         ssd_vgg.ModelConfig(**CFG))
    assert float(np.abs(conf.numpy() - np.asarray(jconf)).max()) < 0.02
    assert float(np.mean(cls.numpy() == np.asarray(jcls))) >= 0.99
    assert float(np.abs(locs.numpy() - np.asarray(jlocs)).max()) < 0.05


def test_calibration_matches_jax_and_chunks(model):
    jcfg, jp, tp, images, scales = model
    cfg = ssd_vgg.ModelConfig(**CFG)
    whole = tq.calibrate_activation_scales(tp, torch.from_numpy(images), cfg, batch_size=4)
    chunked = tq.calibrate_activation_scales(tp, torch.from_numpy(images), cfg, batch_size=3)
    assert set(whole) == set(chunked) == set(scales)
    for k in scales:
        assert whole[k] == pytest.approx(scales[k], rel=1e-5), k
        # the max over chunks is the max over the set; oneDNN's float32
        # convolution sums in an order that depends on the batch, so only
        # to float32's rounding
        assert chunked[k] == pytest.approx(whole[k], rel=1e-6), k


def test_percentile_calibration_raises(model):
    """Percentile calibration is ported (it raised before): a sub-100
    percentile of |x| per chunk, the max over chunks, within calibration's
    rtol of the JAX package's (``test_torch_quantized_families.py`` holds
    the percentile itself to ``jnp.percentile``)."""
    jcfg, jp, tp, images, _ = model
    want = jq.calibrate_activation_scales(jp, images, jcfg, percentile=99.9, batch_size=2)
    got = tq.calibrate_activation_scales(tp, torch.from_numpy(images), ssd_vgg.ModelConfig(**CFG),
                                         percentile=99.9, batch_size=2)
    assert set(got) == set(want)
    for k in want:
        assert got[k] == pytest.approx(want[k], rel=1e-5), k
    maxabs = tq.calibrate_activation_scales(tp, torch.from_numpy(images), ssd_vgg.ModelConfig(**CFG))
    assert all(got[k] <= maxabs[k] for k in got)


def test_quantized_model_result(model):
    """QuantizedModel quantizes, calibrates and stages: its scales are
    JAX's to calibration's rtol, and its result is JAX's ``_forward`` on
    the same q-params and scales (a scale one float32 ulp apart moves
    values across rounding boundaries, so the two calibrations are not
    run through the forward)."""
    jcfg, jp, tp, images, scales = model
    qm = tq.QuantizedModel(tp, ssd_vgg.ModelConfig(**CFG), images, device="cpu")
    assert set(qm.act_scales) == set(scales)
    for k in scales:
        assert qm.act_scales[k] == pytest.approx(scales[k], rel=1e-5), k
    want = np.asarray(jax.jit(lambda qp, x: jq._forward(qp, qm.act_scales, x, jcfg))(
        jq.quantize_weights(jp), images))
    got = qm.result(images).numpy()
    k = jcfg.num_classes + 1
    assert float(np.abs(got[..., :k] - want[..., :k]).max()) < 0.02
    assert float(np.abs(got[..., k:] - want[..., k:]).max()) < 0.05


@pytest.fixture(scope="module")
def bundle_run():
    """The committed vgg512 int8 bundle through both packages' CPU
    ``_forward_scores`` and decode, on two fixture JPEGs."""
    jm = jax_inference.InferenceModel.from_bundle(str(BUNDLE))
    images, _ = jm.preprocess_files([str(p) for p in JPEGS])
    want = jax.jit(lambda qp, x: jq._forward_scores(qp, jm.act_scales, x, jm.config))(
        jm.params, images)
    tm = inference.InferenceModel.from_bundle(str(BUNDLE), device="cpu")
    with torch.inference_mode():
        got = tm.forward_scores(torch.from_numpy(images))
    return jm, tm, images, [np.asarray(v) for v in want], [v.numpy() for v in got]


def test_bundle_scores_match_jax(bundle_run):
    _, tm, images, (jconf, jcls, jlocs), (conf, cls, locs) = bundle_run
    assert len(JPEGS) == 2 and images.shape == (2, 512, 512, 3)
    assert tm.config.preset_name == "vgg512" and conf.shape == jconf.shape
    assert float(np.mean(cls == jcls)) >= 0.995
    assert float(np.abs(conf - jconf).max()) < 0.01
    assert float(np.abs(locs - jlocs).max()) < 0.05


def test_bundle_detections_match_jax(bundle_run):
    jm, tm, _, want, got = bundle_run
    jd = jax_post.decode_scores(*[jnp.asarray(v) for v in want], jnp.asarray(
        anchors_for_preset(tm.preset)), jax_post.DetectionConfig(top_k=200,
                                                                 confidence_threshold=0.01))
    td = postprocess.decode_scores(*[torch.from_numpy(v) for v in got], tm.anchors, tm.detection)
    confident = 0
    for b in range(2):
        for a, o in ((td, jd), (jd, td)):
            boxes, classes = np.asarray(a.boxes[b]), np.asarray(a.classes[b])
            scores, valid = np.asarray(a.scores[b]), np.asarray(a.valid[b])
            oboxes, oclasses = np.asarray(o.boxes[b]), np.asarray(o.classes[b])
            ovalid = np.asarray(o.valid[b])
            for i in np.flatnonzero(valid & (scores >= 0.5)):
                confident += 1
                hit = ovalid & (oclasses == classes[i]) & (
                    np.abs(oboxes - boxes[i]).max(axis=1) <= 1e-3)
                assert hit.any(), (b, i, classes[i], scores[i])
    assert confident > 0  # the trained bundle finds objects on both images
