"""The port's QAT (``models/qat.py``) against the JAX package's, on the CPU
at test64 / rtest64 / mntest64 (K = 3), weights from the JAX init with
seeded nonzero biases and GroupNorm leaves, uint8 images made with numpy
from a seed.

Tolerances:
- ``fake_quant_weight`` / ``fake_quant_act``: values and gradients (a
  seeded cotangent through ``jax.grad`` and autograd) equal bit for bit,
  the zero gradient at saturation included (the weight's against JAX op
  by op: XLA's jit multiplies by float32(1 / 127) where the source
  divides by 127);
- the fake-quant forwards, with JAX's activation grids handed to the
  port's quantizers: logits and locs within 1e-4 of their largest, argmax
  equal on >= 99.9 % of anchors, gradients of every leaf within 1e-4 of
  that leaf's largest (or ``GRAD_FLOOR`` of the model's largest; 5e-3
  below a VGG pool), and two QAT train steps' losses within 1e-5
  relative. Left to its own roundings the port's forward agrees on argmax
  on >= 99 %: a float32 conv sums in another order in each library, an
  input one ulp across a half step rounds to the next integer, and the
  int8 grid carries the step on, layer after layer. The roundings the
  port would take otherwise are counted (at most 0.2 %);
- the fake-quant forward against the port's own int8 path: the floors of
  the JAX package's ``tests/test_qat.py``;
- the QAT contract: stored scales resumed and exported with calibration
  patched to raise; the exported bundle's leaves equal the JAX package's
  bundle of ``quantize_weights[_folded]`` on the same params and stored
  scales, bit for bit.
"""

import json
from functools import partial
from unittest import mock

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from ssd_tensorflow_tpu import inference as jax_inference
from ssd_tensorflow_tpu.models import qat as jax_qat
from ssd_tensorflow_tpu.models import quantized as jax_quantized
from ssd_tensorflow_tpu.models import ssd_vgg as jax_ssd
from ssd_tensorflow_tpu.ops.anchors import anchors_for_preset
from ssd_tensorflow_tpu.parallel import train_step as jax_ts
from ssd_tensorflow_tpu.presets import get_preset_by_name
from ssd_tensorflow_tpu_torch import inference
from ssd_tensorflow_tpu_torch.models import qat, quantized, ssd_vgg
from ssd_tensorflow_tpu_torch.parallel import train_step
from ssd_tensorflow_tpu_torch.utils.checkpoint import checkpoint_config, save_checkpoint
from ssd_tensorflow_tpu_torch.weights import params_from_jax, params_to_jax

K = 3
PRESETS = ["test64", "rtest64", "mntest64"]
FAMILIES = ["rtest64", "mntest64"]


def _jax_params(preset):
    jcfg = jax_ssd.ModelConfig(preset_name=preset, num_classes=K, compute_dtype="float32")
    jp = jax_ssd.init_params(jax.random.PRNGKey(0), jcfg)
    rng = np.random.default_rng(5)
    out = {}
    for name, leaves in jp.items():
        out[name] = {k: np.asarray(v, np.float32) for k, v in leaves.items()}
        if "w" in leaves:
            out[name]["b"] = rng.normal(0, 0.05, leaves["b"].shape).astype(np.float32)
        elif "bias" in leaves:
            out[name]["scale"] = rng.normal(1, 0.2, leaves["scale"].shape).astype(np.float32)
            out[name]["bias"] = rng.normal(0, 0.2, leaves["bias"].shape).astype(np.float32)
    return out


def _configs(preset):
    """``(JAX config, port config)`` as QAT trains: float32, L2 eps 1e-3."""
    return (jax_ssd.ModelConfig(preset_name=preset, num_classes=K, compute_dtype="float32",
                                l2_norm_eps=1e-3),
            qat.qat_model_config(ssd_vgg.ModelConfig(preset_name=preset, num_classes=K)))


def _images(seed, b=2):
    return np.random.default_rng(seed).integers(0, 256, (b, 64, 64, 3), dtype=np.uint8)


@pytest.fixture(scope="module", params=PRESETS)
def setup(request):
    """Weights, images and the JAX package's calibration (VGG per-layer
    scales, a family's per-channel amax) of one preset."""
    preset = request.param
    jp = _jax_params(preset)
    jcfg, tcfg = _configs(preset)
    img = _images(1)
    if preset == "test64":
        scales = jax_quantized.calibrate_activation_scales(jp, img, jcfg)
    else:
        scales = jax_quantized.calibrate_activation_amax(jp, img, jcfg)
    return preset, jp, jcfg, tcfg, img, scales


def _rel(got, want):
    got = got.detach().float().numpy() if torch.is_tensor(got) else np.asarray(got, np.float32)
    want = np.asarray(want, np.float32)
    assert got.shape == want.shape
    return float(np.abs(got - want).max()) / max(float(np.abs(want).max()), 1e-30)


# ---------------------------------------------------------------------------
# The quantizers
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("shape", [(3, 3, 8, 16), (1, 1, 32, 5), (3, 3, 1, 24)])
def test_fake_quant_weight_matches_jax_bit_for_bit(shape):
    """Bit for bit against the JAX function as written (op by op). XLA's
    jit turns its ``/ 127.0`` into a multiply by float32(1 / 127), which
    moves some channels' scale, and with it their values, by an ulp: the
    port divides, as the export's ``quantize_weights`` does."""
    rng = np.random.default_rng(sum(shape))
    w = rng.normal(0, 0.1, shape).astype(np.float32)
    w[..., 0] = 0.0  # an all-zero channel: the 1e-12 floor of the scale
    cot = rng.normal(0, 1, shape).astype(np.float32)
    fq = jax_qat.fake_quant_weight(w)
    grad = jax.grad(lambda w: jnp.sum(jax_qat.fake_quant_weight(w) * cot))(w)
    tw = torch.from_numpy(w.transpose(3, 2, 0, 1).copy()).requires_grad_(True)
    got = qat.fake_quant_weight(tw)
    (got * torch.from_numpy(cot.transpose(3, 2, 0, 1).copy())).sum().backward()
    got = got.detach().numpy().transpose(2, 3, 1, 0)
    np.testing.assert_array_equal(got, np.asarray(fq))
    np.testing.assert_array_equal(tw.grad.numpy().transpose(2, 3, 1, 0), np.asarray(grad))
    scale = np.maximum(np.abs(w).max(axis=(0, 1, 2)) / np.float32(127), np.float32(1e-12))
    jitted = np.asarray(jax.jit(jax_qat.fake_quant_weight)(w))
    assert (np.abs(jitted - got) <= 127 * np.spacing(scale) + np.spacing(np.abs(got))).all()


@pytest.mark.parametrize("jit", [False, True], ids=["eager", "jit"])
@pytest.mark.parametrize("scale", [0.1, 0.05, 0.0123, "per_channel"])
def test_fake_quant_act_matches_jax_bit_for_bit(scale, jit):
    rng = np.random.default_rng(3)
    x = rng.normal(0, 4, (2, 5, 5, 8)).astype(np.float32)
    x[0, 0, 0, :3] = [-100.0, 100.0, 0.0]  # saturated: zero gradient
    if scale == "per_channel":
        scale_j = rng.uniform(0.01, 0.2, 8).astype(np.float32)
        scale_t = torch.from_numpy(scale_j)
    else:
        scale_j = scale_t = scale
    cot = rng.normal(0, 1, x.shape).astype(np.float32)

    def loss(x):
        return jnp.sum(jax_qat.fake_quant_act(x, scale_j) * cot)

    fq, grad = (jax.jit if jit else lambda f: f)(
        lambda x: (jax_qat.fake_quant_act(x, scale_j), jax.grad(loss)(x)))(x)
    tx = torch.from_numpy(x).requires_grad_(True)
    got = qat.fake_quant_act(tx, scale_t)
    (got * torch.from_numpy(cot)).sum().backward()
    np.testing.assert_array_equal(got.detach().numpy(), np.asarray(fq))
    np.testing.assert_array_equal(tx.grad.numpy(), np.asarray(grad))
    assert tx.grad[0, 0, 0, 0] == 0 and tx.grad[0, 0, 0, 1] == 0


def test_fake_quant_act_gates_at_saturation():
    """The JAX package's own cases: no gradient where the quantizer
    saturates, values clipped to +-127 steps."""
    x = torch.tensor([-100.0, -1.0, 0.0, 1.0, 100.0], requires_grad=True)
    qat.fake_quant_act(x, 0.1).sum().backward()
    assert x.grad.tolist() == [0, 1, 1, 1, 0]
    q = qat.fake_quant_act(torch.tensor([-1000.0, -0.4, 0.0, 0.4, 1000.0]), 0.1)
    np.testing.assert_allclose(q.numpy(), [-12.7, -0.4, 0.0, 0.4, 12.7], atol=1e-4)


# ---------------------------------------------------------------------------
# The fake-quant forwards
# ---------------------------------------------------------------------------


class _Grids:
    """JAX's activation grids, recorded from inside its jitted programs and
    handed to the port's quantizers in the same order: with equal grids
    every other step of
    the two forwards must agree to float32 rounding. The port's own grid of
    each quantizer input is kept, to count the roundings that differ."""

    def __init__(self):
        self.jax, self.port, self.calls = {}, [], 0

    def recording(self, real):
        """JAX's ``fake_quant_act``, reporting its grid to the host."""
        traced = iter(range(10 ** 6))

        def fq(x, scale):
            grid = jnp.clip(jnp.round(x / scale), -127, 127)
            jax.debug.callback(partial(self.jax.__setitem__, next(traced)), grid)
            return real(x, scale)
        return fq

    def forced(self):
        """The port's ``fake_quant_act`` with JAX's grid in place of its own
        rounding (the clipped STE from the port's input)."""
        def fq(x, scale):
            s = scale if torch.is_tensor(scale) else torch.tensor(scale, dtype=torch.float32)
            self.port.append(torch.clamp(torch.round(x.detach() / s), -127, 127).numpy())
            grid = torch.tensor(np.asarray(self.jax[self.calls], np.float32))
            self.calls += 1
            in_range = (x.abs() <= 127.5 * scale).to(x.dtype)
            return (grid * scale).detach() + in_range * (x - x.detach())
        return fq

    def differing(self):
        """``(roundings the port would take otherwise, all roundings)``."""
        assert self.calls == len(self.jax) > 0
        grids = [self.jax[i] for i in range(self.calls)]
        return (sum(int((a != b).sum()) for a, b in zip(grids, self.port)),
                sum(g.size for g in grids))


#: VGG leaves whose gradient passes a max-pool: on the fake-quant grid a
#: conv's outputs are ``a * s * N + b`` with integer ``N``, so two inputs
#: of a window can tie in exact arithmetic, and each library's float32
#: rounding then routes the window's gradient to either one
BELOW_A_POOL = {"conv1_1", "conv1_2", "conv2_1", "conv2_2", "conv3_1", "conv3_2", "conv3_3"}


#: the gradient gap every leaf is allowed beside its own bound, as a
#: share of the model's largest gradient. Measured: the biases before a
#: GroupNorm of one channel per group (mntest64's stem_conv and b1_dw),
#: whose gradient is zero in exact arithmetic, 7.9e-11 and 2.1e-8; test64's
#: conv5_1/w and rtest64's s3b0_gn1/scale, small leaves (6.9e-4 and 1.8e-3
#: of the largest) that are 2.5e-4 and 2.6e-4 of their own largest off
#: JAX's, 1.7e-7 and 4.6e-7. Every other leaf is within its own bound.
GRAD_FLOOR = 1e-6


def _loss(logits, locs):
    return (logits ** 2).mean() + (locs ** 2).mean()


def test_qat_forward_and_gradients_match_jax(setup):
    """The fake-quant forward and the gradient of every leaf, JAX's jitted
    forward against the port's with JAX's grids handed in: logits and locs
    within 1e-4 of their largest, argmax on >= 99.9 %; gradients within
    1e-4 of each leaf's largest (5e-3 below a VGG max-pool,
    ``BELOW_A_POOL``) or of ``GRAD_FLOOR`` of the model's largest,
    whichever is larger (a bias before a GroupNorm of one channel per
    group has a zero gradient in exact arithmetic, float32 noise in both
    packages).
    The roundings the port takes otherwise are counted, and the port's
    forward left to its own roundings is held to argmax >= 99 %."""
    preset, jp, jcfg, tcfg, img, scales = setup
    grids = _Grids()
    with mock.patch.object(jax_qat, "fake_quant_act", grids.recording(jax_qat.fake_quant_act)):
        jfwd = jax_qat.make_qat_forward(jcfg, scales)
        (_, (jl, jloc)), jgrad = jax.jit(jax.value_and_grad(
            lambda p: (lambda o: (_loss(*o), o))(jfwd(p, jnp.asarray(img))), has_aux=True))(jp)
    params = {n: {k: v.requires_grad_(True) for k, v in d.items()}
              for n, d in params_from_jax(jp).items()}
    with mock.patch.object(qat, "fake_quant_act", grids.forced()):
        tl, tloc = qat.make_qat_forward(tcfg, scales)(params, torch.from_numpy(img))
    _loss(tl, tloc).backward()
    differ, total = grids.differing()
    print(f"{preset}: {differ} of {total} activation roundings of the port differ from JAX's")
    assert tl.dtype == tloc.dtype == torch.float32
    assert _rel(tl, jl) <= 1e-4 and _rel(tloc, jloc) <= 1e-4, (_rel(tl, jl), _rel(tloc, jloc))
    assert (tl.argmax(-1).numpy() == np.asarray(jl).argmax(-1)).mean() >= 0.999
    assert differ <= 2e-3 * total
    got = params_to_jax({n: {k: v.grad for k, v in d.items()} for n, d in params.items()})
    largest = max(float(np.abs(np.asarray(v)).max()) for d in jgrad.values() for v in d.values())
    for n in jgrad:
        for k in jgrad[n]:
            want = np.asarray(jgrad[n][k])
            assert np.isfinite(got[n][k]).all() and np.abs(want).max() > 0, (n, k)
            err = float(np.abs(got[n][k] - want).max())
            own = (5e-3 if n in BELOW_A_POOL else 1e-4) * float(np.abs(want).max())
            assert err <= max(own, GRAD_FLOOR * largest), (n, k, err / largest)
    assert any(n.endswith("_dw") for n in jgrad) == (preset == "mntest64")
    with torch.no_grad():
        free = qat.make_qat_forward(tcfg, scales)(params, torch.from_numpy(img))[0]
    assert (free.argmax(-1).numpy() == np.asarray(jl).argmax(-1)).mean() >= 0.99


def test_two_qat_train_steps_match_jax(setup):
    """Two ``make_qat_train_step`` steps, each with JAX's grids of that
    step handed to the port: each loss within 1e-5 relative."""
    preset, jp, jcfg, tcfg, img, scales = setup
    anchors = anchors_for_preset(get_preset_by_name(preset))
    batch = {"images": np.concatenate([img, _images(2)]),
             "gt_boxes": np.tile([[[0.375, 0.375, 0.4, 0.4], [0.6, 0.55, 0.5, 0.3]]],
                                 (4, 1, 1)).astype(np.float32),
             "gt_labels": np.tile([[1, 2]], (4, 1)).astype(np.int32),
             "gt_mask": np.ones((4, 2), bool)}
    jtcfg = jax_ts.TrainConfig(model=jcfg, lr_values=(0.001,), lr_boundaries=(), detect=None)
    ttcfg = train_step.TrainConfig(model=tcfg, lr_values=(0.001,), lr_boundaries=(), detect=None)
    grids = _Grids()
    with mock.patch.object(jax_qat, "fake_quant_act", grids.recording(jax_qat.fake_quant_act)):
        jstep = jax_qat.make_qat_train_step(jtcfg, anchors, scales, donate=False)
        js = jax_ts.make_train_state(jp, jtcfg)
        tstep = qat.make_qat_train_step(ttcfg, anchors, scales)
        ts = train_step.make_train_state(params_from_jax(jp), ttcfg, device="cpu")
        for i in range(2):
            js, jl, _ = jstep(js, batch)
            jax.block_until_ready(jl)
            grids.port, grids.calls = [], 0
            with mock.patch.object(qat, "fake_quant_act", grids.forced()):
                ts, tl, _ = tstep(ts, batch)
            for k in jl:
                assert abs(float(tl[k]) - float(jl[k])) <= 1e-5 * abs(float(jl[k])), (i, k)
    assert ts.step == 2


@pytest.mark.parametrize("preset", PRESETS)
def test_qat_forward_matches_the_int8_path(preset):
    """The fake-quant forward and the port's int8 deploy path compute the
    same network, at the floors of the JAX package's tests/test_qat.py and
    on its setup there (JAX init, images from ``default_rng(1234)``)."""
    jcfg = jax_ssd.ModelConfig(preset_name=preset, num_classes=K, compute_dtype="float32",
                               l2_norm_eps=1e-3 if preset == "test64" else 1e-12)
    tcfg = ssd_vgg.ModelConfig(preset_name=preset, num_classes=K, compute_dtype="float32",
                               l2_norm_eps=jcfg.l2_norm_eps)
    params = params_from_jax(jax_ssd.init_params(jax.random.PRNGKey(0), jcfg))
    img = np.random.default_rng(1234).integers(0, 256, (2, 64, 64, 3), dtype=np.uint8)
    with torch.no_grad():
        if preset == "test64":
            scales = quantized.calibrate_activation_scales(params, img, tcfg)
            qp, act = quantized.quantize_weights(params), scales
        else:
            scales = quantized.calibrate_activation_amax(params, img, tcfg)
            qp, act = quantized.quantize_weights_folded(params, scales), {}
        logits, locs = qat.make_qat_forward(tcfg, scales)(params, torch.from_numpy(img))
    probs = torch.softmax(logits, -1).numpy()
    model = inference.InferenceModel(qp, tcfg, device="cpu", act_scales=act)
    with torch.inference_mode():
        ref = quantized._forward(model.params, torch.from_numpy(img), tcfg).float().numpy()
    ref_probs, ref_locs = ref[..., : K + 1], ref[..., K + 1:]
    agree = (probs.argmax(-1) == ref_probs.argmax(-1)).mean()
    print(f"{preset}: fake-quant against int8 argmax agreement {agree}")
    if preset == "test64":
        assert agree > 0.95, agree
        np.testing.assert_allclose(probs, ref_probs, atol=0.05)
        np.testing.assert_allclose(locs.numpy(), ref_locs, atol=0.15)
    else:
        assert agree > {"rtest64": 0.98, "mntest64": 0.95}[preset], agree
        assert np.abs(probs - ref_probs).mean() < 0.02
        assert np.abs(locs.numpy() - ref_locs).mean() < 0.5


def test_vgg_qat_refuses_a_small_l2_eps_and_bf16():
    cfg = ssd_vgg.ModelConfig(preset_name="test64", num_classes=K)
    with pytest.raises(ValueError, match="l2_norm_eps"):
        qat.make_qat_forward(cfg, {})
    qcfg = qat.qat_model_config(cfg)
    assert qcfg.l2_norm_eps == 1e-3 and qcfg.compute_dtype == "float32"
    qat.make_qat_forward(qcfg, {})
    tcfg = train_step.TrainConfig(model=qat.qat_model_config(cfg))
    anchors = anchors_for_preset(get_preset_by_name("test64"))
    qat.make_qat_train_step(tcfg, anchors, {})
    with pytest.raises(ValueError, match="float32"):
        qat.make_qat_train_step(train_step.TrainConfig(
            model=ssd_vgg.ModelConfig(preset_name="test64", num_classes=K, l2_norm_eps=1e-3)),
            anchors, {})


# ---------------------------------------------------------------------------
# The QAT contract
# ---------------------------------------------------------------------------


def _no_calibration():
    """Every calibration entry patched to raise."""
    boom = AssertionError("a QAT checkpoint was recalibrated")
    return (mock.patch.object(quantized, "calibrate_activation_amax", side_effect=boom),
            mock.patch.object(quantized, "calibrate_activation_scales", side_effect=boom),
            mock.patch.object(quantized, "QuantizedModel", side_effect=boom))


@pytest.mark.parametrize("preset", ["test64", "mntest64"])
def test_qat_contract_end_to_end(preset, tmp_path):
    """Calibrate, checkpoint with the right key, resume and export without
    recalibrating; the bundle equals the JAX package's bundle of the same
    params and stored scales, and runs on the CPU."""
    jp = _jax_params(preset)
    jcfg, tcfg = _configs(preset)
    img = _images(3, 4)
    ttcfg = train_step.TrainConfig(model=tcfg, lr_values=(0.001,), lr_boundaries=(), detect=None)
    state = train_step.make_train_state(params_from_jax(jp), ttcfg, device="cpu")
    scales, entry = qat.qat_scales(state.params, tcfg, None, img)
    key = "qat_act_scales" if preset == "test64" else "qat_act_amax"
    assert list(entry) == [key] == [qat.qat_checkpoint_key(tcfg)]
    assert all(isinstance(v, float if preset == "test64" else list) for v in entry[key].values())

    # one QAT step, then a checkpoint carrying the scales
    batch = {"images": img, "gt_boxes": np.tile([[[0.375, 0.375, 0.4, 0.4]]], (4, 1, 1)),
             "gt_labels": np.ones((4, 1), np.int32), "gt_mask": np.ones((4, 1), bool)}
    state, _, _ = qat.make_qat_train_step(ttcfg, anchors_for_preset(get_preset_by_name(preset)),
                                          scales)(state, batch)
    ckpt = str(tmp_path / "e1.ckpt.npz")
    save_checkpoint(ckpt, state, {"model": inference.model_config_to_dict(tcfg), **entry})
    stored = checkpoint_config(ckpt)
    patches = _no_calibration()
    with patches[0], patches[1], patches[2]:
        resumed, again = qat.qat_scales(state.params, tcfg, stored, img)
        assert again == entry == {key: stored[key]}
        bundle = str(tmp_path / "qat.npz")
        act = qat.export_int8_bundle(ckpt, bundle)
    if preset == "test64":
        assert resumed == stored[key] and act == stored[key]
    else:
        assert act == {}

    # the JAX package's bundle of the same params and stored scales
    final = params_to_jax(state.params)
    if preset == "test64":
        jq, jact = jax_quantized.quantize_weights(final), stored[key]
    else:
        amax = {k: np.asarray(v, np.float32) for k, v in stored[key].items()}
        jq, jact = jax_quantized.quantize_weights_folded(final, amax), {}
    want = str(tmp_path / "jax.npz")
    jax_inference.save_bundle(want, jq, jcfg, {}, act_scales=jact)
    with np.load(bundle) as got_npz, np.load(want) as want_npz:
        assert sorted(got_npz.files) == sorted(want_npz.files)
        for f in want_npz.files:
            if f == "__meta__":
                gm, wm = (json.loads(bytes(z[f])) for z in (got_npz, want_npz))
                assert gm["act_scales"] == wm["act_scales"] and gm["model"] == wm["model"]
            else:
                assert got_npz[f].dtype == want_npz[f].dtype, f
                np.testing.assert_array_equal(got_npz[f], want_npz[f], err_msg=f)
    if preset == "mntest64":
        with np.load(bundle) as z:
            a_scales = qat.family_a_scales(stored[key])
            meta = json.loads(bytes(z["__meta__"]))
        got_q = inference.load_bundle(bundle)[0]
        for name, a in a_scales.items():
            np.testing.assert_array_equal(got_q[name]["a_scale"].numpy(), a)
        assert meta["act_scales"] == {}
    dets = inference.InferenceModel.from_bundle(bundle, device="cpu").run_scores(img)
    assert dets.boxes.shape[0] == 4 and torch.isfinite(dets.scores[dets.valid]).all()


def test_export_of_a_float_checkpoint_calibrates(tmp_path):
    """A checkpoint without QAT scales is calibrated (it needs images)."""
    jp = _jax_params("mntest64")
    _, tcfg = _configs("mntest64")
    ttcfg = train_step.TrainConfig(model=tcfg)
    ckpt = str(tmp_path / "e1.ckpt.npz")
    save_checkpoint(ckpt, train_step.make_train_state(params_from_jax(jp), ttcfg, device="cpu"),
                    {"model": inference.model_config_to_dict(tcfg)})
    with pytest.raises(ValueError, match="calibration images"):
        qat.export_int8_bundle(ckpt, str(tmp_path / "b.npz"), device="cpu")
    img = _images(4, 2)
    assert qat.export_int8_bundle(ckpt, str(tmp_path / "b.npz"), img, device="cpu") == {}
    want = quantized.QuantizedModel(params_from_jax(jp), tcfg, img, device="cpu").qparams
    got = inference.load_bundle(str(tmp_path / "b.npz"))[0]
    for name in want:
        for k in want[name]:
            assert torch.equal(got[name][k], want[name][k]), (name, k)
    with pytest.raises(ValueError, match="calibration images"):
        qat.qat_scales(params_from_jax(jp), tcfg, {})
