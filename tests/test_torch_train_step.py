"""The port's training forward, train step and eval step against the JAX
package's ``apply_model(inference=False)``, ``make_train_step`` and
``make_eval_step``, on the CPU at test64 (K = 20), weights from the JAX
init, inputs made with numpy from a seed.

Tolerances:
- forward: float32 within 1e-5 of the largest output; bf16 within two bf16
  steps (2 * 2^-7) of it, against JAX with ``packed_stem`` True (its
  default) and False (the port computes the plain conv1 block, the same
  math);
- one train step, float32: each loss within 1e-5 relative, each leaf's
  update (``p_new - p_old``) within 1e-3 of that leaf's largest update;
- one train step, bf16: each loss within 1e-3 relative; each leaf's update
  no further from the JAX float32 step's (relative to that leaf's largest
  float32 update) than twice the JAX bf16 step's distance from it, plus
  0.01. bf16 gradients are loose by nature: every conv rounds its output
  and its gradients to 8 bits, in another order in each library, and the
  JAX packed pool takes ``jnp.maximum`` over a width pair, which splits a
  tie's gradient 0.5 / 0.5 where ``max_pool2d`` gives all of it to one
  input (bf16 ties are common). On this batch both bf16 steps land 0.3 % to
  33 % of the largest update away from the float32 step (conv5 and
  conv6 / conv7, whose gradients nearly cancel at random init, the
  furthest); the port's distance is at most 1.7 times the JAX package's;
- eval step: losses as the train step's, detections equal in count,
  class and validity, boxes and scores within 1e-5.
"""

import dataclasses
import sys
from pathlib import Path

import jax
import numpy as np
import pytest
import torch

from ssd_tensorflow_tpu.models import ssd_vgg as jax_ssd
from ssd_tensorflow_tpu.ops.anchors import anchors_for_preset
from ssd_tensorflow_tpu.ops.postprocess import DetectionConfig as JaxDetectionConfig
from ssd_tensorflow_tpu.parallel import train_step as jax_ts
from ssd_tensorflow_tpu.presets import get_preset_by_name
from ssd_tensorflow_tpu_torch.models import ssd_vgg
from ssd_tensorflow_tpu_torch.ops.postprocess import DetectionConfig
from ssd_tensorflow_tpu_torch.parallel import train_step
from ssd_tensorflow_tpu_torch.weights import params_from_jax, params_to_jax

sys.path.insert(0, str(Path(__file__).resolve().parent))
from reference_impl import random_boxes  # noqa: E402

K = 20
BF16_STEP = 2.0 ** -7


def _cfgs(dtype, packed=True, threshold=0.5):
    jcfg = jax_ts.TrainConfig(
        model=jax_ssd.ModelConfig(preset_name="test64", num_classes=K, compute_dtype=dtype,
                                  packed_stem=packed),
        detect=JaxDetectionConfig(top_k=32, confidence_threshold=threshold))
    tcfg = train_step.TrainConfig(
        model=ssd_vgg.ModelConfig(preset_name="test64", num_classes=K, compute_dtype=dtype),
        detect=DetectionConfig(top_k=32, confidence_threshold=threshold))
    return jcfg, tcfg


def _batch(seed, b=2, g=8):
    rng = np.random.default_rng(seed)
    gt = np.stack([random_boxes(rng, g, tight=True) for _ in range(b)]).astype(np.float32)
    mask = np.ones((b, g), dtype=bool)
    mask[1, g - 3:] = False
    return {"images": rng.uniform(0, 255, (b, 64, 64, 3)).astype(np.float32),
            "gt_boxes": gt, "gt_labels": rng.integers(0, K, (b, g)).astype(np.int32),
            "gt_mask": mask}


@pytest.fixture(scope="module")
def setup():
    jcfg, _ = _cfgs("float32")
    jp = jax_ssd.init_params(jax.random.PRNGKey(0), jcfg.model)
    # nonzero biases, so that where a bias joins the sums is part of the check
    rng = np.random.default_rng(11)
    jp = {n: {k: (rng.normal(0, 0.05, v.shape).astype(np.float32) if k == "b" else np.asarray(v))
              for k, v in d.items()} for n, d in jp.items()}
    return jp, anchors_for_preset(get_preset_by_name("test64")), _batch(0)


def _rel(got, want):
    got = got.detach().float().numpy() if torch.is_tensor(got) else np.asarray(got, np.float32)
    want = np.asarray(want, np.float32)
    assert got.shape == want.shape
    return float(np.abs(got - want).max()) / max(float(np.abs(want).max()), 1e-30)


@pytest.mark.parametrize("dtype,packed", [("float32", True), ("float32", False),
                                          ("bfloat16", True), ("bfloat16", False)])
def test_training_forward_matches_jax(setup, dtype, packed):
    jp, _, batch = setup
    jcfg, tcfg = _cfgs(dtype, packed)
    jl, jloc = jax.jit(lambda p, x: jax_ssd.apply_model(p, x, jcfg.model))(jp, batch["images"])
    tl, tloc = ssd_vgg.apply_model(params_from_jax(jp), torch.from_numpy(batch["images"]),
                                   tcfg.model, inference=False)
    tol = 1e-5 if dtype == "float32" else 2 * BF16_STEP
    assert tl.dtype == tloc.dtype == torch.float32
    assert _rel(tl, jl) <= tol and _rel(tloc, jloc) <= tol


def test_training_forward_takes_no_stem_kernel_and_has_gradients(setup):
    from unittest import mock

    from ssd_tensorflow_tpu_torch.ops import stem_cuda

    jp, _, batch = setup
    _, tcfg = _cfgs("bfloat16")
    params = {n: {k: v.requires_grad_() for k, v in d.items()}
              for n, d in params_from_jax(jp).items()}
    with mock.patch.object(stem_cuda, "fused_stem", side_effect=AssertionError("stem")), \
            mock.patch.object(ssd_vgg, "widen_bias", side_effect=AssertionError("widen_bias")):
        logits, locs = ssd_vgg.apply_model(params, torch.from_numpy(batch["images"]), tcfg.model,
                                           inference=False)
    (logits.sum() + locs.sum()).backward()
    assert all(v.grad is not None and torch.isfinite(v.grad).all()
               for d in params.values() for v in d.values())


def _updates(new, old):
    return {n: {k: np.asarray(new[n][k]) - np.asarray(old[n][k]) for k in old[n]} for n in old}


def _one_step_both(jp, anchors, batch, jcfg, tcfg):
    js, jl, jd = jax_ts.make_train_step(jcfg, anchors, donate=False)(
        jax_ts.make_train_state(jp, jcfg), batch)
    state = train_step.make_train_state(params_from_jax(jp), tcfg, device="cpu")
    ts, tl, td = train_step.make_train_step(tcfg, anchors)(state, batch)
    assert ts.step == 1 and ts.opt_state.count == 1
    return (_updates(js.params, jp), jl, jd), (_updates(params_to_jax(ts.params), jp), tl, td)


@pytest.fixture(scope="module")
def jax_float32_step(setup):
    jp, anchors, batch = setup
    jcfg, _ = _cfgs("float32")
    js, jl, jd = jax_ts.make_train_step(jcfg, anchors, donate=False)(
        jax_ts.make_train_state(jp, jcfg), batch)
    return _updates(js.params, jp), jl, jd


def _port_step(jp, anchors, batch, tcfg):
    state = train_step.make_train_state(params_from_jax(jp), tcfg, device="cpu")
    ts, tl, td = train_step.make_train_step(tcfg, anchors)(state, batch)
    assert ts.step == 1 and ts.opt_state.count == 1
    return _updates(params_to_jax(ts.params), jp), tl, td


def test_one_float32_step_matches_jax(setup, jax_float32_step):
    jp, anchors, batch = setup
    ju, jl, jd = jax_float32_step
    tu, tl, td = _port_step(jp, anchors, batch, _cfgs("float32")[1])
    assert sorted(tl) == sorted(jl) == ["confidence", "l2", "localization", "total"]
    for k in jl:
        assert abs(float(tl[k]) - float(jl[k])) <= 1e-5 * abs(float(jl[k])), k
    for n in ju:
        for k in ju[n]:
            if np.abs(ju[n][k]).max():
                assert _rel(tu[n][k], ju[n][k]) <= 1e-3, (n, k)
            else:  # a layer whose ReLUs are all off at this init
                assert not np.abs(tu[n][k]).max(), (n, k)
    assert td.boxes.shape == (2, 32, 4)
    np.testing.assert_array_equal(td.valid.numpy(), np.asarray(jd.valid))


def test_one_bf16_step_matches_jax(setup, jax_float32_step):
    jp, anchors, batch = setup
    jf, _, _ = jax_float32_step
    jcfg, tcfg = _cfgs("bfloat16")
    js, jl, _ = jax_ts.make_train_step(jcfg, anchors, donate=False)(
        jax_ts.make_train_state(jp, jcfg), batch)
    ju = _updates(js.params, jp)
    tu, tl, _ = _port_step(jp, anchors, batch, tcfg)
    for k in jl:
        assert abs(float(tl[k]) - float(jl[k])) <= 1e-3 * abs(float(jl[k])), k
    for n in jf:
        for k in jf[n]:
            if np.abs(jf[n][k]).max():
                assert _rel(tu[n][k], jf[n][k]) <= 2 * _rel(ju[n][k], jf[n][k]) + 0.01, (n, k)


def test_lr_schedule_boundaries():
    sched = train_step.lr_schedule((0.1, 0.01, 0.001), (100, 200))
    jsched = jax_ts.lr_schedule((0.1, 0.01, 0.001), (100, 200))
    for step in (0, 1, 99, 100, 101, 199, 200, 201, 10 ** 6):
        assert float(sched(step)) == float(jsched(step)), step
        assert sched(step).dtype == torch.float32
    assert float(sched(100)) == pytest.approx(0.1) and float(sched(101)) == pytest.approx(0.01)
    assert float(train_step.lr_schedule((0.5,), ())(7)) == 0.5


def test_three_steps_lower_the_loss(setup):
    jp, anchors, batch = setup
    _, tcfg = _cfgs("float32")
    step = train_step.make_train_step(tcfg, anchors)
    state = train_step.make_train_state(params_from_jax(jp), tcfg, device="cpu")
    w0 = state.params["conv8_1"]["w"].clone()
    hist = []
    for _ in range(3):
        state, losses, dets = step(state, batch)
        hist.append(float(losses["total"]))
    assert state.step == 3 and np.isfinite(hist).all()
    assert hist[-1] < hist[0]
    assert not torch.equal(state.params["conv8_1"]["w"], w0)
    assert dets.boxes.shape == (2, 32, 4)


def test_eval_step_matches_jax(setup):
    jp, anchors, _ = setup
    batch = _batch(1)
    jcfg, tcfg = _cfgs("float32", threshold=0.06)
    jl, jd = jax_ts.make_eval_step(jcfg, anchors)(jp, batch)
    tl, td = train_step.make_eval_step(tcfg, anchors)(params_from_jax(jp), batch)
    for k in jl:
        assert abs(float(tl[k]) - float(jl[k])) <= 1e-5 * abs(float(jl[k])), k
    valid = np.asarray(jd.valid)
    assert valid.sum() > 0
    np.testing.assert_array_equal(td.valid.numpy(), valid)
    np.testing.assert_array_equal(td.classes.numpy()[valid], np.asarray(jd.classes)[valid])
    np.testing.assert_allclose(td.boxes.numpy()[valid], np.asarray(jd.boxes)[valid], atol=1e-5)
    np.testing.assert_allclose(td.scores.numpy()[valid], np.asarray(jd.scores)[valid], atol=1e-5)


def test_unported_options_raise(setup):
    """Tensor parallelism is the one part of the JAX package's parallelism
    that is not ported: it raises, naming its ROADMAP item. Remat, state
    and batch placement are ported (``tests/test_torch_parallel.py``)."""
    from ssd_tensorflow_tpu_torch.parallel import mesh

    jp, anchors, batch = setup
    _, tcfg = _cfgs("float32")
    state = train_step.make_train_state(params_from_jax(jp), tcfg, device="cpu")
    with pytest.raises(NotImplementedError, match="item 12"):
        train_step.shard_state(state, None, tensor_parallel=True)
    with pytest.raises(NotImplementedError, match="item 12"):
        mesh.make_mesh(model=2, device="cpu")
    assert train_step.shard_state(state, None) is state
    assert train_step.shard_batch(batch, None) is batch
    train_step.make_train_step(dataclasses.replace(tcfg, remat=True), anchors)(state, batch)


def test_ssdvgg_facade(setup):
    jp, _, batch = setup
    _, tcfg = _cfgs("float32")
    model = ssd_vgg.SSDVGG(tcfg.model)
    params = model.init(seed=3)
    assert model.num_classes == K + 1 and model.num_vars == K + 5
    for n, d in ssd_vgg.init_params(tcfg.model, seed=3).items():
        for k, v in d.items():
            assert torch.equal(params[n][k], v)
    model.params = params_from_jax(jp)
    jl, jloc = jax_ssd.SSDVGG(jax_ssd.ModelConfig(preset_name="test64", num_classes=K,
                                                  compute_dtype="float32"), jp)(batch["images"])
    tl, tloc = model(torch.from_numpy(batch["images"]))
    assert _rel(tl, jl) <= 1e-5 and _rel(tloc, jloc) <= 1e-5
    assert model.result(torch.from_numpy(batch["images"])).shape == (2, 372, K + 5)
