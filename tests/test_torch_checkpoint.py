"""Training checkpoints and pretrained-VGG import of the PyTorch port
against the JAX package, on the CPU at test64 (float32, K = 20).

- A JAX ``save_checkpoint`` of a ``TrainState`` after two JAX steps
  restores into the port (every leaf equal), and the port's third step
  matches JAX's third step (losses within 1e-5 relative, each leaf's
  update within 1e-3 of its largest, or two float32 ulps of the leaf's
  largest parameter where that is larger).
- A port checkpoint restores in JAX ``restore_checkpoint`` with every
  leaf equal, in the JAX leaf order (params, momentum trace, count, step).
- ``load_params_from_train_checkpoint`` and ``InferenceModel.from_checkpoint``
  give the JAX package's params and detections (the same set measure as
  ``tests/test_torch_slice.py``, here on float32: scores within 1e-4).
- ``decimate_fc6/7`` and ``load_pretrained_vgg`` on a synthetic npz equal
  the JAX package's (HWIO archive, OIHW port).
"""

import os
import sys
from pathlib import Path

import jax
import numpy as np
import pytest
import torch

from ssd_tensorflow_tpu import inference as jax_inference
from ssd_tensorflow_tpu.models import ssd_vgg as jax_ssd
from ssd_tensorflow_tpu.models import vgg16 as jax_vgg16
from ssd_tensorflow_tpu.ops.anchors import anchors_for_preset
from ssd_tensorflow_tpu.ops.postprocess import DetectionConfig as JaxDetectionConfig
from ssd_tensorflow_tpu.parallel import train_step as jax_ts
from ssd_tensorflow_tpu.presets import get_preset_by_name
from ssd_tensorflow_tpu.utils import checkpoint as jax_ckpt
from ssd_tensorflow_tpu_torch import inference
from ssd_tensorflow_tpu_torch.models import ssd_vgg, vgg16
from ssd_tensorflow_tpu_torch.ops.postprocess import DetectionConfig
from ssd_tensorflow_tpu_torch.parallel import train_step
from ssd_tensorflow_tpu_torch.utils import checkpoint
from ssd_tensorflow_tpu_torch.utils.checkpoint import train_state_from_jax, train_state_to_jax
from ssd_tensorflow_tpu_torch.weights import params_from_jax, params_to_jax

sys.path.insert(0, str(Path(__file__).resolve().parent))
from reference_impl import random_boxes  # noqa: E402

K = 20


def _batch(seed, b=2, g=6):
    rng = np.random.default_rng(seed)
    gt = np.stack([random_boxes(rng, g, tight=True) for _ in range(b)]).astype(np.float32)
    return {"images": rng.uniform(0, 255, (b, 64, 64, 3)).astype(np.float32),
            "gt_boxes": gt, "gt_labels": rng.integers(0, K, (b, g)).astype(np.int32),
            "gt_mask": np.ones((b, g), dtype=bool)}


def _jax_state_dict(state):
    return {"params": state.params, "trace": state.opt_state[0].trace,
            "count": state.opt_state[1].count, "step": state.step}


@pytest.fixture(scope="module")
def trained():
    """JAX config, port config, anchors, and the JAX state after two steps,
    its JAX step function and the batch of the third step."""
    jcfg = jax_ts.TrainConfig(
        model=jax_ssd.ModelConfig(preset_name="test64", num_classes=K, compute_dtype="float32"),
        lr_values=(1e-3, 1e-4), lr_boundaries=(2,),
        detect=JaxDetectionConfig(top_k=32, confidence_threshold=0.5))
    tcfg = train_step.TrainConfig(
        model=ssd_vgg.ModelConfig(preset_name="test64", num_classes=K, compute_dtype="float32"),
        lr_values=(1e-3, 1e-4), lr_boundaries=(2,),
        detect=DetectionConfig(top_k=32, confidence_threshold=0.5))
    anchors = anchors_for_preset(get_preset_by_name("test64"))
    jstep = jax_ts.make_train_step(jcfg, anchors, donate=False)
    state = jax_ts.make_train_state(jax_ssd.init_params(jax.random.PRNGKey(1), jcfg.model), jcfg)
    for seed in (0, 1):
        state, _, _ = jstep(state, _batch(seed))
    return jcfg, tcfg, anchors, state, jstep


def _config(tcfg):
    return {"model": inference.model_config_to_dict(tcfg.model),
            "train": {"lr_values": list(tcfg.lr_values),
                      "lr_boundaries": list(tcfg.lr_boundaries),
                      "momentum": tcfg.momentum, "weight_decay": tcfg.weight_decay},
            "lid2name": {str(i): f"class{i}" for i in range(K)}, "epoch": 2}


def _update_tol(update, old):
    """1e-3 of a leaf's largest update, or two float32 ulps of its largest
    parameter where that is larger: a difference of two rounded parameters
    resolves no finer (a layer that only weight decay moves takes steps of
    ~1e-7 on parameters of ~0.05)."""
    return max(1e-3 * np.abs(update).max(), 2.0 ** -22 * np.abs(old).max())


def _assert_trees_equal(got, want):
    assert sorted(got) == sorted(want)
    for n in want:
        assert sorted(got[n]) == sorted(want[n])
        for k in want[n]:
            np.testing.assert_array_equal(np.asarray(got[n][k]), np.asarray(want[n][k]))


def test_jax_checkpoint_restores_and_continues(tmp_path, trained):
    jcfg, tcfg, anchors, jstate, jstep = trained
    path = str(tmp_path / "e2.ckpt.npz")
    jax_ckpt.save_checkpoint(path, jstate, _config(tcfg))
    template = train_step.make_train_state(ssd_vgg.init_params(tcfg.model), tcfg, device="cpu")
    state = checkpoint.restore_checkpoint(path, template)
    assert state.step == 2 and state.opt_state.count == 2
    host = train_state_to_jax(state)
    _assert_trees_equal(host["params"], jstate.params)
    _assert_trees_equal(host["trace"], jstate.opt_state[0].trace)
    assert checkpoint.checkpoint_config(path)["epoch"] == 2

    batch = _batch(2)
    js3, jl, _ = jstep(jstate, batch)
    ts3, tl, _ = train_step.make_train_step(tcfg, anchors)(state, batch)
    assert ts3.step == 3
    for k in jl:
        assert abs(float(tl[k]) - float(jl[k])) <= 1e-5 * abs(float(jl[k])), k
    got = params_to_jax(ts3.params)
    for n in got:
        for k in got[n]:
            old = np.asarray(jstate.params[n][k])
            want = np.asarray(js3.params[n][k]) - old
            assert np.abs(got[n][k] - old - want).max() <= _update_tol(want, old), (n, k)


def test_port_checkpoint_restores_in_jax(tmp_path, trained):
    jcfg, tcfg, _, jstate, _ = trained
    state = train_state_from_jax(jax.tree_util.tree_map(np.asarray, _jax_state_dict(jstate)))
    path = str(tmp_path / "port.ckpt.npz")
    checkpoint.save_checkpoint(path, state, _config(tcfg))
    template = jax_ts.make_train_state(jax_ssd.init_params(jax.random.PRNGKey(0), jcfg.model), jcfg)
    restored = jax_ckpt.restore_checkpoint(path, template)
    flat_got, tree_got = jax.tree_util.tree_flatten(restored)
    flat_want, tree_want = jax.tree_util.tree_flatten(jstate)
    assert tree_got == tree_want and len(flat_got) == len(flat_want)
    for a, b in zip(flat_got, flat_want):
        assert np.asarray(a).dtype == np.asarray(b).dtype
        np.testing.assert_array_equal(np.asarray(a), np.asarray(b))
    assert jax_ckpt.checkpoint_config(path)["epoch"] == 2
    # and the state converts back unchanged
    again = train_state_to_jax(train_state_from_jax(train_state_to_jax(state)))
    _assert_trees_equal(again["params"], jstate.params)
    assert again["count"] == 2 and again["step"] == 2 and again["step"].dtype == np.int32


def test_restore_refuses_another_model(tmp_path, trained):
    _, tcfg, _, jstate, _ = trained
    path = str(tmp_path / "e2.ckpt.npz")
    jax_ckpt.save_checkpoint(path, jstate, _config(tcfg))
    other = ssd_vgg.ModelConfig(preset_name="test64", num_classes=3, compute_dtype="float32")
    template = train_step.make_train_state(ssd_vgg.init_params(other), tcfg, device="cpu")
    with pytest.raises(ValueError, match="shape"):
        checkpoint.restore_checkpoint(path, template)


def test_inference_from_checkpoint_matches_jax(tmp_path, trained):
    jcfg, tcfg, _, jstate, _ = trained
    path = str(tmp_path / "e2.ckpt.npz")
    jax_ckpt.save_checkpoint(path, jstate, _config(tcfg))
    params, cfg, lid2name = inference.load_params_from_train_checkpoint(path)
    jparams, jcfg_m, jlid2name = jax_inference.load_params_from_train_checkpoint(path)
    assert cfg == tcfg.model and lid2name == jlid2name
    _assert_trees_equal(params_to_jax(params), jparams)

    det = dict(top_k=200, confidence_threshold=0.02)
    tm = inference.InferenceModel.from_checkpoint(path, device="cpu",
                                                  detection=DetectionConfig(**det))
    jm = jax_inference.InferenceModel.from_checkpoint(path, detection=JaxDetectionConfig(**det))
    img = np.random.default_rng(3).integers(0, 255, (2, 64, 64, 3), dtype=np.uint8)
    got, want = tm.run_scores(img), jm._run_scores(jm.params, jm._to_device(img))
    valid = np.asarray(want.valid)
    assert valid.sum() > 0
    np.testing.assert_array_equal(got.valid.numpy(), valid)
    np.testing.assert_array_equal(got.classes.numpy()[valid], np.asarray(want.classes)[valid])
    np.testing.assert_allclose(got.scores.numpy()[valid], np.asarray(want.scores)[valid],
                               atol=1e-4)
    np.testing.assert_allclose(got.boxes.numpy()[valid], np.asarray(want.boxes)[valid],
                               atol=1e-4)
    assert [len(r) for r in tm.detect_boxes(img)] == [int(v) for v in valid.sum(1)]


def test_find_checkpoint_and_manager(tmp_path, trained):
    _, tcfg, _, jstate, _ = trained
    state = train_state_from_jax(jax.tree_util.tree_map(np.asarray, _jax_state_dict(jstate)))
    d = str(tmp_path / "ckpts")
    mgr = checkpoint.CheckpointManager(d, config=_config(tcfg), max_to_keep=2)
    for epoch in (1, 2, 3):
        mgr.save(epoch, state)
    mgr.close()
    assert sorted(os.listdir(d)) == ["e2.ckpt.npz", "e3.ckpt.npz"]
    assert checkpoint.find_checkpoint(d) == jax_ckpt.find_checkpoint(d)
    assert checkpoint.find_checkpoint(d) == (os.path.join(d, "e3.ckpt.npz"), 3)
    assert checkpoint.find_checkpoint(d, epoch=2)[1] == 2
    assert checkpoint.find_checkpoint(d, epoch=7) == (None, None)
    checkpoint.save_checkpoint(os.path.join(d, "final.ckpt.npz"), state,
                               dict(_config(tcfg), epoch=9))
    assert checkpoint.find_checkpoint(d) == jax_ckpt.find_checkpoint(d)
    assert checkpoint.find_checkpoint(d)[1] == 9
    assert checkpoint.find_checkpoint(str(tmp_path / "none")) == (None, None)


def _strided(buf, shape, steps):
    return np.lib.stride_tricks.as_strided(buf, shape, [st * buf.itemsize for st in steps],
                                           writeable=False)


def test_decimate_and_load_pretrained_vgg(tmp_path):
    rng = np.random.default_rng(4)
    # full-size fc6 / fc7 as read-only views of a small buffer (neighbours
    # along every axis differ), so that no 400 MB of random numbers is drawn
    buf = rng.normal(0, 1, 20000).astype(np.float32)
    fc6_w = _strided(buf, (7, 7, 512, 4096), (13, 5, 3, 1))
    fc7_w = _strided(buf, (1, 1, 4096, 4096), (1, 1, 3, 1))
    fc6_b = rng.normal(0, 1, (4096,)).astype(np.float32)
    fc7_b = rng.normal(0, 1, (4096,)).astype(np.float32)
    for mod in ("decimate_fc6", "decimate_fc7"):
        w, b = (fc6_w, fc6_b) if mod.endswith("6") else (fc7_w, fc7_b)
        for got, want in zip(getattr(vgg16, mod)(w, b), getattr(jax_vgg16, mod)(w, b)):
            np.testing.assert_array_equal(got, want)
    with pytest.raises(ValueError, match="fc6"):
        vgg16.decimate_fc6(fc6_w[:3], fc6_b)

    shapes = vgg16.vgg_param_shapes()
    archive = {}
    for name, shape in shapes.items():
        if name.startswith("conv") and name != "conv3_2":  # one layer missing
            archive[f"{name}/w"] = rng.normal(0, 1, shape).astype(np.float32)
            archive[f"{name}/b"] = rng.normal(0, 1, shape[3:]).astype(np.float32)
    raw = tmp_path / "vgg_raw.npz"
    np.savez(raw, **archive, **{"fc6/w": fc6_w, "fc6/b": fc6_b, "fc7/w": fc7_w, "fc7/b": fc7_b})
    pre = tmp_path / "vgg_pre.npz"
    mod = {f"mod_conv6/{k}": v for k, v in zip("wb", jax_vgg16.decimate_fc6(fc6_w, fc6_b))}
    mod.update({f"mod_conv7/{k}": v for k, v in zip("wb", jax_vgg16.decimate_fc7(fc7_w, fc7_b))})
    np.savez(pre, **archive, **mod)

    cfg = jax_ssd.ModelConfig(preset_name="test64", num_classes=K, compute_dtype="float32")
    jp = jax_ssd.init_params(jax.random.PRNGKey(2), cfg)
    for path in (raw, pre):
        want = jax_vgg16.load_pretrained_vgg(str(path), jp)
        base = params_from_jax(jp)
        got = vgg16.load_pretrained_vgg(str(path), base)
        _assert_trees_equal(params_to_jax(got), want)
        assert got["conv3_2"] is base["conv3_2"]  # missing: kept

    model = ssd_vgg.SSDVGG(ssd_vgg.ModelConfig(preset_name="test64", num_classes=K,
                                               compute_dtype="float32"))
    params = model.init(seed=5, pretrained_vgg=str(raw))
    np.testing.assert_array_equal(params["conv1_1"]["w"].numpy(),
                                  archive["conv1_1/w"].transpose(3, 2, 0, 1))
    assert torch.equal(params["classifier0"]["w"], ssd_vgg.init_params(model.config, 5)[
        "classifier0"]["w"])
