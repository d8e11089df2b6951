"""Checks shared by ``test_torch_resnet.py`` and ``test_torch_mobilenet.py``:
the port's float family forward and train step against the JAX package on
the CPU, at the small presets ``rtest64`` / ``mntest64``.

Weights come from the JAX init, with every conv bias, GroupNorm scale and
GroupNorm bias redrawn from a seed (the init's zero biases and zero
residual scales would leave half of each block out of the check).
"""

import jax
import numpy as np
import torch

from ssd_tensorflow_tpu.models import ssd_vgg as jax_ssd
from ssd_tensorflow_tpu.ops.anchors import anchors_for_preset
from ssd_tensorflow_tpu.ops.postprocess import DetectionConfig as JaxDetectionConfig
from ssd_tensorflow_tpu.parallel import train_step as jax_ts
from ssd_tensorflow_tpu_torch import inference
from ssd_tensorflow_tpu_torch.models import layers, ssd_vgg
from ssd_tensorflow_tpu_torch.ops.postprocess import DetectionConfig
from ssd_tensorflow_tpu_torch.parallel import train_step
from ssd_tensorflow_tpu_torch.weights import params_from_jax, params_to_jax

K = 3


def jax_params(preset: str, seed: int = 0, num_classes: int = K):
    """JAX-initialised float32 parameters (numpy) with seeded nonzero conv
    biases and GroupNorm scales and biases."""
    cfg = jax_ssd.ModelConfig(preset_name=preset, num_classes=num_classes,
                              compute_dtype="float32")
    jp = jax_ssd.init_params(jax.random.PRNGKey(seed), cfg)
    rng = np.random.default_rng(100 + seed)
    out = {}
    for name, leaves in jp.items():
        out[name] = {k: np.asarray(v, np.float32) for k, v in leaves.items()}
        if "w" in leaves:
            out[name]["b"] = rng.normal(0, 0.1, leaves["b"].shape).astype(np.float32)
        else:
            out[name]["scale"] = rng.normal(1, 0.2, leaves["scale"].shape).astype(np.float32)
            out[name]["bias"] = rng.normal(0, 0.2, leaves["bias"].shape).astype(np.float32)
    return out


def configs(preset: str, dtype: str, num_classes: int = K):
    return (jax_ssd.ModelConfig(preset_name=preset, num_classes=num_classes, compute_dtype=dtype),
            ssd_vgg.ModelConfig(preset_name=preset, num_classes=num_classes, compute_dtype=dtype))


def images(seed: int, b: int = 2, size: int = 64):
    return np.random.default_rng(seed).integers(0, 256, (b, size, size, 3), dtype=np.uint8)


def rel(got, want):
    """max |got - want| over max |want|."""
    got = got.detach().float().numpy() if torch.is_tensor(got) else np.asarray(got, np.float32)
    want = np.asarray(want, np.float32)
    assert got.shape == want.shape
    return float(np.abs(got - want).max()) / max(float(np.abs(want).max()), 1e-30)


def port_maps(params, images, cfg, inference_route: bool = True):
    """The port's family walk of raw images through the float executor
    (``layers.float_conv_executor``): the inference one, or the training
    one; the multibox source maps, without the heads."""
    return ssd_vgg._backbone_module(cfg.preset).walk_feature_maps(
        params, ssd_vgg.preprocess(images, cfg), cfg,
        layers.float_conv_executor(params, inference=inference_route))


def feature_maps(preset: str, dtype: str, inference_route: bool, seed: int = 0):
    """``(JAX maps, port maps)`` as float32 numpy, the same weights and
    images; the JAX side with ``f32_out`` = ``inference_route``."""
    jp = jax_params(preset, seed)
    jcfg, tcfg = configs(preset, dtype)
    img = images(seed)
    want = jax.jit(lambda p, x: jax_ssd._feature_maps(p, x, jcfg, inference=inference_route))(
        jp, img)
    with torch.no_grad():
        got = port_maps(params_from_jax(jp), torch.from_numpy(img), tcfg, inference_route)
    return ([np.asarray(m, np.float32) for m in want], [m.float().numpy() for m in got])


def scores(preset: str, seed: int = 1):
    """bf16 ``apply_scores`` of both packages on the same weights and
    images, and both ``run_scores`` detections."""
    jp = jax_params(preset, seed)
    jcfg, tcfg = configs(preset, "bfloat16")
    img = images(seed)
    want = [np.asarray(v) for v in jax.jit(lambda p, x: jax_ssd.apply_scores(p, x, jcfg))(jp, img)]
    tm = inference.InferenceModel(params_from_jax(jp), tcfg, device="cpu")
    with torch.inference_mode():
        got = [v.numpy() for v in tm.forward_scores(torch.from_numpy(img))]
    from ssd_tensorflow_tpu import inference as jax_inference

    jm = jax_inference.InferenceModel(jp, jcfg, detection=JaxDetectionConfig(
        top_k=200, confidence_threshold=0.01))
    return want, got, jm._run_scores(jm.params, jm._to_device(img)), tm.run_scores(img)


def train_batch(seed: int, preset: str, b: int = 2, g: int = 6):
    rng = np.random.default_rng(seed)
    w, h = rng.uniform(0.1, 0.6, (2, b, g))
    boxes = np.stack([rng.uniform(w / 2, 1 - w / 2), rng.uniform(h / 2, 1 - h / 2), w, h], -1)
    mask = np.ones((b, g), dtype=bool)
    mask[1, g - 2:] = False
    return {"images": images(seed, b).astype(np.float32), "gt_boxes": boxes.astype(np.float32),
            "gt_labels": rng.integers(0, K, (b, g)).astype(np.int32), "gt_mask": mask}


def one_float32_step(preset: str, seed: int = 2):
    """One float32 SGD step of both packages from the same state and batch:
    ``((JAX updates, losses), (port updates, losses))``."""
    jp = jax_params(preset, seed)
    jcfg, tcfg = configs(preset, "float32")
    jtc = jax_ts.TrainConfig(model=jcfg, detect=JaxDetectionConfig(top_k=32,
                                                                   confidence_threshold=0.2))
    ttc = train_step.TrainConfig(model=tcfg, detect=DetectionConfig(top_k=32,
                                                                    confidence_threshold=0.2))
    anchors = anchors_for_preset(jcfg.preset)
    batch = train_batch(seed, preset)
    js, jl, _ = jax_ts.make_train_step(jtc, anchors, donate=False)(
        jax_ts.make_train_state(jp, jtc), batch)
    ts, tl, _ = train_step.make_train_step(ttc, anchors)(
        train_step.make_train_state(params_from_jax(jp), ttc, device="cpu"), batch)
    tnew = params_to_jax(ts.params)
    ju = {n: {k: np.asarray(js.params[n][k]) - jp[n][k] for k in jp[n]} for n in jp}
    tu = {n: {k: tnew[n][k] - jp[n][k] for k in jp[n]} for n in jp}
    return (ju, jl), (tu, tl)
