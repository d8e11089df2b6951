"""Inference façade: load a float model bundle and run fused detection.

The bundle is the JAX package's npz format: a ``__meta__`` JSON entry
(model config, label map, format tag) and the parameters as
``leaf_<i>`` arrays in JAX tree-flatten order, which is sorted dict keys
at every level, convolutions HWIO. Bundles written by either package
load in the other.
"""

from __future__ import annotations

import dataclasses
import json

import numpy as np
import torch

from ssd_tensorflow_tpu_torch import resolve_device
from ssd_tensorflow_tpu_torch.models.ssd_vgg import (
    ModelConfig,
    apply_scores,
    param_shapes,
    stage_head_weights,
)
from ssd_tensorflow_tpu_torch.ops.anchors import anchors_for_preset
from ssd_tensorflow_tpu_torch.ops.postprocess import (
    DetectionConfig,
    Detections,
    decode_scores,
    detections_to_boxes,
)
from ssd_tensorflow_tpu_torch.weights import params_from_jax, params_to_jax

FLOAT_BUNDLE_FORMAT = "ssd_tensorflow_tpu.bundle.v1"


def model_config_from_dict(d: dict) -> ModelConfig:
    return ModelConfig(
        preset_name=d["preset_name"],
        num_classes=d["num_classes"],
        a_trous=d.get("a_trous", True),
        compute_dtype=d.get("compute_dtype", "bfloat16"),
        mean_bgr=tuple(d.get("mean_bgr", (104.0, 117.0, 123.0))),
        packed_stem=d.get("packed_stem", True),
        l2_norm_eps=d.get("l2_norm_eps", 1e-12),
    )


def model_config_to_dict(cfg: ModelConfig) -> dict:
    """The serialization of ModelConfig in checkpoint configs and bundles."""
    return {
        "preset_name": cfg.preset_name,
        "num_classes": cfg.num_classes,
        "a_trous": cfg.a_trous,
        "compute_dtype": cfg.compute_dtype,
        "mean_bgr": list(cfg.mean_bgr),
        "packed_stem": cfg.packed_stem,
        "l2_norm_eps": cfg.l2_norm_eps,
    }


def _leaf_order(shapes: dict):
    """``(layer, leaf)`` pairs in JAX tree-flatten order (sorted keys)."""
    return [(name, key) for name in sorted(shapes) for key in sorted(shapes[name])]


def save_bundle(path: str, params, model_cfg: ModelConfig, lid2name=None):
    """Write a float inference bundle of the port's parameters."""
    tree = params_to_jax(params)
    arrays = {
        f"leaf_{i}": tree[name][key]
        for i, (name, key) in enumerate(_leaf_order(param_shapes(model_cfg)))
    }
    meta = {
        "model": model_config_to_dict(model_cfg),
        "lid2name": {str(k): v for k, v in (lid2name or {}).items()},
        "format": FLOAT_BUNDLE_FORMAT,
    }
    arrays["__meta__"] = np.frombuffer(json.dumps(meta).encode(), dtype=np.uint8)
    with open(path, "wb") as f:
        np.savez(f, **arrays)


def load_bundle(path: str):
    """Load ``(params, model config, lid2name)`` from a float bundle."""
    with np.load(path) as data:
        meta = json.loads(bytes(data["__meta__"]))
        fmt = meta.get("format", "")
        if fmt.endswith("int8.v1"):
            raise NotImplementedError(
                f"{path} is an int8 bundle ({fmt}); the int8 deploy path "
                "(models/quantized) is the port's next slice and is not ported yet"
            )
        model_cfg = model_config_from_dict(meta["model"])
        shapes = param_shapes(model_cfg)
        order = _leaf_order(shapes)
        n_leaves = sum(1 for k in data.files if k.startswith("leaf_"))
        if n_leaves != len(order):
            raise ValueError(f"{path}: {n_leaves} parameter leaves, the "
                             f"{model_cfg.preset_name} model has {len(order)}")
        tree = {name: {} for name in shapes}
        for i, (name, key) in enumerate(order):
            leaf = data[f"leaf_{i}"]
            if leaf.shape != tuple(shapes[name][key]):
                raise ValueError(f"{path}: leaf_{i} ({name}/{key}) has shape "
                                 f"{leaf.shape}, expected {shapes[name][key]}")
            tree[name][key] = leaf
        lid2name = {int(k): v for k, v in meta.get("lid2name", {}).items()}
    return params_from_jax(tree), model_cfg, lid2name


def _apply_overrides(model_cfg: ModelConfig, overrides: dict) -> ModelConfig:
    """``model_cfg`` with execution-backend fields replaced, as the JAX
    package's ``InferenceModel(overrides=...)`` does; never serialized.

    Takes ``pallas_stem_variant``, and ``pallas_stem: True`` as a no-op so
    that the JAX package's override dicts work: the port's bf16 forward
    always runs a stem kernel, so ``pallas_stem: False`` raises. On a
    bundle that does not run the bf16 float stem (float32) the stem
    overrides are dropped with the JAX package's message.
    """
    overrides = dict(overrides)
    if not overrides.get("pallas_stem", True):
        raise ValueError(
            "pallas_stem=False is not available in the port: its bf16 forward "
            "always runs a stem kernel (ops/stem_cuda.py); choose the kernel "
            "with pallas_stem_variant"
        )
    stem_keys = [k for k in ("pallas_stem", "pallas_stem_variant") if k in overrides]
    if stem_keys and model_cfg.compute_dtype != "bfloat16":
        print(f"[!] pallas_stem override ignored: this {model_cfg.compute_dtype} "
              "bundle does not run the bf16 VGG float stem")
        for k in stem_keys:
            overrides.pop(k)
    overrides.pop("pallas_stem", None)
    unknown = set(overrides) - {"pallas_stem_variant"}
    if unknown:
        raise ValueError(f"unsupported overrides {sorted(unknown)}; the port takes "
                         "pallas_stem and pallas_stem_variant")
    return dataclasses.replace(model_cfg, **overrides)


class InferenceModel:
    """End-to-end detector: uint8 BGR batch -> detections, on one device.

    ``overrides`` holds execution-backend fields of the model config,
    applied per run and never serialized (see :func:`_apply_overrides`).
    """

    def __init__(self, params, model_cfg: ModelConfig, lid2name=None,
                 detection: DetectionConfig | None = None, overrides: dict | None = None,
                 device="cuda"):
        if overrides:
            model_cfg = _apply_overrides(model_cfg, overrides)
        self.device = resolve_device(device)
        self.config = model_cfg
        self.preset = model_cfg.preset
        self.lid2name = lid2name or {}
        self.detection = detection or DetectionConfig(top_k=200, confidence_threshold=0.01)
        self.params = stage_head_weights({
            name: {key: self._stage(v) for key, v in leaves.items()}
            for name, leaves in params.items()
        })
        self.anchors = torch.from_numpy(anchors_for_preset(self.preset)).to(self.device)

    def _stage(self, value):
        """Filters in the compute dtype, channels-last (the convolutions'
        layout); biases and scales stay float32."""
        value = value.to(self.device)
        if value.dim() == 4:
            value = value.to(self.config.dtype).contiguous(memory_format=torch.channels_last)
        return value

    @classmethod
    def from_bundle(cls, path: str, **kw):
        params, cfg, lid2name = load_bundle(path)
        return cls(params, cfg, lid2name, **kw)

    def run_scores(self, images) -> Detections:
        """Forward + lazy softmax + decode + NMS of ``(B, H, W, 3)`` uint8
        BGR images (numpy or tensor); tensors stay on the device."""
        x = images if torch.is_tensor(images) else torch.from_numpy(np.ascontiguousarray(images))
        with torch.inference_mode():
            conf, cls, locs = apply_scores(self.params, x.to(self.device), self.config)
            return decode_scores(conf, cls, locs, self.anchors, self.detection)

    def detect_boxes(self, images):
        """Detections as host lists of ``(conf, Box)`` with label names."""
        return detections_to_boxes(self.run_scores(images), self.lid2name)
