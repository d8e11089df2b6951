"""The system under test, built as a configuration file says, and the
plain reference of the same configuration (its family's module,
``benchlib/family.py``). Only here does the benchmark import the program
(``ssd_tensorflow_tpu_torch``)."""

from __future__ import annotations

import torch

from benchlib import family
from benchlib.registry import BENCH_DIR

CHECKOUT = BENCH_DIR.parent


def model_config(cfg: dict):
    from ssd_tensorflow_tpu_torch.inference import model_config_from_dict

    return model_config_from_dict(cfg["model"])


def detection_config(det: dict):
    from ssd_tensorflow_tpu_torch.ops.postprocess import DetectionConfig

    return DetectionConfig(**det)


def weights(cfg: dict, seed: int, device):
    """What both sides are handed: the bundle's path, or the family's seeded
    float32 parameters on ``device``."""
    if cfg["weights"]["kind"] == "bundle":
        return str(CHECKOUT / cfg["weights"]["path"])
    return family.of(cfg).seeded_params(cfg, seed, device)


def serving_model(cfg: dict, given, device):
    """``InferenceModel`` of the configuration: ``from_bundle`` of an int8
    bundle, or the seeded float parameters with the configuration's
    overrides (the uint8 stem)."""
    from ssd_tensorflow_tpu_torch.inference import InferenceModel

    det = detection_config(cfg["detection"])
    if cfg["weights"]["kind"] == "bundle":
        model = InferenceModel.from_bundle(given, detection=det, device=device)
        want = model_config(cfg)
        if (model.config.preset_name, model.config.num_classes) != (want.preset_name,
                                                                     want.num_classes):
            raise ValueError(f"{given} holds {model.config.preset_name} with "
                             f"{model.config.num_classes} classes; {cfg['name']} states "
                             f"{want.preset_name} with {want.num_classes}")
        return model
    return InferenceModel(given, model_config(cfg), detection=det,
                          overrides=cfg.get("serve_overrides"), device=device)


def train_step(cfg: dict, given, device):
    """``(step, state)``: ``make_train_step`` with the configuration's
    optimizer and detection settings, and a fresh state of ``given``."""
    from ssd_tensorflow_tpu_torch.ops.anchors import anchors_for_preset
    from ssd_tensorflow_tpu_torch.parallel.train_step import (
        TrainConfig,
        make_train_state,
        make_train_step,
    )

    mc = model_config(cfg)
    tr = cfg["train"]
    tc = TrainConfig(model=mc, lr_values=tuple(tr["lr_values"]),
                     lr_boundaries=tuple(tr["lr_boundaries"]), momentum=tr["momentum"],
                     weight_decay=tr["weight_decay"], detect=detection_config(tr["detect"]))
    step = make_train_step(tc, anchors_for_preset(mc.preset))
    return step, make_train_state(given, tc, device=device)


def reference_serving(cfg: dict, given, images, control: bool = False, chunk: int = 8):
    """The family's ``detect`` of ``images`` (uint8 on the reference's
    device) by its float32 reference; ``control`` computes it a precision
    below the configuration's (int8 -> int4, bf16 -> fp8)."""
    fam = family.of(cfg)
    anc = fam.anchors(cfg["preset"]).to(images.device)
    fwd = fam.serving_forward(cfg, given, control)
    out = []
    with torch.no_grad():
        for s in range(0, images.shape[0], chunk):
            logits, locs = fwd(images[s:s + chunk])
            out += fam.detect(logits, locs, anc, cfg["detection"])
    return out
