"""Quantization-aware training (QAT) for the int8 deploy path, as in the
JAX package's ``models/qat.py``.

The forward applies the rounding and clipping of the int8 deploy path
(``models/quantized.py``) as fake quantization with straight-through
gradients, so that SGD moves the weights to minima that survive int8:
symmetric per-output-channel weights (the scale recomputed from the live
weights every step) and static activation scales from a calibration of
the float model. VGG quantizes every conv input with one scale per layer;
the ResNet-34 / MobileNetV1 families quantize per input channel with the
scale folded into the weights (``quantized.quantize_weights_folded``) and
keep their depthwise convs weight-only. The forward is float32 from
``preprocess`` on, convolutions with TF32 off (``layers.full_float32``):
the quantized values are small integers times scales, which bf16 or TF32
would not hold.

Parameters keep the port's OIHW layout, so the per-output-channel
reductions run over dims ``(1, 2, 3)`` and a per-input-channel scale
broadcasts along dim 1. Every division by a number goes through
``ops/boxes.true_div``: right before a ``round`` a reciprocal multiply one
bit off would pick another integer.

The QAT contract (the JAX package's ``cli/train.py`` and
``cli/export_model.py``): calibrate once, store the scales in the
checkpoint (``qat_act_scales``, per-layer floats, for VGG;
``qat_act_amax``, per-input-channel lists, for the families), train and
resume against the stored values, and export the int8 bundle with exactly
those values, never recalibrating (:func:`qat_scales`,
:func:`export_int8_bundle`).
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch

from ssd_tensorflow_tpu_torch.models import quantized
from ssd_tensorflow_tpu_torch.models.layers import conv2d, depthwise_conv2d, full_float32
from ssd_tensorflow_tpu_torch.models.ssd_vgg import (
    ModelConfig,
    _backbone_module,
    anchor_order,
    preprocess,
)
from ssd_tensorflow_tpu_torch.ops.boxes import true_div

#: the conv4_3 L2-norm epsilon QAT trains with: fake quantization zeroes
#: whole pixel vectors, and ``rsqrt`` of the float path's 1e-12 would make
#: 1e6-scale gradients
QAT_L2_NORM_EPS = 1e-3
#: the smallest epsilon :func:`make_qat_forward` takes for a VGG model
MIN_L2_NORM_EPS = 1e-6


def _ste(x, q):
    """Straight-through estimator: the value of ``q``, the gradient of ``x``."""
    return x + (q - x).detach()


def fake_quant_weight(w):
    """Symmetric per-output-channel int8 fake quantization of an OIHW
    filter, the scale recomputed from the live weights as
    ``quantize_weights`` does at export: ``s = max(max|w| / 127, 1e-12)``
    (detached), ``clip(round(w / s), -127, 127) * s``, identity gradient."""
    s = true_div(w.detach().abs().amax(dim=(1, 2, 3), keepdim=True), 127.0)
    s = torch.clamp_min(s, 1e-12)
    return _ste(w, torch.clamp(torch.round(w / s), -127, 127) * s)


def fake_quant_act(x, scale):
    """Symmetric int8 fake quantization of ``x`` with the static ``scale``
    (a number, or a per-channel tensor along the last dim).

    Clipped STE: the gradient is 1 where ``|x| <= 127.5 * scale`` and 0
    where the quantizer saturates; an identity gradient there lets weights
    behind a saturated input drift until the backward explodes."""
    divisor = scale if torch.is_tensor(scale) else torch.full((), scale, dtype=x.dtype,
                                                              device=x.device)
    q = torch.clamp(torch.round(x / divisor), -127, 127) * scale
    in_range = (x.abs() <= 127.5 * scale).to(x.dtype)
    return q.detach() + in_range * (x - x.detach())


def _fq_conv(p, x, act_scale, stride=1, padding="SAME", dilation=1, relu=True):
    """The float32 twin of ``quantized._qconv``: fake-quantized input and
    filter, conv, ``+ b``, ReLU."""
    xq = fake_quant_act(x, act_scale)
    y = conv2d(xq, fake_quant_weight(p["w"].float()), None, stride, padding, dilation)
    y = y + p["b"].float()
    return torch.relu(y) if relu else y


def qat_apply_model(params, images, config: ModelConfig, act_scales):
    """Fake-quantized VGG forward -> ``(logits, locs)`` like
    ``ssd_vgg.apply_model``: the int8 path's own walk
    (``quantized._walk``: the pools, the dilated conv6, the conv12_1 pad,
    the float L2-norm) with a fake-quant conv at each layer, then the
    heads. ``act_scales`` maps every conv and head to its per-layer scale."""
    x = preprocess(images, config).float()

    def conv(name, x, stride=1, padding="SAME", dilation=1):
        return _fq_conv(params[name], x, act_scales[name], stride, padding, dilation)

    maps = quantized._walk(conv, x, params["l2_norm_conv4_3"]["scale"], config)
    return _heads(maps, config, lambda i, fmap: _fq_conv(
        params[f"classifier{i}"], fmap, act_scales[f"classifier{i}"], relu=False))


def _heads(maps, config: ModelConfig, head):
    """``head(i, map)`` of each map -> ``(logits, locs)`` in the anchor order."""
    out = anchor_order([head(i, fmap) for i, fmap in enumerate(maps)], config)
    return out[:, :, : config.num_classes + 1], out[:, :, config.num_classes + 1:]


def _fq_conv_folded(p, x, a_scale, stride=1, padding="SAME"):
    """The float32 twin of a family's int8 conv (``quantized._qconv_folded``):
    ``conv(fq_act(x, a), fq_w(w * a) / a) + b``, the per-input-channel
    activation scale ``a`` folded into the filter before its per-output
    -channel fake quantization and divided out after. Gradients: clipped
    STE through the activation, identity through the weight."""
    a = a_scale[None, :, None, None]
    xq = fake_quant_act(x.float(), a_scale)
    wq = fake_quant_weight(p["w"].float() * a)
    return conv2d(xq, wq / a, None, stride, padding) + p["b"].float()


def _fq_family_executor(params, a_scales):
    """The conv executor of a family's ``walk_feature_maps``: full and
    pointwise convs through :func:`_fq_conv_folded`; depthwise convs with a
    weight-only fake-quantized filter in float32 (the deploy path has no
    activation quantizer there)."""

    def conv(name, x, *, stride=1, padding="SAME", depthwise=False):
        p = params[name]
        if depthwise:
            return depthwise_conv2d(x, fake_quant_weight(p["w"].float()), p["b"].float(), stride,
                                    padding)
        return _fq_conv_folded(p, x, a_scales[name], stride, padding)

    return conv


def qat_apply_model_family(params, images, config: ModelConfig, a_scales):
    """Fake-quantized family forward -> ``(logits, locs)``: the family's
    ``walk_feature_maps`` with :func:`_fq_family_executor`, GroupNorms and
    activations in float32 between the convs, then the heads through the
    folded quantizer. ``a_scales`` maps each quantized conv and head to its
    per-input-channel scale (``amax / 127``) on the images' device."""
    fam = _backbone_module(config.preset)
    if fam is None:
        raise ValueError(f"{config.preset_name} is a VGG preset: use qat_apply_model")
    x = preprocess(images, config).float()
    maps = fam.walk_feature_maps(params, x, config.preset, _fq_family_executor(params, a_scales))
    return _heads(maps, config, lambda i, fmap: _fq_conv_folded(
        params[f"classifier{i}"], fmap, a_scales[f"classifier{i}"]))


def family_a_scales(act_amax) -> dict:
    """``{conv: max(float32(amax) / 127, 1e-12)}`` as float32 numpy, on the
    host: the grid of ``quantized.quantize_weights_folded``."""
    return {k: quantized.folded_a_scale(v) for k, v in act_amax.items()}


def make_qat_forward(model_cfg: ModelConfig, act_scales):
    """The fake-quant forward ``(params, images) -> (logits, locs)`` over
    static scales, for ``make_train_step`` / ``make_eval_step``'s
    ``forward``. ``act_scales``: VGG, the per-layer scales of
    ``quantized.calibrate_activation_scales``; a family, the
    per-input-channel amax of ``quantized.calibrate_activation_amax``
    (lists from a checkpoint's JSON do as well). The forward runs in float32
    with TF32 off whatever the config's dtype.

    Raises ``ValueError`` for a VGG config whose ``l2_norm_eps`` is below
    1e-6 (see :data:`QAT_L2_NORM_EPS`)."""
    if _backbone_module(model_cfg.preset) is not None:
        host = {k: torch.from_numpy(v) for k, v in family_a_scales(act_scales).items()}
        staged = {}

        def family_forward(params, images):
            if images.device not in staged:
                staged[images.device] = {k: v.to(images.device) for k, v in host.items()}
            with full_float32(torch.float32):
                return qat_apply_model_family(params, images, model_cfg, staged[images.device])

        return family_forward
    if model_cfg.l2_norm_eps < MIN_L2_NORM_EPS:
        raise ValueError(
            f"QAT requires ModelConfig.l2_norm_eps >= {MIN_L2_NORM_EPS} (got "
            f"{model_cfg.l2_norm_eps}): fake quantization zeroes whole conv4_3 pixel vectors "
            "and rsqrt of a tiny eps explodes the backward; build the config with "
            f"qat_model_config (l2_norm_eps={QAT_L2_NORM_EPS})")
    scales = {k: float(v) for k, v in act_scales.items()}

    def forward(params, images):
        with full_float32(torch.float32):
            return qat_apply_model(params, images, model_cfg, scales)

    return forward


def make_qat_train_step(cfg, anchors, act_scales):
    """``parallel/train_step.make_train_step`` with the fake-quant forward:
    ``(state, batch) -> (state, losses, detections)``. The config must be
    float32 (:func:`qat_model_config`): the step runs its backward under
    the config's dtype, and a bf16 config would leave it to TF32."""
    from ssd_tensorflow_tpu_torch.parallel.train_step import make_train_step

    if cfg.model.compute_dtype != "float32":
        raise ValueError(f"QAT trains in float32 (got compute_dtype={cfg.model.compute_dtype!r});"
                         " build the config with qat_model_config")
    return make_train_step(cfg, anchors, forward=make_qat_forward(cfg.model, act_scales))


# ---------------------------------------------------------------------------
# The QAT contract
# ---------------------------------------------------------------------------


def qat_model_config(model_cfg: ModelConfig) -> ModelConfig:
    """``model_cfg`` as QAT trains it: float32 and ``l2_norm_eps = 1e-3``
    (the value rides in the checkpoint, so that deploy computes what QAT
    trained)."""
    return dataclasses.replace(model_cfg, compute_dtype="float32", l2_norm_eps=QAT_L2_NORM_EPS)


def qat_checkpoint_key(model_cfg: ModelConfig) -> str:
    """``qat_act_amax`` for a family (per-input-channel amax grids),
    ``qat_act_scales`` for VGG (per-layer scales): the units differ."""
    return "qat_act_scales" if _backbone_module(model_cfg.preset) is None else "qat_act_amax"


def qat_scales(params, model_cfg: ModelConfig, stored_config=None, calibration_images=None):
    """The train CLI's calibrate-or-resume choice -> ``(act_scales, entry)``.

    A checkpoint config (``stored_config``) that carries the model's
    :func:`qat_checkpoint_key` is resumed with its stored values and never
    recalibrated: recalibrating on finetuned weights would change the
    quantizer mid-run. Otherwise the float ``params`` are calibrated on
    ``calibration_images`` (uint8 NHWC, moved to the params' device):
    ``calibrate_activation_amax`` for a family, ``calibrate_activation_scales``
    for VGG. ``entry`` is ``{key: values}`` as the checkpoint config stores
    them (lists of float32 values, or floats), to merge into it."""
    key = qat_checkpoint_key(model_cfg)
    act_scales = (stored_config or {}).get(key)
    if act_scales is None:
        if calibration_images is None:
            raise ValueError(f"no {key} in the checkpoint config and no calibration images: "
                             "QAT needs images to calibrate its int8 scales")
        device = next(iter(next(iter(params.values())).values())).device
        images = torch.as_tensor(calibration_images).to(device)
        if key == "qat_act_amax":
            act_scales = quantized.calibrate_activation_amax(params, images, model_cfg)
        else:
            act_scales = quantized.calibrate_activation_scales(params, images, model_cfg)
    if key == "qat_act_amax":
        stored = {k: np.asarray(v, np.float32).tolist() for k, v in act_scales.items()}
    else:
        stored = {k: float(v) for k, v in act_scales.items()}
    return act_scales, {key: stored}


def export_int8_bundle(checkpoint_path: str, output_path: str, calibration_images=None,
                       percentile: float = 100.0, device="cuda"):
    """The int8 export of a training checkpoint (the export CLI's
    ``--quantize``) -> the bundle's ``act_scales``.

    A QAT family checkpoint (``qat_act_amax``) is quantized with exactly
    its stored grids, ``quantize_weights_folded(params, amax)``, and
    ``act_scales={}``; a QAT VGG checkpoint (``qat_act_scales``) with
    ``quantize_weights(params)`` and its stored scales. Neither is
    recalibrated. Any other checkpoint is calibrated on
    ``calibration_images`` on ``device`` (``quantized.QuantizedModel``).
    The bundle is written by ``inference.save_bundle``."""
    from ssd_tensorflow_tpu_torch.inference import load_params_from_train_checkpoint, save_bundle
    from ssd_tensorflow_tpu_torch.utils.checkpoint import checkpoint_config

    params, model_cfg, lid2name = load_params_from_train_checkpoint(checkpoint_path)
    stored = checkpoint_config(checkpoint_path)
    if stored.get("qat_act_amax") is not None:
        amax = {k: np.asarray(v, np.float32) for k, v in stored["qat_act_amax"].items()}
        qparams, act_scales = quantized.quantize_weights_folded(params, amax), {}
    elif stored.get("qat_act_scales") is not None:
        qparams, act_scales = quantized.quantize_weights(params), dict(stored["qat_act_scales"])
    elif calibration_images is None:
        raise ValueError(f"{checkpoint_path} is not a QAT checkpoint: the int8 export needs "
                         "calibration images")
    else:
        model = quantized.QuantizedModel(params, model_cfg, calibration_images,
                                         percentile=percentile, device=device)
        qparams, act_scales = model.qparams, model.act_scales
    save_bundle(output_path, qparams, model_cfg, lid2name, act_scales=act_scales)
    return act_scales
