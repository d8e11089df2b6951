"""The int8 (W8A8) deploy path of every model family.

Symmetric per-output-channel int8 weights, static activation scales from
a float calibration pass, exact integer sums, float32 bias and
requantization, bf16 activations between layers: the JAX package's
``models/quantized.py`` on its unpacked stem (its width-packed int8 stem
is a TPU lane layout with the same sums, and is off there too).

Every family walks its module's ``walk_feature_maps`` and the heads
(``ssd_vgg.walk_heads``) with the int8 conv executor
(:func:`_qconv_executor`). The family's ``PER_LAYER_SCALES`` names its
scheme. VGG (per layer): every conv is quantized (trunk, the a-trous
conv6/7, extras, multibox heads) with one activation scale per layer; the
conv4_3 L2-normalization runs in float between quantized convs. ResNet-34
and MobileNetV1 (folded): full and pointwise convs and the heads W8A8 with
per-INPUT-channel activation scales folded into the weights
(:func:`quantize_weights_folded`), GroupNorms in float between them, and
MobileNet's depthwise convs weight-only (the int8 filter dequantized to
bf16, a bf16 stencil). The quantized walks run VGG's conv6 a-trous
whatever the config's ``a_trous`` (:func:`walk_config`), as the JAX
package's do.

The parameters are the port's q-param dict ``{layer: {"wq": (kh, kw, cin,
cout) int8, "w_scale": (cout,) float32, "b": (cout,) float32}}`` (a
family conv also holds ``"a_scale": (cin,)``) plus the float leaves (the
L2-norm ``scale``, the GroupNorms); ``weights.qparams_from_jax`` converts
the JAX package's tree. The forward functions take them staged on their
device by ``weights.stage_qparams``: the filters laid out for the GEMM
(``ops/int8_conv.py``), the requant multipliers and the inverse scales
computed once. Each conv is one call of ``ops/int8_conv.int8_qconv``: one
kernel on the card, the three steps below as separate passes on the CPU.

Order of operations, as in the JAX package's ``_qconv`` and
``_qconv_folded``: ``xq = clip(round(float32(x) * inv), -127, 127)``
(rounding half to even) with ``inv = 1 / act_scale`` rounded to float32,
or per channel ``inv = float32(1 / a_scale)``; the exact int32 sums; then
``sums * m + b`` as one float32 multiply-add (``m = float32(act_scale) *
w_scale`` in float32, or ``w_scale`` where the scale is folded; XLA's CPU
backend contracts the multiply and the add, and ``torch.addcmul`` does the
same on either device), ReLU where the VGG layer has one, one rounding to
bf16.
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch

from ssd_tensorflow_tpu_torch import resolve_device
from ssd_tensorflow_tpu_torch.models.layers import (
    depthwise_conv2d,
    float_conv_executor,
    full_float32,
    preprocess,
)
from ssd_tensorflow_tpu_torch.models.ssd_vgg import (
    ModelConfig,
    _backbone_module,
    anchor_order,
    reduce_head_maps,
    walk_heads,
)
from ssd_tensorflow_tpu_torch.ops.int8_conv import int8_qconv


def _hwio(w) -> np.ndarray:
    """An OIHW filter tensor as a float32 HWIO numpy array."""
    return np.asarray(w.detach().cpu(), dtype=np.float32).transpose(2, 3, 1, 0)


def _per_cout_int8(w: np.ndarray):
    """``(scale, wq)`` of a float32 HWIO filter, in numpy as the JAX package
    computes them: ``scale = max(max|w| / 127, 1e-12)`` per output channel,
    ``wq = clip(round(w / scale), -127, 127)`` rounding half to even."""
    scale = np.abs(w).max(axis=(0, 1, 2)) / 127.0
    scale = np.maximum(scale, 1e-12)
    wq = np.clip(np.round(w / scale), -127, 127).astype(np.int8)
    return torch.from_numpy(scale), torch.from_numpy(np.ascontiguousarray(wq))


def _float_leaf(leaf) -> dict:
    return {k: v.detach().cpu().clone() for k, v in leaf.items()}


def quantize_weights(params) -> dict:
    """Symmetric per-output-channel int8 quantization of every conv of the
    port's float ``params`` (OIHW), as the JAX package's (see
    :func:`_per_cout_int8`). Returns the port's q-param dict (HWIO int8
    filters); other leaves pass through."""
    q = {}
    for name, leaf in params.items():
        if "w" in leaf:
            w_scale, wq = _per_cout_int8(_hwio(leaf["w"]))
            q[name] = {"wq": wq, "w_scale": w_scale, "b": leaf["b"].detach().float().cpu().clone()}
        else:
            q[name] = _float_leaf(leaf)
    return q


def folded_a_scale(amax) -> np.ndarray:
    """A conv's per-input-channel activation scale from its calibrated
    amax: ``max(float32(amax) / 127, 1e-12)`` in float32, as the JAX
    package computes it on the host."""
    return np.maximum(np.asarray(amax, np.float32) / np.float32(127), np.float32(1e-12))


def quantize_weights_folded(params, act_amax=None) -> dict:
    """The family int8 q-params: per-input-channel activation scales folded
    into per-output-channel int8 weights, bit for bit as the JAX package's
    ``quantize_weights_folded`` (the same float32 numpy arithmetic).

    ``act_amax`` maps each quantized conv to its per-input-channel max |x|
    (:func:`calibrate_activation_amax`); None gives unit scales (the
    bundle's structural template). A conv gets ``a_scale = max(amax / 127,
    1e-12)`` and the quantization of ``w * a_scale`` along its input axis;
    a depthwise conv (``*_dw``) is weight-only, per output channel, with no
    ``a_scale``. Other leaves (the GroupNorms) pass through."""
    q = {}
    for name, leaf in params.items():
        if "w" not in leaf:
            q[name] = _float_leaf(leaf)
            continue
        w = _hwio(leaf["w"])
        b = leaf["b"].detach().float().cpu().clone()
        if name.endswith("_dw"):
            w_scale, wq = _per_cout_int8(w)
            q[name] = {"wq": wq, "w_scale": w_scale, "b": b}
            continue
        a_scale = (np.ones((w.shape[2],), np.float32) if act_amax is None
                   else folded_a_scale(act_amax[name]))
        w_scale, wq = _per_cout_int8(w * a_scale[None, None, :, None])
        q[name] = {"wq": wq, "w_scale": w_scale, "a_scale": torch.from_numpy(a_scale), "b": b}
    return q


def walk_config(config: ModelConfig) -> ModelConfig:
    """``config`` as the int8, calibration and QAT walks take it: conv6
    a-trous (dilation 6) whatever ``a_trous`` says, as the JAX package's
    ``quantized`` and ``qat`` walks."""
    return config if config.a_trous else dataclasses.replace(config, a_trous=True)


def _qconv_executor(staged):
    """The int8 conv executor of a family's walk and the heads: each W8A8
    conv one call of ``ops/int8_conv.int8_qconv``, ``bf16(act(sums * m +
    b))`` with the staged layer's ``inv`` (per layer, or per input channel
    where the scale is folded into the weights, as
    ``weights.stage_qparams`` staged it); depthwise convs weight-only, the
    staged bf16 dequantized filter (``float32(wq) * w_scale`` rounded once)
    in the two-rounding bf16 stencil with the bias in bf16, as the JAX
    package's executor. A grouped conv raises: ``csrc/int8_conv.cu`` has
    no grouped route."""

    def conv(name, x, *, stride=1, padding="SAME", dilation=1, depthwise=False, relu=False,
             groups=1):
        if groups > 1:
            raise NotImplementedError(f"{name}: the int8 route has no grouped conv "
                                      f"(groups={groups}); csrc/int8_conv.cu runs dense convs")
        layer = staged[name]
        if depthwise:
            return depthwise_conv2d(x, layer["w"], layer["b"], stride, padding)
        return int8_qconv(x.contiguous(), layer, stride, padding, dilation, relu)

    return conv


def _heads_q(staged, images, config: ModelConfig):
    """int8 walk + heads of ``(B, H, W, 3)`` raw BGR images -> each map's
    head conv output as float32."""
    x = preprocess(images, config).to(torch.bfloat16)
    heads = walk_heads(staged, x, walk_config(config), _qconv_executor(staged))
    return [y.float() for y in heads]


def _forward(staged, images, config: ModelConfig):
    """Quantized forward -> ``(B, A, K+5)`` float32 result tensor
    (softmax over the K+1 class logits, then the 4 offsets)."""
    out = anchor_order(_heads_q(staged, images, config), config)
    k = config.num_classes + 1
    return torch.cat([torch.softmax(out[:, :, :k], dim=-1), out[:, :, k:]], dim=-1)


def _forward_scores(staged, images, config: ModelConfig):
    """int8 throughput head: per-anchor ``(conf, cls, locs)`` by the lazy
    softmax of ``ssd_vgg.reduce_head_maps``; feed to
    ``ops/postprocess.decode_scores``."""
    return reduce_head_maps(_heads_q(staged, images, config), config)


def percentile_of(a, q: float, dim=None):
    """``jnp.percentile(a, q, axis=dim)`` with its default ``"linear"``
    method, of float32 ``a``: over all elements (``dim=None``) or along
    ``dim``, for any number of elements (``torch.quantile`` refuses more
    than 2^24).

    JAX's arithmetic in float32: ``pos = float32(q) / 100 * (float32(n) -
    1)`` (``n`` rounded to float32, as JAX converts the count), ``low =
    floor(pos)``, ``high = ceil(pos)``, ``w = pos - low``; the values of
    rank ``low`` and ``high`` (``torch.kthvalue``, clamped to the last as
    XLA's gather clamps), then ``v_low * (1 - w) + v_high * w``. Within one
    float32 ulp of JAX's, which may contract the last multiply-add."""
    a = a.float()
    if dim is None:
        a, dim = a.reshape(-1), 0
    n = a.shape[dim]
    f32 = np.float32
    last = f32(n) - f32(1)
    pos = f32(q) / f32(100) * last
    low, high = np.floor(pos), np.ceil(pos)
    w_high = pos - low
    w_low = f32(1) - w_high

    def value(rank):
        k = min(int(min(max(rank, f32(0)), last)), n - 1)
        return torch.kthvalue(a, k + 1, dim=dim).values

    v_low = value(low)
    v_high = v_low if high == low else value(high)
    return v_low * torch.tensor(w_low, device=a.device) + \
        v_high * torch.tensor(w_high, device=a.device)


def _record_conv_inputs(params, images, config: ModelConfig, inference: bool, record):
    """A float32 walk + heads of ``images`` through the float executor
    (``layers.float_conv_executor(params, inference)``), calling
    ``record(name, x)`` on the input of every conv the int8 route
    quantizes (the depthwise convs are weight-only)."""
    inner = float_conv_executor(params, inference)

    def conv(name, x, *, depthwise=False, **kwargs):
        if not depthwise:
            record(name, x)
        return inner(name, x, depthwise=depthwise, **kwargs)

    with torch.inference_mode():
        walk_heads(params, preprocess(images, config).float(), walk_config(config), conv)


def calibrate_activation_scales(params, images, config: ModelConfig,
                                percentile: float = 100.0, batch_size: int = 8) -> dict:
    """Float32 forwards of the port's float ``params`` (the inference
    executor's convs, as the JAX package's per-layer calibration) over the
    calibration ``images`` recording each conv input's amplitude ->
    ``{conv: amp / 127 + 1e-12}``, the static per-layer activation scales.
    The amplitude is max |x| (``percentile=100``) or the ``percentile`` of
    |x| over the chunk's tensor (:func:`percentile_of`). Runs on the
    images' device with TF32 off; ``batch_size`` images at a time, each
    scale the max over the chunks, as the JAX package's."""
    images = torch.as_tensor(images)
    out = None
    with full_float32(torch.float32):
        for off in range(0, images.shape[0], batch_size):
            amps = {}

            def record(name, x):
                a = x.abs()
                amps[name] = a.amax() if percentile >= 100 else percentile_of(a, percentile)

            _record_conv_inputs(params, images[off:off + batch_size], config, True, record)
            chunk = {k: float(v) / 127.0 + 1e-12 for k, v in amps.items()}
            out = chunk if out is None else {k: max(out[k], chunk[k]) for k in out}
    return out


def calibrate_activation_amax(params, images, config: ModelConfig,
                              percentile: float = 100.0, batch_size: int = 8) -> dict:
    """Per-INPUT-channel |x| amplitudes of every quantized conv and head
    -> ``{conv: (cin,) float32 numpy}`` for
    :func:`quantize_weights_folded`: float32 forwards of the port's float
    ``params`` (the training executor's conv-then-bias, as the JAX
    package's calibration walk) recording each conv input; depthwise convs
    are skipped (weight-only). The amplitude is the max over the
    calibration set, ``batch_size`` images at a time (the max of the
    chunks' maxima); a ``percentile < 100`` runs the whole set as one
    chunk, the percentile per channel over all its values (a per-chunk
    percentile would depend on ``batch_size``). TF32 off."""
    images = torch.as_tensor(images)
    if percentile < 100:
        batch_size = int(images.shape[0])
    out = None
    with full_float32(torch.float32):
        for off in range(0, images.shape[0], batch_size):
            amax = {}

            def record(name, x):
                a = x.float().abs().reshape(-1, x.shape[-1])
                amax[name] = (a.amax(dim=0) if percentile >= 100
                              else percentile_of(a, percentile, dim=0))

            _record_conv_inputs(params, images[off:off + batch_size], config, False, record)
            chunk = {k: v.cpu().numpy() for k, v in amax.items()}
            out = chunk if out is None else {k: np.maximum(out[k], chunk[k]) for k in out}
    return out


class QuantizedModel:
    """Post-training-quantized deployable model: calibrates on
    ``calibration_images`` (uint8 NHWC), quantizes ``params`` and stages
    both on ``device``. A family of per-layer scales (VGG) gets them as
    ``act_scales``; the others per-channel maxima folded into their
    q-params, and ``act_scales`` is ``{}`` (what marks its bundle int8)."""

    def __init__(self, params, config: ModelConfig, calibration_images,
                 percentile: float = 100.0, device="cuda"):
        from ssd_tensorflow_tpu_torch.weights import stage_qparams

        self.config = config
        self.device = resolve_device(device)
        on_device = {name: {k: v.to(self.device) for k, v in leaf.items()}
                     for name, leaf in params.items()}
        images = torch.as_tensor(calibration_images).to(self.device)
        if _backbone_module(config.preset).PER_LAYER_SCALES:
            self.qparams = quantize_weights(params)
            self.act_scales = calibrate_activation_scales(on_device, images, config,
                                                          percentile=percentile)
        else:
            amax = calibrate_activation_amax(on_device, images, config, percentile=percentile)
            self.qparams = quantize_weights_folded(params, amax)
            self.act_scales = {}
        self.staged = stage_qparams(self.qparams, self.act_scales, self.device)

    def result(self, images):
        """``(B, A, K+5)`` fused result tensor, like ``ssd_vgg.apply_result``."""
        with torch.inference_mode():
            return _forward(self.staged, torch.as_tensor(images).to(self.device), self.config)
