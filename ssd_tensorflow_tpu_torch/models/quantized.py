"""The int8 (W8A8) deploy path of the VGG family.

Symmetric per-output-channel int8 weights, static per-layer activation
scales from a float calibration pass, exact integer sums, float32 bias
and requantization, bf16 activations between layers: the JAX package's
``models/quantized.py`` on its unpacked stem (its width-packed int8 stem
is a TPU lane layout with the same sums, and is off there too). Every
conv is quantized (trunk, the a-trous conv6/7, extras, multibox heads);
the conv4_3 L2-normalization runs in float between quantized convs.

The parameters are the port's q-param dict ``{layer: {"wq": (kh, kw, cin,
cout) int8, "w_scale": (cout,) float32, "b": (cout,) float32}}`` plus
``{"l2_norm_conv4_3": {"scale": (512,)}}`` (``weights.qparams_from_jax``
converts the JAX package's tree), and the forward functions take them
staged on their device by ``weights.stage_qparams`` together with the
activation scales: the filters laid out for the GEMM
(``ops/int8_conv.py``), the requant multipliers and the inverse scales
computed once.

Order of operations, as in the JAX package's ``_qconv``:
``xq = clip(round(float32(x) * inv), -127, 127)`` with ``inv = 1 /
act_scale`` rounded to float32 (rounding half to even), the exact int32
sums, then ``sums * m + b`` as one float32 multiply-add (``m =
float32(act_scale) * w_scale`` in float32; XLA's CPU backend contracts
the multiply and the add, and ``torch.addcmul`` does the same on either
device), ReLU except on the heads, one rounding to bf16.

Family int8 bundles (per-input-channel scales folded into the weights)
and percentile calibration are not ported (``ROADMAP.md`` queue 1 items
7 and 5).
"""

from __future__ import annotations

import numpy as np
import torch
import torch.nn.functional as F

from ssd_tensorflow_tpu_torch import resolve_device
from ssd_tensorflow_tpu_torch.models import vgg16
from ssd_tensorflow_tpu_torch.models.layers import (
    conv_relu,
    full_float32,
    l2_normalize_scale,
    max_pool,
)
from ssd_tensorflow_tpu_torch.models.ssd_vgg import (
    ModelConfig,
    _extra_layer_defs,
    preprocess,
    reduce_head_maps,
)
from ssd_tensorflow_tpu_torch.ops.int8_conv import int8_conv

def quantize_weights(params) -> dict:
    """Symmetric per-output-channel int8 quantization of every conv of the
    port's float ``params`` (OIHW), in numpy as the JAX package does it:
    ``scale = max(max|w| / 127, 1e-12)`` per output channel, ``wq =
    clip(round(w / scale), -127, 127)`` rounding half to even. Returns the
    port's q-param dict (HWIO int8 filters); other leaves pass through."""
    q = {}
    for name, leaf in params.items():
        if "w" in leaf:
            w = np.asarray(leaf["w"].detach().cpu(), dtype=np.float32).transpose(2, 3, 1, 0)
            scale = np.abs(w).max(axis=(0, 1, 2)) / 127.0
            scale = np.maximum(scale, 1e-12)
            wq = np.clip(np.round(w / scale), -127, 127).astype(np.int8)
            q[name] = {
                "wq": torch.from_numpy(np.ascontiguousarray(wq)),
                "w_scale": torch.from_numpy(scale),
                "b": leaf["b"].detach().float().cpu().clone(),
            }
        else:
            q[name] = {k: v.detach().cpu().clone() for k, v in leaf.items()}
    return q


def quantize(x, inv):
    """int8 ``clip(round(float32(x) * inv), -127, 127)``; ``inv`` is the
    staged ``(1,)`` float32 inverse scale (a one-element tensor, so that a
    bf16 ``x`` is multiplied in float32)."""
    return torch.mul(x, inv).round_().clamp_(-127, 127).to(torch.int8)


def _qconv(layer, x, stride=1, padding="SAME", dilation=1, relu=True):
    """Quantize ``x`` with the layer's static scale, int8 conv, requantize:
    ``bf16(act(sums * m + b))``. ``layer`` is one staged conv of
    ``weights.stage_qparams``."""
    y = int8_conv(quantize(x, layer["inv"]), layer["w"], stride, padding, dilation)
    return requant(y, layer, relu)


def requant(sums, layer, relu=True):
    """``bf16(act(sums * m + b))``: the multiply-add in float32, rounded
    once to bf16 as it is stored; ReLU then on the bf16 values (rounding
    is monotone and keeps 0, so it commutes with ReLU)."""
    out = torch.empty(sums.shape, dtype=torch.bfloat16, device=sums.device)
    torch.addcmul(layer["b"], sums, layer["mult"], out=out)
    return out.relu_() if relu else out


def _walk(conv, x, l2_scale, config: ModelConfig):
    """The VGG walk from the preprocessed batch ``x`` to the preset's
    multibox source maps (NHWC), every convolution through ``conv(name,
    x, stride=1, padding="SAME", dilation=1)``: the trunk with its pools,
    the a-trous conv6 and conv7, the L2-normalized conv4_3, the extras."""
    conv4_3 = None
    for name, _ in vgg16.VGG_CONV_LAYERS:
        x = conv(name, x)
        if name == "conv4_3":
            conv4_3 = x
        if name in vgg16._POOL_AFTER:
            x = max_pool(x, 2, 2)
    x = max_pool(x, 3, 1)
    x = conv("mod_conv6", x, dilation=6)
    x = conv("mod_conv7", x)
    maps = [l2_normalize_scale(conv4_3, l2_scale, eps=config.l2_norm_eps), x]
    for name, _, _, stride, padding in _extra_layer_defs(config.preset.num_maps):
        x = conv(name, x, stride, padding)
        if name == "conv12_1":
            x = F.pad(x, (0, 0, 0, 1, 0, 1))  # bottom/right zero pad before conv12_2
        elif name.endswith("_2"):
            maps.append(x)
    return maps


def _feature_maps_q(staged, images, config: ModelConfig):
    """int8 backbone + extras -> the preset's multibox source maps (NHWC
    bf16), from ``(B, H, W, 3)`` raw BGR images."""
    x = preprocess(images, config).to(torch.bfloat16)
    return _walk(lambda name, x, *args, **kwargs: _qconv(staged[name], x, *args, **kwargs), x,
                 staged["l2_norm_conv4_3"]["scale"], config)


def _head_maps(staged, maps):
    """Each map's multibox head conv, int8 without ReLU, as float32."""
    return [_qconv(staged[f"classifier{i}"], fmap, relu=False).float()
            for i, fmap in enumerate(maps)]


def _forward(staged, images, config: ModelConfig):
    """Quantized forward -> ``(B, A, K+5)`` float32 result tensor
    (softmax over the K+1 class logits, then the 4 offsets)."""
    nv = config.num_vars
    outs = []
    for y, m in zip(_head_maps(staged, _feature_maps_q(staged, images, config)),
                    config.preset.maps):
        b, h, w, _ = y.shape
        y = y.reshape(b, h * w, m.num_shapes, nv).transpose(1, 2)
        outs.append(y.reshape(b, m.num_shapes * h * w, nv))
    out = torch.cat(outs, dim=1)
    k = config.num_classes + 1
    return torch.cat([torch.softmax(out[:, :, :k], dim=-1), out[:, :, k:]], dim=-1)


def _forward_scores(staged, images, config: ModelConfig):
    """int8 throughput head: per-anchor ``(conf, cls, locs)`` by the lazy
    softmax of ``ssd_vgg.reduce_head_maps``; feed to
    ``ops/postprocess.decode_scores``."""
    maps = _feature_maps_q(staged, images, config)
    return reduce_head_maps(_head_maps(staged, maps), config)


def calibrate_activation_scales(params, images, config: ModelConfig,
                                percentile: float = 100.0, batch_size: int = 8) -> dict:
    """Float32 forwards of the port's float ``params`` over the calibration
    ``images`` recording each conv input's max |x| -> ``{conv: max / 127 +
    1e-12}``, the static activation scales. Runs on the images' device
    with TF32 off; ``batch_size`` images at a time, each scale the max
    over the chunks (exact for max-abs). ``percentile < 100`` is not
    ported (``ROADMAP.md`` queue 1 item 5)."""
    if percentile < 100:
        raise NotImplementedError(
            f"percentile={percentile}: percentile calibration is not ported "
            "(ROADMAP.md queue 1 item 5); the port calibrates by max-abs (percentile=100)")
    images = torch.as_tensor(images)
    out = None
    with full_float32(torch.float32):
        for off in range(0, images.shape[0], batch_size):
            chunk = _calibrate_one_batch(params, images[off:off + batch_size], config)
            out = chunk if out is None else {k: max(out[k], chunk[k]) for k in out}
    return out


def _calibrate_one_batch(params, images, config: ModelConfig) -> dict:
    amps = {}

    def conv(name, x, stride=1, padding="SAME", dilation=1):
        amps[name] = x.abs().amax()
        return conv_relu(params[name], x, stride, padding, dilation)

    with torch.inference_mode():
        maps = _walk(conv, preprocess(images, config).float(),
                     params["l2_norm_conv4_3"]["scale"], config)
        for i, fmap in enumerate(maps):
            amps[f"classifier{i}"] = fmap.abs().amax()
    return {k: float(v) / 127.0 + 1e-12 for k, v in amps.items()}


class QuantizedModel:
    """Post-training-quantized deployable model: quantizes ``params``,
    calibrates the activation scales on ``calibration_images`` (uint8
    NHWC) and stages both on ``device``."""

    def __init__(self, params, config: ModelConfig, calibration_images,
                 percentile: float = 100.0, device="cuda"):
        from ssd_tensorflow_tpu_torch.weights import stage_qparams

        self.config = config
        self.device = resolve_device(device)
        self.qparams = quantize_weights(params)
        on_device = {name: {k: v.to(self.device) for k, v in leaf.items()}
                     for name, leaf in params.items()}
        self.act_scales = calibrate_activation_scales(
            on_device, torch.as_tensor(calibration_images).to(self.device), config,
            percentile=percentile)
        self.staged = stage_qparams(self.qparams, self.act_scales, self.device)

    def result(self, images):
        """``(B, A, K+5)`` fused result tensor, like ``ssd_vgg.apply_result``."""
        with torch.inference_mode():
            return _forward(self.staged, torch.as_tensor(images).to(self.device), self.config)
