"""The ResNet-34 SSD backbone (the JAX package's ``models/resnet.py``).

A ResNet-34 trunk with GroupNorm in place of BatchNorm (per-sample
statistics: no train/eval split, no cross-device moments), zero-initialized
final GroupNorm scale in every residual block, then SSD-style extra conv
pairs (1x1 reduce + 3x3) whose stride and padding follow the preset's map
sizes. The multibox source maps are the layer2/3/4 outputs (strides 8, 16,
32) and one map per extra pair; ``resnet320`` has 6 maps, the test preset
``rtest64`` 4.

The walk (:func:`walk_feature_maps`) runs every convolution through an
injected executor (conv + bias only; ``models/ssd_vgg.py`` documents the
family protocol), so the float and training routes
(``layers.float_conv_executor``), the int8 route and its calibration
(``models/quantized.py``) and QAT (``models/qat.py``) walk one structure.
GroupNorm, ReLU and the skips run here, in the executor's output dtype:
:func:`norm_act` takes each GroupNorm with the activation and the skip
after it, in one launch of ``csrc/group_norm.cu`` where the route rule
(``ops/group_norm_cuda.engages``) lets it, else as :func:`group_norm`
and the plain activation.
"""

from __future__ import annotations

import numpy as np
import torch

from ssd_tensorflow_tpu_torch.models.layers import init_conv, max_pool, relu6
from ssd_tensorflow_tpu_torch.ops.group_norm_cuda import engages, group_norm_cuda
from ssd_tensorflow_tpu_torch.presets import SSDPreset
from ssd_tensorflow_tpu_torch.utils.profiling import counted_span, span

#: ResNet-34 stage layout: (num_blocks, channels, first-block stride).
STAGES = ((3, 64, 1), (4, 128, 2), (6, 256, 2), (3, 512, 2))

#: channels of the three trunk taps (layer2/layer3/layer4 outputs)
TRUNK_TAP_CHANNELS = (128, 256, 512)

#: channels of every extra pair's 3x3 output
EXTRA_CHANNELS = 256

GN_GROUPS = 32

#: int8 activation scales: per input channel, folded into the weights
#: (``quantized.quantize_weights_folded``)
PER_LAYER_SCALES = False
#: a GroupNorm sits between each conv and its activation, so every
#: inference conv carries its bias in (``layers.conv2d_bias_in``)
RELU_IN_CONV = False
#: no stem kernel, and no pretrained import for the train CLI's ``--vgg-dir``
stem = load_pretrained = None


def map_channels(preset: SSDPreset):
    """Head-input channel count per multibox source map."""
    n_extra = preset.num_maps - len(TRUNK_TAP_CHANNELS)
    if n_extra < 0:
        raise ValueError(f"{preset.name}: resnet34 presets need >= 3 maps (trunk taps)")
    return TRUNK_TAP_CHANNELS + (EXTRA_CHANNELS,) * n_extra


def extra_geometry(cur: int, target: int, preset: SSDPreset):
    """``(stride, padding)`` of the 3x3 conv that takes a ``cur``-sized map
    to ``target``: halving -> stride 2 SAME, shrink by 2 -> stride 1 VALID."""
    if target == -(-cur // 2):
        return 2, "SAME"
    if target == cur - 2:
        return 1, "VALID"
    raise ValueError(f"{preset.name}: can't derive extra layer {cur}->{target}")


def extra_layer_defs(preset: SSDPreset):
    """``(name, out_ch, kernel, stride, padding)`` of the conv pairs beyond
    the three trunk taps, stride and padding derived from consecutive map
    sizes."""
    defs = []
    cur = preset.maps[len(TRUNK_TAP_CHANNELS) - 1].size.h
    for i, m in enumerate(preset.maps[len(TRUNK_TAP_CHANNELS):]):
        stride, padding = extra_geometry(cur, m.size.h, preset)
        defs.append((f"extra{i}_1", EXTRA_CHANNELS // 2, 1, 1, "SAME"))
        defs.append((f"extra{i}_2", EXTRA_CHANNELS, 3, stride, padding))
        cur = m.size.h
    return defs


def _conv(kh, kw, cin, cout):
    return {"b": (cout,), "w": (kh, kw, cin, cout)}


def _gn(ch):
    return {"bias": (ch,), "scale": (ch,)}


def backbone_shapes(preset: SSDPreset) -> dict:
    """``{layer: {leaf: shape}}`` of the trunk and extras in init order,
    filters HWIO (the bundle's layout); GroupNorms hold ``scale`` and
    ``bias``."""
    shapes = {"stem_conv": _conv(7, 7, 3, 64), "stem_gn": _gn(64)}
    cin = 64
    for si, (blocks, ch, _) in enumerate(STAGES):
        for bi in range(blocks):
            name = f"s{si}b{bi}"
            shapes[f"{name}_conv1"] = _conv(3, 3, cin, ch)
            shapes[f"{name}_gn1"] = _gn(ch)
            shapes[f"{name}_conv2"] = _conv(3, 3, ch, ch)
            shapes[f"{name}_gn2"] = _gn(ch)
            if bi == 0 and cin != ch:
                shapes[f"{name}_proj"] = _conv(1, 1, cin, ch)
                shapes[f"{name}_proj_gn"] = _gn(ch)
            cin = ch
    for name, cout, k, _, _ in extra_layer_defs(preset):
        shapes[name] = _conv(k, k, cin, cout)
        cin = cout
    return shapes


def init_from_shapes(rng: np.random.Generator, shapes: dict, zero_scale=lambda name: False):
    """Xavier convolutions with zero biases (OIHW) and GroupNorms of unit
    scale (zero where ``zero_scale(name)``) and zero bias, float32 CPU
    tensors, drawn from ``rng`` in the order of ``shapes``."""
    params = {}
    for name, leaves in shapes.items():
        if "w" in leaves:
            params[name] = init_conv(rng, *leaves["w"])
        else:
            ch = leaves["scale"][0]
            params[name] = {"scale": torch.zeros(ch) if zero_scale(name) else torch.ones(ch),
                            "bias": torch.zeros(ch)}
    return params


def init_backbone_params(rng: np.random.Generator, preset: SSDPreset) -> dict:
    """The trunk + extras (heads live with ``ssd_vgg.init_params``); each
    block's last GroupNorm starts at zero scale, so the block starts as
    the identity."""
    return init_from_shapes(rng, backbone_shapes(preset), lambda name: name.endswith("_gn2"))


#: the JAX package's name of the family init
init_resnet_params = init_backbone_params


@counted_span("ssd.group_norm")
def group_norm(x, gn, groups=GN_GROUPS, eps=1e-5):
    """GroupNorm of NHWC ``x`` in float32, as the JAX package's: ``groups``
    groups when they divide the channels, else one; the mean, then the mean
    of squared deviations ``d = x - mean``, over ``(H, W, C / g)``; ``d *
    rsqrt(var + eps)``, times the scale, plus the bias; one rounding back
    to ``x.dtype``.

    The two means are float64 sums rounded once to float32, and the rsqrt
    is taken in float64 and rounded once; every elementwise step is one
    float32 operation. So the CPU and the card give the same bits (a
    float32 sum's value depends on its order, which differs by device and
    library; JAX's XLA CPU sums in 32-wide windows and its rsqrt is not
    correctly rounded, ROADMAP.md section 3). Plain PyTorch on any device:
    :func:`norm_act`'s route off the kernel, and the kernel's yardstick.

    Each call counts once in ``group_norm.calls`` and runs inside the
    span ``ssd.group_norm`` (``utils/profiling.counted_span``)."""
    b, h, w, c = x.shape
    g = groups if c % groups == 0 else 1
    n = h * w * (c // g)
    x32 = x.float().reshape(b, h, w, g, c // g)
    mean = (x32.sum(dim=(1, 2, 4), keepdim=True, dtype=torch.float64) / n).float()
    d = x32 - mean
    var = (d.square().sum(dim=(1, 2, 4), keepdim=True, dtype=torch.float64) / n).float()
    y = (d * (var + eps).double().rsqrt().float()).reshape(b, h, w, c)
    return (y * gn["scale"].float() + gn["bias"].float()).to(x.dtype)


#: the counted GroupNorm, whose counter and span the kernel's route shares
#: (held here, so a test that patches the module's name changes neither)
_GROUP_NORM = group_norm
#: the plain activations of :func:`norm_act`
_ACTIVATIONS = {None: lambda y: y, "relu": torch.relu, "relu6": relu6}


def _f32(t):
    return t if t.dtype is torch.float32 and t.is_contiguous() else t.float().contiguous()


def norm_act(x, gn, act=None, skip=None, norm=None):
    """``act(GroupNorm(x) + skip)``, ``act`` None, ``"relu"`` or
    ``"relu6"``, ``skip`` optional: the GroupNorm rounded to ``x.dtype``
    first, the skip added in float32 and rounded once, the activation exact
    on the rounded values.

    Where ``ops/group_norm_cuda.engages`` (``x``, the GroupNorm's leaves
    and ``skip``) all of it is one launch of ``csrc/group_norm.cu``,
    counted in ``group_norm.calls`` and inside span ``ssd.group_norm`` as
    :func:`group_norm` is; else ``norm(x, gn)`` (this module's
    :func:`group_norm`, looked up at the call, unless a walk hands in its
    own module's name), then the plain skip add and activation."""
    if engages(x, gn["scale"], gn["bias"], skip):
        _GROUP_NORM.calls += 1
        g = GN_GROUPS if x.shape[-1] % GN_GROUPS == 0 else 1
        with span("ssd.group_norm"):
            return group_norm_cuda(x.contiguous(), _f32(gn["scale"]), _f32(gn["bias"]), g,
                                   act=act, skip=skip)
    y = (norm or group_norm)(x, gn)
    return _ACTIVATIONS[act](y if skip is None else y + skip)


def _block(params, name, x, stride, conv):
    """Basic residual block: conv-GN-ReLU-conv-GN + skip, then ReLU. With a
    projection its GroupNorm, the block's last, carries the sum and the
    ReLU (the sum is commutative, and the GroupNorms keep their order)."""
    y = norm_act(conv(f"{name}_conv1", x, stride=stride), params[f"{name}_gn1"], "relu")
    y = conv(f"{name}_conv2", y)
    if f"{name}_proj" in params:
        y = norm_act(y, params[f"{name}_gn2"])
        return norm_act(conv(f"{name}_proj", x, stride=stride), params[f"{name}_proj_gn"],
                        "relu", skip=y)
    skip = x[:, ::stride, ::stride, :] if stride != 1 else x
    return norm_act(y, params[f"{name}_gn2"], "relu", skip=skip)


def walk_feature_maps(params, x, config, conv):
    """Preprocessed NHWC images -> the multibox source maps of
    ``config.preset``, every convolution through ``conv`` (see the module
    doc)."""
    x = norm_act(conv("stem_conv", x, stride=2), params["stem_gn"], "relu")
    x = max_pool(x, 3, 2)
    maps = []
    for si, (blocks, _, stride) in enumerate(STAGES):
        for bi in range(blocks):
            x = _block(params, f"s{si}b{bi}", x, stride if bi == 0 else 1, conv)
        if si >= 1:  # layer2/3/4 outputs are the trunk taps
            maps.append(x)
    for name, _, _, stride, padding in extra_layer_defs(config.preset):
        x = torch.relu(conv(name, x, stride=stride, padding=padding))
        if name.endswith("_2"):
            maps.append(x)
    return maps
