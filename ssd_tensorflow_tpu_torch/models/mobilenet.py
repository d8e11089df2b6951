"""The MobileNetV1 SSD backbone (the JAX package's ``models/mobilenet.py``).

A 3x3 stride-2 stem of 32 channels, then 13 depthwise-separable blocks
(a 3x3 depthwise conv and a 1x1 pointwise conv, each followed by
GroupNorm and ReLU6), width multiplier 1.0. The multibox source maps are
the outputs of blocks 11 (512 channels, stride 16) and 13 (1024, stride
32), then one map per SSD-style extra pair (1x1 reduce + 3x3, tapering
widths), stride and padding from the preset's map sizes: ``mobilenet320``
has 6 maps, the test preset ``mntest64`` 3.

The walk runs every convolution through an injected executor as the
ResNet family's does (``models/resnet.py``); the ``depthwise`` flag lets
the int8 executor keep the depthwise stencils weight-only quantized.
"""

from __future__ import annotations

import numpy as np

from ssd_tensorflow_tpu_torch.models.layers import relu6
from ssd_tensorflow_tpu_torch.models.resnet import (
    extra_geometry,
    group_norm,
    init_from_shapes,
    norm_act,
)
from ssd_tensorflow_tpu_torch.presets import SSDPreset

#: MobileNetV1 stack: (stride, out_channels) per depthwise-separable
#: block, after the 3x3/s2/32-channel stem (Howard 2017, table 1).
BLOCKS = (
    (1, 64),
    (2, 128), (1, 128),
    (2, 256), (1, 256),
    (2, 512), (1, 512), (1, 512), (1, 512), (1, 512), (1, 512),
    (2, 1024), (1, 1024),
)

#: the trunk taps: block numbers (1-based) and their channel counts
TAP_BLOCKS = (11, 13)
TRUNK_TAP_CHANNELS = (512, 1024)

#: extra pairs beyond the trunk taps: (1x1 reduce ch, 3x3 out ch); presets
#: with fewer maps use a prefix
EXTRA_DEFS = ((256, 512), (128, 256), (128, 256), (64, 128))

#: the family protocol's facts, as the ResNet family's (``models/resnet.py``)
PER_LAYER_SCALES = False
RELU_IN_CONV = False
#: the maps feed SSD's multibox heads (``ssd_vgg.MULTIBOX``)
OWN_HEADS = False
stem = load_pretrained = None


def map_channels(preset: SSDPreset):
    """Head-input channel count per multibox source map."""
    n_extra = preset.num_maps - len(TRUNK_TAP_CHANNELS)
    if not 0 <= n_extra <= len(EXTRA_DEFS):
        raise ValueError(
            f"{preset.name}: mobilenetv1 presets support {len(TRUNK_TAP_CHANNELS)}.."
            f"{len(TRUNK_TAP_CHANNELS) + len(EXTRA_DEFS)} maps, got {preset.num_maps}")
    return TRUNK_TAP_CHANNELS + tuple(out for _, out in EXTRA_DEFS[:n_extra])


def extra_layer_defs(preset: SSDPreset):
    """``(name, out_ch, kernel, stride, padding)`` of the conv pairs beyond
    the two trunk taps, stride and padding derived from consecutive map
    sizes as the ResNet family's are."""
    n_extra = preset.num_maps - len(TRUNK_TAP_CHANNELS)
    if n_extra > len(EXTRA_DEFS):
        raise ValueError(
            f"{preset.name}: {n_extra} extra maps but the mobilenetv1 channel table "
            f"(EXTRA_DEFS) defines only {len(EXTRA_DEFS)}")
    defs = []
    cur = preset.maps[len(TRUNK_TAP_CHANNELS) - 1].size.h
    for i, m in enumerate(preset.maps[len(TRUNK_TAP_CHANNELS):]):
        stride, padding = extra_geometry(cur, m.size.h, preset)
        reduce_ch, out_ch = EXTRA_DEFS[i]
        defs.append((f"extra{i}_1", reduce_ch, 1, 1, "SAME"))
        defs.append((f"extra{i}_2", out_ch, 3, stride, padding))
        cur = m.size.h
    return defs


def backbone_shapes(preset: SSDPreset) -> dict:
    """``{layer: {leaf: shape}}`` of the trunk and extras in init order,
    filters HWIO (a depthwise filter is ``(3, 3, 1, C)``)."""
    shapes = {"stem_conv": {"b": (32,), "w": (3, 3, 3, 32)},
              "stem_gn": {"bias": (32,), "scale": (32,)}}
    cin = 32
    for i, (_, cout) in enumerate(BLOCKS, start=1):
        shapes[f"b{i}_dw"] = {"b": (cin,), "w": (3, 3, 1, cin)}
        shapes[f"b{i}_dw_gn"] = {"bias": (cin,), "scale": (cin,)}
        shapes[f"b{i}_pw"] = {"b": (cout,), "w": (1, 1, cin, cout)}
        shapes[f"b{i}_pw_gn"] = {"bias": (cout,), "scale": (cout,)}
        cin = cout
    for name, cout, k, _, _ in extra_layer_defs(preset):
        shapes[name] = {"b": (cout,), "w": (k, k, cin, cout)}
        cin = cout
    return shapes


def init_backbone_params(rng: np.random.Generator, preset: SSDPreset) -> dict:
    """The trunk + extras (heads live with ``ssd_vgg.init_params``): Xavier
    convolutions with zero biases, GroupNorms of unit scale and zero bias."""
    return init_from_shapes(rng, backbone_shapes(preset))


def _gn_relu6(x, gn):
    """GroupNorm then ReLU6 (``resnet.norm_act``; off the kernel's route
    through this module's ``group_norm``)."""
    return norm_act(x, gn, "relu6", norm=group_norm)


def walk_feature_maps(params, x, config, conv):
    """Preprocessed NHWC images -> the multibox source maps of
    ``config.preset``, every convolution through ``conv`` (see the module
    doc)."""
    x = _gn_relu6(conv("stem_conv", x, stride=2), params["stem_gn"])
    maps = []
    for i, (stride, _) in enumerate(BLOCKS, start=1):
        x = _gn_relu6(conv(f"b{i}_dw", x, stride=stride, depthwise=True), params[f"b{i}_dw_gn"])
        x = _gn_relu6(conv(f"b{i}_pw", x), params[f"b{i}_pw_gn"])
        if i in TAP_BLOCKS:
            maps.append(x)
    for name, _, _, stride, padding in extra_layer_defs(config.preset):
        x = relu6(conv(name, x, stride=stride, padding=padding))
        if name.endswith("_2"):
            maps.append(x)
    return maps
