"""The VGG-16 SSD backbone: the VGG-16 trunk, the a-trous conv6/conv7 and
the extra layers conv8..11 (+12 for 7-map presets) on NHWC tensors, and
the import of pretrained VGG-16 weights with the fc6/fc7 decimation.

The multibox source maps are the L2-normalized conv4_3, conv7 and the
second conv of each extra pair. The walk (:func:`walk_feature_maps`)
runs every convolution through an injected executor as the ResNet-34 and
MobileNetV1 walks do (``models/ssd_vgg.py`` documents the family
protocol); each of VGG's convs carries its ReLU.
"""

from __future__ import annotations

import numpy as np
import torch
import torch.nn.functional as F

from ssd_tensorflow_tpu_torch.models.layers import (
    init_conv,
    l2_normalize_scale,
    max_pool,
    preprocess,
)
from ssd_tensorflow_tpu_torch.ops import stem_cuda
from ssd_tensorflow_tpu_torch.presets import SSDPreset

#: (name, out_channels) of the 13 conv layers; pools follow each block.
VGG_CONV_LAYERS = (
    ("conv1_1", 64),
    ("conv1_2", 64),
    ("conv2_1", 128),
    ("conv2_2", 128),
    ("conv3_1", 256),
    ("conv3_2", 256),
    ("conv3_3", 256),
    ("conv4_1", 512),
    ("conv4_2", 512),
    ("conv4_3", 512),
    ("conv5_1", 512),
    ("conv5_2", 512),
    ("conv5_3", 512),
)

_POOL_AFTER = {"conv1_2", "conv2_2", "conv3_3", "conv4_3"}

#: input channels of each multibox source map
#: [norm_conv4_3, mod_conv7, conv8_2, conv9_2, conv10_2, conv11_2, (conv12_2)]
_MAP_CHANNELS = (512, 1024, 512, 256, 256, 256, 256)

#: int8 activation scales: one per layer (``quantized.calibrate_activation_scales``)
PER_LAYER_SCALES = True
#: every conv of the walk carries its ReLU, so the float inference route
#: runs them as ``layers.conv_relu`` and only the heads carry their bias in
RELU_IN_CONV = True
#: the maps feed SSD's multibox heads (``ssd_vgg.MULTIBOX``)
OWN_HEADS = False


def map_channels(preset: SSDPreset):
    """Head-input channel count per multibox source map."""
    return _MAP_CHANNELS[: preset.num_maps]


def extra_layer_defs(preset: SSDPreset):
    """Extra feature layers ``(name, out_ch, kernel, stride, padding)``.

    conv10_2 differs between 6- and 7-map presets; presets with fewer
    maps use a truncated prefix of the chain.
    """
    num_maps = preset.num_maps
    stride10, padding10 = (2, "SAME") if num_maps >= 7 else (1, "VALID")
    defs = [
        ("conv8_1", 256, 1, 1, "SAME"),
        ("conv8_2", 512, 3, 2, "SAME"),
        ("conv9_1", 128, 1, 1, "SAME"),
        ("conv9_2", 256, 3, 2, "SAME"),
        ("conv10_1", 128, 1, 1, "SAME"),
        ("conv10_2", 256, 3, stride10, padding10),
        ("conv11_1", 128, 1, 1, "SAME"),
        ("conv11_2", 256, 3, 1, "VALID"),
    ][: 2 * (num_maps - 2)]
    if num_maps >= 7:
        defs += [
            ("conv12_1", 128, 1, 1, "SAME"),  # + bottom/right zero pad
            ("conv12_2", 256, 3, 1, "VALID"),
        ]
    return defs


def vgg_param_shapes() -> dict:
    """``{name: (kh, kw, cin, cout)}`` of the trunk's convolutions."""
    shapes = {}
    cin = 3
    for name, cout in VGG_CONV_LAYERS:
        shapes[name] = (3, 3, cin, cout)
        cin = cout
    shapes["mod_conv6"] = (3, 3, 512, 1024)
    shapes["mod_conv7"] = (1, 1, 1024, 1024)
    return shapes


def backbone_shapes(preset: SSDPreset) -> dict:
    """``{layer: {leaf: shape}}`` of the trunk, the conv4_3 L2-norm scale
    and the extras in init order, filters HWIO (the bundle's layout)."""
    shapes = {name: {"b": (s[3],), "w": s} for name, s in vgg_param_shapes().items()}
    shapes["l2_norm_conv4_3"] = {"scale": (512,)}
    cin = 1024
    for name, cout, ksize, _, _ in extra_layer_defs(preset):
        shapes[name] = {"b": (cout,), "w": (ksize, ksize, cin, cout)}
        cin = cout
    return shapes


def init_backbone_params(rng: np.random.Generator, preset: SSDPreset) -> dict:
    """Xavier convolutions with zero biases (OIHW) drawn from ``rng`` in
    the order of :func:`backbone_shapes`, the L2-norm scale at 20 (heads
    live with ``ssd_vgg.init_params``)."""
    return {name: (init_conv(rng, *leaves["w"]) if "w" in leaves
                   else {"scale": torch.full(leaves["scale"], 20.0)})
            for name, leaves in backbone_shapes(preset).items()}


def conv1_block(params, x):
    """conv1_1 + conv1_2 + pool1 of a preprocessed bf16 NHWC batch:
    conv1_1 as an un-biased bf16 convolution, the rest as the split stem
    kernel (``ops/stem_cuda.fused_stem``)."""
    p2 = params["conv1_2"]
    return stem_cuda.fused_stem(stem_cuda.conv1_1_unbiased(params, x), params["conv1_1"]["b"],
                                p2["w"], p2["b"])


def conv1_block_uint8(params, images, mean_bgr):
    """preprocess + conv1_1 + conv1_2 + pool1 of a raw ``(B, H, W, 3)``
    uint8 BGR batch as one kernel (``ops/stem_cuda.fused_stem_uint8``,
    which stages the weights in the kernel's layout): bf16 pool1."""
    return stem_cuda.fused_stem_uint8(params, images, mean_bgr)


def stem(params, images, config):
    """pool1 of the bf16 inference route from raw ``(B, H, W, 3)`` BGR
    images by the stem kernel ``config.pallas_stem_variant`` names:
    ``"uint8"`` the whole stem from the images cast to uint8, as in the JAX
    package, ``"dma"`` the split stem (:func:`conv1_block`) from the
    preprocessed batch. The walk then starts from pool1."""
    if config.pallas_stem_variant == "uint8":
        return conv1_block_uint8(params, images.to(torch.uint8), config.mean_bgr)
    return conv1_block(params, preprocess(images, config))


def walk_feature_maps(params, x, config, conv, from_pool1: bool = False):
    """Preprocessed NHWC images (with ``from_pool1``, pool1's output) ->
    the preset's multibox source maps, every convolution through ``conv``
    with its ReLU (``relu=True``): the trunk with a 2x2 pool after each
    block, pool5 3x3 stride 1, conv6 dilated 6 where ``config.a_trous``
    (else 1), conv7, the extras (conv12_1 zero-padded at the bottom and
    right); the maps are the L2-normalized conv4_3, conv7 and each extra
    pair's second conv."""
    conv4_3 = None
    for name, _ in VGG_CONV_LAYERS[2 if from_pool1 else 0:]:
        x = conv(name, x, relu=True)
        if name == "conv4_3":
            conv4_3 = x
        if name in _POOL_AFTER:
            x = max_pool(x, 2, 2)
    x = max_pool(x, 3, 1)
    x = conv("mod_conv6", x, dilation=6 if config.a_trous else 1, relu=True)
    x = conv("mod_conv7", x, relu=True)
    maps = [l2_normalize_scale(conv4_3, params["l2_norm_conv4_3"]["scale"],
                               eps=config.l2_norm_eps), x]
    for name, _, _, stride, padding in extra_layer_defs(config.preset):
        x = conv(name, x, stride=stride, padding=padding, relu=True)
        if name == "conv12_1":
            x = F.pad(x, (0, 0, 0, 1, 0, 1))  # bottom/right zero pad before conv12_2
        elif name.endswith("_2"):
            maps.append(x)
    return maps


def decimate_fc6(fc6_w: np.ndarray, fc6_b: np.ndarray):
    """HWIO ``(7, 7, 512, 4096)`` fc6 -> the ``(3, 3, 512, 1024)`` a-trous
    conv6: every 3rd spatial tap, every 4th output channel (numpy)."""
    if fc6_w.shape != (7, 7, 512, 4096):
        raise ValueError(f"fc6/w must be (7, 7, 512, 4096), got {fc6_w.shape}")
    return np.ascontiguousarray(fc6_w[::3, ::3, :, ::4]), np.ascontiguousarray(fc6_b[::4])


def decimate_fc7(fc7_w: np.ndarray, fc7_b: np.ndarray):
    """HWIO ``(1, 1, 4096, 4096)`` fc7 -> ``(1, 1, 1024, 1024)``: every 4th
    input and output channel (numpy)."""
    if fc7_w.shape != (1, 1, 4096, 4096):
        raise ValueError(f"fc7/w must be (1, 1, 4096, 4096), got {fc7_w.shape}")
    return np.ascontiguousarray(fc7_w[:, :, ::4, ::4]), np.ascontiguousarray(fc7_b[::4])


def _conv_leaves(w_hwio, b):
    """HWIO numpy filter + bias -> the port's ``{"w": OIHW, "b"}`` float32 tensors."""
    w = np.asarray(w_hwio, dtype=np.float32).transpose(3, 2, 0, 1)
    return {"w": torch.from_numpy(np.ascontiguousarray(w)),
            "b": torch.from_numpy(np.asarray(b, dtype=np.float32).copy())}


def load_pretrained_vgg(npz_path: str, params: dict) -> dict:
    """``params`` with pretrained VGG-16 weights from an npz archive laid
    over it (a new dict; ``params`` is not changed).

    The archive holds ``conv{i}_{j}/w`` (HWIO) and ``conv{i}_{j}/b`` for
    the 13 conv layers, plus either pre-decimated ``mod_conv6/...`` /
    ``mod_conv7/...`` or raw ``fc6/w`` (7, 7, 512, 4096), ``fc6/b``,
    ``fc7/w`` (1, 1, 4096, 4096), ``fc7/b``, decimated here. Layers the
    archive lacks keep their values, with a warning printed.
    """
    out = dict(params)
    with np.load(npz_path) as data:
        for name, _ in VGG_CONV_LAYERS:
            if f"{name}/w" in data:
                out[name] = _conv_leaves(data[f"{name}/w"], data[f"{name}/b"])
            else:
                print(f"[!] pretrained archive missing {name}/w; keeping random init")
        if "mod_conv6/w" in data:
            for name in ("mod_conv6", "mod_conv7"):
                out[name] = _conv_leaves(data[f"{name}/w"], data[f"{name}/b"])
        elif "fc6/w" in data:
            out["mod_conv6"] = _conv_leaves(*decimate_fc6(data["fc6/w"], data["fc6/b"]))
            out["mod_conv7"] = _conv_leaves(*decimate_fc7(data["fc7/w"], data["fc7/b"]))
        else:
            print("[!] pretrained archive has no fc6/fc7; keeping random init")
    return out


#: the pretrained import that the train CLI's ``--vgg-dir`` bootstrap lays
#: over a new model (a family without one has None)
load_pretrained = load_pretrained_vgg
