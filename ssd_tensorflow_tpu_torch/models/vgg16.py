"""VGG-16 trunk with the a-trous conv6/conv7, on NHWC tensors."""

from __future__ import annotations

import numpy as np

from ssd_tensorflow_tpu_torch.models.layers import conv_relu, init_conv, max_pool
from ssd_tensorflow_tpu_torch.ops import stem_cuda

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


def init_vgg_params(rng: np.random.Generator) -> dict:
    """Xavier init of the 13 conv layers + mod_conv6/7 (OIHW tensors)."""
    return {name: init_conv(rng, *shape) for name, shape in vgg_param_shapes().items()}


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


def apply_backbone(params, x, a_trous: bool = True, from_pool1: bool = False):
    """VGG-16 trunk -> (conv4_3 relu, mod_conv7 relu), NHWC.

    pool5 is 3x3 stride-1 SAME; conv6 is the rate-6 dilated conv.
    ``from_pool1=True`` means ``x`` is already pool1's output and the
    conv1 block is skipped.
    """
    conv4_3 = None
    for name, _ in VGG_CONV_LAYERS:
        if from_pool1 and name in ("conv1_1", "conv1_2"):
            continue
        x = conv_relu(params[name], x)
        if name == "conv4_3":
            conv4_3 = x
        if name in _POOL_AFTER:
            x = max_pool(x, 2, 2)
    x = max_pool(x, 3, 1)
    x = conv_relu(params["mod_conv6"], x, dilation=6 if a_trous else 1)
    x = conv_relu(params["mod_conv7"], x)
    return conv4_3, x
