"""VGG-16 trunk with the a-trous conv6/conv7, on NHWC tensors, and the
import of pretrained VGG-16 weights with the fc6/fc7 decimation."""

from __future__ import annotations

import numpy as np
import torch

from ssd_tensorflow_tpu_torch.models.layers import conv_relu, conv_relu_train, init_conv, max_pool
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


def apply_backbone(params, x, a_trous: bool = True, from_pool1: bool = False,
                   train: bool = False):
    """VGG-16 trunk -> (conv4_3 relu, mod_conv7 relu), NHWC.

    pool5 is 3x3 stride-1 SAME; conv6 is the rate-6 dilated conv.
    ``from_pool1=True`` means ``x`` is already pool1's output and the
    conv1 block is skipped. ``train=True`` runs every conv through the
    differentiable training conv (``layers.conv_relu_train``), the conv1
    block included, as plain convolutions and a pool: the JAX package's
    training forward never takes a stem kernel.
    """
    conv = conv_relu_train if train else conv_relu
    conv4_3 = None
    for name, _ in VGG_CONV_LAYERS:
        if from_pool1 and name in ("conv1_1", "conv1_2"):
            continue
        x = conv(params[name], x)
        if name == "conv4_3":
            conv4_3 = x
        if name in _POOL_AFTER:
            x = max_pool(x, 2, 2)
    x = max_pool(x, 3, 1)
    x = conv(params["mod_conv6"], x, dilation=6 if a_trous else 1)
    x = conv(params["mod_conv7"], x)
    return conv4_3, x


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
