#!/usr/bin/env python3
"""Convert pretrained VGG16 weights into the npz that the port's
``cli/train.py --vgg-dir`` reads (the counterpart of
``tools/convert_vgg_weights.py``, for users without ``jax``).

    python3 tools/torch_convert_vgg_weights.py vgg16-397923af.pth --output vgg_graph/vgg16.npz
    python3 tools/torch_convert_vgg_weights.py caffe_vgg16.npz --output vgg_graph/vgg16.npz \
        --device cpu

Sources:

* a torchvision ``vgg16`` state_dict (``.pth``, loaded onto ``--device``:
  ``cuda`` unless the caller asks for ``cpu``, as every entry point of the
  port; without a card it raises),
* a caffe-style npz with conv weights in HWIO and our layer names.

Output keys: ``conv{i}_{j}/w`` (HWIO) and ``conv{i}_{j}/b`` for the 13
conv layers, plus ``mod_conv6/{w,b}`` (3x3x512x1024, a-trous rate 6) and
``mod_conv7/{w,b}`` (1x1x1024x1024) decimated from fc6 / fc7 by
``models/vgg16.decimate_fc6`` / ``decimate_fc7``. The same arrays, bit for
bit, as the JAX tool writes; ``models/vgg16.load_pretrained_vgg`` lays them
over a model's parameters.

Preprocessing: torchvision's VGG16 was trained on RGB [0, 1]
ImageNet-normalized input, while this detector (like the SSD / caffe
lineage) feeds BGR with the mean [104, 117, 123] subtracted. conv1_1 is
rewritten to absorb the difference: the channel order swapped, the kernel
rescaled and the bias shifted, so that the network computes the same
function on caffe-convention input. Imports nothing of JAX or of the JAX
package.
"""

from __future__ import annotations

import argparse
import sys
from pathlib import Path

import numpy as np

sys.path.insert(0, str(Path(__file__).resolve().parent.parent))

#: torchvision features.{idx} -> our layer names
TORCH_LAYER_MAP = {
    0: "conv1_1",
    2: "conv1_2",
    5: "conv2_1",
    7: "conv2_2",
    10: "conv3_1",
    12: "conv3_2",
    14: "conv3_3",
    17: "conv4_1",
    19: "conv4_2",
    21: "conv4_3",
    24: "conv5_1",
    26: "conv5_2",
    28: "conv5_3",
}

# ImageNet RGB normalization used by torchvision models
_TV_MEAN = np.array([0.485, 0.456, 0.406], dtype=np.float64)
_TV_STD = np.array([0.229, 0.224, 0.225], dtype=np.float64)
# caffe-convention BGR means this detector subtracts on the device
_BGR_MEAN = np.array([104.0, 117.0, 123.0], dtype=np.float64)


def _oihw_to_hwio(w):
    return np.ascontiguousarray(np.transpose(w, (2, 3, 1, 0)))


def _absorb_preprocessing(w1, b1):
    """conv1_1 (HWIO, input channels RGB) rewritten for BGR-mean-subtracted
    input in place of RGB ImageNet-normalized input.

    torchvision computes ``conv(w, (rgb / 255 - m) / s)``. Our input is
    ``x_bgr = bgr - mean_bgr``, so ``rgb = x_bgr[::-1] + mean_bgr[::-1]`` and
    ``(rgb / 255 - m) / s = (x_bgr[::-1] + mean_bgr[::-1]) / 255 / s - m / s``:
    the ``1 / (255 s)`` scale and the channel flip go into the kernel, the
    constant offset into the bias (float64, rounded once to float32).
    """
    w = w1.astype(np.float64)
    # new input channel c (BGR) feeds old channel 2 - c (RGB)
    w = w[:, :, ::-1, :]
    scale = 1.0 / (255.0 * _TV_STD[::-1])
    w = w * scale[None, None, :, None]
    const_rgb = (_BGR_MEAN[::-1] / 255.0 - _TV_MEAN) / _TV_STD  # per RGB channel
    b = b1.astype(np.float64) + np.einsum("hwio,i->o", w1.astype(np.float64), const_rgb)
    return w.astype(np.float32), b.astype(np.float32)


def _decimated(fc6_w, fc6_b, fc7_w, fc7_b) -> dict:
    from ssd_tensorflow_tpu_torch.models.vgg16 import decimate_fc6, decimate_fc7

    out = {}
    out["mod_conv6/w"], out["mod_conv6/b"] = decimate_fc6(fc6_w, fc6_b)
    out["mod_conv7/w"], out["mod_conv7/b"] = decimate_fc7(fc7_w, fc7_b)
    return out


def _host(t) -> np.ndarray:
    return t.detach().cpu().numpy()


def convert_torchvision(state_dict) -> dict:
    """A torchvision ``vgg16`` state_dict -> our npz arrays (see the module doc)."""
    out = {}
    for idx, name in TORCH_LAYER_MAP.items():
        out[f"{name}/w"] = _oihw_to_hwio(_host(state_dict[f"features.{idx}.weight"]))
        out[f"{name}/b"] = _host(state_dict[f"features.{idx}.bias"])
    out["conv1_1/w"], out["conv1_1/b"] = _absorb_preprocessing(out["conv1_1/w"],
                                                               out["conv1_1/b"])
    # classifier.0: Linear(25088 -> 4096) over the flattened (512, 7, 7) CHW map
    fc6_w = _host(state_dict["classifier.0.weight"]).reshape(4096, 512, 7, 7)
    fc6_w = np.transpose(fc6_w, (2, 3, 1, 0))  # HWIO (7, 7, 512, 4096)
    fc7_w = _host(state_dict["classifier.3.weight"]).T[None, None]  # (1, 1, 4096, 4096)
    out.update(_decimated(fc6_w, _host(state_dict["classifier.0.bias"]),
                          fc7_w, _host(state_dict["classifier.3.bias"])))
    return out


def convert_npz(data: dict) -> dict:
    """An npz already in our naming: raw ``fc6`` / ``fc7`` decimated, the
    rest as it is."""
    data = dict(data)
    if "fc6/w" in data:
        data.update(_decimated(data.pop("fc6/w"), data.pop("fc6/b"),
                               data.pop("fc7/w"), data.pop("fc7/b")))
    return data


def main(argv=None):
    parser = argparse.ArgumentParser(description="Convert VGG16 weights")
    parser.add_argument("input", help=".pth state_dict or .npz archive")
    parser.add_argument("--output", default="vgg16.npz", help="output npz")
    parser.add_argument("--device", default="cuda",
                        help="where a .pth loads (cuda unless asked for cpu; raises without a card)")
    args = parser.parse_args(argv)
    from ssd_tensorflow_tpu_torch import resolve_device

    device = resolve_device(args.device)
    if args.input.endswith(".npz"):
        with np.load(args.input) as data:
            out = convert_npz(data)
    else:
        import torch

        state_dict = torch.load(args.input, map_location=device, weights_only=True)
        if hasattr(state_dict, "state_dict"):
            state_dict = state_dict.state_dict()
        out = convert_torchvision(state_dict)

    np.savez(args.output, **out)
    print(f"[i] wrote {args.output} with {len(out)} arrays")
    return 0


if __name__ == "__main__":
    sys.exit(main())
