"""Operations and bytes of the SSD forward and train step, counted from
the configuration's shapes by the benchmark itself (not by the program),
and the H100's published peaks, so that a roofline or MFU share reads the
same work whatever implements it.

A convolution's bound is ``max(operations / dense peak, bytes / 3.35
TB/s)``: operations ``2 * B * Ho * Wo * cout * k * k * cin``; bytes its
input read once, its filter and its output written once, activations in
bf16 (the raw uint8 image for conv1_1), filters in the configuration's
precision (int8: 1 byte, bf16: 2)."""

from __future__ import annotations

import os
import sys

sys.path.insert(0, os.path.join(os.path.dirname(os.path.abspath(__file__)), ".."))

from reference import ssd_ref  # noqa: E402

#: NVIDIA's H100 SXM data sheet, dense rates without sparsity, at 700 W
PEAK_OPS = {"int8": 1979e12, "fp8": 1979e12, "bfloat16": 989e12, "float16": 989e12,
            "tf32": 495e12, "float32": 67e12}
HBM_BYTES_PER_S = 3.35e12
_WEIGHT_BYTES = {"int8": 1, "fp8": 1, "bfloat16": 2, "float16": 2, "float32": 4}


def conv_shapes(cfg: dict, batch: int):
    """Every convolution of the forward at ``batch``: dicts of ``name, b,
    hin, win, cin, ho, wo, cout, k``, in forward order (heads last)."""
    preset = cfg["preset"]
    h, w = preset["image_size"][1], preset["image_size"][0]
    sizes = {}
    for name, k, cin, cout, s, p, d, _ in ssd_ref.conv_layers(preset, cfg["model"]["num_classes"]):
        if name.startswith("classifier"):
            continue
        if p == "SAME":
            ho, wo = -(-h // s), -(-w // s)
        else:
            ho, wo = (h - (k - 1) * d - 1) // s + 1, (w - (k - 1) * d - 1) // s + 1
        sizes[name] = (h, w, ho, wo)
        h, w = ho, wo
        if name in ssd_ref.POOL_AFTER:
            h, w = -(-h // 2), -(-w // 2)
        if name == "conv12_1":
            h, w = h + 1, w + 1
    maps = [m["size"] for m in preset["maps"]]
    out = []
    for name, k, cin, cout, s, p, d, _ in ssd_ref.conv_layers(preset, cfg["model"]["num_classes"]):
        if name.startswith("classifier"):
            i = int(name[len("classifier"):])
            hin, win, ho, wo = maps[i][1], maps[i][0], maps[i][1], maps[i][0]
        else:
            hin, win, ho, wo = sizes[name]
        out.append(dict(name=name, b=batch, hin=hin, win=win, cin=cin, ho=ho, wo=wo,
                        cout=cout, k=k))
    return out


def conv_ops(c: dict) -> float:
    return 2.0 * c["b"] * c["ho"] * c["wo"] * c["cout"] * c["k"] * c["k"] * c["cin"]


def conv_bytes(c: dict, precision: str) -> float:
    act_in = 1 if c["name"] == "conv1_1" else 2
    return (c["b"] * c["hin"] * c["win"] * c["cin"] * act_in
            + c["k"] * c["k"] * c["cin"] * c["cout"] * _WEIGHT_BYTES[precision]
            + c["b"] * c["ho"] * c["wo"] * c["cout"] * 2)


def conv_bound_s(c: dict, precision: str) -> float:
    return max(conv_ops(c) / PEAK_OPS[precision], conv_bytes(c, precision) / HBM_BYTES_PER_S)


def forward_ops(cfg: dict, batch: int = 1) -> float:
    """Operations of the forward: twice its convolutions' multiply-adds."""
    return sum(conv_ops(c) for c in conv_shapes(cfg, batch))


def train_ops(cfg: dict, batch: int = 1) -> float:
    """Operations of a train step: the forward, the data gradient of every
    convolution but conv1_1 (whose input needs none) and every filter
    gradient, each as many operations as the forward convolution."""
    convs = conv_shapes(cfg, batch)
    fwd = sum(conv_ops(c) for c in convs)
    return 3 * fwd - sum(conv_ops(c) for c in convs if c["name"] == "conv1_1")


def convs_bound_s(cfg: dict, batch: int) -> float:
    """The least time of the forward's convolutions at ``batch``."""
    return sum(conv_bound_s(c, cfg["precision"]) for c in conv_shapes(cfg, batch))


def stem_bound_s(cfg: dict, batch: int) -> float:
    """The least time of the uint8 stem (preprocess + conv1_1 + conv1_2 +
    pool1 in one kernel): conv1_1's and conv1_2's operations; bytes the
    uint8 image read and the bf16 pool1 written."""
    convs = {c["name"]: c for c in conv_shapes(cfg, batch)}
    c1, c2 = convs["conv1_1"], convs["conv1_2"]
    ops = conv_ops(c1) + conv_ops(c2)
    pool1 = batch * -(-c2["ho"] // 2) * -(-c2["wo"] // 2) * c2["cout"] * 2
    nbytes = batch * c1["hin"] * c1["win"] * 3 + pool1 + (27 + 576) * 64 * 2
    return max(ops / PEAK_OPS[cfg["precision"]], nbytes / HBM_BYTES_PER_S)
