"""Operations and bytes of the SSD forward and train step, counted from
the convolutions that the configuration's family lists
(``benchlib/family.py``: ``conv_records``), by the benchmark itself (not by
the program), and the H100's published peaks, so that a roofline or MFU
share reads the same work whatever implements it.

A convolution's bound is ``max(operations / dense peak, bytes / 3.35
TB/s)``: operations ``2 * B * Ho * Wo * cout * k * k * cin / groups``;
bytes its input read once, its filter (``k * k * cin / groups * cout``)
and its output written once, activations in bf16 (the raw uint8 image for
the convolution that reads it), filters in the configuration's precision
(int8: 1 byte, bf16: 2)."""

from __future__ import annotations

import os
import sys

sys.path.insert(0, os.path.join(os.path.dirname(os.path.abspath(__file__)), ".."))

from benchlib import family  # noqa: E402

#: NVIDIA's H100 SXM data sheet, dense rates without sparsity, at 700 W
PEAK_OPS = {"int8": 1979e12, "fp8": 1979e12, "bfloat16": 989e12, "float16": 989e12,
            "tf32": 495e12, "float32": 67e12}
HBM_BYTES_PER_S = 3.35e12
_WEIGHT_BYTES = {"int8": 1, "fp8": 1, "bfloat16": 2, "float16": 2, "float32": 4}


def conv_shapes(cfg: dict, batch: int):
    """Every convolution of the forward at ``batch``, as the family's
    ``conv_records`` gives them: dicts of ``name, b, hin, win, cin, ho, wo,
    cout, k, groups, reads_image``, in forward order (heads last)."""
    return family.of(cfg).conv_records(cfg, batch)


def conv_ops(c: dict) -> float:
    return (2.0 * c["b"] * c["ho"] * c["wo"] * c["cout"] * c["k"] * c["k"]
            * (c["cin"] // c["groups"]))


def conv_bytes(c: dict, precision: str) -> float:
    act_in = 1 if c["reads_image"] else 2
    return (c["b"] * c["hin"] * c["win"] * c["cin"] * act_in
            + c["k"] * c["k"] * (c["cin"] // c["groups"]) * c["cout"] * _WEIGHT_BYTES[precision]
            + c["b"] * c["ho"] * c["wo"] * c["cout"] * 2)


def conv_bound_s(c: dict, precision: str) -> float:
    return max(conv_ops(c) / PEAK_OPS[precision], conv_bytes(c, precision) / HBM_BYTES_PER_S)


def forward_ops(cfg: dict, batch: int = 1) -> float:
    """Operations of the forward: twice its convolutions' multiply-adds."""
    return sum(conv_ops(c) for c in conv_shapes(cfg, batch))


def train_ops(cfg: dict, batch: int = 1) -> float:
    """Operations of a train step: the forward, the data gradient of every
    convolution but those that read the image (whose input needs none) and
    every filter gradient, each as many operations as the forward
    convolution."""
    convs = conv_shapes(cfg, batch)
    fwd = sum(conv_ops(c) for c in convs)
    return 3 * fwd - sum(conv_ops(c) for c in convs if c["reads_image"])


def convs_bound_s(cfg: dict, batch: int) -> float:
    """The least time of the forward's convolutions at ``batch``."""
    return sum(conv_bound_s(c, cfg["precision"]) for c in conv_shapes(cfg, batch))


def stem_bound_s(cfg: dict, batch: int) -> float:
    """The least time of the uint8 stem kernel, which runs the
    preprocessing, the convolution that reads the image, the one after it
    and a 2x2/s2 max-pool in one launch (read where ``serve_overrides``
    selects ``pallas_stem_variant`` ``uint8``): the two convolutions'
    operations; bytes the uint8 image read, the two filters in bf16 and the
    pooled bf16 map written."""
    convs = conv_shapes(cfg, batch)
    i = next(j for j, c in enumerate(convs) if c["reads_image"])
    c1, c2 = convs[i], convs[i + 1]
    ops = conv_ops(c1) + conv_ops(c2)
    pooled = batch * -(-c2["ho"] // 2) * -(-c2["wo"] // 2) * c2["cout"] * 2
    filters = (c1["k"] * c1["k"] * c1["cin"] * c1["cout"]
               + c2["k"] * c2["k"] * c2["cin"] * c2["cout"]) * 2
    nbytes = batch * c1["hin"] * c1["win"] * c1["cin"] + pooled + filters
    return max(ops / PEAK_OPS[cfg["precision"]], nbytes / HBM_BYTES_PER_S)
