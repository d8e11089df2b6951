"""Plain float32 reference of SSD with a MobileNetV1 trunk (Howard et al.
2017, arXiv:1704.04861, Table 1, width 1.0) as the SSD feature extractor
of Huang et al. 2017 (arXiv:1611.10012), with GroupNorm (Wu and He 2018,
arXiv:1803.08494) in place of BatchNorm: the forward of float and of int8
weights. Plain PyTorch on NCHW tensors with TF32 off; it imports nothing
of the program under test. It is a family module (``benchlib/family.py``),
and takes ``ssd_ref``'s anchors, decode, NMS and detect and
``ssd_resnet34gn``'s GroupNorm.

The model, as ``ssd_tensorflow_tpu_torch/models/mobilenet.py`` and
``models/quantized.py`` document it:

* a 3x3/s2 convolution to 32 channels, GroupNorm, ReLU6;
* 13 depthwise-separable blocks (64, 128, 128, 256, 256, 512 x 6, 1024,
  1024 channels; stride 2 in blocks 2, 4, 6 and 12): a 3x3 depthwise conv
  (``groups`` = channels) with its stride, GroupNorm, ReLU6, then a 1x1
  conv, GroupNorm, ReLU6;
* the outputs of blocks 11 and 13 are the first two multibox maps; each
  further map is an extra pair, a 1x1 conv then a 3x3 conv, each with
  ReLU6 and no GroupNorm (256 -> 512, 128 -> 256, 128 -> 256, 64 -> 128:
  the published layer depths with halved reductions), whose stride and
  padding follow the map sizes (halving: stride 2 SAME; shrinking by 2:
  stride 1 VALID);
* one 3x3 multibox head conv per map, its output the per-shape heads of
  ``K + 5`` values concatenated (``ssd_ref.heads_to_anchors``);
* GroupNorm of 32 groups (one where 32 does not divide the channels), the
  mean and the mean squared deviation over each group, ``eps`` 1e-5, then
  the per-channel scale and bias;
* the int8 model: every full and 1x1 conv and every head W8A8, with
  per-input-channel activation scales folded into per-output-channel int8
  filters: ``x_q = clip(round(x / a_scale), -127, 127)`` per input channel,
  the exact integer sums, ``sums * w_scale + b``; the depthwise convs
  weight-only (the int8 filter times its per-channel ``w_scale``, the
  activations unquantized); GroupNorm and ReLU6 in float between them.

Departures from the program, each deliberate:

* Activations stay float32 between layers. The program stores bf16
  activations (each conv's output and each GroupNorm's rounded to bf16);
  the reference is the float32 math of the same model.
* GroupNorm's means are float32 sums in the library's order; the program
  sums in float64 and rounds once.
* int8 sums are computed in float64 and rounded to the nearest integer,
  exact whatever algorithm the library picks (the program: int8 products
  summed in int32).
* A depthwise conv's dequantized filter and its output stay float32; the
  program rounds the filter to bf16 once, the stencil's sum to bf16, then
  adds the bias in bf16.
* The bundle marks its stem ``packed_stem``: a width-packed layout of the
  same sums, so the reference runs the plain 3x3 convolution.
* ``quant`` and ``bits`` make the lower-precision controls, as in
  ``ssd_ref``: fp8 operands for the float model, a 4-bit grid for the int8
  one (the depthwise filters requantized to +-7 per channel too).
"""

from __future__ import annotations

import json
import math

import numpy as np
import torch
import torch.nn.functional as F

from reference.ssd_ref import (  # noqa: F401  (the family's anchors and detection step)
    anchors,
    conv,
    detect,
    fp8_quant,
    full_float32,
    heads_to_anchors,
    num_shapes,
    same_pads,
    seed_generator,
)
from reference.ssd_resnet34gn import group_norm  # the same GroupNorm: 32 groups, eps 1e-5

#: (stride, output channels) of the 13 depthwise-separable blocks
BLOCKS = ((1, 64), (2, 128), (1, 128), (2, 256), (1, 256), (2, 512), (1, 512), (1, 512),
          (1, 512), (1, 512), (1, 512), (2, 1024), (1, 1024))
STEM_CHANNELS = 32
#: the blocks (1-based) whose outputs are multibox maps
TAP_BLOCKS = (11, 13)
#: (1x1 reduction, 3x3 output) channels of the extra pairs, in order
EXTRA_CHANNELS = ((256, 512), (128, 256), (128, 256), (64, 128))


def relu6(x):
    return x.clamp(0.0, 6.0)


def extra_geometry(preset):
    """``(stride, padding)`` of each extra pair's 3x3 conv, from the sizes
    of consecutive maps."""
    sizes = [m["size"][1] for m in preset["maps"]]
    cur, out = sizes[len(TAP_BLOCKS) - 1], []
    for nxt in sizes[len(TAP_BLOCKS):]:
        if nxt == -(-cur // 2):
            out.append((2, "SAME"))
        elif nxt == cur - 2:
            out.append((1, "VALID"))
        else:
            raise ValueError(f"{preset['name']}: no extra pair takes a {cur} map to {nxt}")
        cur = nxt
    if len(out) > len(EXTRA_CHANNELS):
        raise ValueError(f"{preset['name']}: {len(out)} extra maps, the family has "
                         f"{len(EXTRA_CHANNELS)}")
    return out


def layer_shapes(preset, num_classes: int) -> dict:
    """``{layer: ("conv", cout, cin, k) or ("dw", channels, k) or ("gn",
    channels)}`` in forward order, under the bundle's layer names."""
    out = {"stem_conv": ("conv", STEM_CHANNELS, 3, 3), "stem_gn": ("gn", STEM_CHANNELS)}
    cin = STEM_CHANNELS
    for i, (_, cout) in enumerate(BLOCKS, start=1):
        out[f"b{i}_dw"] = ("dw", cin, 3)
        out[f"b{i}_dw_gn"] = ("gn", cin)
        out[f"b{i}_pw"] = ("conv", cout, cin, 1)
        out[f"b{i}_pw_gn"] = ("gn", cout)
        cin = cout
    maps = [BLOCKS[b - 1][1] for b in TAP_BLOCKS]
    for i, _ in enumerate(extra_geometry(preset)):
        reduce_ch, out_ch = EXTRA_CHANNELS[i]
        out[f"extra{i}_1"] = ("conv", reduce_ch, cin, 1)
        out[f"extra{i}_2"] = ("conv", out_ch, reduce_ch, 3)
        cin = out_ch
        maps.append(out_ch)
    for i, (m, c) in enumerate(zip(preset["maps"], maps)):
        out[f"classifier{i}"] = ("conv", num_shapes(m) * (num_classes + 5), c, 3)
    return out


def depthwise(x, w, b, stride, padding):
    """NCHW depthwise convolution (``groups`` = channels) with TF padding,
    ``w`` of shape ``(C, 1, k, k)``."""
    if padding == "SAME":
        ph = same_pads(x.shape[2], w.shape[2], stride)
        pw = same_pads(x.shape[3], w.shape[3], stride)
        x = F.pad(x, (pw[0], pw[1], ph[0], ph[1]))
    return F.conv2d(x, w, b, stride=stride, groups=x.shape[1])


def walk(images, cfg, conv_fn, dw_fn, norm_fn):
    """Raw ``(B, H, W, 3)`` BGR images -> the multibox source maps (NCHW):
    ``conv_fn(name, x, stride, padding)`` is a conv + bias, ``dw_fn(name,
    x, stride)`` a depthwise conv + bias (SAME), ``norm_fn(name, x)`` a
    GroupNorm."""
    mean = torch.tensor(cfg["model"]["mean_bgr"], dtype=torch.float32, device=images.device)
    x = (images.float() - mean).permute(0, 3, 1, 2)
    x = relu6(norm_fn("stem_gn", conv_fn("stem_conv", x, 2, "SAME")))
    maps = []
    for i, (stride, _) in enumerate(BLOCKS, start=1):
        x = relu6(norm_fn(f"b{i}_dw_gn", dw_fn(f"b{i}_dw", x, stride)))
        x = relu6(norm_fn(f"b{i}_pw_gn", conv_fn(f"b{i}_pw", x, 1, "SAME")))
        if i in TAP_BLOCKS:
            maps.append(x)
    for i, (s, p) in enumerate(extra_geometry(cfg["preset"])):
        x = relu6(conv_fn(f"extra{i}_1", x, 1, "SAME"))
        x = relu6(conv_fn(f"extra{i}_2", x, s, p))
        maps.append(x)
    return maps


def _forward(images, cfg, conv_fn, dw_fn, norm_fn):
    preset, k = cfg["preset"], cfg["model"]["num_classes"]
    maps = walk(images, cfg, conv_fn, dw_fn, norm_fn)
    heads = [conv_fn(f"classifier{i}", fm, 1, "SAME") for i, fm in enumerate(maps)]
    out = heads_to_anchors(heads, preset, k)
    return out[..., : k + 1], out[..., k + 1:]


def conv_records(cfg, batch: int):
    """Every convolution of the forward at ``batch`` (``benchlib/family.py``),
    read off the reference's own walk run on shapes alone (meta tensors);
    a depthwise conv's record has ``groups`` = its channels."""
    table = layer_shapes(cfg["preset"], cfg["model"]["num_classes"])
    out = []

    def record(name, x, y, cin, cout, k, groups):
        out.append(dict(name=name, b=batch, hin=x.shape[2], win=x.shape[3], cin=cin,
                        ho=y.shape[2], wo=y.shape[3], cout=cout, k=k, groups=groups,
                        reads_image=name == "stem_conv"))
        return y

    def conv_fn(name, x, stride, padding):
        _, cout, cin, k = table[name]
        y = conv(x, torch.empty((cout, cin, k, k), device="meta"), None, stride, padding, 1)
        return record(name, x, y, cin, cout, k, 1)

    def dw_fn(name, x, stride):
        _, c, k = table[name]
        y = depthwise(x, torch.empty((c, 1, k, k), device="meta"), None, stride, "SAME")
        return record(name, x, y, c, c, k, c)

    w, h = cfg["preset"]["image_size"]
    _forward(torch.empty((batch, h, w, 3), dtype=torch.uint8, device="meta"), cfg, conv_fn,
             dw_fn, lambda name, x: x)
    return out


def _filter_shape(t):
    return (t[1], 1, t[2], t[2]) if t[0] == "dw" else (t[1], t[2], t[3], t[3])


def seeded_params(cfg, seed: int, device) -> dict:
    """Float32 parameters made on ``device`` from ``seed`` in one uniform
    draw, in the program's layout (``{conv: {"w": OIHW, "b"}, norm:
    {"scale", "bias"}}``, a depthwise filter ``(C, 1, k, k)``): filters
    Xavier-uniform over ``(k*k*cin + k*k*cout)`` per group (each multibox
    head shape counted as its own ``K+5``-wide conv), conv biases and
    GroupNorm biases uniform in ``+-bias_range``, GroupNorm scales uniform
    in ``gn_scale``."""
    k = cfg["model"]["num_classes"]
    spec = cfg["weights"]
    table = layer_shapes(cfg["preset"], k)
    sizes = {n: (math.prod(_filter_shape(t)) + t[1] if t[0] != "gn" else 2 * t[1])
             for n, t in table.items()}
    u = torch.rand(sum(sizes.values()), generator=seed_generator(seed, device),
                   device=device) * 2 - 1
    lo, hi = spec["gn_scale"]
    params, off = {}, 0
    for name, t in table.items():
        v = u[off:off + sizes[name]]
        off += sizes[name]
        if t[0] == "gn":
            params[name] = {"scale": lo + (hi - lo) * (v[:t[1]] + 1) / 2,
                            "bias": v[t[1]:] * spec["bias_range"]}
            continue
        shape = _filter_shape(t)
        kk, cin_g = shape[2], shape[1]
        fan_out = (k + 5) if name.startswith("classifier") else (1 if t[0] == "dw" else t[1])
        limit = math.sqrt(6.0 / (kk * kk * cin_g + kk * kk * fan_out))
        nw = math.prod(shape)
        params[name] = {"w": (v[:nw] * limit).view(shape), "b": v[nw:] * spec["bias_range"]}
    return params


def float_forward(params, images, cfg, quant=None):
    """``(logits, locs)`` of float32 parameters in the program's layout;
    ``quant(t)`` rounds each conv's input and filter (the fp8 control)
    where given."""
    q = quant or (lambda t: t)

    def conv_fn(name, x, s, p):
        return conv(q(x), q(params[name]["w"].float()), params[name]["b"].float(), s, p, 1)

    def dw_fn(name, x, s):
        return depthwise(q(x), q(params[name]["w"].float()), params[name]["b"].float(), s,
                         "SAME")

    def norm_fn(name, x):
        return group_norm(x, params[name]["scale"].float(), params[name]["bias"].float())

    return _forward(images, cfg, conv_fn, dw_fn, norm_fn)


def read_int8_bundle(path, cfg) -> dict:
    """The int8 bundle's arrays as numpy: ``{conv: {"a_scale" (cin,), "b",
    "w_scale" (cout,), "wq" HWIO int8}, depthwise: {"b", "w_scale" (C,),
    "wq" (k, k, 1, C) int8}, norm: {"bias", "scale"}}``. Leaves are
    ``leaf_<i>`` in sorted (layer, key) order, as the bundle format states;
    the bundle's model has to be the configuration's."""
    model = cfg["model"]
    table = layer_shapes(cfg["preset"], model["num_classes"])
    want = {}
    for name, t in table.items():
        if t[0] == "gn":
            want[name] = {"bias": (t[1],), "scale": (t[1],)}
        elif t[0] == "dw":
            want[name] = {"b": (t[1],), "w_scale": (t[1],), "wq": (t[2], t[2], 1, t[1])}
        else:
            _, cout, cin, k = t
            want[name] = {"a_scale": (cin,), "b": (cout,), "w_scale": (cout,),
                          "wq": (k, k, cin, cout)}
    order = [(n, key) for n in sorted(want) for key in sorted(want[n])]
    with np.load(path) as data:
        meta = json.loads(bytes(data["__meta__"]))
        got = (meta["model"]["preset_name"], meta["model"]["num_classes"])
        if got != (model["preset_name"], model["num_classes"]):
            raise ValueError(f"{path} holds {got}; {cfg['name']} states "
                             f"{(model['preset_name'], model['num_classes'])}")
        n_leaves = sum(1 for f in data.files if f.startswith("leaf_"))
        if n_leaves != len(order):
            raise ValueError(f"{path}: {n_leaves} leaves, the model has {len(order)}")
        tree = {n: {} for n in want}
        for i, (n, key) in enumerate(order):
            leaf = data[f"leaf_{i}"]
            if leaf.shape != want[n][key]:
                raise ValueError(f"{path}: leaf_{i} ({n}/{key}) has shape {leaf.shape}, "
                                 f"expected {want[n][key]}")
            tree[n][key] = leaf
    return tree


def _requant(w, n: int):
    """``w`` (float32, output channels first) on a per-output-channel grid
    of ``+-n``: ``(wq as float64, scale)``."""
    scale = w.abs().amax(dim=(1, 2, 3)).clamp_min(1e-12) / n
    return torch.clamp(torch.round(w / scale.view(-1, 1, 1, 1)), -n, n).double(), scale


def int8_forward(tree, images, cfg, bits: int = 8):
    """The int8 model of a bundle in float32 (see the module doc).
    ``bits=4`` is the int4 control: each activation grid widened to 4 bits
    (``n = 7``, the scale times ``127 / 7``) and each filter (the
    depthwise ones too), folded into that grid, requantized per output
    channel to ``+-7``."""
    dev = images.device
    n = 2 ** (bits - 1) - 1
    staged, dws = {}, {}
    for name, leaf in tree.items():
        if "wq" not in leaf:
            continue
        b = torch.from_numpy(leaf["b"]).to(dev).float()
        w_scale = torch.from_numpy(leaf["w_scale"]).to(dev).float()
        if "a_scale" not in leaf:  # depthwise: weight-only
            w = torch.from_numpy(leaf["wq"]).to(dev).permute(3, 2, 0, 1).float() \
                * w_scale.view(-1, 1, 1, 1)
            if bits != 8:
                wq, s = _requant(w, n)
                w = wq.float() * s.view(-1, 1, 1, 1)
            dws[name] = (w, b)
            continue
        wq = torch.from_numpy(leaf["wq"]).to(dev).permute(3, 2, 0, 1).double()
        inv = 1.0 / torch.from_numpy(leaf["a_scale"]).to(dev).float()
        if bits != 8:
            wq, w_scale = _requant(wq.float() * w_scale.view(-1, 1, 1, 1) * (127.0 / n), n)
            inv = inv * (n / 127.0)
        staged[name] = (wq, inv, w_scale, b)

    def conv_fn(name, x, s, p):
        wq, inv, w_scale, b = staged[name]
        xq = torch.clamp(torch.round(x * inv.view(1, -1, 1, 1)), -n, n).double()
        sums = torch.round(conv(xq, wq, None, s, p, 1)).float()
        return sums * w_scale.view(1, -1, 1, 1) + b.view(1, -1, 1, 1)

    def dw_fn(name, x, s):
        w, b = dws[name]
        return depthwise(x, w, b, s, "SAME")

    def norm_fn(name, x):
        leaf = tree[name]
        return group_norm(x, torch.from_numpy(leaf["scale"]).to(dev).float(),
                          torch.from_numpy(leaf["bias"]).to(dev).float())

    return _forward(images, cfg, conv_fn, dw_fn, norm_fn)


def serving_forward(cfg, given, control: bool = False):
    """uint8 images -> ``(logits, locs)`` of the configuration's serving
    model with TF32 off: the int8 bundle at the path ``given`` (``control``:
    int4), or the float parameters ``given`` (``control``: fp8 operands)."""
    if cfg["precision"] == "int8":
        tree = read_int8_bundle(given, cfg)
        bits = 4 if control else 8

        def fwd(images):
            return int8_forward(tree, images, cfg, bits)
    else:
        quant = fp8_quant if control else None

        def fwd(images):
            return float_forward(given, images, cfg, quant)

    def run(images):
        with full_float32():
            return fwd(images)

    return run
