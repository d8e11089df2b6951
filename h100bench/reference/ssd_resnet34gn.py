"""Plain float32 reference of SSD with a ResNet-34 trunk (He et al. 2016,
arXiv:1512.03385, Table 1) and GroupNorm (Wu and He 2018,
arXiv:1803.08494) in place of BatchNorm: the forward of float and of
int8 W8A8 weights. Plain PyTorch on NCHW tensors with TF32 off; it imports
nothing of the program under test. It is a family module
(``benchlib/family.py``), and takes ``ssd_ref``'s anchors, decode, NMS and
detect.

The design is the repository's own, as ``ssd_tensorflow_tpu_torch/
models/resnet.py`` and ``models/quantized.py`` document it, not a
published detector:

* a 7x7/s2 convolution to 64 channels, GroupNorm, ReLU, a 3x3/s2 max-pool
  (TF SAME, -inf padding);
* four stages of basic blocks (3, 4, 6, 3 blocks of 64, 128, 256, 512
  channels; stride 2 in the first block of the last three): conv 3x3,
  GroupNorm, ReLU, conv 3x3, GroupNorm, plus the skip (a 1x1 projection and
  GroupNorm where the channels change), then ReLU;
* the outputs of stages 2, 3 and 4 are the first three multibox maps;
  each further map is an extra pair, a 1x1 conv to 128 and a 3x3 conv to
  256, each with ReLU, whose stride and padding follow the map sizes
  (halving: stride 2 SAME; shrinking by 2: stride 1 VALID);
* one 3x3 multibox head conv per map, its output the per-shape heads of
  ``K + 5`` values concatenated (``ssd_ref.heads_to_anchors``);
* GroupNorm of 32 groups (one where 32 does not divide the channels), the
  mean and the mean squared deviation over each group, ``eps`` 1e-5, then
  the per-channel scale and bias;
* the int8 model W8A8 with per-input-channel activation scales folded
  into per-output-channel int8 filters: ``x_q = clip(round(x / a_scale),
  -127, 127)`` per input channel, the exact integer sums, ``sums *
  w_scale + b``; GroupNorm, ReLU and the skips in float between them.

Departures from the program, each deliberate:

* Activations stay float32 between layers. The program stores bf16
  activations (each conv's output and each GroupNorm's rounded to bf16);
  the reference is the float32 math of the same model.
* GroupNorm's means are float32 sums in the library's order; the program
  sums in float64 and rounds once.
* int8 sums are computed in float64 and rounded to the nearest integer,
  exact whatever algorithm the library picks (the program: int8 products
  summed in int32).
* The program's stem may be width-packed in the bundle's description
  (``packed_stem``): a layout of the same sums, so the reference runs the
  plain 7x7 convolution.
* ``quant`` and ``bits`` make the lower-precision controls, as in
  ``ssd_ref``: fp8 operands for the float model, a 4-bit grid for the int8
  one.
"""

from __future__ import annotations

import json
import math

import numpy as np
import torch

from reference.ssd_ref import (  # noqa: F401  (the family's anchors and detection step)
    anchors,
    conv,
    detect,
    fp8_quant,
    full_float32,
    heads_to_anchors,
    max_pool,
    num_shapes,
    seed_generator,
)

#: (blocks, channels, stride of the first block) of the four stages
STAGES = ((3, 64, 1), (4, 128, 2), (6, 256, 2), (3, 512, 2))
STEM_CHANNELS = 64
STEM_KERNEL = 7
#: the stages whose outputs are multibox maps
TAPPED_STAGES = (1, 2, 3)
#: output channels of an extra pair's 1x1 and 3x3 convs
EXTRA_CHANNELS = (128, 256)
GN_GROUPS = 32
GN_EPS = 1e-5


def extra_geometry(preset):
    """``(stride, padding)`` of each extra pair's 3x3 conv, from the sizes
    of consecutive maps."""
    sizes = [m["size"][1] for m in preset["maps"]]
    cur, out = sizes[len(TAPPED_STAGES) - 1], []
    for nxt in sizes[len(TAPPED_STAGES):]:
        if nxt == -(-cur // 2):
            out.append((2, "SAME"))
        elif nxt == cur - 2:
            out.append((1, "VALID"))
        else:
            raise ValueError(f"{preset['name']}: no extra pair takes a {cur} map to {nxt}")
        cur = nxt
    return out


def layer_shapes(preset, num_classes: int) -> dict:
    """``{layer: ("conv", cout, cin, k) or ("gn", channels)}`` in forward
    order, under the bundle's layer names."""
    out = {"stem_conv": ("conv", STEM_CHANNELS, 3, STEM_KERNEL),
           "stem_gn": ("gn", STEM_CHANNELS)}
    cin = STEM_CHANNELS
    for si, (blocks, ch, _) in enumerate(STAGES):
        for bi in range(blocks):
            n = f"s{si}b{bi}"
            out[f"{n}_conv1"] = ("conv", ch, cin, 3)
            out[f"{n}_gn1"] = ("gn", ch)
            out[f"{n}_conv2"] = ("conv", ch, ch, 3)
            out[f"{n}_gn2"] = ("gn", ch)
            if bi == 0 and cin != ch:
                out[f"{n}_proj"] = ("conv", ch, cin, 1)
                out[f"{n}_proj_gn"] = ("gn", ch)
            cin = ch
    for i, _ in enumerate(extra_geometry(preset)):
        out[f"extra{i}_1"] = ("conv", EXTRA_CHANNELS[0], cin, 1)
        out[f"extra{i}_2"] = ("conv", EXTRA_CHANNELS[1], EXTRA_CHANNELS[0], 3)
        cin = EXTRA_CHANNELS[1]
    maps = [STAGES[s][1] for s in TAPPED_STAGES] + [EXTRA_CHANNELS[1]] * (
        len(preset["maps"]) - len(TAPPED_STAGES))
    for i, (m, c) in enumerate(zip(preset["maps"], maps)):
        out[f"classifier{i}"] = ("conv", num_shapes(m) * (num_classes + 5), c, 3)
    return out


def group_norm(x, scale, bias, groups: int = GN_GROUPS, eps: float = GN_EPS):
    """GroupNorm of NCHW ``x``: ``groups`` groups where they divide the
    channels, else one; ``(x - mean) * rsqrt(var + eps)`` over each group,
    then the per-channel ``scale`` and ``bias``."""
    b, c, h, w = x.shape
    g = groups if c % groups == 0 else 1
    xg = x.reshape(b, g, c // g, h, w)
    d = xg - xg.mean(dim=(2, 3, 4), keepdim=True)
    var = (d * d).mean(dim=(2, 3, 4), keepdim=True)
    y = (d * torch.rsqrt(var + eps)).reshape(b, c, h, w)
    return y * scale.view(1, -1, 1, 1) + bias.view(1, -1, 1, 1)


def walk(images, cfg, conv_fn, norm_fn):
    """Raw ``(B, H, W, 3)`` BGR images -> the multibox source maps (NCHW):
    ``conv_fn(name, x, stride, padding)`` is a conv + bias, ``norm_fn(name,
    x)`` a GroupNorm."""
    relu = torch.relu
    mean = torch.tensor(cfg["model"]["mean_bgr"], dtype=torch.float32, device=images.device)
    x = (images.float() - mean).permute(0, 3, 1, 2)
    x = relu(norm_fn("stem_gn", conv_fn("stem_conv", x, 2, "SAME")))
    x = max_pool(x, 3, 2)
    maps, cin = [], STEM_CHANNELS
    for si, (blocks, ch, stride) in enumerate(STAGES):
        for bi in range(blocks):
            n, s = f"s{si}b{bi}", stride if bi == 0 else 1
            y = relu(norm_fn(f"{n}_gn1", conv_fn(f"{n}_conv1", x, s, "SAME")))
            y = norm_fn(f"{n}_gn2", conv_fn(f"{n}_conv2", y, 1, "SAME"))
            if bi == 0 and cin != ch:
                skip = norm_fn(f"{n}_proj_gn", conv_fn(f"{n}_proj", x, s, "SAME"))
            else:
                skip = x[:, :, ::s, ::s]
            x, cin = relu(y + skip), ch
        if si in TAPPED_STAGES:
            maps.append(x)
    for i, (s, p) in enumerate(extra_geometry(cfg["preset"])):
        x = relu(conv_fn(f"extra{i}_1", x, 1, "SAME"))
        x = relu(conv_fn(f"extra{i}_2", x, s, p))
        maps.append(x)
    return maps


def _forward(images, cfg, conv_fn, norm_fn):
    preset, k = cfg["preset"], cfg["model"]["num_classes"]
    maps = walk(images, cfg, conv_fn, norm_fn)
    heads = [conv_fn(f"classifier{i}", fm, 1, "SAME") for i, fm in enumerate(maps)]
    out = heads_to_anchors(heads, preset, k)
    return out[..., : k + 1], out[..., k + 1:]


def conv_records(cfg, batch: int):
    """Every convolution of the forward at ``batch`` (``benchlib/family.py``),
    read off the reference's own walk run on shapes alone (meta tensors)."""
    table = layer_shapes(cfg["preset"], cfg["model"]["num_classes"])
    out = []

    def conv_fn(name, x, stride, padding):
        _, cout, cin, k = table[name]
        y = conv(x, torch.empty((cout, cin, k, k), device="meta"), None, stride, padding, 1)
        out.append(dict(name=name, b=batch, hin=x.shape[2], win=x.shape[3], cin=cin,
                        ho=y.shape[2], wo=y.shape[3], cout=cout, k=k, groups=1,
                        reads_image=name == "stem_conv"))
        return y

    w, h = cfg["preset"]["image_size"]
    _forward(torch.empty((batch, h, w, 3), dtype=torch.uint8, device="meta"), cfg, conv_fn,
             lambda name, x: x)
    return out


def seeded_params(cfg, seed: int, device) -> dict:
    """Float32 parameters made on ``device`` from ``seed`` in one uniform
    draw, in the program's layout (``{conv: {"w": OIHW, "b"}, norm:
    {"scale", "bias"}}``): filters Xavier-uniform over ``(k*k*cin +
    k*k*cout)`` (each multibox head shape counted as its own ``K+5``-wide
    conv), conv biases and GroupNorm biases uniform in ``+-bias_range``,
    GroupNorm scales uniform in ``gn_scale``."""
    k = cfg["model"]["num_classes"]
    spec = cfg["weights"]
    table = layer_shapes(cfg["preset"], k)
    sizes = {n: (t[1] * t[2] * t[3] * t[3] + t[1] if t[0] == "conv" else 2 * t[1])
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
        _, cout, cin, kk = t
        fan_out = (k + 5) if name.startswith("classifier") else cout
        limit = math.sqrt(6.0 / (kk * kk * cin + kk * kk * fan_out))
        nw = cout * cin * kk * kk
        params[name] = {"w": (v[:nw] * limit).view(cout, cin, kk, kk),
                        "b": v[nw:] * spec["bias_range"]}
    return params


def float_forward(params, images, cfg, quant=None):
    """``(logits, locs)`` of float32 parameters in the program's layout;
    ``quant(t)`` rounds each conv's input and filter (the fp8 control)
    where given."""
    q = quant or (lambda t: t)

    def conv_fn(name, x, s, p):
        return conv(q(x), q(params[name]["w"].float()), params[name]["b"].float(), s, p, 1)

    def norm_fn(name, x):
        return group_norm(x, params[name]["scale"].float(), params[name]["bias"].float())

    return _forward(images, cfg, conv_fn, norm_fn)


_CONV_LEAVES = ("a_scale", "b", "w_scale", "wq")
_NORM_LEAVES = ("bias", "scale")


def read_int8_bundle(path, cfg) -> dict:
    """The int8 bundle's arrays as numpy: ``{conv: {"a_scale" (cin,),
    "b", "w_scale" (cout,), "wq" HWIO int8}, norm: {"bias", "scale"}}``.
    Leaves are ``leaf_<i>`` in sorted (layer, key) order, as the bundle
    format states; the bundle's model has to be the configuration's."""
    model = cfg["model"]
    table = layer_shapes(cfg["preset"], model["num_classes"])
    want = {}
    for name, t in table.items():
        if t[0] == "gn":
            want[name] = {"bias": (t[1],), "scale": (t[1],)}
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


def int8_forward(tree, images, cfg, bits: int = 8):
    """The W8A8 model of an int8 bundle in float32 (see the module doc).
    ``bits=4`` is the int4 control: each activation grid widened to 4 bits
    (``n = 7``, the scale times ``127 / 7``) and each filter, folded into
    that grid, requantized per output channel to ``+-7``."""
    dev = images.device
    n = 2 ** (bits - 1) - 1
    staged = {}
    for name, leaf in tree.items():
        if "wq" not in leaf:
            continue
        wq = torch.from_numpy(leaf["wq"]).to(dev).permute(3, 2, 0, 1).double()
        w_scale = torch.from_numpy(leaf["w_scale"]).to(dev).float()
        inv = 1.0 / torch.from_numpy(leaf["a_scale"]).to(dev).float()
        if bits != 8:
            w = wq.float() * w_scale.view(-1, 1, 1, 1) * (127.0 / n)
            w_scale = w.abs().amax(dim=(1, 2, 3)).clamp_min(1e-12) / n
            wq = torch.clamp(torch.round(w / w_scale.view(-1, 1, 1, 1)), -n, n).double()
            inv = inv * (n / 127.0)
        staged[name] = (wq, inv, w_scale, torch.from_numpy(leaf["b"]).to(dev).float())

    def conv_fn(name, x, s, p):
        wq, inv, w_scale, b = staged[name]
        xq = torch.clamp(torch.round(x * inv.view(1, -1, 1, 1)), -n, n).double()
        sums = torch.round(conv(xq, wq, None, s, p, 1)).float()
        return sums * w_scale.view(1, -1, 1, 1) + b.view(1, -1, 1, 1)

    def norm_fn(name, x):
        leaf = tree[name]
        return group_norm(x, torch.from_numpy(leaf["scale"]).to(dev).float(),
                          torch.from_numpy(leaf["bias"]).to(dev).float())

    return _forward(images, cfg, conv_fn, norm_fn)


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
