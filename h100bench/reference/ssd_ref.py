"""Plain float32 reference of SSD with a VGG-16 trunk (Liu et al. 2016,
arXiv:1512.02325): anchors, the forward of float and of int8 W8A8
weights, decode, greedy NMS, target matching, the multibox loss and an
SGD-momentum step. Plain PyTorch on NHWC tensors with TF32 off; it imports
nothing of the program under test.

It is the VGG-16 family's module (``benchlib/family.py`` lists what a
family provides: ``conv_records``, ``seeded_params``, ``read_int8_bundle``,
``serving_forward``, ``anchors``, ``detect``, ``sgd_step`` and
``train_control``), and the other SSD families take its anchors, decode,
NMS and detect.

It follows the configuration files in ``h100bench/configs`` (the preset's
maps, the detection settings), and the program's documented semantics
where the paper leaves a choice open. Departures from the program, each
deliberate:

* Activations stay float32 between layers. The program stores bf16
  activations (and, in the int8 model, bf16 between the requantization
  and the next quantization); the reference is the float32 math of the
  same model, so those roundings are part of what it measures.
* int8 sums are computed in float64 and rounded to the nearest integer:
  exact whatever algorithm the library picks, where the program uses an
  int8 GEMM with int32 accumulation.
* Detections are decoded for every anchor (``all_boxes``) as well as for
  the top-k candidates, so that a served box can be judged by what the
  reference says at any anchor.
* NMS runs per image on the host in float64 on the integer canvas corners
  (the program divides in float32: an IoU within one float32 ulp of the
  threshold may be decided the other way).
* ``quant`` (a function applied to each convolution's input and filter)
  and ``bits`` make the lower-precision controls: the same mathematics
  with operands rounded to fp8 or int4.
"""

from __future__ import annotations

import contextlib
import json
import math

import numpy as np
import torch
import torch.nn.functional as F

CANVAS = 1000
NMS_THRESHOLD = 0.45
MATCH_THRESHOLD = 0.5

#: (name, out channels) of the 13 trunk convolutions; a 2x2/s2 pool follows each block
TRUNK = (("conv1_1", 64), ("conv1_2", 64), ("conv2_1", 128), ("conv2_2", 128),
         ("conv3_1", 256), ("conv3_2", 256), ("conv3_3", 256),
         ("conv4_1", 512), ("conv4_2", 512), ("conv4_3", 512),
         ("conv5_1", 512), ("conv5_2", 512), ("conv5_3", 512))
POOL_AFTER = ("conv1_2", "conv2_2", "conv3_3", "conv4_3")
MAP_CHANNELS = (512, 1024, 512, 256, 256, 256, 256)


@contextlib.contextmanager
def full_float32():
    """TF32 off for matmuls and convolutions inside the block."""
    saved = (torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    try:
        yield
    finally:
        torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32 = saved


def num_shapes(m) -> int:
    return 2 + len(m["aspect_ratios"])


def extra_layers(num_maps: int):
    """``(name, cout, k, stride, padding)`` of the extra feature layers."""
    stride10, pad10 = (2, "SAME") if num_maps >= 7 else (1, "VALID")
    defs = [("conv8_1", 256, 1, 1, "SAME"), ("conv8_2", 512, 3, 2, "SAME"),
            ("conv9_1", 128, 1, 1, "SAME"), ("conv9_2", 256, 3, 2, "SAME"),
            ("conv10_1", 128, 1, 1, "SAME"), ("conv10_2", 256, 3, stride10, pad10),
            ("conv11_1", 128, 1, 1, "SAME"), ("conv11_2", 256, 3, 1, "VALID")][: 2 * (num_maps - 2)]
    if num_maps >= 7:
        defs += [("conv12_1", 128, 1, 1, "SAME"), ("conv12_2", 256, 3, 1, "VALID")]
    return defs


def conv_layers(preset, num_classes: int):
    """Every convolution in forward order: ``(name, k, cin, cout, stride,
    padding, dilation, relu)``; the heads last."""
    out, cin = [], 3
    for name, cout in TRUNK:
        out.append((name, 3, cin, cout, 1, "SAME", 1, True))
        cin = cout
    out.append(("mod_conv6", 3, 512, 1024, 1, "SAME", 6, True))
    out.append(("mod_conv7", 1, 1024, 1024, 1, "SAME", 1, True))
    cin = 1024
    for name, cout, k, s, p in extra_layers(len(preset["maps"])):
        out.append((name, k, cin, cout, s, p, 1, True))
        cin = cout
    for i, m in enumerate(preset["maps"]):
        out.append((f"classifier{i}", 3, MAP_CHANNELS[i], num_shapes(m) * (num_classes + 5),
                    1, "SAME", 1, False))
    return out


def conv_records(cfg, batch: int):
    """Every convolution of the forward at ``batch``: dicts of ``name, b,
    hin, win, cin, ho, wo, cout, k, groups, reads_image``, in forward order
    (heads last)."""
    preset = cfg["preset"]
    h, w = preset["image_size"][1], preset["image_size"][0]
    layers = conv_layers(preset, cfg["model"]["num_classes"])
    sizes = {}
    for name, k, cin, cout, s, p, d, _ in layers:
        if name.startswith("classifier"):
            continue
        if p == "SAME":
            ho, wo = -(-h // s), -(-w // s)
        else:
            ho, wo = (h - (k - 1) * d - 1) // s + 1, (w - (k - 1) * d - 1) // s + 1
        sizes[name] = (h, w, ho, wo)
        h, w = ho, wo
        if name in POOL_AFTER:
            h, w = -(-h // 2), -(-w // 2)
        if name == "conv12_1":
            h, w = h + 1, w + 1
    maps = [m["size"] for m in preset["maps"]]
    out = []
    for name, k, cin, cout, *_ in layers:
        if name.startswith("classifier"):
            i = int(name[len("classifier"):])
            hin, win, ho, wo = maps[i][1], maps[i][0], maps[i][1], maps[i][0]
        else:
            hin, win, ho, wo = sizes[name]
        out.append(dict(name=name, b=batch, hin=hin, win=win, cin=cin, ho=ho, wo=wo,
                        cout=cout, k=k, groups=1, reads_image=name == "conv1_1"))
    return out


def seed_generator(seed: int, device) -> torch.Generator:
    return torch.Generator(device=device).manual_seed(int(seed) % (1 << 63))


def seeded_params(cfg, seed: int, device) -> dict:
    """Float32 parameters made on ``device`` from ``seed`` in one uniform
    draw, in the program's layout: ``{layer: {"w": OIHW, "b"},
    "l2_norm_conv4_3": {"scale"}}``. Filters are Xavier-uniform over
    ``(k*k*cin + k*k*cout)`` as the program's ``init_params`` (each multibox
    head shape counted as its own ``K+5``-wide conv); biases uniform in
    ``+-bias_range``; the conv4_3 L2-norm scale the constant
    ``l2_norm_scale``."""
    k = cfg["model"]["num_classes"]
    spec = cfg["weights"]
    layers = conv_layers(cfg["preset"], k)
    sizes = [cout * cin * kk * kk + cout for _, kk, cin, cout, *_ in layers]
    u = torch.rand(sum(sizes), generator=seed_generator(seed, device), device=device) * 2 - 1
    params, off = {}, 0
    for (name, kk, cin, cout, *_), n in zip(layers, sizes):
        fan_out = (k + 5) if name.startswith("classifier") else cout
        limit = math.sqrt(6.0 / (kk * kk * cin + kk * kk * fan_out))
        nw = cout * cin * kk * kk
        params[name] = {"w": (u[off:off + nw] * limit).view(cout, cin, kk, kk),
                        "b": u[off + nw:off + n] * spec["bias_range"]}
        off += n
    params["l2_norm_conv4_3"] = {"scale": torch.full((512,), float(spec["l2_norm_scale"]),
                                                     device=device)}
    return params


def same_pads(n: int, k: int, s: int, d: int = 1):
    """TF SAME padding ``(before, after)`` along one axis."""
    out = -(-n // s)
    total = max((out - 1) * s + (k - 1) * d + 1 - n, 0)
    return total // 2, total - total // 2


def _pad_hw(x, ph, pw, value=0.0):
    return F.pad(x, (pw[0], pw[1], ph[0], ph[1]), value=value)


def conv(x, w, b, stride, padding, dilation):
    """NCHW float convolution with TF padding, OIHW filter."""
    if padding == "SAME":
        x = _pad_hw(x, same_pads(x.shape[2], w.shape[2], stride, dilation),
                    same_pads(x.shape[3], w.shape[3], stride, dilation))
    return F.conv2d(x, w, b, stride=stride, dilation=dilation)


def max_pool(x, k, s):
    """Max pool with TF SAME (ceil) semantics and -inf padding."""
    return F.max_pool2d(_pad_hw(x, same_pads(x.shape[2], k, s), same_pads(x.shape[3], k, s),
                                float("-inf")), k, s)


def walk(images, preset, conv_fn, l2_scale, mean_bgr, l2_eps=1e-12):
    """Raw ``(B, H, W, 3)`` BGR images -> the multibox source maps (NCHW):
    ``conv_fn(name, x, stride, padding, dilation, relu)`` runs each layer."""
    x = (images.float() - torch.tensor(mean_bgr, dtype=torch.float32, device=images.device))
    x = x.permute(0, 3, 1, 2)
    conv4_3 = None
    for name, _ in TRUNK:
        x = conv_fn(name, x, 1, "SAME", 1, True)
        if name == "conv4_3":
            conv4_3 = x
        if name in POOL_AFTER:
            x = max_pool(x, 2, 2)
    x = max_pool(x, 3, 1)
    x = conv_fn("mod_conv6", x, 1, "SAME", 6, True)
    x = conv_fn("mod_conv7", x, 1, "SAME", 1, True)
    norm = conv4_3 * torch.rsqrt((conv4_3 * conv4_3).sum(dim=1, keepdim=True) + l2_eps)
    maps = [norm * l2_scale.view(1, -1, 1, 1), x]
    for name, _, _, s, p in extra_layers(len(preset["maps"])):
        x = conv_fn(name, x, s, p, 1, True)
        if name == "conv12_1":
            x = F.pad(x, (0, 1, 0, 1))
        elif name.endswith("_2"):
            maps.append(x)
    return maps


def heads_to_anchors(heads, preset, num_classes):
    """Head outputs (NCHW) -> ``(B, A, K+5)`` in the heads-major anchor
    order: map by map, shape by shape, then row-major cells."""
    nv = num_classes + 5
    out = []
    for y, m in zip(heads, preset["maps"]):
        b, _, h, w = y.shape
        y = y.permute(0, 2, 3, 1).reshape(b, h * w, num_shapes(m), nv).transpose(1, 2)
        out.append(y.reshape(b, -1, nv))
    return torch.cat(out, dim=1)


def float_forward(params, images, cfg, quant=None):
    """``(logits (B, A, K+1), locs (B, A, 4))`` of float32 parameters
    ``{layer: {"w": OIHW, "b"}}``; ``quant(t)`` rounds each conv's input
    and filter (a lower-precision control) where given."""
    q = quant or (lambda t: t)

    def conv_fn(name, x, s, p, d, relu):
        y = conv(q(x), q(params[name]["w"].float()), params[name]["b"].float(), s, p, d)
        return torch.relu(y) if relu else y

    return _forward(images, cfg, conv_fn, params["l2_norm_conv4_3"]["scale"].float())


def _forward(images, cfg, conv_fn, l2_scale):
    preset, k = cfg["preset"], cfg["model"]["num_classes"]
    maps = walk(images, preset, conv_fn, l2_scale, cfg["model"]["mean_bgr"],
                cfg["model"].get("l2_norm_eps", 1e-12))
    heads = [conv_fn(f"classifier{i}", fm, 1, "SAME", 1, False) for i, fm in enumerate(maps)]
    out = heads_to_anchors(heads, preset, k)
    return out[..., : k + 1], out[..., k + 1:]


def read_int8_bundle(path, cfg):
    """The int8 bundle's arrays: ``({layer: {"wq": HWIO int8, "w_scale",
    "b"}, "l2_norm_conv4_3": {"scale"}}, act_scales)`` as numpy. Leaves are
    ``leaf_<i>`` in sorted (layer, key) order, as the bundle format states."""
    names = {n: ("b", "w_scale", "wq") for n, *_ in conv_layers(cfg["preset"],
                                                               cfg["model"]["num_classes"])}
    names["l2_norm_conv4_3"] = ("scale",)
    order = [(n, k) for n in sorted(names) for k in sorted(names[n])]
    with np.load(path) as data:
        meta = json.loads(bytes(data["__meta__"]))
        tree = {n: {} for n in names}
        for i, (n, k) in enumerate(order):
            tree[n][k] = data[f"leaf_{i}"]
    return tree, {k: float(v) for k, v in meta["act_scales"].items()}


def int8_forward(tree, act_scales, images, cfg, bits: int = 8):
    """The W8A8 model of an int8 bundle in float32: ``x_q = clip(round(x /
    s), -n, n)`` with the layer's activation scale ``s``, the exact integer
    sums, ``sums * (s * w_scale) + b``, ReLU. ``bits=4`` is the int4
    control: the same scales widened to a 4-bit grid (``n = 7``), the
    filter requantized per output channel from ``wq * w_scale``."""
    dev = images.device
    n = 2 ** (bits - 1) - 1
    staged = {}
    for name, leaf in tree.items():
        if "wq" not in leaf:
            continue
        wq = torch.from_numpy(leaf["wq"]).to(dev).permute(3, 2, 0, 1).double()
        w_scale = torch.from_numpy(leaf["w_scale"]).to(dev).float()
        a_scale = act_scales[name]
        if bits != 8:
            w = wq.float() * w_scale.view(-1, 1, 1, 1)
            w_scale = w.abs().amax(dim=(1, 2, 3)).clamp_min(1e-12) / n
            wq = torch.clamp(torch.round(w / w_scale.view(-1, 1, 1, 1)), -n, n).double()
            a_scale = a_scale * 127.0 / n
        staged[name] = (wq, float(np.float32(1.0 / a_scale)),
                        torch.tensor(a_scale, dtype=torch.float32, device=dev) * w_scale,
                        torch.from_numpy(leaf["b"]).to(dev).float())

    def conv_fn(name, x, s, p, d, relu):
        wq, inv, mult, b = staged[name]
        xq = torch.clamp(torch.round(x * inv), -n, n).double()
        sums = torch.round(conv(xq, wq, None, s, p, d)).float()
        y = sums * mult.view(1, -1, 1, 1) + b.view(1, -1, 1, 1)
        return torch.relu(y) if relu else y

    scale = torch.from_numpy(tree["l2_norm_conv4_3"]["scale"]).to(dev).float()
    return _forward(images, cfg, conv_fn, scale)


def fp8_quant(t):
    """Per-tensor scaled e4m3 rounding (round to nearest, amax -> 448)."""
    return _fp8(t, torch.float8_e4m3fn, 448.0)


def _fp8(t, dtype, top):
    amax = t.detach().abs().amax().clamp_min(1e-30)
    scale = top / amax
    return (t * scale).to(dtype).float() / scale


class _Fp8Train(torch.autograd.Function):
    """Forward: e4m3 rounding (per tensor, amax -> 448); backward: the
    incoming gradient rounded to e5m2 (amax -> 57344), as fp8 training
    recipes do."""

    @staticmethod
    def forward(ctx, t):
        return _fp8(t, torch.float8_e4m3fn, 448.0)

    @staticmethod
    def backward(ctx, g):
        return _fp8(g, torch.float8_e5m2, 57344.0)


def fp8_quant_train(t):
    """:func:`fp8_quant` of a conv operand for the training control; its
    gradient is rounded to fp8 too, so the backward runs a precision below
    bf16 as well."""
    return _Fp8Train.apply(t)


def serving_forward(cfg, given, control: bool = False):
    """uint8 images -> ``(logits, locs)`` of the configuration's serving
    model with TF32 off: the int8 bundle at the path ``given`` (``control``:
    int4), or the float parameters ``given`` (``control``: fp8 operands)."""
    if cfg["precision"] == "int8":
        tree, scales = read_int8_bundle(given, cfg)
        bits = 4 if control else 8

        def fwd(images):
            return int8_forward(tree, scales, images, cfg, bits)
    else:
        quant = fp8_quant if control else None

        def fwd(images):
            return float_forward(given, images, cfg, quant)

    def run(images):
        with full_float32():
            return fwd(images)

    return run


# ---- anchors, decode, NMS -------------------------------------------------

def anchors(preset):
    """``(A, 4)`` float32 center-form anchors in the heads-major order."""
    maps = preset["maps"]
    parts = []
    for i, m in enumerate(maps):
        s = m["scale"]
        nxt = maps[i + 1]["scale"] if i + 1 < len(maps) else preset["extra_scale"]
        sizes = [(s * math.sqrt(ar), s / math.sqrt(ar)) for ar in (1.0, *m["aspect_ratios"])]
        sizes.append((math.sqrt(s * nxt),) * 2)
        fk = m["size"][0]
        c = (np.arange(fk, dtype=np.float64) + 0.5) / fk
        cy, cx = np.meshgrid(c, c, indexing="ij")
        for w, h in sizes:
            parts.append(np.stack([cx.ravel(), cy.ravel(), np.full(fk * fk, w),
                                   np.full(fk * fk, h)], axis=-1))
    return torch.from_numpy(np.concatenate(parts).astype(np.float32))


def canvas_corners(boxes):
    """Center-form boxes -> integer canvas corners ``(xmin, xmax, ymin, ymax)``
    (truncation toward zero)."""
    cx, cy, w, h = (boxes[..., i] * CANVAS for i in range(4))
    return torch.trunc(torch.stack([cx - w * 0.5, cx + w * 0.5, cy - h * 0.5, cy + h * 0.5], -1))


def decode(locs, anc):
    """Offsets (variances 0.1 / 0.2, clamped at 100) -> clamped center-form boxes."""
    t = torch.clamp_max(locs.float(), 100.0)
    cx = t[..., 0] / 10.0 * anc[..., 2] + anc[..., 0]
    cy = t[..., 1] / 10.0 * anc[..., 3] + anc[..., 1]
    w = torch.exp(t[..., 2].double() / 5.0).float() * anc[..., 2]
    h = torch.exp(t[..., 3].double() / 5.0).float() * anc[..., 3]
    c = canvas_corners(torch.stack([cx, cy, w, h], -1))
    xmax = torch.clamp_max(c[..., 1], CANVAS - 1.0)
    ymax = torch.clamp_max(c[..., 3], CANVAS - 1.0)
    xmin = torch.minimum(torch.clamp_min(c[..., 0], 0.0), xmax)
    ymin = torch.minimum(torch.clamp_min(c[..., 2], 0.0), ymax)
    return torch.stack([(xmin + xmax) * 0.5, (ymin + ymax) * 0.5, xmax - xmin, ymax - ymin],
                       -1) / CANVAS


def iou_canvas(a, b):
    """+1-pixel IoU of integer canvas corners ``a (N, 4)`` vs ``b (M, 4)``."""
    iw = np.maximum(0.0, np.minimum(a[:, None, 1], b[None, :, 1])
                    - np.maximum(a[:, None, 0], b[None, :, 0]) + 1)
    ih = np.maximum(0.0, np.minimum(a[:, None, 3], b[None, :, 3])
                    - np.maximum(a[:, None, 2], b[None, :, 2]) + 1)
    area_a = (a[:, 1] - a[:, 0] + 1) * (a[:, 3] - a[:, 2] + 1)
    area_b = (b[:, 1] - b[:, 0] + 1) * (b[:, 3] - b[:, 2] + 1)
    inter = iw * ih
    return inter / (area_a[:, None] + area_b[None, :] - inter)


def detect(logits, locs, anc, det):
    """Per image: probabilities, every anchor's box, and the detections
    (top-k by the largest foreground probability, threshold, class-aware
    greedy NMS), as ``{"probs" (A, K+1), "all_boxes" (A, 4), "boxes",
    "scores", "classes", "anchors", "cutoff"}`` (detections in descending
    score order; ``cutoff`` the ``top_k``-th candidate's score or the
    threshold, the larger)."""
    probs = torch.softmax(logits.float(), dim=-1)
    boxes = decode(locs, anc)
    out = []
    for i in range(probs.shape[0]):
        fg = probs[i, :, :-1]
        conf, cls = fg.max(dim=-1)
        k = min(det["top_k"], conf.shape[0])
        ranked = torch.sort(conf, descending=True, stable=True)
        order = ranked.indices[:k]
        cutoff = max(float(ranked.values[k - 1]), det["confidence_threshold"])
        keep_c = conf[order] >= det["confidence_threshold"]
        order = order[keep_c]
        cand = boxes[i, order].double().cpu().numpy()
        c = canvas_corners(torch.from_numpy(cand)).numpy()
        ci = cls[order].cpu().numpy()
        iou = iou_canvas(c, c)
        alive = np.ones(len(order), bool)
        kept = []
        for j in range(len(order)):
            if not alive[j]:
                continue
            kept.append(j)
            alive &= ~((iou[j] > det.get("nms_threshold", NMS_THRESHOLD)) & (ci == ci[j]))
        kept = np.asarray(kept[: det.get("max_detections", 200)], np.int64)
        sel = order[torch.from_numpy(kept).to(order.device)]
        out.append({"probs": probs[i], "all_boxes": boxes[i], "boxes": boxes[i, sel],
                    "scores": conf[sel], "classes": cls[sel], "anchors": sel, "cutoff": cutoff})
    return out


# ---- training -------------------------------------------------------------

def match_targets(gt_boxes, gt_labels, gt_mask, anc, num_classes):
    """``(B, A, K+5)`` targets: each anchor takes the gt of greatest IoU
    above 0.5 (the first on ties); each gt whose best IoU is above 0.5
    then claims its best anchor (the first on ties; the highest IoU wins
    among claimants); one-hot classes (background last) and the encoded
    offsets of the positives."""
    gt_boxes = gt_boxes.float()
    gc, ac = canvas_corners(gt_boxes), canvas_corners(anc)
    iw = torch.clamp_min(torch.minimum(gc[..., :, None, 1], ac[None, None, :, 1])
                         - torch.maximum(gc[..., :, None, 0], ac[None, None, :, 0]) + 1, 0)
    ih = torch.clamp_min(torch.minimum(gc[..., :, None, 3], ac[None, None, :, 3])
                         - torch.maximum(gc[..., :, None, 2], ac[None, None, :, 2]) + 1, 0)
    area_g = (gc[..., 1] - gc[..., 0] + 1) * (gc[..., 3] - gc[..., 2] + 1)
    area_a = (ac[:, 1] - ac[:, 0] + 1) * (ac[:, 3] - ac[:, 2] + 1)
    inter = iw * ih
    iou = inter / (area_g[..., :, None] + area_a[None, None, :] - inter)
    iou = torch.where(gt_mask[..., :, None], iou, torch.full_like(iou, -1.0))
    gt_of = iou.argmax(dim=1)
    pos = iou.amax(dim=1) > MATCH_THRESHOLD
    best_anchor = iou.argmax(dim=2)
    claims = (iou.amax(dim=2) > MATCH_THRESHOLD) & gt_mask
    claim = (best_anchor[..., None] == torch.arange(anc.shape[0], device=anc.device)) \
        & claims[..., None]
    claimed = torch.where(claim, iou, torch.full_like(iou, -1.0))
    forced = claimed.amax(dim=1) > 0
    gt_of = torch.where(forced, claimed.argmax(dim=1), gt_of)
    pos = pos | forced
    labels = torch.gather(gt_labels.long(), 1, gt_of)
    cls = torch.where(pos, labels, torch.full_like(labels, num_classes))
    onehot = F.one_hot(cls, num_classes + 1).float()
    m = torch.gather(gt_boxes, 1, gt_of[..., None].expand(-1, -1, 4))
    m = torch.where(pos[..., None], m, anc.expand_as(m))
    a = anc.expand_as(m)
    loc = torch.stack([(m[..., 0] - a[..., 0]) / a[..., 2] * 10.0,
                       (m[..., 1] - a[..., 1]) / a[..., 3] * 10.0,
                       torch.log((m[..., 2] / a[..., 2]).double()).float() * 5.0,
                       torch.log((m[..., 3] / a[..., 3]).double()).float() * 5.0], -1)
    loc = torch.where(pos[..., None], loc, torch.zeros_like(loc))
    return torch.cat([onehot, loc], dim=-1)


def multibox_loss(logits, locs, targets, params, num_classes, weight_decay):
    """Total loss: softmax cross-entropy of the positives and of the
    ``min(negatives, 3 * positives)`` hardest negatives, plus smooth-L1 of
    the positives' offsets, each over the positives and zero for an image
    without any, batch mean; plus ``weight_decay * 0.5 * sum(w^2)`` over
    the filters."""
    gt_cl, gt_loc = targets[..., : num_classes + 1], targets[..., num_classes + 1:]
    posm = gt_cl[..., -1] == 0
    n_pos = posm.sum(dim=1)
    n_neg = gt_cl.shape[1] - n_pos
    denom = torch.where(n_pos > 0, n_pos.float(), torch.ones_like(n_pos, dtype=torch.float32))
    ce = -(gt_cl * torch.log_softmax(logits, dim=-1)).sum(-1)
    zero = ce.new_zeros(())
    neg = torch.sort(torch.where(posm, zero, ce), dim=1, descending=True, stable=True).values
    n_hard = torch.minimum(n_neg, 3 * n_pos)
    take = torch.arange(ce.shape[1], device=ce.device)[None] < n_hard[:, None]
    conf = (torch.where(posm, ce, zero).sum(1) + torch.where(take, neg, zero).sum(1)) / denom
    d = (locs - gt_loc).abs()
    sl1 = torch.where(d < 1.0, 0.5 * d * d, d - 0.5).sum(-1)
    loc = torch.where(posm, sl1, zero).sum(1) / denom
    has = n_pos > 0
    l2 = sum(0.5 * (leaf["w"] * leaf["w"]).sum() for leaf in params.values() if "w" in leaf)
    return (torch.where(has, conf, zero).mean() + torch.where(has, loc, zero).mean()
            + weight_decay * l2)


def sgd_step(params, trace, batch, anc, cfg, quant=None):
    """One SGD-momentum step of the float32 model: ``(loss, grads, params,
    trace)``; ``trace = g + momentum * trace``, ``p - lr * trace``."""
    tr = cfg["train"]
    k = cfg["model"]["num_classes"]
    leaves = {n: {key: v.detach().clone().requires_grad_(True) for key, v in leaf.items()}
              for n, leaf in params.items()}
    with full_float32():
        targets = match_targets(batch["gt_boxes"], batch["gt_labels"], batch["gt_mask"].bool(),
                                anc, k)
        logits, locs = float_forward(leaves, batch["images"], cfg, quant)
        loss = multibox_loss(logits, locs, targets, leaves, k, tr["weight_decay"])
        flat = [v for leaf in leaves.values() for v in leaf.values()]
        grads = torch.autograd.grad(loss, flat)
    it = iter(grads)
    grads = {n: {key: next(it) for key in leaf} for n, leaf in leaves.items()}
    lr, mom = tr["lr"], tr["momentum"]
    new_trace = {n: {key: g + mom * trace[n][key] for key, g in leaf.items()}
                 for n, leaf in grads.items()}
    new = {n: {key: params[n][key] - lr * new_trace[n][key] for key in leaf}
           for n, leaf in params.items()}
    return loss.detach(), grads, new, new_trace


#: the training control's ``quant``: fp8 operands and gradients, a precision below bf16
train_control = fp8_quant_train
