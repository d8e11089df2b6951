"""Plain float32 reference of RetinaNet (Lin et al. 2017, arXiv:1708.02002)
with a ResNeXt-50 32x4d trunk (Xie et al. 2017, arXiv:1611.05431) and an
FPN (Lin et al. 2017, arXiv:1612.03144): MLPerf Inference's detector, as
torchvision's ``retinanet_resnet50_fpn`` (the v1 head) with the ResNeXt
trunk put in. Plain PyTorch on NCHW tensors with TF32 off; it imports
nothing of the program under test. It is a family module
(``benchlib/family.py``).

The model, as the papers and torchvision's definitions give it:

* the images' ImageNet normalization ``(x - mean) / std`` per BGR channel
  (the configuration's ``mean_bgr`` and ``std_bgr``);
* the ResNeXt-50 32x4d trunk: a 7x7/2 conv to 64, ReLU, a 3x3/2 max-pool
  (padding 1); stages of 3 / 4 / 6 / 3 bottlenecks of widths 128 / 256 /
  512 / 1024 in 32 groups and outputs 256 / 512 / 1024 / 2048: 1x1, ReLU,
  grouped 3x3 (the stride), ReLU, 1x1, plus the skip (a strided 1x1
  projection in each stage's first block), ReLU. Padding ``k // 2``
  everywhere. BatchNorm is frozen in the deployed model, an affine map
  per channel, so it is folded into each conv's filter and bias and the
  seeded weights are drawn in that folded form;
* the FPN on C3-C5: 1x1 laterals to 256, the top-down sums with nearest
  upsampling, 3x3 outputs; P6 a 3x3/2 conv and P7 a 3x3/2 conv of
  ReLU(P6);
* two subnets shared over P3-P7, each four 3x3 convs of 256 and ReLU, then
  a 3x3 conv to ``9 K`` class logits or ``9 * 4`` box offsets; sigmoid
  scores, no background class;
* anchors by torchvision's ``AnchorGenerator``: sizes ``(x, int(x 2^(1/3)),
  int(x 2^(2/3)))`` for x = 32 .. 512 (the configuration's
  ``anchor_sizes``), ratios 0.5 / 1 / 2, base anchors rounded, shifted by
  ``image // grid`` pixels a cell;
* the decode of torchvision's ``RetinaNet.postprocess_detections``: per
  level the scores above the threshold, the ``top_k`` largest, their
  anchors' offsets decoded by the R-CNN box coder (weights 1, width and
  height offsets clamped at ``log(1000 / 16)``) and clipped to the image;
  the levels merged; class-wise NMS; the ``max_detections`` best.

Departures, each deliberate:

* P6 is taken from P5 (torchvision's ``LastLevelP6P7(256, 256)``, which
  MLPerf's reference model uses); the paper takes it from C5.
* The canvas convention of the repository's checks: boxes are proportional
  center form on the 1000-pixel canvas, their corners truncated and
  clamped to ``[0, 999]``, and NMS suppresses by the +1-pixel IoU of those
  corners, in float64 (torchvision: the continuous IoU of pixel boxes).
* Activations stay float32 between layers (the program stores bf16).
* ``quant`` makes the lower-precision control: each conv's input and
  filter rounded to fp8 (e4m3, per tensor).
"""

from __future__ import annotations

import math

import numpy as np
import torch
import torch.nn.functional as F

from reference.ssd_ref import (  # noqa: F401  (the canvas convention, TF32 off, fp8, seeds)
    CANVAS,
    canvas_corners,
    fp8_quant,
    full_float32,
    seed_generator,
)

#: (blocks, width, output channels, stride of the first block) of each stage
STAGES = ((3, 128, 256, 1), (4, 256, 512, 2), (6, 512, 1024, 2), (3, 1024, 2048, 2))
CARDINALITY = 32
STEM_CHANNELS = 64
FPN_CHANNELS = 256
HEAD_CONVS = 4
#: torchvision's ``BoxCoder.bbox_xform_clip``
SIZE_CLAMP = math.log(1000.0 / 16)
#: the last ``1 / CAP_SLACK`` of the capped detections may fall out of a
#: program's by rounding alone: NMS decisions near the threshold flip, so
#: a program keeps other numbers of survivors (of ~1,500-2,100 an image at
#: retina800, on an H100: a bf16 program -58 to +73, a float32 one -6 to
#: +16), and those ahead of a detection push it past the cap (14-18 ranks
#: in the worst images read). Without the slack a float32 program read
#: ``missed_residual`` up to 0.049, a bf16 one 0.060; with it 0.0002 and
#: 0.015. The program's row count, which this leaves unjudged past rank
#: 240, is held by the program's own checks
CAP_SLACK = 5


def anchors_per_cell(preset) -> int:
    m = preset["maps"][0]
    return len(m["anchor_sizes"]) * len(m["aspect_ratios"])


def layer_table(cfg) -> dict:
    """``{layer: (cout, cin, k, groups, gain)}`` in forward order, under the
    program's layer names; ``gain`` the seeded filter's (see
    :func:`seeded_params`)."""
    spec = cfg["weights"]
    relu, k = math.sqrt(2.0), cfg["model"]["num_classes"]
    out = {"stem_conv": (STEM_CHANNELS, 3, 7, 1, relu)}
    cin, taps = STEM_CHANNELS, []
    for si, (blocks, width, cout, _) in enumerate(STAGES):
        for bi in range(blocks):
            n = f"s{si}b{bi}"
            out[f"{n}_conv1"] = (width, cin, 1, 1, relu)
            out[f"{n}_conv2"] = (width, width, 3, CARDINALITY, relu)
            out[f"{n}_conv3"] = (cout, width, 1, 1, spec["residual_gain"])
            if bi == 0:
                out[f"{n}_proj"] = (cout, cin, 1, 1, 1.0)
            cin = cout
        if si >= 1:
            taps.append(cout)
    levels = ("fpn_output3", "fpn_output4", "fpn_output5", "fpn_p6", "fpn_p7")
    gains = dict(zip(levels, spec["level_gains"]))
    for lvl, c in zip((3, 4, 5), taps):
        out[f"fpn_lateral{lvl}"] = (FPN_CHANNELS, c, 1, 1, 1.0)
        out[f"fpn_output{lvl}"] = (FPN_CHANNELS, FPN_CHANNELS, 3, 1, gains[f"fpn_output{lvl}"])
    out["fpn_p6"] = (FPN_CHANNELS, FPN_CHANNELS, 3, 1, gains["fpn_p6"])
    out["fpn_p7"] = (FPN_CHANNELS, FPN_CHANNELS, 3, 1, gains["fpn_p7"])
    a = anchors_per_cell(cfg["preset"])
    for sub, final, cout, gain in (("cls", "cls_logits", a * k, spec["class_gain"]),
                                   ("box", "box_deltas", a * 4, spec["box_gain"])):
        for i in range(HEAD_CONVS):
            out[f"{sub}_conv{i}"] = (FPN_CHANNELS, FPN_CHANNELS, 3, 1, relu)
        out[final] = (cout, FPN_CHANNELS, 3, 1, gain)
    return out


def _conv(x, w, b, stride, groups):
    return F.conv2d(x, w, b, stride=stride, padding=w.shape[-1] // 2, groups=groups)


def _forward(images, cfg, conv_fn):
    """Raw ``(B, H, W, 3)`` BGR images -> ``(logits (B, A, K), locs (B, A,
    4))``, levels in order, within a level cells row-major then the cell's
    anchors; ``conv_fn(name, x, stride)`` is a conv + bias."""
    model = cfg["model"]
    mean = torch.tensor(model["mean_bgr"], dtype=torch.float32, device=images.device)
    std = torch.tensor(model["std_bgr"], dtype=torch.float32, device=images.device)
    x = ((images.float() - mean) / std).permute(0, 3, 1, 2)
    x = F.max_pool2d(torch.relu(conv_fn("stem_conv", x, 2)), 3, 2, padding=1)
    taps = []
    for si, (blocks, _, _, stride) in enumerate(STAGES):
        for bi in range(blocks):
            n, s = f"s{si}b{bi}", stride if bi == 0 else 1
            y = torch.relu(conv_fn(f"{n}_conv1", x, 1))
            y = torch.relu(conv_fn(f"{n}_conv2", y, s))
            skip = conv_fn(f"{n}_proj", x, s) if bi == 0 else x
            x = torch.relu(conv_fn(f"{n}_conv3", y, 1) + skip)
        if si >= 1:
            taps.append(x)
    last = conv_fn("fpn_lateral5", taps[2], 1)
    levels = [conv_fn("fpn_output5", last, 1)]
    for lvl, c in ((4, taps[1]), (3, taps[0])):
        last = conv_fn(f"fpn_lateral{lvl}", c, 1) + F.interpolate(last, size=c.shape[-2:],
                                                                   mode="nearest")
        levels.insert(0, conv_fn(f"fpn_output{lvl}", last, 1))
    p6 = conv_fn("fpn_p6", levels[-1], 2)
    levels += [p6, conv_fn("fpn_p7", torch.relu(p6), 2)]
    k = model["num_classes"]
    logits, locs = [], []
    for p in levels:
        c, r = p, p
        for i in range(HEAD_CONVS):
            c = torch.relu(conv_fn(f"cls_conv{i}", c, 1))
            r = torch.relu(conv_fn(f"box_conv{i}", r, 1))
        c, r = conv_fn("cls_logits", c, 1), conv_fn("box_deltas", r, 1)
        b, _, h, w = c.shape
        logits.append(c.permute(0, 2, 3, 1).reshape(b, h * w * (c.shape[1] // k), k))
        locs.append(r.permute(0, 2, 3, 1).reshape(b, -1, 4))
    return torch.cat(logits, 1), torch.cat(locs, 1)


def conv_records(cfg, batch: int):
    """Every convolution of the forward at ``batch`` (``benchlib/family.py``),
    read off the reference's own walk on shapes alone (meta tensors); the
    shared heads count once a level."""
    table = layer_table(cfg)
    out = []

    def conv_fn(name, x, stride):
        cout, cin, k, groups, _ = table[name]
        y = _conv(x, torch.empty((cout, cin // groups, k, k), device="meta"), None, stride,
                  groups)
        out.append(dict(name=name, b=batch, hin=x.shape[2], win=x.shape[3], cin=cin,
                        ho=y.shape[2], wo=y.shape[3], cout=cout, k=k, groups=groups,
                        reads_image=name == "stem_conv"))
        return y

    w, h = cfg["preset"]["image_size"]
    _forward(torch.empty((batch, h, w, 3), dtype=torch.uint8, device="meta"), cfg, conv_fn)
    return out


def seeded_params(cfg, seed: int, device) -> dict:
    """Float32 parameters made on ``device`` from ``seed`` in one uniform
    draw, in the program's layout (``{conv: {"w": OIHW, "b"}}``, a grouped
    filter of ``cin / 32`` inputs), BatchNorm folded in: each filter
    uniform in ``+-gain * sqrt(3 / fan_in)`` (``fan_in = k * k * cin /
    groups``), so that a conv multiplies its input's second moment by
    ``gain^2``: He's ``sqrt(2)`` before a ReLU, 1 for a projection and a
    lateral, the configuration's ``residual_gain`` for a bottleneck's last
    conv (a zero-initialized BatchNorm scale leaves a block the identity;
    ``residual_gain`` keeps the sum of 16 blocks from growing without
    bound), its ``level_gains`` for the convs that make P3-P7 (the output
    convs, P6 and P7: they even out the levels' scales, which the top-down
    sums and the strided convs part, as training does for heads shared over
    the levels), ``class_gain`` and ``box_gain`` for the subnets' last
    convs. Biases uniform in ``+-bias_range``, but the class bias: the
    paper's prior ``-log((1 - prior) / prior)``. The class conv's filters
    are centred, each output's mean taken out: the subnet's features are
    ReLU outputs with a mean of their own, which a filter of random sum
    would turn into a per-image offset of its class, one class then taking
    most anchors of an image (as no trained model does on a busy photo)."""
    spec = cfg["weights"]
    table = layer_table(cfg)
    sizes = {n: cout * (cin // g) * k * k + cout for n, (cout, cin, k, g, _) in table.items()}
    u = torch.rand(sum(sizes.values()), generator=seed_generator(seed, device),
                   device=device) * 2 - 1
    params, off = {}, 0
    for name, (cout, cin, k, groups, gain) in table.items():
        v = u[off:off + sizes[name]]
        off += sizes[name]
        nw = cout * (cin // groups) * k * k
        limit = gain * math.sqrt(3.0 / (k * k * cin / groups))
        params[name] = {"w": (v[:nw] * limit).view(cout, cin // groups, k, k),
                        "b": v[nw:] * spec["bias_range"]}
    cls = params["cls_logits"]
    cls["w"] = cls["w"] - cls["w"].mean(dim=(1, 2, 3), keepdim=True)
    cls["b"] = torch.full_like(cls["b"], -math.log((1 - spec["prior"]) / spec["prior"]))
    return params


def float_forward(params, images, cfg, quant=None):
    """``(logits, locs)`` of float32 parameters in the program's layout;
    ``quant(t)`` rounds each conv's input and filter (the fp8 control)
    where given."""
    q = quant or (lambda t: t)
    table = layer_table(cfg)

    def conv_fn(name, x, stride):
        p = params[name]
        return _conv(q(x), q(p["w"].float()), p["b"].float(), stride, table[name][3])

    return _forward(images, cfg, conv_fn)


def serving_forward(cfg, given, control: bool = False):
    """uint8 images -> ``(logits, locs)`` of the seeded float parameters
    ``given`` with TF32 off (``control``: fp8 operands)."""
    quant = fp8_quant if control else None

    def run(images):
        with full_float32():
            return float_forward(given, images, cfg, quant)

    return run


# ---- anchors, decode, NMS -------------------------------------------------

def anchors(preset):
    """``(A, 5)`` float32 anchors: torchvision's ``AnchorGenerator`` (float32
    arithmetic, base anchors rounded half to even) as ``(x1, y1, x2, y2)``
    in pixels over the image's size, then the anchor's level; levels in
    order, then cells row-major, then the cell's anchors (ratio-major, then
    size)."""
    img_w, img_h = preset["image_size"]
    out = []
    for lvl, m in enumerate(preset["maps"]):
        scales = torch.tensor(m["anchor_sizes"], dtype=torch.float32)
        h_ratios = torch.sqrt(torch.tensor(m["aspect_ratios"], dtype=torch.float32))
        w_ratios = 1 / h_ratios
        ws = (w_ratios[:, None] * scales[None, :]).view(-1)
        hs = (h_ratios[:, None] * scales[None, :]).view(-1)
        base = (torch.stack([-ws, -hs, ws, hs], dim=1) / 2).round()
        gh, gw = m["size"]
        sx = torch.arange(gw, dtype=torch.int32) * (img_w // gw)
        sy = torch.arange(gh, dtype=torch.int32) * (img_h // gh)
        yy, xx = torch.meshgrid(sy, sx, indexing="ij")
        shifts = torch.stack([xx.reshape(-1), yy.reshape(-1)] * 2, dim=1)
        xyxy = (shifts.view(-1, 1, 4) + base.view(1, -1, 4)).reshape(-1, 4).double()
        xyxy = xyxy / torch.tensor([img_w, img_h, img_w, img_h], dtype=torch.float64)
        out.append(torch.cat([xyxy, torch.full((len(xyxy), 1), float(lvl),
                                               dtype=torch.float64)], 1))
    return torch.cat(out).float()


def decode(locs, anc):
    """R-CNN offsets (weights 1, size offsets clamped at ``log(1000 /
    16)``) of the anchors ``anc`` -> boxes clipped to the image, then in
    the canvas convention: proportional center form of the truncated
    canvas corners, clamped to ``[0, 999]``."""
    t = locs.float()
    wa, ha = anc[..., 2] - anc[..., 0], anc[..., 3] - anc[..., 1]
    cxa, cya = anc[..., 0] + 0.5 * wa, anc[..., 1] + 0.5 * ha
    cx, cy = t[..., 0] * wa + cxa, t[..., 1] * ha + cya
    w = torch.exp(torch.clamp_max(t[..., 2], SIZE_CLAMP)) * wa
    h = torch.exp(torch.clamp_max(t[..., 3], SIZE_CLAMP)) * ha
    x1, x2 = (cx - 0.5 * w).clamp(0, 1), (cx + 0.5 * w).clamp(0, 1)
    y1, y2 = (cy - 0.5 * h).clamp(0, 1), (cy + 0.5 * h).clamp(0, 1)
    c = canvas_corners(torch.stack([(x1 + x2) / 2, (y1 + y2) / 2, x2 - x1, y2 - y1], -1))
    xmax = torch.clamp_max(c[..., 1], CANVAS - 1.0)
    ymax = torch.clamp_max(c[..., 3], CANVAS - 1.0)
    xmin = torch.minimum(torch.clamp_min(c[..., 0], 0.0), xmax)
    ymin = torch.minimum(torch.clamp_min(c[..., 2], 0.0), ymax)
    return torch.stack([(xmin + xmax) * 0.5, (ymin + ymax) * 0.5, xmax - xmin, ymax - ymin],
                       -1) / CANVAS


def _greedy(c: np.ndarray, threshold: float) -> list:
    """Greedy NMS of float64 canvas corners sorted by score: the kept
    indices, each suppressing the later ones of +1-pixel IoU above
    ``threshold``."""
    iw = np.maximum(0.0, np.minimum(c[:, None, 1], c[None, :, 1])
                    - np.maximum(c[:, None, 0], c[None, :, 0]) + 1)
    ih = np.maximum(0.0, np.minimum(c[:, None, 3], c[None, :, 3])
                    - np.maximum(c[:, None, 2], c[None, :, 2]) + 1)
    area = (c[:, 1] - c[:, 0] + 1) * (c[:, 3] - c[:, 2] + 1)
    inter = iw * ih
    over = inter / (area[:, None] + area[None, :] - inter) > threshold
    alive, kept = np.ones(len(c), bool), []
    for j in range(len(c)):
        if alive[j]:
            kept.append(j)
            alive &= ~over[j]
    return kept


class PerDetection(torch.Tensor):
    """A per-detection cut (``detect``'s ``cutoff``). ``round`` gives the
    list of rounded values, so a summary that rounds one cut prints them."""

    def __round__(self, ndigits=None):
        return [round(float(v), ndigits) for v in self.reshape(-1)]


def detect(logits, locs, anc, det):
    """Per image: sigmoid probabilities, every anchor's box, and the
    detections (module doc), as ``{"probs" (A, K), "all_boxes" (A, 4),
    "boxes", "scores", "classes", "anchors", "cutoff"}``: detections in
    descending score order, ``anchors`` their anchors' indices, ``cutoff``
    per detection the larger of two cuts that rounding alone may move a
    detection across: its level's ``top_k``-th candidate's score where the
    level had that many above the threshold (else the threshold), and,
    where NMS kept more than ``max_detections`` less a fifth, the score of
    the detection at that rank (:data:`CAP_SLACK`)."""
    k = logits.shape[-1]
    probs = torch.sigmoid(logits.float())
    anc = anc.to(locs.device)
    counts = torch.bincount(anc[:, 4].long()).tolist()
    boxes = decode(locs, anc[:, :4])
    out = []
    for i in range(probs.shape[0]):
        sel_s, sel_a, sel_c, cut, start = [], [], [], [], 0
        for n in counts:
            s = probs[i, start:start + n].reshape(-1)
            idx = torch.nonzero(s > det["confidence_threshold"]).squeeze(1)
            top = torch.topk(s[idx], min(det["top_k"], len(idx)))
            pair = idx[top.indices]
            cutoff = (float(top.values[-1]) if len(pair) == det["top_k"]
                      else det["confidence_threshold"])
            sel_s.append(top.values)
            sel_a.append(start + pair // k)
            sel_c.append(pair % k)
            cut.append(torch.full((len(pair),), cutoff, device=s.device))
            start += n
        scores = torch.cat(sel_s)
        order = torch.sort(scores, descending=True, stable=True).indices
        scores, anchor = scores[order], torch.cat(sel_a)[order]
        cls, cut = torch.cat(sel_c)[order], torch.cat(cut)[order]
        c = canvas_corners(boxes[i, anchor].double()).cpu().numpy()
        cls_np = cls.cpu().numpy()
        kept = []
        for label in np.unique(cls_np):
            members = np.nonzero(cls_np == label)[0]
            kept += [members[j] for j in _greedy(c[members], det["nms_threshold"])]
        kept = np.sort(np.asarray(kept, np.int64))
        cap = det["max_detections"] - det["max_detections"] // CAP_SLACK
        if len(kept) > cap:  # the cap cuts too, as far as rounding moves it
            cut = torch.clamp_min(cut, float(scores[kept[cap - 1]]))
        kept = torch.from_numpy(kept[: det["max_detections"]]).to(scores.device)
        out.append({"probs": probs[i], "all_boxes": boxes[i], "boxes": boxes[i, anchor[kept]],
                    "scores": scores[kept], "classes": cls[kept], "anchors": anchor[kept],
                    "cutoff": cut[kept].as_subclass(PerDetection)})
    return out
