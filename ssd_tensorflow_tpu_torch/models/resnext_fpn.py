"""RetinaNet with a ResNeXt-50 32x4d FPN (Lin et al. 2017, arXiv:1708.02002;
Xie et al. 2017, arXiv:1611.05431; Lin et al. 2017, arXiv:1612.03144), as
torchvision's ``retinanet_resnet50_fpn`` (the v1 head) with the ResNeXt
trunk put in: MLPerf Inference's detector, at 800x800 (``retina800``).

* The trunk: a 7x7/2 conv to 64 channels and ReLU, a 3x3/2 max-pool, then
  four stages of 3 / 4 / 6 / 3 bottlenecks: a 1x1 conv to the stage's
  width (128 / 256 / 512 / 1024) and ReLU, a 3x3 conv of 32 groups (the
  stage's stride in its first block) and ReLU, a 1x1 conv to the output
  (256 / 512 / 1024 / 2048) added to the skip and ReLU; the first block's
  skip is a 1x1 projection of the stride. Frozen BatchNorm is an affine
  map per channel in the deployed model, folded into each conv's filter
  and bias, so no norm runs.
* The FPN: 1x1 laterals to 256 channels on C3-C5 (the outputs of stages
  2-4), the top-down sum with a nearest upsample, a 3x3 output conv per
  level; P6 a 3x3/2 conv of P5 and P7 a 3x3/2 conv of ReLU(P6)
  (torchvision's ``LastLevelP6P7(256, 256)``; the paper takes P6 from C5).
* The heads: two subnets, each four 3x3 convs of 256 channels and ReLU,
  then a 3x3 conv to ``9 * K`` class logits or ``9 * 4`` box offsets, one
  set of weights applied to every level; no background class, sigmoid
  scores, and the class bias starts at ``-log((1 - 0.01) / 0.01)``.

Padding is PyTorch's symmetric ``k // 2`` throughout (the executors' int
padding). Every convolution runs through the route's conv executor
(``models/ssd_vgg.py`` documents the family protocol): the grouped convs
with ``groups=32``, each bottleneck's last conv with its ``skip``. Only the
float executor takes them: ``csrc/int8_conv.cu`` has no grouped route, so
the int8 and fake-quant executors raise at the first grouped conv.

The family runs its own heads (``OWN_HEADS``), so besides the protocol's
trunk functions it gives :func:`param_shapes`, :func:`init_params`,
:func:`apply_model` and :func:`apply_scores`, which ``ssd_vgg``'s
functions of those names hand over to. It serves and does not train: the
inference route alone, and no initialization of its own (its weights are
a bundle's, or the benchmark's reference seeds them in the folded form
its configuration states). Its outputs are per level, in the anchor order of
``ops/anchors.py``'s pyramid rule (cells row-major, then the cell's 9
anchors): the NHWC head output reshaped, no copy. :func:`apply_scores`
gives ``(class logits per level, None, box offsets per level)`` for
``ops/postprocess.decode_scores``'s multi-label path (:data:`DETECTION`).
"""

from __future__ import annotations

import torch

from ssd_tensorflow_tpu_torch.models.layers import (
    float_conv_executor,
    full_float32,
    max_pool,
    preprocess,
    upsample_nearest,
)
from ssd_tensorflow_tpu_torch.ops.postprocess import DetectionConfig
from ssd_tensorflow_tpu_torch.presets import SSDPreset
from ssd_tensorflow_tpu_torch.utils.profiling import counted_span, span

#: (blocks, width, output channels, stride of the first block) of each stage
STAGES = ((3, 128, 256, 1), (4, 256, 512, 2), (6, 512, 1024, 2), (3, 1024, 2048, 2))
CARDINALITY = 32
STEM_CHANNELS = 64
#: the stages whose outputs are C3, C4, C5
TAPPED_STAGES = (1, 2, 3)
FPN_CHANNELS = 256
HEAD_CONVS = 4

#: the family protocol's facts: its own heads and entry points; no int8
#: route; the non-ReLU convs carry their bias in
#: (``layers.conv2d_bias_in``); no stem kernel, no pretrained import
OWN_HEADS = True
PER_LAYER_SCALES = False
RELU_IN_CONV = False
stem = load_pretrained = None

#: the decode of the published model: per level the top 1000 (anchor,
#: class) pairs above 0.05, R-CNN box offsets, class-aware NMS at 0.5, 300
#: detections (torchvision's ``RetinaNet`` defaults)
DETECTION = DetectionConfig(top_k=1000, confidence_threshold=0.05, nms_threshold=0.5,
                            max_detections=300, multi_label=True)


def map_channels(preset: SSDPreset):
    """Channels of each pyramid level (P3-P7)."""
    return (FPN_CHANNELS,) * preset.num_maps


def _conv(k, cin, cout):
    return {"b": (cout,), "w": (k, k, cin, cout)}


def backbone_shapes(preset: SSDPreset) -> dict:
    """``{layer: {leaf: shape}}`` of the trunk and the FPN in forward order,
    filters HWIO (a grouped filter holds ``cin / 32`` input channels)."""
    shapes = {"stem_conv": _conv(7, 3, STEM_CHANNELS)}
    cin, taps = STEM_CHANNELS, []
    for si, (blocks, width, out, _) in enumerate(STAGES):
        for bi in range(blocks):
            n = f"s{si}b{bi}"
            shapes[f"{n}_conv1"] = _conv(1, cin, width)
            shapes[f"{n}_conv2"] = _conv(3, width // CARDINALITY, width)
            shapes[f"{n}_conv3"] = _conv(1, width, out)
            if bi == 0:
                shapes[f"{n}_proj"] = _conv(1, cin, out)
            cin = out
        if si in TAPPED_STAGES:
            taps.append(out)
    for lvl, c in zip((3, 4, 5), taps):
        shapes[f"fpn_lateral{lvl}"] = _conv(1, c, FPN_CHANNELS)
        shapes[f"fpn_output{lvl}"] = _conv(3, FPN_CHANNELS, FPN_CHANNELS)
    shapes["fpn_p6"] = _conv(3, FPN_CHANNELS, FPN_CHANNELS)
    shapes["fpn_p7"] = _conv(3, FPN_CHANNELS, FPN_CHANNELS)
    return shapes


def head_shapes(config) -> dict:
    """The two subnets' layers: ``{cls,box}_conv{0..3}``, ``cls_logits``
    (``9 K`` outputs) and ``box_deltas`` (``9 * 4``), filters HWIO."""
    a = config.preset.maps[0].num_shapes
    shapes = {}
    for sub, final, cout in (("cls", "cls_logits", a * config.num_classes),
                             ("box", "box_deltas", a * 4)):
        for i in range(HEAD_CONVS):
            shapes[f"{sub}_conv{i}"] = _conv(3, FPN_CHANNELS, FPN_CHANNELS)
        shapes[final] = _conv(3, FPN_CHANNELS, cout)
    return shapes


def param_shapes(config) -> dict:
    """Every parameter's shape, trunk, FPN and heads."""
    return {**backbone_shapes(config.preset), **head_shapes(config)}


def init_params(config, seed: int = 0) -> dict:
    """Raises: the family serves given weights (see the module doc)."""
    raise NotImplementedError(f"{config.preset_name}: RetinaNet has no initialization of its "
                              "own; serve a bundle or given folded weights")


def walk_feature_maps(params, x, config, conv):
    """Preprocessed NHWC images -> the pyramid levels P3-P7, every
    convolution through ``conv`` (see the module doc)."""
    # the ReLU after the rounding (exact): cuDNN's fused conv + bias + ReLU
    # runs a generic FFMA kernel on 3 input channels, 40 ms a batch of 64
    # against 16 with the bias carried in (PERF.md)
    x = torch.relu(conv("stem_conv", x, stride=2, padding=3))
    x = max_pool(x, 3, 2, padding=1)
    taps = []
    for si, (blocks, _, _, stride) in enumerate(STAGES):
        for bi in range(blocks):
            n, s = f"s{si}b{bi}", stride if bi == 0 else 1
            y = conv(f"{n}_conv1", x, padding=0, relu=True)
            y = conv(f"{n}_conv2", y, stride=s, padding=1, relu=True, groups=CARDINALITY)
            skip = conv(f"{n}_proj", x, stride=s, padding=0) if bi == 0 else x
            x = conv(f"{n}_conv3", y, padding=0, relu=True, skip=skip)
        if si in TAPPED_STAGES:
            taps.append(x)
    with span("ssd.fpn"):
        return _fpn(taps, conv)


def _fpn(taps, conv):
    """C3-C5 -> P3-P7: laterals, the top-down sums (nearest upsample, the
    sum in the activations' dtype), the output convs, P6 and P7."""
    inner = conv("fpn_lateral5", taps[2], padding=0)
    levels = [conv("fpn_output5", inner, padding=1)]
    for lvl, c in ((4, taps[1]), (3, taps[0])):
        inner = conv(f"fpn_lateral{lvl}", c, padding=0) + upsample_nearest(inner, c.shape[1:3])
        levels.insert(0, conv(f"fpn_output{lvl}", inner, padding=1))
    p6 = conv("fpn_p6", levels[-1], stride=2, padding=1)
    p7 = conv("fpn_p7", torch.relu(p6), stride=2, padding=1)
    return levels + [p6, p7]


@counted_span("ssd.retina.heads")
def retina_head(x, conv, sub: str, final: str):
    """One subnet on one level: four 3x3 convs and ReLU, then ``final``.
    Each call counts once in ``retina_head.calls`` (10 a forward: two
    subnets on five levels) and runs inside span ``ssd.retina.heads``."""
    for i in range(HEAD_CONVS):
        x = conv(f"{sub}_conv{i}", x, padding=1, relu=True)
    return conv(final, x, padding=1)


def walk_heads(params, x, config, conv):
    """The walk, then both subnets on every level: ``[(class logits (B, h,
    w, 9 K), box offsets (B, h, w, 36))]`` NHWC per level. Raises unless
    the walk gave the preset's levels, in number and size."""
    preset = config.preset
    levels = walk_feature_maps(params, x, config, conv)
    sizes = [tuple(m.shape[1:3]) for m in levels]
    want = [(m.size.h, m.size.w) for m in preset.maps]
    if sizes != want:
        raise AssertionError(f"{preset.name}: walked levels {sizes}, the preset has {want}")
    return [(retina_head(m, conv, "cls", "cls_logits"), retina_head(m, conv, "box", "box_deltas"))
            for m in levels]


def _float_heads(params, images, config):
    return walk_heads(params, preprocess(images, config), config, float_conv_executor(params))


def _per_level(heads, config):
    """Per level ``(B, h * w * 9, K)`` logits and ``(B, h * w * 9, 4)``
    offsets: views of the NHWC head outputs in the anchor order."""
    k = config.num_classes
    return (tuple(c.reshape(c.shape[0], -1, k) for c, _ in heads),
            tuple(b.reshape(b.shape[0], -1, 4) for _, b in heads))


def apply_model(params, images, config, *, inference: bool = True, shards=None):
    """``(logits (B, A, K), locs (B, A, 4))`` float32 of ``(B, H, W, 3)`` raw
    BGR images, every level's in the anchor order, concatenated; the
    inference route alone (``inference=False`` raises, as ``shards``)."""
    if not inference or shards is not None:
        raise ValueError("the RetinaNet family serves on one card: no training route, no "
                         "tensor-parallel layers")
    with full_float32(config.dtype):
        logits, locs = _per_level(_float_heads(params, images, config), config)
    return torch.cat(logits, dim=1).float(), torch.cat(locs, dim=1).float()


def apply_scores(params, images, config):
    """The inference forward for the multi-label decode: ``(class logits
    per level, None, box offsets per level)`` in the compute dtype (every
    class of every anchor is scored, so there is no per-anchor class)."""
    with full_float32(config.dtype):
        logits, locs = _per_level(_float_heads(params, images, config), config)
    return logits, None, locs
