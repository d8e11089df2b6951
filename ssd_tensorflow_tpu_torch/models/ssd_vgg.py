"""The SSD detector: configuration, parameters and forward pass.

Three backbone families, chosen by the preset's ``backbone``: VGG-16
(below), ResNet-34 (``models/resnet.py``) and MobileNetV1
(``models/mobilenet.py``); the heads, the anchor order and everything
after them are family-generic.

VGG architecture: VGG-16 trunk -> a-trous conv6/conv7 -> extra layers
conv8..11 (+12 for 7-map presets) -> the L2-normalized conv4_3 plus 5-6
more feature maps -> one wide 3x3 multibox head conv per map, whose
output channels are the per-shape heads concatenated. Outputs follow the
anchor-order contract of ``ops/anchors.py``: heads-major, then row-major
cells.

Parameters are a nested dict ``{layer: {"w": OIHW, "b": (cout,)}}`` plus
``{"l2_norm_conv4_3": {"scale": (512,)}}``; ``weights.params_from_jax``
converts the JAX package's HWIO dict into it.

A bf16 inference forward always runs a stem kernel
(``ops/stem_cuda.py``): the split stem (conv1_1 as a convolution,
conv1_2 + pool1 as a kernel) or, with ``pallas_stem_variant="uint8"``,
the whole stem from the raw uint8 image; a float32 forward runs the conv1
block as plain convolutions. A family forward runs no stem kernel: its
walk takes the float conv executor (``layers.float_conv_executor``), one
rounding per conv + bias on the inference route. The training forward
(``apply_model(..., inference=False)``) runs no kernel without a
derivative: every conv is ``layers.conv2d_train``, conv1 included. A
float32 forward on the card runs its convs in full float32, TF32 off
(``layers.full_float32``).
"""

from __future__ import annotations

import dataclasses
from typing import Optional, Tuple

import numpy as np
import torch
import torch.nn.functional as F

from ssd_tensorflow_tpu_torch.models import vgg16
from ssd_tensorflow_tpu_torch.models.layers import (
    conv2d_bias_in,
    conv2d_train,
    conv_relu,
    conv_relu_train,
    float_conv_executor,
    full_float32,
    init_conv,
    l2_normalize_scale,
    widen_bias,
)
from ssd_tensorflow_tpu_torch.presets import SSDPreset, get_preset_by_name

_DTYPES = {"bfloat16": torch.bfloat16, "float32": torch.float32}
#: the stem kernels a bf16 VGG forward may run (``ModelConfig.pallas_stem_variant``)
STEM_VARIANTS = ("dma", "uint8")
#: the backbone families a preset may name
BACKBONES = ("vgg", "resnet34", "mobilenetv1")


@dataclasses.dataclass(frozen=True)
class ModelConfig:
    """Static model configuration; the fields ``inference.model_config_to_dict``
    serializes, as in the JAX package."""

    preset_name: str = "vgg300"
    #: number of foreground classes K; background is index K.
    num_classes: int = 20
    #: a-trous (dilation 6) conv6.
    a_trous: bool = True
    #: conv compute dtype; parameters stay float32.
    compute_dtype: str = "bfloat16"
    #: BGR channel means subtracted from the raw images.
    mean_bgr: Tuple[float, float, float] = (104.0, 117.0, 123.0)
    #: carried for bundle compatibility only: the JAX package's
    #: width-packed conv1 block is a TPU lane-layout choice with the same
    #: math, and the port always computes the plain conv1 block.
    packed_stem: bool = True
    #: epsilon inside the conv4_3 L2-normalization rsqrt.
    l2_norm_eps: float = 1e-12
    #: which stem kernel a bf16 VGG forward runs (a family runs none):
    #: "dma" = the split stem (conv1_1 as a cuDNN convolution, conv1_2 + pool1 as
    #: ``csrc/stem.cu``); "uint8" = the whole stem in one kernel reading
    #: the raw uint8 image (``csrc/stem_uint8.cu``). An execution-backend
    #: choice, never serialized (``InferenceModel(overrides=...)`` sets
    #: it per run), as in the JAX package. The port has no ``pallas_stem``
    #: switch: its bf16 forward always runs a stem kernel, because on the
    #: card the split stem kernel beats cuDNN's conv1_2 + ReLU + pool
    #: (5.15 ms against 14.21 ms per vgg512 batch of 64 on an H100 80GB
    #: HBM3 at 700 W, PERF.md).
    pallas_stem_variant: str = "dma"

    def __post_init__(self):
        if self.preset.backbone not in BACKBONES:
            raise ValueError(f"preset {self.preset_name!r}: unknown backbone "
                             f"{self.preset.backbone!r}, expected one of {BACKBONES}")
        if self.pallas_stem_variant != "dma" and self.preset.backbone != "vgg":
            raise ValueError(
                f"pallas_stem_variant={self.pallas_stem_variant!r} selects a VGG conv1-block "
                f"kernel; preset {self.preset_name!r} uses backbone {self.preset.backbone!r}"
            )
        if self.compute_dtype not in _DTYPES:
            raise ValueError(f"compute_dtype must be one of {sorted(_DTYPES)}, "
                             f"got {self.compute_dtype!r}")
        if self.pallas_stem_variant not in STEM_VARIANTS:
            raise ValueError(f"pallas_stem_variant must be one of {STEM_VARIANTS}, "
                             f"got {self.pallas_stem_variant!r}")
        if self.pallas_stem_variant != "dma" and self.compute_dtype != "bfloat16":
            raise ValueError(
                f"pallas_stem_variant={self.pallas_stem_variant!r} requires "
                f"compute_dtype='bfloat16' (got {self.compute_dtype!r}); the fused "
                "stem kernel is a bf16 tensor-core kernel (ops/stem_cuda.py)"
            )

    @property
    def preset(self) -> SSDPreset:
        return get_preset_by_name(self.preset_name)

    @property
    def dtype(self) -> torch.dtype:
        return _DTYPES[self.compute_dtype]

    @property
    def num_vars(self) -> int:
        """Per-anchor output width: K+1 classes + 4 offsets."""
        return self.num_classes + 5


def _extra_layer_defs(num_maps: int):
    """Extra feature layers ``(name, out_ch, kernel, stride, padding)``.

    conv10_2 differs between 6- and 7-map presets; presets with fewer
    maps use a truncated prefix of the chain.
    """
    stride10, padding10 = (2, "SAME") if num_maps >= 7 else (1, "VALID")
    defs = [
        ("conv8_1", 256, 1, 1, "SAME"),
        ("conv8_2", 512, 3, 2, "SAME"),
        ("conv9_1", 128, 1, 1, "SAME"),
        ("conv9_2", 256, 3, 2, "SAME"),
        ("conv10_1", 128, 1, 1, "SAME"),
        ("conv10_2", 256, 3, stride10, padding10),
        ("conv11_1", 128, 1, 1, "SAME"),
        ("conv11_2", 256, 3, 1, "VALID"),
    ][: 2 * (num_maps - 2)]
    if num_maps >= 7:
        defs += [
            ("conv12_1", 128, 1, 1, "SAME"),  # + bottom/right zero pad
            ("conv12_2", 256, 3, 1, "VALID"),
        ]
    return defs


#: input channels of each multibox source map (VGG family)
#: [norm_conv4_3, mod_conv7, conv8_2, conv9_2, conv10_2, conv11_2, (conv12_2)]
_MAP_CHANNELS = (512, 1024, 512, 256, 256, 256, 256)


def _backbone_module(preset: SSDPreset):
    """The family module of a non-VGG preset (``models/resnet.py`` or
    ``models/mobilenet.py``), or None for the VGG family. Each exposes
    ``map_channels``, ``backbone_shapes``, ``init_backbone_params`` and
    ``walk_feature_maps``."""
    if preset.backbone == "resnet34":
        from ssd_tensorflow_tpu_torch.models import resnet

        return resnet
    if preset.backbone == "mobilenetv1":
        from ssd_tensorflow_tpu_torch.models import mobilenet

        return mobilenet
    return None


def map_channels(preset: SSDPreset):
    """Head-input channel count per multibox source map, per family."""
    fam = _backbone_module(preset)
    if fam is not None:
        return fam.map_channels(preset)
    return _MAP_CHANNELS[: preset.num_maps]


def param_shapes(config: ModelConfig) -> dict:
    """``{layer: {leaf: shape}}`` of every parameter, convolutions in the
    JAX package's HWIO layout (the bundle's and the conversion's layout)."""
    preset = config.preset
    fam = _backbone_module(preset)
    if fam is not None:
        shapes = fam.backbone_shapes(preset)
    else:
        shapes = {name: {"b": (s[3],), "w": s} for name, s in vgg16.vgg_param_shapes().items()}
        shapes["l2_norm_conv4_3"] = {"scale": (512,)}
        cin = 1024
        for name, cout, ksize, _, _ in _extra_layer_defs(preset.num_maps):
            shapes[name] = {"b": (cout,), "w": (ksize, ksize, cin, cout)}
            cin = cout
    for i, (m, c) in enumerate(zip(preset.maps, map_channels(preset))):
        co = m.num_shapes * config.num_vars
        shapes[f"classifier{i}"] = {"b": (co,), "w": (3, 3, c, co)}
    return shapes


def init_params(config: ModelConfig, seed: int = 0) -> dict:
    """Xavier-initialized parameters from ``numpy.random.default_rng(seed)``
    (float32 CPU tensors, OIHW). Each multibox head is initialized like a
    separate ``3x3xCx(K+5)`` conv, then the heads of a map are concatenated."""
    rng = np.random.default_rng(seed)
    preset = config.preset
    fam = _backbone_module(preset)
    if fam is not None:
        params = fam.init_backbone_params(rng, preset)
    else:
        params = vgg16.init_vgg_params(rng)
        params["l2_norm_conv4_3"] = {"scale": torch.full((512,), 20.0)}
        cin = 1024
        for name, cout, ksize, _, _ in _extra_layer_defs(preset.num_maps):
            params[name] = init_conv(rng, ksize, ksize, cin, cout)
            cin = cout
    for i, (m, c) in enumerate(zip(preset.maps, map_channels(preset))):
        heads = [init_conv(rng, 3, 3, c, config.num_vars) for _ in range(m.num_shapes)]
        params[f"classifier{i}"] = {
            "w": torch.cat([h["w"] for h in heads], dim=0),
            "b": torch.cat([h["b"] for h in heads], dim=0),
        }
    return params


def preprocess(images, config: ModelConfig):
    """uint8/float NHWC BGR images -> mean-subtracted compute-dtype tensor
    (the subtraction in float32, then one rounding)."""
    mean = torch.tensor(config.mean_bgr, dtype=torch.float32, device=images.device)
    return (images.float() - mean).to(config.dtype)


def _backbone(params, images, config: ModelConfig, train: bool = False):
    """Preprocess + VGG trunk -> (conv4_3, mod_conv7), NHWC. The uint8
    stem preprocesses inside its kernel, from images cast to uint8 as in
    the JAX package. A float32 forward and the training forward (``train``)
    run the conv1 block as plain convolutions."""
    if train or config.dtype != torch.bfloat16:
        return vgg16.apply_backbone(params, preprocess(images, config), config.a_trous,
                                    train=train)
    if config.pallas_stem_variant == "uint8":
        pool1 = vgg16.conv1_block_uint8(params, images.to(torch.uint8), config.mean_bgr)
    else:
        pool1 = vgg16.conv1_block(params, preprocess(images, config))
    return vgg16.apply_backbone(params, pool1, config.a_trous, from_pool1=True)


def _extra_maps(params, conv4_3, x, config: ModelConfig, train: bool = False):
    """L2-normalized conv4_3, mod_conv7 and the extra layers -> the
    preset's multibox source maps (NHWC)."""
    conv = conv_relu_train if train else conv_relu
    maps = [
        l2_normalize_scale(conv4_3, params["l2_norm_conv4_3"]["scale"], eps=config.l2_norm_eps),
        x,
    ]
    for name, _, _, stride, padding in _extra_layer_defs(config.preset.num_maps):
        x = conv(params[name], x, stride, padding)
        if name == "conv12_1":
            x = F.pad(x, (0, 0, 0, 1, 0, 1))  # bottom/right zero pad before conv12_2
        elif name.endswith("_2"):
            maps.append(x)
    if len(maps) != config.preset.num_maps:
        raise AssertionError((len(maps), config.preset.num_maps))
    return maps


def _feature_maps(params, images, config: ModelConfig, train: bool = False):
    """Backbone + extra layers -> the preset's multibox source maps (NHWC).
    A family walks its module's ``walk_feature_maps`` with the float conv
    executor: the inference one, or with ``train`` the training one."""
    fam = _backbone_module(config.preset)
    if fam is not None:
        return fam.walk_feature_maps(params, preprocess(images, config), config.preset,
                                     float_conv_executor(params, inference=not train))
    return _extra_maps(params, *_backbone(params, images, config, train), config, train)


def bias_in_layers(params, config: ModelConfig):
    """The layers whose inference conv carries its bias in as input
    channels (``layers.conv2d_bias_in``): every multibox head, and for a
    family every conv but the depthwise ones."""
    if _backbone_module(config.preset) is None:
        return [name for name in params if name.startswith("classifier")]
    return [name for name, p in params.items()
            if "w" in p and not name.endswith("_dw")]


def stage_conv_weights(params, config: ModelConfig):
    """Add to every layer of :func:`bias_in_layers` (in place) its filter
    with the bias folded in, ``"wb" = widen_bias(w, b)``, so that a forward
    does not rebuild it per call. ``w`` must already be in the compute
    dtype."""
    for name in bias_in_layers(params, config):
        params[name]["wb"] = widen_bias(params[name]["w"], params[name]["b"])
    return params


def _head_maps(params, maps, config: ModelConfig, train: bool = False):
    """Each map's multibox head conv: ``(B, h, w, ns * (K+5))`` NHWC,
    ``dtype(conv_f32 + b_f32)`` rounded once (``layers.conv2d_bias_in``).
    Uses the staged ``"wb"`` filter where ``stage_conv_weights`` put one.
    ``train``: the training conv, the bias added in the compute dtype."""
    out = []
    for i, (fmap, m) in enumerate(zip(maps, config.preset.maps)):
        hp = params[f"classifier{i}"]
        if train:
            y = conv2d_train(fmap, hp["w"], hp["b"])
        else:
            wb = hp["wb"] if "wb" in hp else widen_bias(hp["w"].to(fmap.dtype), hp["b"])
            y = conv2d_bias_in(fmap, wb)
        if y.shape[1:3] != (m.size.h, m.size.w):
            raise AssertionError(f"map {i}: got {tuple(y.shape[1:3])}, preset says "
                                 f"{m.size.h}x{m.size.w}")
        out.append(y)
    return out


def apply_model(params, images, config: ModelConfig, *, inference: bool = True):
    """Forward pass of ``(B, H, W, 3)`` raw BGR images.

    Returns ``(logits, locs)``: ``(B, A, K+1)`` float32 class logits and
    ``(B, A, 4)`` float32 location offsets, heads-major anchor order.

    ``inference=True`` (the port's default) is the inference route: stem
    kernels, one rounding per conv, no derivative. ``inference=False`` is
    the training route, differentiable, with the JAX package's training
    math (two roundings per bf16 conv, see ``layers.conv2d_train``). The
    JAX package's ``apply_model`` defaults to ``inference=False``.
    """
    train = not inference
    with full_float32(config.dtype):
        maps = _feature_maps(params, images, config, train)
        heads = _head_maps(params, maps, config, train)
    out = anchor_order(heads, config).float()
    return out[:, :, : config.num_classes + 1], out[:, :, config.num_classes + 1 :]


def anchor_order(head_maps, config: ModelConfig):
    """The head conv outputs ``(B, h, w, shapes * num_vars)`` of each map
    -> one ``(B, A, num_vars)`` tensor in the heads-major anchor order:
    map by map, and within a map shape by shape, then position."""
    nv = config.num_vars
    outputs = []
    for y, m in zip(head_maps, config.preset.maps):
        b, h, w, _ = y.shape
        y = y.reshape(b, h * w, m.num_shapes, nv).transpose(1, 2)
        outputs.append(y.reshape(b, m.num_shapes * h * w, nv))
    return torch.cat(outputs, dim=1)


def apply_result(params, images, config: ModelConfig):
    """The fused inference tensor ``concat(softmax(logits), locs)``."""
    logits, locs = apply_model(params, images, config)
    return torch.cat([torch.softmax(logits, dim=-1), locs], dim=-1)


def apply_scores(params, images, config: ModelConfig):
    """Throughput inference head: per-anchor ``(conf, cls, locs)``.

    Returns conf ``(B, A)`` float32, cls ``(B, A)`` int32 and locs
    ``(B, A, 4)`` float32 in the anchor-order contract.
    """
    with full_float32(config.dtype):
        maps = _feature_maps(params, images, config)
        return reduce_head_maps(_head_maps(params, maps, config), config)


def reduce_head_maps(head_maps, config: ModelConfig):
    """Lazy softmax over the head conv outputs.

    ``conf = exp(max_fg_logit - logsumexp(logits))`` and
    ``cls = argmax(fg_logits)`` (ties to the first index, as in JAX) per
    anchor, without materializing the ``(B, A, K+1)`` softmax. The logits
    are the head conv's dtype (bf16 on the bf16 path); the exponentials
    are taken in float32.
    """
    k = config.num_classes
    confs, clss, locss = [], [], []
    for y, m in zip(head_maps, config.preset.maps):
        b, h, w, co = y.shape
        y = y.reshape(b, h * w, m.num_shapes, co // m.num_shapes).permute(0, 2, 3, 1)
        logits = y[:, :, : k + 1, :]  # (B, ns, K+1, hw)
        fg = logits[:, :, :k, :]
        cls_m = torch.argmax(fg, dim=2).to(torch.int32)
        mx = torch.amax(logits, dim=2).float()
        se = torch.sum(torch.exp(logits.float() - mx[:, :, None, :]), dim=2)
        conf_m = torch.exp(torch.amax(fg, dim=2).float() - mx) / se
        locs_m = y[:, :, k + 1 : k + 5, :].permute(0, 1, 3, 2)  # (B, ns, hw, 4)
        confs.append(conf_m.reshape(b, -1))
        clss.append(cls_m.reshape(b, -1))
        locss.append(locs_m.reshape(b, -1, 4).float())
    return torch.cat(confs, dim=1), torch.cat(clss, dim=1), torch.cat(locss, dim=1)


class SSDVGG:
    """Thin object façade bundling config + params, as the JAX package's
    ``SSDVGG`` (the reference's class surface)."""

    def __init__(self, config: ModelConfig, params=None):
        self.config = config
        self.preset = config.preset
        self.num_classes = config.num_classes + 1
        self.num_vars = config.num_vars
        self.params = params

    def init(self, seed: int = 0, pretrained_vgg: Optional[str] = None):
        """Xavier parameters from ``seed``, with the pretrained VGG-16
        archive ``pretrained_vgg`` laid over the trunk where given."""
        self.params = init_params(self.config, seed)
        if pretrained_vgg:
            self.params = vgg16.load_pretrained_vgg(pretrained_vgg, self.params)
        return self.params

    def __call__(self, images):
        """``(logits, locs)`` of the training forward, as the JAX façade's
        call (its ``apply_model`` default)."""
        return apply_model(self.params, images, self.config, inference=False)

    def result(self, images):
        return apply_result(self.params, images, self.config)
