"""The SSD detector: configuration, parameters and forward pass.

Three backbone families, chosen by the preset's ``backbone``: VGG-16
(``models/vgg16.py``), ResNet-34 (``models/resnet.py``) and MobileNetV1
(``models/mobilenet.py``); the heads, the anchor order and everything
after them are family-generic: one wide 3x3 multibox head conv per
source map, whose output channels are the per-shape heads concatenated.
Outputs follow the anchor-order contract of ``ops/anchors.py``:
heads-major, then row-major cells.

The family protocol. Each family module (:func:`_backbone_module`, the
one place that maps a backbone name to its code) exposes
``map_channels(preset)``, ``backbone_shapes(preset)``,
``init_backbone_params(rng, preset)`` and ``walk_feature_maps(params, x,
config, conv)``, the one walk of its layers from the preprocessed images
to the multibox source maps, and the facts the routes ask of it:
``PER_LAYER_SCALES`` (int8 activation scales one per layer, or per input
channel folded into the weights), ``RELU_IN_CONV`` (each walked conv
carries its ReLU), ``stem`` (the bf16 inference route's stem kernel,
after which the walk starts from pool1, or None) and ``load_pretrained``
(or None). The walk runs every convolution, and :func:`walk_heads` every
head, through a route's conv executor ``conv(name, x, *, stride=1,
padding="SAME", dilation=1, depthwise=False, relu=False)``: the float
and training routes' ``layers.float_conv_executor``, the int8 route's
``quantized._qconv_executor`` and its calibration's recorder, QAT's
``qat._fq_executor``; tensor parallelism wraps the float one
(``parallel/tensor_parallel.ModelShards.conv_executor``).

Parameters are a nested dict ``{layer: {"w": OIHW, "b": (cout,)}}`` plus
the family's other leaves (VGG's ``{"l2_norm_conv4_3": {"scale":
(512,)}}``, the GroupNorms); ``weights.params_from_jax`` converts the JAX
package's HWIO dict into it.

A bf16 inference forward of a family with a ``stem`` always runs it
(``ops/stem_cuda.py``): the split stem (conv1_1 as a convolution,
conv1_2 + pool1 as a kernel) or, with ``pallas_stem_variant="uint8"``,
the whole stem from the raw uint8 image; a float32 forward runs the conv1
block as plain convolutions. The inference route rounds once per conv +
bias. The training forward (``apply_model(..., inference=False)``) runs
no kernel without a derivative: every conv is ``layers.conv2d_train``,
conv1 included. A float32 forward on the card runs its convs in full
float32, TF32 off (``layers.full_float32``).
"""

from __future__ import annotations

import dataclasses
from typing import Optional, Tuple

import numpy as np
import torch

from ssd_tensorflow_tpu_torch.models import mobilenet, resnet, vgg16
from ssd_tensorflow_tpu_torch.models.layers import (
    float_conv_executor,
    full_float32,
    init_conv,
    preprocess,
    widen_bias,
)
from ssd_tensorflow_tpu_torch.presets import SSDPreset, get_preset_by_name

_DTYPES = {"bfloat16": torch.bfloat16, "float32": torch.float32}
#: the stem kernels a bf16 VGG forward may run (``ModelConfig.pallas_stem_variant``)
STEM_VARIANTS = ("dma", "uint8")
#: the family module of each backbone a preset may name
_FAMILIES = {"vgg": vgg16, "resnet34": resnet, "mobilenetv1": mobilenet}
BACKBONES = tuple(_FAMILIES)


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
        if self.pallas_stem_variant != "dma" and _backbone_module(self.preset).stem is None:
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


def _backbone_module(preset: SSDPreset):
    """The family module of ``preset`` (``models/vgg16.py``,
    ``models/resnet.py`` or ``models/mobilenet.py``; see the module doc)."""
    return _FAMILIES[preset.backbone]


def map_channels(preset: SSDPreset):
    """Head-input channel count per multibox source map, per family."""
    return _backbone_module(preset).map_channels(preset)


def param_shapes(config: ModelConfig) -> dict:
    """``{layer: {leaf: shape}}`` of every parameter, convolutions in the
    JAX package's HWIO layout (the bundle's and the conversion's layout)."""
    preset = config.preset
    shapes = _backbone_module(preset).backbone_shapes(preset)
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
    params = _backbone_module(preset).init_backbone_params(rng, preset)
    for i, (m, c) in enumerate(zip(preset.maps, map_channels(preset))):
        heads = [init_conv(rng, 3, 3, c, config.num_vars) for _ in range(m.num_shapes)]
        params[f"classifier{i}"] = {
            "w": torch.cat([h["w"] for h in heads], dim=0),
            "b": torch.cat([h["b"] for h in heads], dim=0),
        }
    return params


def walk_heads(params, x, config: ModelConfig, conv, **entry):
    """The family's walk of ``x`` (``walk_feature_maps(params, x, config,
    conv, **entry)``), then each source map's multibox head conv
    ``conv(f"classifier{i}", map)`` (no ReLU) through the same executor:
    ``(B, h, w, ns * (K+5))`` NHWC each. Raises unless the walk gave the
    preset's maps, in number and size."""
    preset = config.preset
    maps = _backbone_module(preset).walk_feature_maps(params, x, config, conv, **entry)
    if len(maps) != preset.num_maps:
        raise AssertionError(f"{preset.name}: walked {len(maps)} maps, the preset has "
                             f"{preset.num_maps}")
    for m, pm in zip(maps, preset.maps):
        if tuple(m.shape[1:3]) != (pm.size.h, pm.size.w):
            raise AssertionError(f"{preset.name}: a map of {tuple(m.shape[1:3])}, the preset "
                                 f"says {pm.size.h}x{pm.size.w}")
    return [conv(f"classifier{i}", fmap) for i, fmap in enumerate(maps)]


def _float_heads(params, images, config: ModelConfig, inference: bool = True, shards=None):
    """:func:`walk_heads` of ``(B, H, W, 3)`` raw BGR images through the
    float executor (``layers.float_conv_executor``): the inference one or
    the training one. A bf16 inference forward of a family with a stem
    kernel walks from the kernel's pool1. ``shards``: conv6 / conv7
    tensor-parallel (``parallel/tensor_parallel.ModelShards``)."""
    fam = _backbone_module(config.preset)
    conv = float_conv_executor(params, inference)
    if shards is not None:
        conv = shards.conv_executor(conv, params)
    if inference and config.dtype == torch.bfloat16 and fam.stem is not None:
        return walk_heads(params, fam.stem(params, images, config), config, conv, from_pool1=True)
    return walk_heads(params, preprocess(images, config), config, conv)


def bias_in_layers(params, config: ModelConfig):
    """The layers whose inference conv carries its bias in as input
    channels (``layers.conv2d_bias_in``): every multibox head, and where
    the family's walked convs carry no ReLU (``RELU_IN_CONV``) every conv
    but the depthwise ones."""
    if _backbone_module(config.preset).RELU_IN_CONV:
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


def apply_model(params, images, config: ModelConfig, *, inference: bool = True, shards=None):
    """Forward pass of ``(B, H, W, 3)`` raw BGR images.

    Returns ``(logits, locs)``: ``(B, A, K+1)`` float32 class logits and
    ``(B, A, 4)`` float32 location offsets, heads-major anchor order.

    ``inference=True`` (the port's default) is the inference route: stem
    kernels, one rounding per conv, no derivative. ``inference=False`` is
    the training route, differentiable, with the JAX package's training
    math (two roundings per bf16 conv, see ``layers.conv2d_train``). The
    JAX package's ``apply_model`` defaults to ``inference=False``.

    ``shards`` (a ``parallel/tensor_parallel.ModelShards``): ``params``
    hold this process's shard of conv6 / conv7, run tensor-parallel.
    """
    with full_float32(config.dtype):
        heads = _float_heads(params, images, config, inference, shards)
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
        return reduce_head_maps(_float_heads(params, images, config), config)


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
