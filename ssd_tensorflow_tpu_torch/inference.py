"""Inference façade: load a model bundle and run fused detection.

The bundle is the JAX package's npz format: a ``__meta__`` JSON entry
(model config, label map, format tag, and for an int8 bundle the
activation scales) and the parameters as ``leaf_<i>`` arrays in JAX
tree-flatten order, which is sorted dict keys at every level,
convolutions HWIO. A float bundle holds ``b``, ``w`` per conv; an int8
(W8A8) bundle ``b``, ``w_scale``, ``wq`` (int8), and a family conv of an
int8 bundle (resnet34 / mobilenetv1, per-channel activation scales folded
into the weights) also its ``a_scale``; GroupNorms hold ``bias`` and
``scale``. Bundles of every family, float or int8, written by either
package load in the other.
"""

from __future__ import annotations

import dataclasses
import json

import numpy as np
import torch

from ssd_tensorflow_tpu_torch import resolve_device
from ssd_tensorflow_tpu_torch.data import image_io
from ssd_tensorflow_tpu_torch.models import quantized
from ssd_tensorflow_tpu_torch.models.ssd_vgg import (
    ModelConfig,
    _backbone_module,
    apply_result,
    apply_scores,
    param_shapes,
    stage_conv_weights,
)
from ssd_tensorflow_tpu_torch.ops.anchors import anchors_for_preset
from ssd_tensorflow_tpu_torch.ops.postprocess import (
    DetectionConfig,
    Detections,
    decode_scores,
    detect,
    detections_to_boxes,
)
from ssd_tensorflow_tpu_torch.utils.checkpoint import checkpoint_config, read_params
from ssd_tensorflow_tpu_torch.utils.profiling import span
from ssd_tensorflow_tpu_torch.weights import (
    params_from_jax,
    params_to_jax,
    qparams_from_jax,
    qparams_to_jax,
    stage_qparams,
)

FLOAT_BUNDLE_FORMAT = "ssd_tensorflow_tpu.bundle.v1"
INT8_BUNDLE_FORMAT = "ssd_tensorflow_tpu.bundle.int8.v1"


def model_config_from_dict(d: dict) -> ModelConfig:
    return ModelConfig(
        preset_name=d["preset_name"],
        num_classes=d["num_classes"],
        a_trous=d.get("a_trous", True),
        compute_dtype=d.get("compute_dtype", "bfloat16"),
        mean_bgr=tuple(d.get("mean_bgr", (104.0, 117.0, 123.0))),
        packed_stem=d.get("packed_stem", True),
        l2_norm_eps=d.get("l2_norm_eps", 1e-12),
    )


def model_config_to_dict(cfg: ModelConfig) -> dict:
    """The serialization of ModelConfig in checkpoint configs and bundles."""
    return {
        "preset_name": cfg.preset_name,
        "num_classes": cfg.num_classes,
        "a_trous": cfg.a_trous,
        "compute_dtype": cfg.compute_dtype,
        "mean_bgr": list(cfg.mean_bgr),
        "packed_stem": cfg.packed_stem,
        "l2_norm_eps": cfg.l2_norm_eps,
    }


def _leaf_order(shapes: dict):
    """``(layer, leaf)`` pairs in JAX tree-flatten order (sorted keys)."""
    return [(name, key) for name in sorted(shapes) for key in sorted(shapes[name])]


def qparam_shapes(config: ModelConfig) -> dict:
    """``{layer: {leaf: shape}}`` of an int8 bundle: each conv's ``w``
    becomes ``wq`` (HWIO int8) beside a per-output-channel ``w_scale``; in
    a family without per-layer scales a conv other than a depthwise one
    (``*_dw``) also holds its folded per-input-channel ``a_scale``
    (``quantized.quantize_weights_folded``)."""
    folded = not _backbone_module(config.preset).PER_LAYER_SCALES
    shapes = {}
    for name, leaves in param_shapes(config).items():
        if "w" in leaves:
            shapes[name] = {"b": leaves["b"], "w_scale": leaves["b"], "wq": leaves["w"]}
            if folded and not name.endswith("_dw"):
                shapes[name]["a_scale"] = (leaves["w"][2],)
        else:
            shapes[name] = dict(leaves)
    return shapes


def save_bundle(path: str, params, model_cfg: ModelConfig, lid2name=None, act_scales=None):
    """Write an inference bundle of the port's parameters: float, or with
    ``act_scales`` given, int8 of the port's q-params
    (``models/quantized.quantize_weights``, or ``quantize_weights_folded``
    for a family with ``act_scales={}``) with the scales in its meta."""
    if act_scales is None:
        tree, shapes = params_to_jax(params), param_shapes(model_cfg)
    else:
        tree, shapes = qparams_to_jax(params), qparam_shapes(model_cfg)
    arrays = {f"leaf_{i}": tree[name][key] for i, (name, key) in enumerate(_leaf_order(shapes))}
    meta = {
        "model": model_config_to_dict(model_cfg),
        "lid2name": {str(k): v for k, v in (lid2name or {}).items()},
        "format": FLOAT_BUNDLE_FORMAT if act_scales is None else INT8_BUNDLE_FORMAT,
    }
    if act_scales is not None:
        meta["act_scales"] = {k: float(v) for k, v in act_scales.items()}
    arrays["__meta__"] = np.frombuffer(json.dumps(meta).encode(), dtype=np.uint8)
    with open(path, "wb") as f:
        np.savez(f, **arrays)


def load_bundle(path: str):
    """Load ``(params, model config, lid2name, act_scales)`` from a bundle:
    the port's float parameters and ``act_scales=None``, or for an int8
    bundle its q-params and activation scales."""
    with np.load(path) as data:
        meta = json.loads(bytes(data["__meta__"]))
        quantized_bundle = meta.get("format", "").endswith("int8.v1")
        model_cfg = model_config_from_dict(meta["model"])
        shapes = (qparam_shapes if quantized_bundle else param_shapes)(model_cfg)
        order = _leaf_order(shapes)
        n_leaves = sum(1 for k in data.files if k.startswith("leaf_"))
        if n_leaves != len(order):
            raise ValueError(f"{path}: {n_leaves} parameter leaves, the "
                             f"{model_cfg.preset_name} model has {len(order)}")
        tree = {name: {} for name in shapes}
        for i, (name, key) in enumerate(order):
            leaf = data[f"leaf_{i}"]
            if leaf.shape != tuple(shapes[name][key]):
                raise ValueError(f"{path}: leaf_{i} ({name}/{key}) has shape "
                                 f"{leaf.shape}, expected {shapes[name][key]}")
            tree[name][key] = leaf
        lid2name = {int(k): v for k, v in meta.get("lid2name", {}).items()}
    if not quantized_bundle:
        return params_from_jax(tree), model_cfg, lid2name, None
    return qparams_from_jax(tree), model_cfg, lid2name, dict(meta["act_scales"])


def load_params_from_train_checkpoint(path: str):
    """``(params, model config, lid2name)`` from a training checkpoint
    (``utils/checkpoint.py``, either package's): its config's model entry
    and the params, the first leaves of the state."""
    cfg = checkpoint_config(path)
    model_cfg = model_config_from_dict(cfg["model"])
    params = read_params(path, param_shapes(model_cfg))
    lid2name = {int(k): v for k, v in cfg.get("lid2name", {}).items()}
    return params, model_cfg, lid2name


def load_calibration_images(files, h: int, w: int) -> np.ndarray:
    """Decode and resize calibration images to a uint8 ``(N, h, w, 3)`` BGR
    batch (``data/image_io.py``), as the JAX package's loader that the
    export CLI's ``--quantize`` calibrates on."""
    files = list(files)
    if not files:
        raise ValueError("no calibration images given")
    out = np.zeros((len(files), h, w, 3), dtype=np.uint8)
    for i, f in enumerate(files):
        img = image_io.imread(f)
        if img is None:
            raise ValueError(f"cannot read calibration image {f!r}")
        out[i] = image_io.resize(img, (w, h))
    return out


def _apply_overrides(model_cfg: ModelConfig, overrides: dict, int8: bool = False) -> ModelConfig:
    """``model_cfg`` with execution-backend fields replaced, as the JAX
    package's ``InferenceModel(overrides=...)`` does; never serialized.

    Takes ``pallas_stem_variant``, ``pallas_stem: True`` and
    ``padded_heads`` (True or False) as no-ops so that the JAX package's
    override dicts work: the port's bf16 forward always runs a stem
    kernel, so ``pallas_stem: False`` raises; ``padded_heads`` pads the
    JAX package's head convs to a lane-aligned width whose pad channels
    its scores path slices away, which changes no math. On a
    bundle that does not run the bf16 VGG float stem (int8, which
    quantizes conv1 as it does every conv, float32, or a family without a
    stem kernel, such as resnet34 / mobilenetv1, whose stem is another
    block) the stem overrides are dropped with the JAX package's message.
    """
    overrides = dict(overrides)
    stem_keys = [k for k in ("pallas_stem", "pallas_stem_variant") if k in overrides]
    no_stem = _backbone_module(model_cfg.preset).stem is None
    if stem_keys and (int8 or model_cfg.compute_dtype != "bfloat16" or no_stem):
        kind = ("int8" if int8 else model_cfg.preset.backbone if no_stem
                else model_cfg.compute_dtype)
        print(f"[!] pallas_stem override ignored: this {kind} "
              "bundle does not run the bf16 VGG float stem")
        for k in stem_keys:
            overrides.pop(k)
    if overrides.pop("padded_heads", False) not in (True, False):
        raise ValueError("padded_heads must be True or False")
    if not overrides.pop("pallas_stem", True):
        raise ValueError(
            "pallas_stem=False is not available in the port: its bf16 forward "
            "always runs a stem kernel (ops/stem_cuda.py); choose the kernel "
            "with pallas_stem_variant"
        )
    unknown = set(overrides) - {"pallas_stem_variant"}
    if unknown:
        raise ValueError(f"unsupported overrides {sorted(unknown)}; the port takes "
                         "pallas_stem, pallas_stem_variant and padded_heads")
    return dataclasses.replace(model_cfg, **overrides)


#: what :func:`forward_graph` keeps for a key seen once
_SEEN = object()


def _capture(forward, x):
    """``(input buffer, graph, outputs)``: ``forward`` of a buffer like
    ``x`` captured on a side stream into one CUDA graph (the capture runs
    nothing, so the buffer is filled at each replay). The device is idle
    first (``torch.cuda.graph`` synchronises); ``thread_local`` lets other
    threads (a prefetch producer, a process group's watchdog) run on."""
    with torch.cuda.device(x.device):
        static_x = torch.empty_like(x, memory_format=torch.contiguous_format)
        graph = torch.cuda.CUDAGraph()
        with torch.cuda.graph(graph, stream=torch.cuda.Stream(),
                              capture_error_mode="thread_local"):
            outs = forward(static_x)
    return static_x, graph, outs


def forward_graph(graphs: dict, forward, x):
    """``forward(x)`` of a CUDA tensor through one CUDA graph per input
    shape, dtype and device, kept in ``graphs``.

    The first call of a key runs ``forward`` eagerly: it builds the kernel
    libraries and cuDNN's plans and fills the kernels' host caches (the
    driver's entry points, the cluster sizes) outside any capture. The
    second captures ``forward`` into a graph that reads its own input
    buffer; the launches freeze every address (the int8 kernel encodes its
    input's tensor map on the host), which the buffer and the graph's
    private memory pool keep fixed. That call and every later one copy
    ``x`` into the buffer, replay the graph on the current stream and
    return clones of its outputs, which the caller owns: a later replay
    overwrites none of them. A shape called once never captures. Counted
    in ``forward_graph.captures`` and ``forward_graph.replays``, inside
    spans ``ssd.forward_graph.capture`` and ``ssd.forward_graph.replay``."""
    key = (tuple(x.shape), x.dtype, x.device)
    entry = graphs.get(key)
    if entry is None:
        graphs[key] = _SEEN
        return forward(x)
    if entry is _SEEN:
        with span("ssd.forward_graph.capture"):
            entry = graphs[key] = _capture(forward, x)
        forward_graph.captures += 1
    static_x, graph, outs = entry
    with span("ssd.forward_graph.replay"):
        static_x.copy_(x)
        graph.replay()
        out = tuple(t.clone() for t in outs)
    forward_graph.replays += 1
    return out


forward_graph.captures = 0
forward_graph.replays = 0


class InferenceModel:
    """End-to-end detector: uint8 BGR batch -> detections, on one device,
    or data-parallel over a mesh.

    With ``act_scales`` given, ``params`` are int8 q-params (an int8
    bundle's, or ``models/quantized.quantize_weights[_folded]``'; a family
    model's ``act_scales`` is ``{}``) and the forward is the int8 W8A8 path
    (``models/quantized._forward_scores``); otherwise float parameters and
    the float path, of any family. ``overrides`` holds
    execution-backend fields of the model config, applied per run and
    never serialized (see :func:`_apply_overrides`).

    Data-parallel serving (``mesh`` from ``parallel/mesh.make_mesh``): the
    parameters are rank 0's, broadcast to every process, which runs on
    its own device (``device`` is ignored) and takes its rows of each
    batch, split over the mesh's ``data`` dimension; a batch that does not
    divide raises. The whole program is per image, so each process
    computes its rows alone, and ``run`` / ``run_scores`` gather the whole
    batch's result onto every process (``sharding.gather_rows``).
    ``mesh=None`` is one device.
    """

    def __init__(self, params, model_cfg: ModelConfig, lid2name=None,
                 detection: DetectionConfig | None = None, overrides: dict | None = None,
                 device="cuda", act_scales: dict | None = None, mesh=None):
        if overrides:
            model_cfg = _apply_overrides(model_cfg, overrides, int8=act_scales is not None)
        self.mesh = mesh
        if mesh is not None:
            from ssd_tensorflow_tpu_torch.parallel.mesh import mesh_device
            from ssd_tensorflow_tpu_torch.parallel.sharding import replicate

            # broadcast on the device (NCCL takes no host tensors), then
            # staged from the host as without a mesh
            device = mesh_device(mesh)
            params = {name: {key: v.detach().to(device, copy=True) for key, v in leaves.items()}
                      for name, leaves in params.items()}
            replicate([v for leaves in params.values() for v in leaves.values()])
            params = {name: {key: v.cpu() for key, v in leaves.items()}
                      for name, leaves in params.items()}
        self.device = resolve_device(device)
        self.config = model_cfg
        self.preset = model_cfg.preset
        self.lid2name = lid2name or {}
        self.detection = detection or DetectionConfig(top_k=200, confidence_threshold=0.01)
        self.act_scales = act_scales
        if act_scales is not None:
            self.params = stage_qparams(params, act_scales, self.device)
        else:
            self.params = stage_conv_weights({
                name: {key: self._stage(v) for key, v in leaves.items()}
                for name, leaves in params.items()
            }, model_cfg)
        self.anchors = torch.from_numpy(anchors_for_preset(self.preset)).to(self.device)
        self._graphs = {}

    def _stage(self, value):
        """Filters in the compute dtype, channels-last (the convolutions'
        layout); biases and scales stay float32."""
        value = value.to(self.device)
        if value.dim() == 4:
            value = value.to(self.config.dtype).contiguous(memory_format=torch.channels_last)
        return value

    @classmethod
    def from_checkpoint(cls, path: str, **kw):
        """The float model of a training checkpoint's params."""
        params, cfg, lid2name = load_params_from_train_checkpoint(path)
        return cls(params, cfg, lid2name, **kw)

    @classmethod
    def from_bundle(cls, path: str, **kw):
        params, cfg, lid2name, act_scales = load_bundle(path)
        return cls(params, cfg, lid2name, act_scales=act_scales, **kw)

    def preprocess_files(self, files):
        """Decode image files to a uint8 BGR batch at the preset's size
        (bilinear resize, ``data/image_io.py``), as the JAX package's
        façade: ``(images (N, H, W, 3), [(width, height) of each file])``."""
        w, h = self.preset.image_size.w, self.preset.image_size.h
        out = np.zeros((len(files), h, w, 3), dtype=np.uint8)
        sizes = []
        for i, f in enumerate(files):
            img = image_io.imread(f)
            if img is None:
                raise FileNotFoundError(f)
            sizes.append((img.shape[1], img.shape[0]))
            out[i] = image_io.resize(img, (w, h))
        return out, sizes

    def _batch(self, images):
        """The batch on the device: under a mesh, this process's rows."""
        x = images if torch.is_tensor(images) else torch.from_numpy(np.ascontiguousarray(images))
        if self.mesh is not None:
            from ssd_tensorflow_tpu_torch.parallel.sharding import batch_rows

            b, d = x.shape[0], self.mesh.shape["data"]
            if b % d:
                raise ValueError(
                    f"batch {b} not divisible by the data-parallel mesh "
                    f"size {d} — pad the batch (fixed shapes keep one "
                    "compiled program anyway, see cli/infer.py)"
                )
            x = x[batch_rows(b, self.mesh)]
        return x.to(self.device)

    def _whole(self, *tensors):
        """``tensors`` (this process's rows) as the whole batch's: gathered
        over the mesh's ``data`` group, or as they are without a mesh."""
        if self.mesh is None:
            return tensors
        from ssd_tensorflow_tpu_torch.parallel.sharding import gather_rows

        return gather_rows(list(tensors), self.mesh)

    def _whole_detections(self, dets: Detections) -> Detections:
        return Detections(*self._whole(dets.boxes, dets.scores, dets.classes, dets.valid))

    def run(self, images):
        """Forward + decode + NMS of ``(B, H, W, 3)`` uint8 BGR images,
        keeping the raw result: ``(result (B, A, K+5), Detections)``, the
        result the softmax probabilities then the 4 offsets of each anchor
        (the int8 or the float forward, as the model was built), the
        detections :func:`ops.postprocess.detect` of it; under a mesh, the
        whole batch's on every process."""
        with torch.inference_mode():
            x = self._batch(images)
            if self.act_scales is not None:
                result = quantized._forward(self.params, x, self.config)
            else:
                result = apply_result(self.params, x, self.config)
            dets = detect(result, self.anchors, self.detection)
            if self.mesh is None:
                return result, dets
            (result,) = self._whole(result)
            return result, self._whole_detections(dets)

    def forward_scores(self, x):
        """Per-anchor ``(conf, cls, locs)`` of a uint8 batch on the device:
        the int8 or the float forward, as the model was built. The int8
        forward of a CUDA batch under ``torch.inference_mode`` (as
        ``run_scores`` runs it) goes through :func:`forward_graph`, one CUDA
        graph per input shape, the same bits; the CPU, the float forward
        and calls outside inference mode run eagerly."""
        if self.act_scales is None:
            return apply_scores(self.params, x, self.config)
        if x.device.type == "cuda" and torch.is_inference_mode_enabled():
            return forward_graph(self._graphs, self._int8_scores, x)
        return self._int8_scores(x)

    def _int8_scores(self, x):
        return quantized._forward_scores(self.params, x, self.config)

    def run_scores(self, images) -> Detections:
        """Forward + lazy softmax + decode + NMS of ``(B, H, W, 3)`` uint8
        BGR images (numpy or tensor); tensors stay on the device. Under a
        mesh, the whole batch's detections on every process."""
        with torch.inference_mode():
            conf, cls, locs = self.forward_scores(self._batch(images))
            dets = decode_scores(conf, cls, locs, self.anchors, self.detection)
            return dets if self.mesh is None else self._whole_detections(dets)

    def detect_boxes(self, images):
        """Detections as host lists of ``(conf, Box)`` with label names."""
        return detections_to_boxes(self.run_scores(images), self.lid2name)
