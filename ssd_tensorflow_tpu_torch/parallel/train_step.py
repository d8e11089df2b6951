"""The train and eval steps, as in the JAX package's ``parallel/train_step.py``.

One call of the train step is one optimizer step on the device that holds
the state: ground-truth target assignment (``ops/matching.py``), the
differentiable forward (``ssd_vgg.apply_model(..., inference=False)``),
the multibox loss with hard-negative mining and the L2 term, gradients by
``torch.autograd.grad`` over the parameter leaves, an SGD-momentum update
under the piecewise-constant LR, and the decode + NMS of the predictions
(``ops/postprocess.decode_detections``; NMS is ``csrc/nms.cu`` on the
card). A float32 step runs its convs, forward and backward, with TF32
off (``layers.full_float32``).

The optimizer is optax's ``sgd(lr_schedule, momentum)`` step for step:
``trace = g + momentum * trace``, then ``p = p + (-lr(count)) * trace``
with ``count`` read before its increment. Its state is explicit tensors,
a momentum dict that mirrors ``params``, so that a checkpoint carries it
both ways (``utils/checkpoint.py`` writes the JAX package's layout).

Data parallelism: under a process group (``parallel/mesh.py``), the state
placed by :func:`shard_state` (rank 0's, broadcast) and each rank feeding
its own rows of the batch (:func:`shard_batch`), the step averages the
gradients and the losses over the ``data`` group of the mesh the state
was placed on before the update: one ``all_reduce`` of a float32
buffer, summed, then divided by the group's size. The loss is a batch
mean of per-sample terms (``models/loss.py``) and nothing normalizes
across samples, so the mean of the ranks' means is the global batch's,
and the losses returned are the global batch's. A state that no mesh
placed takes no collective, inside a process group too: it is one
process's model, as the JAX package's step on one device.

Tensor parallelism: ``shard_state(tensor_parallel=True)`` on a mesh with
a ``model`` dimension keeps each process's slice of conv6 / conv7 and of
their momentum (``sharding.shard_params``) and records the mesh on the
state; the forward and the L2 term sum over its ``model`` group
(``parallel/tensor_parallel.ModelShards``), so every
process of a ``model`` group holds the same losses and the same
gradients of the whole leaves, and its own shard's gradient. Averaging
over ``data`` only keeps two shards from being mixed.
``TrainConfig.remat`` runs the forward under ``remat.checkpoint_dots_only``.
"""

from __future__ import annotations

import dataclasses
from typing import Callable, Optional, Tuple

import numpy as np
import torch
import torch.distributed as dist

from ssd_tensorflow_tpu_torch import resolve_device
from ssd_tensorflow_tpu_torch.models.layers import full_float32
from ssd_tensorflow_tpu_torch.models.loss import total_loss
from ssd_tensorflow_tpu_torch.models.ssd_vgg import ModelConfig, apply_model
from ssd_tensorflow_tpu_torch.ops.matching import encode_targets_batch
from ssd_tensorflow_tpu_torch.ops.postprocess import DetectionConfig, decode_detections
from ssd_tensorflow_tpu_torch.parallel.mesh import mesh_device
from ssd_tensorflow_tpu_torch.parallel.remat import checkpoint_dots_only
from ssd_tensorflow_tpu_torch.parallel.sharding import (
    average,
    batch_rows,
    gather_params,
    replicate,
    shard_params,
    use_tensor_parallel,
)
from ssd_tensorflow_tpu_torch.parallel.tensor_parallel import model_shards
from ssd_tensorflow_tpu_torch.utils.profiling import span


@dataclasses.dataclass(frozen=True)
class TrainConfig:
    """Static training configuration, with the JAX package's defaults."""

    model: ModelConfig = ModelConfig()
    #: piecewise-constant LR: values[i] for boundaries[i-1] < step <= boundaries[i]
    lr_values: Tuple[float, ...] = (0.00075, 0.0001, 0.00001)
    lr_boundaries: Tuple[int, ...] = (320000, 400000)
    momentum: float = 0.9
    #: weight decay, applied in the loss (not by the optimizer)
    weight_decay: float = 0.0005
    #: detections decoded inside the step (None = skip)
    detect: Optional[DetectionConfig] = DetectionConfig(confidence_threshold=0.5)
    #: rematerialize the forward in the backward pass (memory for
    #: operations): ``remat.checkpoint_dots_only``
    remat: bool = False


@dataclasses.dataclass
class SGDState:
    """optax's ``sgd`` state: the momentum ``trace`` (mirrors the params)
    and the schedule's step ``count``."""

    trace: dict
    count: int


@dataclasses.dataclass
class TrainState:
    """Parameters, optimizer state and step; :func:`shard_state` records
    the ``mesh`` it placed them on and whether conv6 / conv7 and their
    momentum are this process's shards (``tensor_parallel``)."""

    params: dict
    opt_state: SGDState
    step: int
    mesh: object = None
    tensor_parallel: bool = False

    def gathered(self) -> "TrainState":
        """The state with whole leaves on every process: a
        tensor-parallel state's shards gathered over its mesh's ``model``
        group (``sharding.gather_params``, a collective every process of
        the mesh enters); any other state as it is."""
        if not self.tensor_parallel:
            return self
        trace = gather_params(self.opt_state.trace, self.mesh)
        return TrainState(params=gather_params(self.params, self.mesh),
                          opt_state=SGDState(trace=trace, count=self.opt_state.count),
                          step=self.step, mesh=self.mesh)


def tree_map(fn, tree):
    """``fn`` over every leaf of a ``{layer: {leaf: value}}`` tree."""
    return {name: {key: fn(v) for key, v in leaves.items()} for name, leaves in tree.items()}


def _device_of(params) -> torch.device:
    return next(iter(next(iter(params.values())).values())).device


def lr_schedule(values, boundaries) -> Callable:
    """TF-style piecewise constant: ``values[i]`` for ``boundaries[i-1] <
    step <= boundaries[i]``. ``searchsorted(..., right=False)`` is JAX's
    ``side="left"``. Returns ``step -> 0-d float32 tensor`` (CPU)."""
    values = torch.tensor(values, dtype=torch.float32)
    boundaries = torch.tensor(boundaries, dtype=torch.int64)

    def schedule(step):
        step = torch.as_tensor(step, dtype=torch.int64).reshape(1)
        return values[torch.searchsorted(boundaries, step, right=False)[0]]

    return schedule


@dataclasses.dataclass(frozen=True)
class SGD:
    """SGD with momentum under a step schedule (optax's ``sgd``)."""

    schedule: Callable
    momentum: float

    def init(self, params) -> SGDState:
        return SGDState(trace=tree_map(torch.zeros_like, params), count=0)

    def update(self, grads, state: SGDState, params):
        """``(new params, new state)``; nothing is changed in place."""
        step_size = -self.schedule(state.count)
        trace = {name: {key: g + self.momentum * state.trace[name][key]
                        for key, g in leaves.items()} for name, leaves in grads.items()}
        new = {name: {key: p + step_size * trace[name][key] for key, p in leaves.items()}
               for name, leaves in params.items()}
        return new, SGDState(trace=trace, count=state.count + 1)


def make_optimizer(cfg: TrainConfig) -> SGD:
    """SGD with momentum under the piecewise LR."""
    return SGD(lr_schedule(cfg.lr_values, cfg.lr_boundaries), cfg.momentum)


def make_train_state(params, cfg: TrainConfig, step: int = 0, device="cuda") -> TrainState:
    """A fresh state of ``params`` (copied to ``device`` as float32) with a
    zero momentum trace."""
    dev = resolve_device(device)
    params = tree_map(lambda v: v.detach().to(dev, torch.float32, copy=True), params)
    return TrainState(params=params, opt_state=make_optimizer(cfg).init(params), step=int(step))


def _batch_on(batch, device):
    return {k: torch.as_tensor(np.asarray(v) if not torch.is_tensor(v) else v).to(device)
            for k, v in batch.items()}


def batch_targets(batch, anchors, cfg: TrainConfig):
    """The ``(B, A, K+5)`` targets of a batch on ``anchors`` (no gradient)."""
    with torch.no_grad():
        return encode_targets_batch(batch["gt_boxes"].float(), batch["gt_labels"],
                                    batch["gt_mask"].bool(), anchors, cfg.model.num_classes)


def model_outputs(params, images, cfg: TrainConfig, forward=None, shards=None):
    """``(logits, locs)`` of the differentiable forward, or of ``forward``;
    with ``cfg.remat`` and gradients on, under ``checkpoint_dots_only``.
    ``shards``: conv6 / conv7 tensor-parallel (``ssd_vgg.apply_model``),
    which only the model's own forward runs."""
    if forward is None:
        forward = lambda p, x: apply_model(p, x, cfg.model, inference=False,  # noqa: E731
                                           shards=shards)
    elif shards is not None:
        raise ValueError("tensor parallelism runs the model's own forward, not a given one")
    if cfg.remat and torch.is_grad_enabled():
        forward = checkpoint_dots_only(forward)
    return forward(params, images)


def loss_terms(params, batch, anchors, cfg: TrainConfig, forward=None, shards=None):
    """``(losses, logits, locs)`` of a batch: its targets, the forward and
    ``models/loss.total_loss``, each a span (``ssd.step.targets``,
    ``ssd.step.forward``, ``ssd.step.loss``) while a profiler runs."""
    with span("ssd.step.targets"):
        labels = batch_targets(batch, anchors, cfg)
    with span("ssd.step.forward"):
        logits, locs = model_outputs(params, batch["images"], cfg, forward, shards)
    with span("ssd.step.loss"):
        losses = total_loss(logits, locs, labels, params, cfg.model.num_classes,
                            cfg.weight_decay, shards)
    return losses, logits, locs


def detect(logits, locs, anchors, cfg: TrainConfig):
    """The decoded detections of the predictions (``None`` when
    ``cfg.detect`` is), with no gradient."""
    if cfg.detect is None:
        return None
    with torch.no_grad():
        return decode_detections(torch.softmax(logits.detach(), dim=-1), locs.detach(), anchors,
                                 cfg.detect)


def _anchors_on(anchors, cache: dict, device):
    if device not in cache:
        cache[device] = anchors.to(device)
    return cache[device]


def make_train_step(cfg: TrainConfig, anchors, forward=None):
    """Build the train step ``(state, batch) -> (state, losses, detections)``.

    ``batch`` holds ``images (B, H, W, 3)``, ``gt_boxes (B, G, 4)``,
    ``gt_labels (B, G)`` and ``gt_mask (B, G)`` (tensors or numpy; moved to
    the state's device). ``forward`` overrides the model forward
    ``(params, images) -> (logits, locs)``. The step returns a new state and
    leaves the old one as it was; ``losses`` are detached 0-d tensors. The
    gradients and losses of a state placed on a mesh are averaged over its
    ``data`` group, and a tensor-parallel state runs conv6 / conv7 over its
    ``model`` group; a state on no mesh takes no collective (the module
    doc). While a profiler runs, the step's parts are spans, in order:
    ``ssd.step.targets``, ``.forward``, ``.loss`` (:func:`loss_terms`),
    ``.backward`` (any remat recompute in it), ``.optimizer`` (the update,
    not the mesh's averaging) and ``.detect``.
    """
    tx = make_optimizer(cfg)
    anchors = torch.as_tensor(np.asarray(anchors, dtype=np.float32))
    cache = {}

    def step_fn(state: TrainState, batch):
        device = _device_of(state.params)
        batch = _batch_on(batch, device)
        anc = _anchors_on(anchors, cache, device)
        leaves = tree_map(lambda v: v.detach().requires_grad_(True), state.params)
        shards = model_shards(state.mesh, state.tensor_parallel)
        with full_float32(cfg.model.dtype):
            losses, logits, locs = loss_terms(leaves, batch, anc, cfg, forward, shards)
            flat = [v for d in leaves.values() for v in d.values()]
            with span("ssd.step.backward"):
                flat_grads = list(torch.autograd.grad(losses["total"], flat))
        losses = {k: v.detach().reshape(()).clone() for k, v in losses.items()}
        with torch.no_grad():
            if state.mesh is not None:
                average(flat_grads + list(losses.values()), state.mesh.get_group("data"))
            flat_grads = iter(flat_grads)
            grads = tree_map(lambda _: next(flat_grads), leaves)
            with span("ssd.step.optimizer"):
                params, opt_state = tx.update(grads, state.opt_state, state.params)
        with span("ssd.step.detect"):
            dets = detect(logits, locs, anc, cfg)
        new = dataclasses.replace(state, params=params, opt_state=opt_state, step=state.step + 1)
        return new, losses, dets

    return step_fn


def make_eval_step(cfg: TrainConfig, anchors, forward=None, mesh=None,
                   tensor_parallel: bool = False):
    """Build the eval step ``(params, batch) -> (losses, detections)``: the
    train step's losses (given a ``mesh``, the global batch's, averaged
    over its ``data`` group) and detections, no gradient and
    no update. ``params`` of a state that ``shard_state`` placed on
    ``mesh`` with ``tensor_parallel`` need the same two arguments here."""
    shards = model_shards(mesh, tensor_parallel)
    anchors = torch.as_tensor(np.asarray(anchors, dtype=np.float32))
    cache = {}

    def step_fn(params, batch):
        device = _device_of(params)
        batch = _batch_on(batch, device)
        anc = _anchors_on(anchors, cache, device)
        with torch.no_grad(), full_float32(cfg.model.dtype):
            losses, logits, locs = loss_terms(params, batch, anc, cfg, forward, shards)
            losses = {k: v.reshape(()).clone() for k, v in losses.items()}
            if mesh is not None:
                average(list(losses.values()), mesh.get_group("data"))
        return losses, detect(logits, locs, anc, cfg)

    return step_fn


def shard_state(state: TrainState, mesh, tensor_parallel: bool = False) -> TrainState:
    """A copy of ``state`` placed on ``mesh``: on this process's device,
    parameters, momentum, count and step replicated from rank 0 (one
    broadcast); with ``tensor_parallel`` on a mesh with ``model`` > 1, each
    process then keeps its slice of conv6 / conv7 and of their momentum
    (``sharding.shard_params``). The state records ``mesh``, for the train
    step and the checkpoint writer. ``mesh=None`` (one process, no group)
    returns ``state``."""
    if mesh is None:
        return state
    device = mesh_device(mesh)
    params = tree_map(lambda v: v.detach().to(device, torch.float32, copy=True), state.params)
    trace = tree_map(lambda v: v.detach().to(device, torch.float32, copy=True),
                     state.opt_state.trace)
    counters = torch.tensor([state.opt_state.count, state.step], dtype=torch.float64,
                            device=device)
    replicate([v for t in (params, trace) for d in t.values() for v in d.values()])
    dist.broadcast(counters, src=0)
    count, step = (int(v) for v in counters.tolist())
    tensor_parallel = use_tensor_parallel(mesh, tensor_parallel)
    if tensor_parallel:
        params, trace = shard_params(params, mesh), shard_params(trace, mesh)
    return TrainState(params=params, opt_state=SGDState(trace=trace, count=count), step=step,
                      mesh=mesh, tensor_parallel=tensor_parallel)


def shard_batch(batch, mesh):
    """This process's rows of a global host batch (its leading dimension
    split over the mesh's ``data`` dimension, in order), on its device.
    ``mesh=None`` returns ``batch``."""
    if mesh is None:
        return batch
    rows = batch_rows(len(next(iter(batch.values()))), mesh)
    return _batch_on({k: v[rows] for k, v in batch.items()}, mesh_device(mesh))
