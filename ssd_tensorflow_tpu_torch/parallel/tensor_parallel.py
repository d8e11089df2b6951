"""Tensor parallelism of the a-trous conv6 / conv7 over the ``model``
dimension of the mesh.

Each process of a ``model`` group of ``m`` holds ``1/m`` of conv6's output
channels (with their bias) and the same share of conv7's input channels
(``sharding._TP_RULES``). conv6 runs column-parallel: its shard of the
channels, bias and ReLU local. conv7 runs row-parallel: a conv without
bias over its input-channel shard gives a float32 partial sum, the
partials are summed over the group, then the bias is added, the ReLU
applied and the result rounded once into the compute dtype, the one
rounding of every other conv + bias.

Two autograd functions carry the collectives, each an ``all_reduce``
over the ``model`` group and nothing else (so gloo over CUDA tensors
runs them as well as NCCL): :func:`copy_to_model` before conv6 (identity
forward; backward sums the input gradient of every shard) and
:func:`reduce_from_model` after conv7's partial conv (sums forward;
identity backward). Under remat the forward runs again in the backward
pass, collective included, in the same order on every process.

The model code imports none of this: the train and eval steps hand it a
:class:`ModelShards` of the mesh the state was sharded on
(``models/ssd_vgg.apply_model``'s and ``models/loss.l2_regularizer``'s
``shards``), and the forward runs its float conv executor through
:meth:`ModelShards.conv_executor`, where this sharding rule lives.
"""

from __future__ import annotations

import torch
import torch.distributed as dist

from ssd_tensorflow_tpu_torch.models.layers import conv2d
from ssd_tensorflow_tpu_torch.parallel.sharding import _TP_RULES, use_tensor_parallel


def _all_reduce_f32(x, group):
    """The float32 sum of ``x`` over ``group`` (a new contiguous tensor)."""
    y = x.to(torch.float32, memory_format=torch.contiguous_format, copy=True)
    dist.all_reduce(y, group=group)
    return y


class _CopyToModel(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, group):
        ctx.group = group
        return x.view_as(x)

    @staticmethod
    def backward(ctx, grad):
        return _all_reduce_f32(grad, ctx.group).to(grad.dtype), None


class _ReduceFromModel(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, group):
        return _all_reduce_f32(x, group)

    @staticmethod
    def backward(ctx, grad):
        return grad, None


def copy_to_model(x, group):
    """``x`` as it is; its gradient summed over ``group``."""
    return _CopyToModel.apply(x, group)


def reduce_from_model(x, group):
    """The float32 sum of ``x`` over ``group``; its gradient as it is."""
    return _ReduceFromModel.apply(x, group)


class ModelShards:
    """conv6 / conv7 split over the ``model`` group ``group``: what the
    forward and the L2 term need to run on this process's shards."""

    #: the layers split over the group
    layers = frozenset(_TP_RULES)

    def __init__(self, group):
        self.group = group

    def copy_in(self, x):
        """conv6's input: ``x``, its gradient summed over the group."""
        return copy_to_model(x, self.group)

    def sum(self, x):
        """The float32 sum of ``x`` over the group."""
        return reduce_from_model(x, self.group)

    def conv_executor(self, conv, params):
        """The conv executor ``conv`` (``layers.float_conv_executor``) over
        this process's shards: conv6's input through :meth:`copy_in`, then
        ``conv``; conv7 :meth:`row_conv_relu`; every other layer ``conv``."""

        def tp_conv(name, x, **kwargs):
            if name == "mod_conv6":
                return conv(name, self.copy_in(x), **kwargs)
            if name == "mod_conv7":
                return self.row_conv_relu(params[name], x)
            return conv(name, x, **kwargs)

        return tp_conv

    def row_conv_relu(self, layer, x):
        """conv7 of this process's input-channel shard: the bias-free
        conv's float32 partial sum, summed over the group, ``+ b``, ReLU,
        rounded once to ``x.dtype``."""
        partial = conv2d(x.float(), layer["w"].float())
        return torch.relu(self.sum(partial) + layer["b"].float()).to(x.dtype)


def model_shards(mesh, tensor_parallel: bool = True):
    """The :class:`ModelShards` of ``mesh``'s ``model`` group where
    ``tensor_parallel`` applies to it (``sharding.use_tensor_parallel``),
    else ``None``."""
    if not use_tensor_parallel(mesh, tensor_parallel):
        return None
    return ModelShards(mesh.get_group("model"))
