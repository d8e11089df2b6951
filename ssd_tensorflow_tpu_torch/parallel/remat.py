"""Rematerialization (activation checkpointing) of a forward.

``torch.utils.checkpoint`` (non-reentrant) in place of ``jax.checkpoint``:
the wrapped forward keeps fewer of its activations for the backward pass
and recomputes the rest there. Enabled by ``TrainConfig.remat``.
"""

from __future__ import annotations

import functools

import torch
from torch.utils.checkpoint import (
    CheckpointPolicy,
    checkpoint,
    create_selective_checkpoint_contexts,
)

#: the products whose outputs the selective policy keeps: matrix products
#: without batch dimensions, as the JAX package's policy
#: ``dots_with_no_batch_dims_saveable`` keeps ``dot_general`` without batch
#: dimensions. Convolutions (``conv_general_dilated`` there) and batched
#: products are recomputed, as there.
_SAVED_OPS = frozenset({
    torch.ops.aten.mm.default,
    torch.ops.aten.addmm.default,
})


def _dots_policy(ctx, op, *args, **kwargs):
    return CheckpointPolicy.MUST_SAVE if op in _SAVED_OPS else CheckpointPolicy.PREFER_RECOMPUTE


def checkpoint_backbone(apply_fn):
    """``apply_fn`` with full rematerialization: only its inputs are kept,
    the whole forward runs again in the backward pass."""

    @functools.wraps(apply_fn)
    def fn(*args):
        return checkpoint(apply_fn, *args, use_reentrant=False)

    return fn


def checkpoint_dots_only(apply_fn):
    """``apply_fn`` keeping the outputs of its matrix products without
    batch dimensions and recomputing everything else (convolutions, bias
    adds, ReLUs, pools, normalizations) in the backward pass. The SSD
    models have no such product, so for them this is a whole-forward
    recompute, as the JAX package's policy is for its models."""

    @functools.wraps(apply_fn)
    def fn(*args):
        return checkpoint(apply_fn, *args, use_reentrant=False,
                          context_fn=functools.partial(create_selective_checkpoint_contexts,
                                                       _dots_policy))

    return fn
