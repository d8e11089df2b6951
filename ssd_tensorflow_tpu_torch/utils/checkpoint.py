"""Training checkpoints in the JAX package's npz format.

A checkpoint is an ``.npz`` of ``leaf_<i>`` arrays plus a ``__meta__`` JSON
entry (``{"num_leaves", "config"}``). The leaves follow the JAX
``TrainState``'s tree flattening, so that either package restores what
the other wrote:

1. the params, layers by sorted name and leaves by sorted key, filters HWIO;
2. optax's momentum trace, in the same order and layout;
3. the schedule's step count, an int32 scalar;
4. the train step, an int32 scalar.

Files are named ``e{N}.ckpt.npz`` per epoch and ``final.ckpt.npz`` at the
end; :class:`CheckpointManager` writes on a worker thread and keeps the
newest ``max_to_keep`` epochs. A training state crosses over as
``{"params", "trace", "count", "step"}`` in the JAX layout
(:func:`train_state_to_jax` / :func:`train_state_from_jax`);
:func:`read_params` reads only the params, for inference.
"""

from __future__ import annotations

import json
import os
import re
import threading
from concurrent.futures import ThreadPoolExecutor
from glob import glob
from typing import TYPE_CHECKING

import numpy as np
import torch

from ssd_tensorflow_tpu_torch.weights import params_from_jax, params_to_jax

if TYPE_CHECKING:
    from ssd_tensorflow_tpu_torch.parallel.train_step import TrainState

_CKPT_RE = re.compile(r"^e(\d+)\.ckpt\.npz$")


def _order(tree: dict):
    return [(name, key) for name in sorted(tree) for key in sorted(tree[name])]


def train_state_to_jax(state: TrainState) -> dict:
    """The port's ``TrainState`` -> ``{"params", "trace", "count", "step"}``
    in the JAX layout: float32 HWIO numpy trees, int32 scalars."""
    return {"params": params_to_jax(state.params), "trace": params_to_jax(state.opt_state.trace),
            "count": np.int32(state.opt_state.count), "step": np.int32(state.step)}


def train_state_from_jax(tree) -> TrainState:
    """``{"params", "trace", "count", "step"}`` in the JAX layout (the JAX
    ``TrainState``'s params, ``opt_state[0].trace``, ``opt_state[1].count``
    and step) -> the port's ``TrainState`` on the CPU."""
    # imported here: reading a checkpoint's params for inference
    # (read_params) loads nothing of the training step
    from ssd_tensorflow_tpu_torch.parallel.train_step import SGDState, TrainState

    return TrainState(params=params_from_jax(tree["params"]),
                      opt_state=SGDState(trace=params_from_jax(tree["trace"]),
                                         count=int(tree["count"])),
                      step=int(tree["step"]))


def _leaves(host: dict):
    """JAX-layout state (:func:`train_state_to_jax`) -> the leaf list."""
    order = _order(host["params"])
    return ([host["params"][n][k] for n, k in order] + [host["trace"][n][k] for n, k in order]
            + [np.asarray(host["count"], np.int32), np.asarray(host["step"], np.int32)])


def _write(path: str, leaves, config: dict | None):
    arrays = {f"leaf_{i}": np.asarray(leaf) for i, leaf in enumerate(leaves)}
    meta = {"num_leaves": len(leaves), "config": config or {}}
    arrays["__meta__"] = np.frombuffer(json.dumps(meta).encode(), dtype=np.uint8)
    tmp = path + ".tmp"
    with open(tmp, "wb") as f:
        np.savez(f, **arrays)
    os.replace(tmp, path)


def read_leaves(path: str):
    """``(meta, [leaf arrays])`` of a checkpoint file."""
    with np.load(path) as data:
        meta = json.loads(bytes(data["__meta__"]))
        return meta, [data[f"leaf_{i}"] for i in range(meta["num_leaves"])]


def _read_state(path: str, shapes: dict) -> dict:
    """The checkpoint at ``path`` as a JAX-layout state (see
    :func:`train_state_to_jax`) whose params and trace are shaped as
    ``shapes`` (``{layer: {leaf: HWIO shape}}``); raises when the leaf
    count or a shape differs."""
    order = _order(shapes)
    want = [tuple(shapes[n][k]) for n, k in order]
    want = want + want + [(), ()]
    _, leaves = read_leaves(path)
    if len(leaves) != len(want):
        raise ValueError(f"{path}: {len(leaves)} leaves, the model's train state has "
                         f"{len(want)}: was the model config changed?")
    for i, (leaf, shape) in enumerate(zip(leaves, want)):
        if tuple(leaf.shape) != shape:
            raise ValueError(f"{path}: leaf {i}: checkpoint shape {leaf.shape} != model {shape}")
    n = len(order)
    tree = {"params": {name: {} for name, _ in order}, "trace": {name: {} for name, _ in order},
            "count": leaves[2 * n], "step": leaves[2 * n + 1]}
    for i, (name, key) in enumerate(order):
        tree["params"][name][key] = leaves[i]
        tree["trace"][name][key] = leaves[n + i]
    return tree


def save_checkpoint(path: str, state: TrainState, config: dict | None = None):
    """Synchronously write ``state`` to ``path`` (.npz, atomic rename)."""
    _write(path, _leaves(train_state_to_jax(state)), config)


def read_params(path: str, shapes: dict) -> dict:
    """The port's parameters (float32 CPU tensors, OIHW) of the checkpoint
    at ``path``, whose model has the parameter ``shapes``
    (``ssd_vgg.param_shapes``)."""
    return params_from_jax(_read_state(path, shapes)["params"])


def _jax_shape(t: torch.Tensor):
    s = tuple(t.shape)
    return (s[2], s[3], s[1], s[0]) if len(s) == 4 else s


def restore_checkpoint(path: str, template_state: TrainState) -> TrainState:
    """Load ``path`` into a state shaped like ``template_state``, on the
    template's device; raises when the leaf count or a shape differs."""
    shapes = {name: {k: _jax_shape(v) for k, v in leaves.items()}
              for name, leaves in template_state.params.items()}
    state = train_state_from_jax(_read_state(path, shapes))
    device = next(iter(next(iter(template_state.params.values())).values())).device
    move = lambda t: {name: {k: v.to(device) for k, v in d.items()} for name, d in t.items()}
    state.params, state.opt_state.trace = move(state.params), move(state.opt_state.trace)
    return state


def checkpoint_config(path: str) -> dict:
    """The config dict stored in a checkpoint."""
    with np.load(path) as data:
        return json.loads(bytes(data["__meta__"]))["config"]


def find_checkpoint(directory: str, epoch: int = -1):
    """``(path, epoch)`` of the checkpoint of ``epoch`` in ``directory``, or
    ``(None, None)``. ``epoch=-1`` picks the furthest along: the highest
    ``e{N}``, or ``final.ckpt.npz`` where its stored epoch is higher (a
    graceful shutdown stamps the reached epoch only there)."""
    found = {}
    for p in glob(os.path.join(directory, "e*.ckpt.npz")):
        m = _CKPT_RE.match(os.path.basename(p))
        if m:
            found[int(m.group(1))] = p
    final = os.path.join(directory, "final.ckpt.npz")
    if epoch == -1:
        best = max(found) if found else None
        if os.path.exists(final):
            e = checkpoint_config(final).get("epoch")
            if best is None or (e is not None and e > best):
                return final, e
        if best is not None:
            return found[best], best
        return None, None
    if epoch in found:
        return found[epoch], epoch
    return None, None


class CheckpointManager:
    """Epoch checkpoints written on a worker thread, newest
    ``max_to_keep`` kept.

    ``save(epoch, state)`` copies the state to host memory before it
    returns, so training may go on at once; ``wait()`` drains the pending
    writes and raises any error of theirs; ``close()`` also stops the
    worker.
    """

    def __init__(self, directory: str, config: dict | None = None, max_to_keep: int = 20):
        self.directory = directory
        self.config = config
        self.max_to_keep = max_to_keep
        os.makedirs(directory, exist_ok=True)
        self._pool = ThreadPoolExecutor(max_workers=1)
        self._pending = []
        self._lock = threading.Lock()

    def _prune(self):
        epochs = sorted(int(m.group(1)) for m in (
            _CKPT_RE.match(os.path.basename(p))
            for p in glob(os.path.join(self.directory, "e*.ckpt.npz"))) if m)
        for e in epochs[: max(0, len(epochs) - self.max_to_keep)]:
            try:
                os.remove(os.path.join(self.directory, f"e{e}.ckpt.npz"))
            except FileNotFoundError:
                pass

    def save(self, epoch, state: TrainState, final: bool = False) -> str:
        leaves = _leaves(train_state_to_jax(state))
        path = os.path.join(self.directory, "final.ckpt.npz" if final else f"e{epoch}.ckpt.npz")
        config = dict(self.config or {}, epoch=int(epoch))

        def work():
            _write(path, leaves, config)
            with self._lock:
                self._prune()
            return path

        self._pending.append(self._pool.submit(work))
        return path

    def wait(self):
        pending, self._pending = self._pending, []
        for fut in pending:
            fut.result()

    def close(self):
        try:
            self.wait()
        finally:
            self._pool.shutdown()
