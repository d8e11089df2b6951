"""Host utilities: checkpoints, the TensorBoard event writer, training
summaries and profiling."""

from ssd_tensorflow_tpu_torch import lazy_exports

#: the JAX package's public names, each imported from its module on first use
_EXPORTS = {
    "CheckpointManager": "checkpoint",
    "find_checkpoint": "checkpoint",
    "restore_checkpoint": "checkpoint",
    "save_checkpoint": "checkpoint",
    "SummaryWriter": "tensorboard",
}
__all__ = list(_EXPORTS)
__getattr__ = lazy_exports(__name__, _EXPORTS)
