"""Training: the train and eval steps (``train_step``), the process group
and the ``(data, model)`` mesh (``mesh``), data- and tensor-parallel
placement (``sharding``, ``multihost``, ``tensor_parallel``), host ->
device prefetch (``prefetch``) and rematerialization (``remat``)."""

from ssd_tensorflow_tpu_torch import lazy_exports

#: the JAX package's public names, each imported from its module on first use
_EXPORTS = {
    "make_mesh": "mesh",
    "TrainConfig": "train_step",
    "TrainState": "train_step",
    "lr_schedule": "train_step",
    "make_eval_step": "train_step",
    "make_train_state": "train_step",
    "make_train_step": "train_step",
}
__all__ = list(_EXPORTS)
__getattr__ = lazy_exports(__name__, _EXPORTS)
