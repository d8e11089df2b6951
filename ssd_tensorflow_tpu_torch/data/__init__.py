"""Input-side modules: the dataset sources (``sources``, ``source_*``), host
image I/O (``image_io``), the host data pipeline and the batched
on-device augmentation (``device_augment``)."""

from ssd_tensorflow_tpu_torch import lazy_exports

#: the JAX package's public names, each imported from its module on first use
_EXPORTS = {
    "load_data_source": "sources",
    "TrainingData": "pipeline",
}
__all__ = list(_EXPORTS)
__getattr__ = lazy_exports(__name__, _EXPORTS)
