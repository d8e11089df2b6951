"""Layers, the VGG-16 trunk and the SSD-VGG detector."""

from ssd_tensorflow_tpu_torch import lazy_exports

#: the JAX package's public names, each imported from its module on first use
_EXPORTS = {
    "ModelConfig": "ssd_vgg",
    "SSDVGG": "ssd_vgg",
    "QuantizedModel": "quantized",
    "apply_model": "ssd_vgg",
    "init_params": "ssd_vgg",
    "multibox_loss": "loss",
    "l2_regularizer": "loss",
}
__all__ = list(_EXPORTS)
__getattr__ = lazy_exports(__name__, _EXPORTS)
