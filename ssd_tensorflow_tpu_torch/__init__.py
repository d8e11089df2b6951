"""ssd_tensorflow_tpu_torch — the SSD detector in PyTorch for NVIDIA Hopper.

A port of the JAX package ``ssd_tensorflow_tpu`` that runs on an H100.
It imports ``torch`` and ``numpy`` and nothing of JAX or of the JAX
package. Public functions keep the JAX package's layouts (NHWC images,
``(B, A)`` / ``(B, A, 4)`` scores, ``(xmin, xmax, ymin, ymax)`` canvas
corners), so both can be held against each other on the same inputs.

Every TPU kernel of the JAX package is a hand-written CUDA kernel for
``sm_90a`` here (``csrc/``): the split conv1_2 + pool1 stem and the whole
uint8 stem (``ops/stem_cuda.py``), the fused IoU + greedy NMS
(``ops/nms_cuda.py``), and the stem probes' kernels
(``ops/stem_probe.py``). The int8 W8A8 deploy path
(``models/quantized.py``) runs each convolution, quantize, integer
product and requantize, as one hand-written kernel
(``csrc/int8_conv.cu``, ``ops/int8_conv.int8_qconv``), where the JAX
package leaves the product to XLA, outside any Pallas kernel; the
earlier route of three passes around im2col and ``torch._int_mm`` stays
as the kernel's bit-exact yardstick on the card. Entry points run on
``device="cuda"`` unless the caller asks for the CPU; on the CPU each
kernel's wrapper runs its plain PyTorch version.
"""

from __future__ import annotations

import torch

from ssd_tensorflow_tpu_torch.presets import SSD_PRESETS, SSDPreset, get_preset_by_name
from ssd_tensorflow_tpu_torch.types import Box, Label, Point, Sample, Size

__version__ = "0.1.0"


def resolve_device(device) -> torch.device:
    """``device`` as a ``torch.device``; raises when CUDA is asked for
    and there is none — the port never quietly runs on the CPU."""
    dev = torch.device(device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            f"device {device!r} requested but torch.cuda.is_available() is "
            "False; pass device='cpu' to run the plain PyTorch path"
        )
    return dev


def lazy_exports(package: str, names: dict):
    """The ``__getattr__`` of a subpackage that exports ``names`` (public
    name -> its module in ``package``): each is imported on first use, so
    that importing one module of the subpackage loads no other."""
    import importlib

    def __getattr__(name):
        if name not in names:
            raise AttributeError(f"module {package!r} has no attribute {name!r}")
        return getattr(importlib.import_module(f"{package}.{names[name]}"), name)

    return __getattr__


__all__ = [
    "Box",
    "Label",
    "Point",
    "Sample",
    "Size",
    "SSDPreset",
    "SSD_PRESETS",
    "get_preset_by_name",
    "resolve_device",
    "__version__",
]
