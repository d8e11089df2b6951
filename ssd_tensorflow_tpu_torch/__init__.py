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
(``models/quantized.py``) computes its integer convolutions by im2col and
``torch._int_mm`` (``ops/int8_conv.py``): the JAX package leaves that
product to XLA, outside any Pallas kernel. Entry points run on
``device="cuda"`` unless the caller asks for the CPU; on the CPU each
kernel's wrapper runs its plain PyTorch version.
"""

from __future__ import annotations

import torch

from ssd_tensorflow_tpu_torch.presets import SSD_PRESETS, SSDPreset, get_preset_by_name
from ssd_tensorflow_tpu_torch.types import Box, Point, Size

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


__all__ = [
    "Box",
    "Point",
    "Size",
    "SSDPreset",
    "SSD_PRESETS",
    "get_preset_by_name",
    "resolve_device",
    "__version__",
]
