"""Batched greedy-NMS keep mask: the CUDA kernel and its plain version.

Replaces ``ssd_tensorflow_tpu/ops/nms_pallas.py`` (``nms_keep_pallas``).
The kernel (``csrc/nms.cu``) runs for CUDA tensors; CPU tensors take the
plain version, ``ops/nms.greedy_keep`` over ``ops/iou.pairwise_canvas_iou``,
which the kernel equals bit for bit. The source note in ``csrc/nms.cu``
says what bounds the kernel and how its design meets that.
"""

from __future__ import annotations

import ctypes
import functools

import torch

from ssd_tensorflow_tpu_torch.ops import _build
from ssd_tensorflow_tpu_torch.ops.iou import pairwise_canvas_iou
from ssd_tensorflow_tpu_torch.ops.nms import NMS_THRESHOLD, greedy_keep

#: Largest candidate count per image the kernel takes (csrc/nms.cu kMaxD).
MAX_CANDIDATES = 1024


def nms_keep_plain(corners, valid, threshold: float = NMS_THRESHOLD):
    """Plain PyTorch keep mask: same contract as :func:`nms_keep`."""
    return greedy_keep(pairwise_canvas_iou(corners, corners), valid, threshold)


@functools.cache
def _launcher():
    fn = _build.libraries()["nms"].nms_keep_launch
    fn.argtypes = [ctypes.c_void_p] * 3 + [ctypes.c_int, ctypes.c_int, ctypes.c_float,
                                           ctypes.c_void_p]
    fn.restype = ctypes.c_int
    return fn


def nms_keep(corners, valid, threshold: float = NMS_THRESHOLD):
    """Batched greedy-NMS keep mask.

    Args:
      corners: ``(B, D, 4)`` float32 canvas corners ``(xmin, xmax, ymin,
        ymax)``, already class-shifted, sorted by descending score.
      valid: ``(B, D)`` bool candidate mask; invalid candidates neither
        suppress nor get kept.
      threshold: IoU threshold.

    Returns:
      ``(B, D)`` bool keep mask. CUDA tensors run the kernel (and count
      one launch in ``nms_keep.launches``); CPU tensors the plain version.
    """
    if corners.device.type == "cpu":
        return nms_keep_plain(corners, valid, threshold)
    if corners.device.type != "cuda":
        raise ValueError(f"nms_keep: unsupported device {corners.device}")
    if corners.dim() != 3 or corners.shape[-1] != 4 or corners.dtype != torch.float32:
        raise ValueError(f"nms_keep: corners must be (B, D, 4) float32, got "
                         f"{tuple(corners.shape)} {corners.dtype}")
    b, d, _ = corners.shape
    if valid.shape != (b, d) or valid.dtype != torch.bool or valid.device != corners.device:
        raise ValueError(f"nms_keep: valid must be ({b}, {d}) bool on {corners.device}")
    if not (corners.is_contiguous() and valid.is_contiguous()) or corners.data_ptr() % 16:
        raise ValueError("nms_keep: corners (16-byte aligned) and valid must be contiguous")
    if d > MAX_CANDIDATES:
        raise ValueError(f"nms_keep: D={d} exceeds the kernel's {MAX_CANDIDATES} candidates")
    keep = torch.empty((b, d), dtype=torch.bool, device=corners.device)
    if b == 0 or d == 0:
        return keep
    with torch.cuda.device(corners.device):
        stream = torch.cuda.current_stream(corners.device).cuda_stream
        rc = _launcher()(corners.data_ptr(), valid.data_ptr(), keep.data_ptr(),
                         b, d, threshold, stream)
    _build.check(rc, "nms_keep")
    nms_keep.launches += 1
    return keep


nms_keep.launches = 0
