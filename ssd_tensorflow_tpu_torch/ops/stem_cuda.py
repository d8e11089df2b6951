"""VGG conv1_2 + pool1 stem: the CUDA kernel and its plain version.

Replaces ``ssd_tensorflow_tpu/ops/stem_pallas.py`` (``fused_stem_pallas_dma``):
conv1_1 runs outside the kernel (bf16 in and out, no bias, see
``models/vgg16.conv1_block``), the kernel (``csrc/stem.cu``) does b1 +
ReLU + the zero border, conv1_2 with float32 accumulation, b2 + ReLU and
the 2x2/s2 max-pool, so conv1_2's activation never reaches device
memory. CUDA tensors run the kernel; CPU tensors take the plain version,
which computes the same function in float32 from the same bf16 values.
The source note in ``csrc/stem.cu`` says what bounds the kernel and how
its design meets that.
"""

from __future__ import annotations

import ctypes
import functools

import torch
import torch.nn.functional as F

from ssd_tensorflow_tpu_torch.ops import _build

_C = 64


def fused_stem_plain(c1, b1, w2, b2):
    """Plain PyTorch version of :func:`fused_stem`, same contract.

    ``bf16(relu(c1 + b1))`` (zero SAME padding outside the image), then
    conv1_2 in float32 on the bf16 weights, + b2, ReLU, 2x2/s2 max-pool,
    rounded to bf16 once at the end.
    """
    y1 = torch.relu(c1.float() + b1.float()).to(torch.bfloat16).float()
    y = F.conv2d(
        y1.permute(0, 3, 1, 2),
        w2.to(torch.bfloat16).float(),
        b2.float(),
        padding=1,
    )
    y = F.max_pool2d(torch.relu(y), 2, 2)
    return y.to(torch.bfloat16).permute(0, 2, 3, 1).contiguous()


@functools.cache
def _launcher():
    fn = _build.libraries()["stem"].stem_launch
    fn.argtypes = [ctypes.c_void_p] * 5 + [ctypes.c_int] * 4 + [ctypes.c_void_p]
    fn.restype = ctypes.c_int
    return fn


@functools.cache
def _sm_count(index: int) -> int:
    return torch.cuda.get_device_properties(index).multi_processor_count


def fused_stem(c1, b1, w2, b2):
    """conv1_2 + ReLU + pool1 over conv1_1's un-biased output.

    Args:
      c1: ``(B, H, W, 64)`` bf16 NHWC, contiguous; H and W even.
      b1: ``(64,)`` conv1_1 bias.
      w2: ``(64, 64, 3, 3)`` conv1_2 weights (OIHW).
      b2: ``(64,)`` conv1_2 bias.

    Returns:
      ``(B, H/2, W/2, 64)`` bf16 pool1. CUDA tensors run the kernel (and
      count one launch in ``fused_stem.launches``); CPU tensors the plain
      version.
    """
    if c1.device.type == "cpu":
        return fused_stem_plain(c1, b1, w2, b2)
    if c1.device.type != "cuda":
        raise ValueError(f"fused_stem: unsupported device {c1.device}")
    if c1.dtype != torch.bfloat16 or c1.dim() != 4 or c1.shape[-1] != _C:
        raise ValueError(f"fused_stem: c1 must be (B, H, W, 64) bf16, got "
                         f"{tuple(c1.shape)} {c1.dtype}")
    if not c1.is_contiguous():
        raise ValueError("fused_stem: c1 must be contiguous NHWC")
    b, h, w, _ = c1.shape
    if h % 2 or w % 2:
        raise ValueError(f"fused_stem: H and W must be even, got {h}x{w}")
    if w2.shape != (_C, _C, 3, 3) or b1.shape != (_C,) or b2.shape != (_C,):
        raise ValueError("fused_stem: expected w2 (64, 64, 3, 3), b1 and b2 (64,)")
    if any(t.device != c1.device for t in (b1, w2, b2)):
        raise ValueError("fused_stem: all operands must be on one device")
    out = torch.empty((b, h // 2, w // 2, _C), dtype=torch.bfloat16, device=c1.device)
    if b == 0 or h == 0 or w == 0:
        return out
    # [dy*3 + dx][cout][cin], the kernel's shared-memory weight layout
    w2t = w2.to(torch.bfloat16).permute(2, 3, 0, 1).contiguous()
    b1f = b1.float().contiguous()
    b2f = b2.float().contiguous()
    tiles = b * -(-h // 16) * -(-w // 32)
    index = c1.device.index if c1.device.index is not None else torch.cuda.current_device()
    with torch.cuda.device(c1.device):
        stream = torch.cuda.current_stream(c1.device).cuda_stream
        rc = _launcher()(c1.data_ptr(), b1f.data_ptr(), w2t.data_ptr(), b2f.data_ptr(),
                         out.data_ptr(), b, h, w, min(tiles, _sm_count(index)), stream)
    _build.check(rc, "fused_stem")
    fused_stem.launches += 1
    return out


fused_stem.launches = 0
