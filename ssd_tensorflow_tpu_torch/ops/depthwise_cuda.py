"""Depthwise 3x3 convolution of NHWC bf16 maps: the hand-written kernel's wrapper.

:func:`depthwise_cuda` runs ``csrc/depthwise_conv.cu``: the depthwise
3x3 conv of an NHWC bf16 map with a ``(C, 1, 3, 3)`` bf16 filter at
stride 1 or 2 with explicit zero padding (TF SAME, symmetric or not, is
the caller's ``layers._pads``): each output the float32 sum of its 9
products in the tap order ky, then kx, then the epilogue of the caller's
``f32_out``, and one launch a call, counted in ``depthwise_cuda.launches``.
Its plain version :func:`depthwise_plain` is the same sum over shifted
slices of the padded map, which the kernel equals bit for bit; the source
note in ``csrc/depthwise_conv.cu`` says what bounds the kernel and how its
design meets that.

:func:`engages` is the route rule of ``models/layers.depthwise_conv2d``:
the kernel takes a CUDA bf16 tensor unless autograd needs a gradient
through it. Everything else (CPU tensors, float32 maps, the train and QAT
steps' differentiable forwards) keeps ``F.conv2d(groups=C)``. A shape the
kernel does not take is no reason to leave the card's route:
:func:`depthwise_cuda` raises on it.
"""

from __future__ import annotations

import contextlib
import ctypes
import functools

import torch
import torch.nn.functional as F

from ssd_tensorflow_tpu_torch.ops import _build

#: the epilogues, as the kernel numbers them: no bias, a float32 bias
#: before the one rounding, a bf16 bias after it (two roundings)
EPILOGUES = {"none": 0, "f32": 1, "bf16": 2}


def eligible(x, *operands) -> bool:
    """The route rule without the device: ``x`` is an NHWC bf16 map and
    autograd needs no gradient through it (grad mode off, or neither ``x``
    nor any of ``operands`` requires one; ``None`` operands are skipped)."""
    if x.dim() != 4 or x.dtype is not torch.bfloat16:
        return False
    return not (torch.is_grad_enabled()
                and any(t is not None and t.requires_grad for t in (x, *operands)))


def engages(x, *operands) -> bool:
    """The route rule: ``x`` lies on the card and is :func:`eligible`."""
    return x.device.type == "cuda" and eligible(x, *operands)


def out_size(size: int, pads, stride: int) -> int:
    """Outputs along an axis of ``size`` inputs padded by ``pads`` (before,
    after) for a 3-tap window at ``stride``."""
    return (size + pads[0] + pads[1] - 3) // stride + 1


def depthwise_plain(x, w, b, stride: int, pads, f32_out: bool):
    """The kernel's function in plain PyTorch, on any device: ``x`` padded
    with zeros by ``pads`` ``((top, bottom), (left, right))``, the float32
    sum ``acc + x_tap * w_tap`` over the 9 taps in the order ky, then kx
    (each bf16 product exact in float32), then with ``f32_out``
    ``bf16(acc + float32(b))``, else ``bf16(bf16(acc) + bf16(b))``; no
    bias: ``bf16(acc)``. Arguments as :func:`depthwise_cuda`'s."""
    (top, bottom), (left, right) = pads
    bsz, h, wd, c = x.shape
    ho, wo = out_size(h, (top, bottom), stride), out_size(wd, (left, right), stride)
    xp = F.pad(x.float(), (0, 0, left, right, top, bottom))
    taps = w.to(x.dtype).float().reshape(c, 9)
    acc = torch.zeros((bsz, ho, wo, c), dtype=torch.float32, device=x.device)
    for ky in range(3):
        for kx in range(3):
            rows = slice(ky, ky + stride * (ho - 1) + 1, stride)
            cols = slice(kx, kx + stride * (wo - 1) + 1, stride)
            acc = acc + xp[:, rows, cols, :] * taps[:, 3 * ky + kx]
    if b is None:
        return acc.to(x.dtype)
    if f32_out:
        return (acc + b.float()).to(x.dtype)
    return acc.to(x.dtype) + b.to(x.dtype)


@functools.cache
def _launcher():
    fn = _build.libraries()["depthwise_conv"].depthwise3x3_launch
    fn.argtypes = [ctypes.c_void_p] * 4 + [ctypes.c_int] * 10 + [ctypes.c_void_p]
    fn.restype = ctypes.c_int
    return fn


def _epilogue(x, w, b, stride, pads, f32_out) -> str:
    """The kernel's epilogue for these arguments; raises ValueError on what
    the kernel does not take (the device last)."""
    if x.dim() != 4 or x.dtype is not torch.bfloat16:
        raise ValueError(f"depthwise_cuda: x must be NHWC bf16, got {tuple(x.shape)} {x.dtype}")
    if not x.is_contiguous():
        raise ValueError("depthwise_cuda: x must be contiguous NHWC")
    device, c = x.device, x.shape[3]
    if c % 8:
        raise ValueError(f"depthwise_cuda: {c} channels are not a multiple of 8")
    if (w.shape != (c, 1, 3, 3) or w.dtype is not torch.bfloat16 or not w.is_contiguous()
            or w.device != device):
        raise ValueError(f"depthwise_cuda: w must be a contiguous bf16 ({c}, 1, 3, 3) filter on "
                         f"{device}, got {tuple(w.shape)} {w.dtype} on {w.device}")
    if stride not in (1, 2):
        raise ValueError(f"depthwise_cuda: stride must be 1 or 2, got {stride}")
    (top, bottom), (left, right) = pads
    if min(top, bottom, left, right) < 0 or out_size(x.shape[1], pads[0], stride) < 1 \
            or out_size(x.shape[2], pads[1], stride) < 1:
        raise ValueError(f"depthwise_cuda: padding {pads} of a {tuple(x.shape[1:3])} map "
                         f"leaves no output")
    epilogue = "none" if b is None else "f32" if f32_out else "bf16"
    want = torch.float32 if f32_out else torch.bfloat16
    if b is not None and (b.shape != (c,) or b.dtype is not want or not b.is_contiguous()
                          or b.device != device):
        raise ValueError(f"depthwise_cuda: b must be a contiguous {want} ({c},) on {device}, "
                         f"got {tuple(b.shape)} {b.dtype} on {b.device}")
    if device.type != "cuda":
        raise ValueError(f"depthwise_cuda: x must be a CUDA tensor, got {device}")
    if x.data_ptr() % 16:
        raise ValueError("depthwise_cuda: x must start on a 16-byte boundary")
    return epilogue


#: what :func:`depthwise_cuda` enters for a tensor on the current device: no switch
_HERE = contextlib.nullcontext()


def depthwise_cuda(x, w, b, stride: int, pads, f32_out: bool):
    """Depthwise 3x3 conv of ``x`` (B, H, W, C), contiguous bf16 on the card
    with C a multiple of 8, by ``w`` (C, 1, 3, 3) contiguous bf16, at
    ``stride`` 1 or 2, zero-padded by ``pads`` ``((top, bottom), (left,
    right))``; ``b`` None, or (C,) float32 with ``f32_out`` (added before
    the one rounding) or bf16 without (added after it, rounded again).
    Returns the bf16 (B, Ho, Wo, C) map, :func:`depthwise_plain` bit for
    bit. Raises ValueError on anything else, before the kernel is built.
    One launch on the current stream, counted in
    ``depthwise_cuda.launches``; it allocates only the output and never
    synchronises, so it may be captured in a CUDA graph."""
    epilogue = _epilogue(x, w, b, stride, pads, f32_out)
    bsz, h, wd, c = x.shape
    ho, wo = out_size(h, pads[0], stride), out_size(wd, pads[1], stride)
    out = torch.empty((bsz, ho, wo, c), dtype=x.dtype, device=x.device)
    if out.numel() == 0:
        return out
    index = x.device.index
    with _HERE if index == torch.cuda.current_device() else torch.cuda.device(index):
        rc = _launcher()(x.data_ptr(), w.data_ptr(), None if b is None else b.data_ptr(),
                         out.data_ptr(), bsz, h, wd, c, ho, wo, stride, pads[0][0], pads[1][0],
                         EPILOGUES[epilogue], torch.cuda.current_stream(index).cuda_stream)
    _build.check(rc, "depthwise_cuda")
    depthwise_cuda.launches += 1
    return out


depthwise_cuda.launches = 0
