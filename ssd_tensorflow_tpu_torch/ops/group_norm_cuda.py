"""GroupNorm with the activation after it: the hand-written kernel's wrapper.

:func:`group_norm_cuda` runs ``csrc/group_norm.cu``: the GroupNorm of an
NHWC bf16 or float32 tensor (float64-summed statistics, a float64 rsqrt,
each rounded once; every elementwise step one float32 operation; one
rounding to the input dtype), then an optional skip added in float32 and
rounded once, then ReLU or ReLU6. One launch a call, counted in
``group_norm_cuda.launches``. Its plain version is
``models/resnet.group_norm`` followed by the plain skip add and
activation, which the kernel equals bit for bit; the source note in
``csrc/group_norm.cu`` says what bounds the kernel and how its design
meets that.

:func:`engages` is the route rule the families' walks use: the kernel
takes a CUDA tensor of a dtype it has, unless autograd needs a gradient
through it. Everything else (CPU tensors, the train steps'
differentiable forwards) takes the plain PyTorch function. A width the
kernel's layout does not take (:func:`channels_fit`) is no reason to
leave the card's route: :func:`group_norm_cuda` raises on it.
"""

from __future__ import annotations

import contextlib
import ctypes
import functools

import torch

from ssd_tensorflow_tpu_torch.ops import _build

#: the dtypes the kernel takes
DTYPES = (torch.bfloat16, torch.float32)
#: the epilogues, as the kernel numbers them
ACTIVATIONS = {None: 0, "relu": 1, "relu6": 2}
#: what a pixel's channels may come to in the kernel's block layout
#: (csrc/group_norm.cu): vectors of 16 bytes, or single channels
MAX_VECTORS, MAX_CHANNELS = 256, 1024


def channels_fit(c: int, dtype) -> bool:
    """True when ``c`` channels fit the kernel's layout: at most
    :data:`MAX_VECTORS` vectors of 16 bytes a pixel when ``c`` divides into
    them, else at most :data:`MAX_CHANNELS` channels."""
    vec = 16 // dtype.itemsize
    return c <= MAX_CHANNELS or (c % vec == 0 and c // vec <= MAX_VECTORS)


def eligible(x, *operands) -> bool:
    """The route rule without the device: ``x`` is NHWC of a dtype the
    kernel has, and autograd needs no gradient through it (grad mode off,
    or neither ``x`` nor any of ``operands`` requires one; ``None``
    operands are skipped)."""
    if x.dim() != 4 or x.dtype not in DTYPES:
        return False
    return not (torch.is_grad_enabled()
                and any(t is not None and t.requires_grad for t in (x, *operands)))


def engages(x, *operands) -> bool:
    """The route rule: ``x`` lies on the card and is :func:`eligible`."""
    return x.device.type == "cuda" and eligible(x, *operands)


@functools.cache
def _launcher():
    fn = _build.libraries()["group_norm"].group_norm_launch
    fn.argtypes = ([ctypes.c_void_p] * 5 + [ctypes.c_int] * 7 + [ctypes.c_float]
                   + [ctypes.c_longlong] * 3 + [ctypes.c_void_p])
    fn.restype = ctypes.c_int
    return fn


def _check(x, scale, bias, groups: int, act, skip):
    shape, dtype = x.shape, x.dtype
    if len(shape) != 4:
        raise ValueError(f"group_norm_cuda: x must be NHWC (B, H, W, C), got {tuple(shape)}")
    if dtype not in DTYPES:
        raise ValueError(f"group_norm_cuda: x must be bf16 or float32, got {dtype}")
    if not x.is_contiguous():
        raise ValueError("group_norm_cuda: x must be contiguous NHWC")
    c = shape[3]
    if not channels_fit(c, dtype):
        raise ValueError(f"group_norm_cuda: {c} channels of {dtype} exceed the kernel's layout")
    if groups <= 0 or c % groups:
        raise ValueError(f"group_norm_cuda: {groups} groups do not divide {c} channels")
    if act not in ACTIVATIONS:
        raise ValueError(f"group_norm_cuda: act must be one of {list(ACTIVATIONS)}, got {act!r}")
    device = x.device
    if device.type != "cuda":
        raise ValueError(f"group_norm_cuda: x must be a CUDA tensor, got {device}")
    for name, t in (("scale", scale), ("bias", bias)):
        if (t.dtype is not torch.float32 or t.shape != (c,) or not t.is_contiguous()
                or t.device != device):
            raise ValueError(f"group_norm_cuda: {name} must be contiguous float32 ({c},) on "
                             f"{device}, got {tuple(t.shape)} {t.dtype} on {t.device}")
    if skip is not None and (skip.shape != shape or skip.dtype is not dtype
                             or skip.stride(-1) != 1 or skip.device != device):
        raise ValueError(f"group_norm_cuda: skip must be {tuple(shape)} {dtype} on {device} with "
                         f"contiguous channels, got {tuple(skip.shape)} {skip.dtype} on "
                         f"{skip.device}")


#: what :func:`_call` enters for a tensor on the current device: no switch
_HERE = contextlib.nullcontext()


def _call(x, scale, bias, groups, eps, act, skip, out):
    b, h, w, c = x.shape
    strides = skip.stride()[:3] if skip is not None else (0, 0, 0)
    index = x.device.index
    with _HERE if index == torch.cuda.current_device() else torch.cuda.device(index):
        rc = _launcher()(x.data_ptr(), scale.data_ptr(), bias.data_ptr(),
                         None if skip is None else skip.data_ptr(), out.data_ptr(),
                         b, h, w, c, groups, int(x.dtype is torch.float32), ACTIVATIONS[act],
                         eps, *strides, torch.cuda.current_stream(index).cuda_stream)
    _build.check(rc, "group_norm_cuda")


def group_norm_cuda(x, scale, bias, groups: int, eps: float = 1e-5, act=None, skip=None):
    """GroupNorm of NHWC ``x`` in ``groups`` groups, then the epilogue:
    ``act(dtype(float32(y) + float32(skip)))`` with ``y`` the GroupNorm
    rounded to ``x.dtype`` (no skip: ``act(y)``), ``act`` None, ``"relu"``
    or ``"relu6"``. ``x`` contiguous bf16 or float32 on the card; ``scale``
    and ``bias`` contiguous float32 ``(C,)``; ``skip`` of ``x``'s shape and
    dtype with contiguous channels (a strided slice will do). Raises on
    anything else, before the kernel is built. One launch, counted in
    ``group_norm_cuda.launches``."""
    _check(x, scale, bias, groups, act, skip)
    out = torch.empty_like(x)
    if x.numel() == 0:
        return out
    _call(x, scale, bias, groups, eps, act, skip, out)
    group_norm_cuda.launches += 1
    return out


group_norm_cuda.launches = 0
