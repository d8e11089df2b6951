"""Primitive layers as plain functions on NHWC tensors.

Activations are NHWC at every function boundary, as in the JAX package.
Inside, a convolution or pool sees the NHWC tensor through a
``permute(0, 3, 1, 2)`` view, which is an NCHW tensor in channels-last
memory: cuDNN (and oneDNN on the CPU) runs it as such and returns
channels-last, so no layout copy is made. Weights are OIHW.

``padding="SAME"`` follows TF semantics, which is asymmetric whenever the
total padding is odd (the stride-2 extras pad 0 on top and 1 at the
bottom); max-pooling is SAME ceil mode with -inf padding. An int
``padding`` pads that many pixels on every side, PyTorch's symmetric
rule (RetinaNet's ``k // 2``), for convolutions and pools alike.
"""

from __future__ import annotations

import contextlib
import functools

import numpy as np
import torch
import torch.nn.functional as F

from ssd_tensorflow_tpu_torch.utils.profiling import counted_span


def _same_pads(size: int, window: int, stride: int, dilation: int = 1):
    """TF SAME padding (before, after) along one axis."""
    out = -(-size // stride)
    eff = (window - 1) * dilation + 1
    total = max((out - 1) * stride + eff - size, 0)
    return total // 2, total - total // 2


def _same_input(x, w, stride, padding, dilation):
    """``(NCHW channels-last view of x, symmetric pads)`` for a convolution
    with OIHW ``w``: an asymmetric TF-SAME padding is applied to ``x``
    here, a symmetric one (or an int ``padding``) is left to the
    convolution."""
    pad = (0, 0)
    if isinstance(padding, int):
        pad = (padding, padding)
    elif padding == "SAME":
        ph = _same_pads(x.shape[1], w.shape[2], stride, dilation)
        pw = _same_pads(x.shape[2], w.shape[3], stride, dilation)
        if ph[0] == ph[1] and pw[0] == pw[1]:
            pad = (ph[0], pw[0])
        else:
            x = F.pad(x, (0, 0, pw[0], pw[1], ph[0], ph[1]))
    elif padding != "VALID":
        raise ValueError(f"padding must be 'SAME', 'VALID' or an int, got {padding!r}")
    return x.permute(0, 3, 1, 2), pad


def conv2d(x, w, b=None, stride=1, padding="SAME", dilation=1):
    """2-D convolution of NHWC ``x`` with OIHW ``w``, optional bias.

    Computes in ``x.dtype``. A bf16 convolution accumulates in float32
    and rounds its output to bf16, as the JAX package's
    ``conv2d(..., f32_out=True)`` does. With a bias, a bf16 convolution on
    the CPU runs in float32 from the bf16 operands (every product is
    exact there), adds the float32 bias and rounds once, as that JAX
    conv does; on the card a bias goes to ``F.conv2d`` in ``x.dtype``,
    which cuDNN adds in a separate bf16 pass. No bf16 layer of the model
    takes that route on the card: conv + bias + ReLU goes through
    :func:`conv_relu` and the multibox heads through
    :func:`conv2d_bias_in`, both of which add the float32 bias before the
    one rounding.
    """
    w = w.to(x.dtype)
    xn, pad = _same_input(x, w, stride, padding, dilation)
    if b is not None and x.dtype != torch.float32 and x.device.type == "cpu":
        y = F.conv2d(xn.float(), w.float(), b.float(), stride=stride, padding=pad,
                     dilation=dilation).to(x.dtype)
    else:
        if b is not None:
            b = b.to(x.dtype)
        y = F.conv2d(xn, w, b, stride=stride, padding=pad, dilation=dilation)
    return y.permute(0, 2, 3, 1)


def conv2d_train(x, w, b, stride=1, padding="SAME", dilation=1):
    """The differentiable convolution + bias of training: ``F.conv2d`` in
    ``x.dtype`` without a bias, then ``+ b`` in ``x.dtype``. In bf16 that
    rounds twice, after the convolution and after the bias add, exactly
    as the JAX package's ``conv2d(..., f32_out=False)`` that its training
    forward runs. Every op has a derivative; the inference routes
    (:func:`conv_relu`, :func:`conv2d_bias_in`) do not."""
    return conv2d(x, w, None, stride, padding, dilation) + b.to(x.dtype)


def conv_relu_train(params, x, stride=1, padding="SAME", dilation=1):
    """conv + bias + ReLU of training (:func:`conv2d_train`, then ReLU)."""
    return torch.relu(conv2d_train(x, params["w"], params["b"], stride, padding, dilation))


@contextlib.contextmanager
def full_float32(dtype):
    """Within the block, cuDNN runs float32 convolutions (forward and
    backward) in full float32 whatever the caller's
    ``torch.backends.cudnn.allow_tf32`` (PyTorch's default, True, gives
    TF32's 10-bit mantissa), as the JAX package's float32 convolutions on
    the CPU do; the caller's flag is restored after. No-op for other
    dtypes."""
    if dtype != torch.float32:
        yield
        return
    saved = torch.backends.cudnn.allow_tf32
    torch.backends.cudnn.allow_tf32 = False
    try:
        yield
    finally:
        torch.backends.cudnn.allow_tf32 = saved


#: input channels that carry the bias into a convolution: three of ones
#: (one per term of the split bias), five of zeros for alignment
BIAS_CHANNELS = 8


def split_terms(x, dtype, terms: int = 3):
    """float32 ``x`` as ``terms`` tensors of ``dtype`` whose float32 sum,
    taken in order, is ``x`` again: each term rounds what the earlier ones
    left. Three bf16 terms of 8 significant bits cover float32's 24; in
    float32 the first term is ``x`` and the rest are zero."""
    parts, rest = [], x.float()
    for _ in range(terms):
        part = rest.to(dtype)
        parts.append(part)
        rest = rest - part.float()
    return parts


def widen_bias(w, b):
    """OIHW filter ``w`` (compute dtype) and float32 bias ``b`` -> the
    filter of :func:`conv2d_bias_in`, ``(cout, cin + 8, kh, kw)`` in
    ``w.dtype``, channels-last contiguous.

    The bias sits at the centre tap of the first three added input
    channels as :func:`split_terms` of ``b``: ``b_hi = w.dtype(b)``, then
    what is left of it twice over, so in bf16 the first two terms are
    within 2^-16 relative of ``b`` and the three add up to it exactly; the
    other five channels are zero. ``kh`` and ``kw`` must be odd.
    """
    cout, _, kh, kw = w.shape
    if kh % 2 == 0 or kw % 2 == 0:
        raise ValueError(f"widen_bias: the kernel must have a centre tap, got {kh}x{kw}")
    b = b.to(device=w.device, dtype=torch.float32)
    extra = w.new_zeros((cout, BIAS_CHANNELS, kh, kw))
    extra[:, :3, kh // 2, kw // 2] = torch.stack(split_terms(b, w.dtype), dim=1)
    return torch.cat([w, extra], dim=1).contiguous(memory_format=torch.channels_last)


def conv2d_bias_in(x, wb, stride=1, padding="SAME", dilation=1):
    """Convolution + bias of NHWC ``x``, rounded once, with the bias
    carried in as input channels: ``wb = widen_bias(w, b)``.

    ``x`` gets 8 more channels, three of ones and five of zeros, so the
    bias's terms enter the convolution's float32 accumulator with the
    products, each times 1, and the output rounds once: the JAX package's
    ``conv2d(x, w, b, stride, padding, f32_out=True)``. One code path on
    every device; it costs one copy of ``x`` and saves the separate bias
    pass (which on the card rounded a second time).

    Every output gets the whole bias because the centre tap of an odd
    ``k x k`` kernel (dilated extent ``e = (k - 1) * dilation + 1``, centre
    at offset ``(e - 1) / 2``) reads a real pixel, never padding. VALID
    pads nothing. TF SAME with ``n`` inputs, ``out = ceil(n / stride)``
    outputs and ``total = max((out - 1) * stride + e - n, 0)`` pads
    ``before = total // 2`` and ``after = total - before``; since ``(out -
    1) * stride <= n - 1``, ``total <= e - 1``, so ``before <= after <=
    (e - 1) / 2``. Output ``o``'s centre tap reads input ``o * stride -
    before + (e - 1) / 2 >= o * stride >= 0``, and the last output's reads
    ``n - 1 + after - (e - 1) / 2 <= n - 1`` (if ``total > 0``; else
    ``(out - 1) * stride + (e - 1) / 2 <= n - 1 - (e - 1) / 2``). An int
    padding of ``(e - 1) / 2`` a side (PyTorch's ``k // 2``) centres every
    tap on input ``o * stride``, and ``(out - 1) * stride <= n - 1``.
    """
    if wb.shape[1] != x.shape[-1] + BIAS_CHANNELS:
        raise ValueError(f"conv2d_bias_in: filter of {wb.shape[1]} input channels for a map "
                         f"of {x.shape[-1]}; expected widen_bias(w, b)")
    carrier = x.new_zeros((*x.shape[:-1], BIAS_CHANNELS))
    carrier[..., :3] = 1
    return conv2d(torch.cat([x, carrier], dim=-1), wb, None, stride, padding, dilation)


@counted_span("ssd.depthwise")
def depthwise_conv2d(x, w, b=None, stride=1, padding="SAME", f32_out=False):
    """Depthwise convolution of NHWC ``x`` with the OIHW filter ``w`` of
    shape ``(C, 1, kh, kw)``: ``F.conv2d(groups=C)`` in float32 from the
    compute-dtype operands (every product of two bf16 values is exact in
    float32), the same route on the CPU and the card.

    ``f32_out=True``, the inference form: the float32 bias added inside
    the conv and the result rounded once to ``x.dtype``, as the JAX
    package's ``depthwise_conv2d(..., f32_out=True)`` (a bias cannot ride
    in as input channels under ``groups=C``, and the stencil is
    bandwidth-bound either way).

    ``f32_out=False``, the training form and the int8 path's weight-only
    depthwise: the sum rounded to ``x.dtype``, then ``+ b`` in ``x.dtype``,
    two roundings in bf16, as the JAX package's default.

    Each call counts once in ``depthwise_conv2d.calls`` and runs inside
    the span ``ssd.depthwise`` (``utils/profiling.counted_span``).
    """
    c = x.shape[-1]
    if w.shape[:2] != (c, 1):
        raise ValueError(f"depthwise_conv2d: filter {tuple(w.shape)} for {c} channels; "
                         f"expected ({c}, 1, kh, kw)")
    w = w.to(x.dtype)
    xn, pad = _same_input(x, w, stride, padding, 1)
    bias = b.float() if f32_out and b is not None else None
    y = F.conv2d(xn.float(), w.float(), bias, stride, pad, groups=c)
    y = y.to(x.dtype).permute(0, 2, 3, 1)
    return y if f32_out or b is None else y + b.to(x.dtype)


def float_conv_executor(params, inference=True):
    """The float conv executor of a family's ``walk_feature_maps`` and the
    heads: ``conv(name, x, *, stride=1, padding="SAME", dilation=1,
    depthwise=False, relu=False, groups=1, skip=None)``, conv + bias (+
    ReLU where ``relu``; norms, other activations and skips live in the
    walker, but for ``skip``: ``relu(conv + bias + skip)``, a residual
    block's last conv), as the JAX package's ``layers.float_conv_executor``
    (which takes neither ``groups`` nor ``skip``).

    ``inference=True``: every output rounds once, as the JAX package's
    ``f32_out=True``: :func:`conv_relu` (cuDNN's fused conv + bias + ReLU
    on the card), :func:`conv_add_relu` for a ``skip``,
    :func:`conv2d_bias_in` (with the ``"wb"`` filter that
    ``ssd_vgg.stage_conv_weights`` staged, else one widened per call) and
    the float32 form of :func:`depthwise_conv2d`. ``inference=False``: the
    differentiable training math, :func:`conv_relu_train`,
    :func:`conv2d_train` and the ``x.dtype`` depthwise form (two roundings
    in bf16, as the JAX package's default). A grouped conv (``groups >
    1``, always with its ReLU) is :func:`grouped_conv`; it and ``skip``
    exist on the inference route alone (RetinaNet serves, and trains
    nowhere in the port)."""

    def conv(name, x, *, stride=1, padding="SAME", dilation=1, depthwise=False, relu=False,
             groups=1, skip=None):
        p = params[name]
        if depthwise:
            return depthwise_conv2d(x, p["w"], p["b"], stride, padding, f32_out=inference)
        if groups > 1 or skip is not None:
            if not (relu and inference):
                raise ValueError(f"{name}: a grouped conv or a skip runs on the inference "
                                 "route alone, with its ReLU")
            if groups > 1:
                return grouped_conv(p, x, stride, padding, groups)
            return conv_add_relu(p, x, skip, stride, padding)
        if relu:
            return (conv_relu if inference else conv_relu_train)(p, x, stride, padding, dilation)
        if not inference:
            return conv2d_train(x, p["w"], p["b"], stride, padding, dilation)
        wb = p["wb"] if "wb" in p else widen_bias(p["w"].to(x.dtype), p["b"])
        return conv2d_bias_in(x, wb, stride, padding, dilation)

    return conv


@counted_span("ssd.grouped_conv")
def grouped_conv(params, x, stride, padding, groups):
    """Grouped conv + bias + ReLU of NHWC ``x`` (an OIHW filter of ``cin /
    groups`` input channels), the inference route's.

    ``F.conv2d(groups=...)`` in float32 from the compute-dtype
    operands with the float32 bias inside, the ReLU, one rounding to
    ``x.dtype``, the same route on the CPU and the card, as
    :func:`depthwise_conv2d`'s ``f32_out`` form (every product of two bf16
    values is exact in float32, and in TF32 where cuDNN takes it). Not
    :func:`conv_relu`: for 32 groups cuDNN's fused conv + bias + ReLU runs
    a generic FFMA kernel, 255 ms of RetinaNet's 16 grouped convs a batch
    of 64 on an H100 against ~40 here (PERF.md).

    Each call counts once in ``grouped_conv.calls`` and runs inside the
    span ``ssd.grouped_conv``."""
    w = params["w"].to(x.dtype)
    xn, pad = _same_input(x, w, stride, padding, 1)
    y = F.conv2d(xn.float(), w.float(), params["b"].float(), stride, pad, 1, groups)
    return torch.relu_(y).to(x.dtype).permute(0, 2, 3, 1)


def conv_relu(params, x, stride=1, padding="SAME", dilation=1):
    """conv + bias + ReLU block.

    On the card this is cuDNN's fused convolution + bias + ReLU
    (``torch.cudnn_convolution_relu``): the float32 bias is added to the
    float32 accumulator and the output rounds once, as the JAX package's
    ``conv2d(..., f32_out=True)`` + ReLU does, and no separate bias or
    ReLU pass runs. The bias must stay float32 there: cuDNN misreads a
    bf16 bias in this fused op (PERF.md). Every conv + bias + ReLU
    shape of the vgg300/vgg512 models takes this route. CPU tensors take
    ``conv2d`` + in-place ReLU, which rounds once as well (a bf16 layer
    sums in float32 there and adds the float32 bias before rounding).
    """
    if x.device.type != "cuda":
        return torch.relu_(conv2d(x, params["w"], params["b"], stride, padding, dilation))
    w = params["w"].to(x.dtype)
    xn, pad = _same_input(x, w, stride, padding, dilation)
    y = torch.cudnn_convolution_relu(xn, w, params["b"].float(), [stride, stride], list(pad),
                                     [dilation, dilation], 1)
    return y.permute(0, 2, 3, 1)


def conv_add_relu(params, x, skip, stride=1, padding="SAME"):
    """``relu(conv(x) + bias + skip)`` of NHWC ``x`` and ``skip``, rounded
    once: a residual block's last conv with its skip and ReLU. On the card
    cuDNN's fused ``torch.cudnn_convolution_add_relu`` (the float32 bias
    and the skip join the float32 accumulator, as :func:`conv_relu`'s
    bias); on the CPU the convolution in float32 from the operands, the
    float32 bias and skip added, the ReLU, one rounding to ``x.dtype``."""
    w = params["w"].to(x.dtype)
    xn, pad = _same_input(x, w, stride, padding, 1)
    z = skip.permute(0, 3, 1, 2)
    if x.device.type != "cuda":
        y = F.conv2d(xn.float(), w.float(), params["b"].float(), stride, pad) + z.float()
        return torch.relu_(y).to(x.dtype).permute(0, 2, 3, 1)
    y = torch.cudnn_convolution_add_relu(xn, w, z.to(x.dtype), 1.0, params["b"].float(),
                                         [stride, stride], list(pad), [1, 1], 1)
    return y.permute(0, 2, 3, 1)


def upsample_nearest(x, size):
    """NHWC ``x`` resized to ``size`` ``(h, w)`` by the nearest pixel
    (``F.interpolate``'s ``"nearest"``: output ``i`` reads input ``floor(i
    * in / out)``), as an FPN's top-down path; exact in any dtype."""
    y = F.interpolate(x.permute(0, 3, 1, 2), size=tuple(size), mode="nearest")
    return y.permute(0, 2, 3, 1)


@functools.cache
def _mean_on(device: torch.device, mean: tuple) -> torch.Tensor:
    with torch.inference_mode(False):
        return torch.tensor(mean, dtype=torch.float32, device=device)


def mean_constant(mean_bgr, device) -> torch.Tensor:
    """The channel means ``mean_bgr`` as a float32 ``(3,)`` tensor on
    ``device``, made once per device and mean and shared by every later
    call (read it, never write it): the copy from pageable host memory,
    which waits for the device and may not run while a CUDA graph is
    captured, happens at the first call alone. While ``torch.export`` or
    ``torch.compile`` traces, a fresh tensor, which the program keeps as
    its own constant."""
    mean = tuple(float(m) for m in mean_bgr)
    if torch.compiler.is_compiling():
        return torch.tensor(mean, dtype=torch.float32, device=device)
    return _mean_on(torch.device(device), mean)


def preprocess(images, config):
    """uint8/float NHWC BGR images -> mean-subtracted compute-dtype tensor
    (the subtraction in float32, then one rounding); with a ``std_bgr``
    other than ones, divided by it in float32 before the rounding."""
    x = images.float() - mean_constant(config.mean_bgr, images.device)
    if tuple(config.std_bgr) != (1.0, 1.0, 1.0):
        x = x / mean_constant(config.std_bgr, images.device)
    return x.to(config.dtype)


def relu6(x):
    """Bounded ReLU, ``min(relu(x), 6)``; exact in bf16."""
    return torch.relu(x).clamp_max(6.0)


def max_pool(x, window=2, stride=2, padding="SAME"):
    """Max pooling of NHWC ``x`` with TF-style SAME (ceil) semantics, or an
    int ``padding`` of -inf on every side (PyTorch's floor mode)."""
    if isinstance(padding, int):
        return F.max_pool2d(x.permute(0, 3, 1, 2), window, stride, padding).permute(0, 2, 3, 1)
    ph = _same_pads(x.shape[1], window, stride)
    pw = _same_pads(x.shape[2], window, stride)
    pad = 0
    if ph[0] == ph[1] and pw[0] == pw[1]:
        pad = (ph[0], pw[0])
    else:
        x = F.pad(x, (0, 0, pw[0], pw[1], ph[0], ph[1]), value=float("-inf"))
    y = F.max_pool2d(x.permute(0, 3, 1, 2), window, stride, padding=pad)
    return y.permute(0, 2, 3, 1)


def l2_normalize_scale(x, scale, eps=1e-12):
    """Channel-wise L2 normalization with a per-channel scale, in float32."""
    x32 = x.float()
    norm = x32 * torch.rsqrt(torch.sum(x32 * x32, dim=-1, keepdim=True) + eps)
    return (scale.float() * norm).to(x.dtype)


def xavier_uniform(rng: np.random.Generator, shape):
    """Glorot/Xavier uniform OIHW filter, float32 numpy."""
    cout, cin, kh, kw = shape
    limit = float(np.sqrt(6.0 / (kh * kw * cin + kh * kw * cout)))
    return rng.uniform(-limit, limit, shape).astype(np.float32)


def init_conv(rng: np.random.Generator, kh, kw, cin, cout):
    """Xavier OIHW filter + zero bias, float32 CPU tensors."""
    return {
        "w": torch.from_numpy(xavier_uniform(rng, (cout, cin, kh, kw))),
        "b": torch.zeros((cout,), dtype=torch.float32),
    }
