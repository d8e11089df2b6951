"""Primitive layers as plain functions on NHWC tensors.

Activations are NHWC at every function boundary, as in the JAX package.
Inside, a convolution or pool sees the NHWC tensor through a
``permute(0, 3, 1, 2)`` view, which is an NCHW tensor in channels-last
memory: cuDNN (and oneDNN on the CPU) runs it as such and returns
channels-last, so no layout copy is made. Weights are OIHW.

``padding="SAME"`` follows TF semantics, which is asymmetric whenever the
total padding is odd (the stride-2 extras pad 0 on top and 1 at the
bottom); max-pooling is SAME ceil mode with -inf padding.
"""

from __future__ import annotations

import numpy as np
import torch
import torch.nn.functional as F


def _same_pads(size: int, window: int, stride: int, dilation: int = 1):
    """TF SAME padding (before, after) along one axis."""
    out = -(-size // stride)
    eff = (window - 1) * dilation + 1
    total = max((out - 1) * stride + eff - size, 0)
    return total // 2, total - total // 2


def _same_input(x, w, stride, padding, dilation):
    """``(NCHW channels-last view of x, symmetric pads)`` for a convolution
    with OIHW ``w``: an asymmetric TF-SAME padding is applied to ``x``
    here, a symmetric one is left to the convolution."""
    pad = (0, 0)
    if padding == "SAME":
        ph = _same_pads(x.shape[1], w.shape[2], stride, dilation)
        pw = _same_pads(x.shape[2], w.shape[3], stride, dilation)
        if ph[0] == ph[1] and pw[0] == pw[1]:
            pad = (ph[0], pw[0])
        else:
            x = F.pad(x, (0, 0, pw[0], pw[1], ph[0], ph[1]))
    elif padding != "VALID":
        raise ValueError(f"padding must be 'SAME' or 'VALID', got {padding!r}")
    return x.permute(0, 3, 1, 2), pad


def conv2d(x, w, b=None, stride=1, padding="SAME", dilation=1):
    """2-D convolution of NHWC ``x`` with OIHW ``w``, optional bias.

    Computes in ``x.dtype``. A bf16 convolution accumulates in float32
    and rounds its output to bf16, as the JAX package's
    ``conv2d(..., f32_out=True)`` does. The bias goes to ``F.conv2d`` in
    bf16: the CPU adds it inside its float32 accumulation (one rounding,
    as in JAX); cuDNN adds it to the rounded output in a bf16 pass, so on
    the card the output may round twice. Only the multibox heads, which
    have no ReLU, still take this route on the card (ROADMAP.md faults).
    """
    w = w.to(x.dtype)
    if b is not None:
        b = b.to(x.dtype)
    xn, pad = _same_input(x, w, stride, padding, dilation)
    y = F.conv2d(xn, w, b, stride=stride, padding=pad, dilation=dilation)
    return y.permute(0, 2, 3, 1)


def conv_relu(params, x, stride=1, padding="SAME", dilation=1):
    """conv + bias + ReLU block.

    On the card this is cuDNN's fused convolution + bias + ReLU
    (``torch.cudnn_convolution_relu``): the float32 bias is added to the
    float32 accumulator and the output rounds once, as the JAX package's
    ``conv2d(..., f32_out=True)`` + ReLU does, and no separate bias or
    ReLU pass runs. The bias must stay float32 there: cuDNN misreads a
    bf16 bias in this fused op (PERF.md). Every conv + bias + ReLU
    shape of the vgg300/vgg512 models takes this route. CPU tensors take
    ``conv2d`` + in-place ReLU, which rounds once as well (oneDNN adds the
    bias inside its accumulation, though it takes the bias in the input's
    dtype, so a bf16 layer's bias is rounded first).
    """
    if x.device.type != "cuda":
        return torch.relu_(conv2d(x, params["w"], params["b"], stride, padding, dilation))
    w = params["w"].to(x.dtype)
    xn, pad = _same_input(x, w, stride, padding, dilation)
    y = torch.cudnn_convolution_relu(xn, w, params["b"].float(), [stride, stride], list(pad),
                                     [dilation, dilation], 1)
    return y.permute(0, 2, 3, 1)


def max_pool(x, window=2, stride=2):
    """Max pooling of NHWC ``x`` with TF-style SAME (ceil) semantics."""
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
