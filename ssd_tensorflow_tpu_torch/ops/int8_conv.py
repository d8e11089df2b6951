"""The integer convolution of the int8 (W8A8) deploy path.

:func:`int8_conv` takes int8 NHWC activations and an int8 filter staged
by :func:`stage_int8_weight` and returns the exact int32 sums
``(B, H', W', cout)``: SAME (TF semantics, stride 1 or 2, any dilation)
or VALID padding, any odd or even kernel, any cin. The padding is int8
zeros, the quantized zeros the JAX package's XLA conv pads ``xq`` with.

The JAX package computes this product with ``lax.conv_general_dilated``
on int8 operands, outside any Pallas kernel, so the card route is a
library GEMM: an im2col of the padded input (the ``kh * kw`` shifted,
dilated and strided slices side by side along channels, in ``(dy, dx,
cin)`` order) times the staged filter by ``torch._int_mm`` (int8 tensor
cores, int32 accumulation). ``_int_mm`` takes ``(M, K) @ (K, N)`` with
M > 16 and K, N multiples of 8, and runs a slower kernel unless rows are
16-byte aligned: the staged filter pads K and N to multiples of 16 with
zero taps and zero output channels (the heads' N = 100 / 150 -> 112 /
160), the im2col pads K likewise, a GEMM of 16 rows or fewer is padded
to 17 with zero rows, and the padding is sliced away. A cin that is not
a multiple of 4 (conv1_1's 3) is padded with zero channels to one (K =
9 * 4 = 36 -> 48), so that the padding and im2col copies move whole 4-
or 8-byte words: PyTorch's strided copy spends its time per element,
not per byte.

**Chunk rule.** The im2col is built for as many whole images at a time as
keep it within :data:`IM2COL_BYTES` (1 GiB), at least one: conv1_2 of
vgg512 is 151 MB an image, so batch 64 runs in chunks of 7 (the whole
batch would take 9.7 GB). A 1x1 stride-1 convolution needs no im2col:
the input is the GEMM's operand as it is.

The plain version (:func:`int8_conv_plain`; the CPU's route and the
card's reference) is ``F.conv2d`` in float32 of the int8 values,
converted: exact while every partial sum stays below 2^24 in magnitude,
the condition the JAX package states for its own float32 accumulation.
On the card it runs with cuDNN off (PyTorch's im2col + float32 GEMM;
TF32 must be off), since cuDNN may pick a Winograd or FFT algorithm,
whose transforms are not exact on integers.

A CUDA tensor runs the card route or raises; CPU tensors take the plain
version. ``int8_conv.launches`` counts the card route's calls (one a
convolution, however many chunks).
"""

from __future__ import annotations

import dataclasses

import torch
import torch.nn.functional as F

from ssd_tensorflow_tpu_torch.models.layers import _same_pads

#: the most bytes of im2col a chunk of whole images may take (at least one image)
IM2COL_BYTES = 1 << 30
#: _int_mm's least number of GEMM rows, less one
_MIN_ROWS = 16


def _round_up(n: int, k: int) -> int:
    return -(-n // k) * k


@dataclasses.dataclass(frozen=True)
class Int8Weight:
    """An int8 filter laid out as the GEMM's operand.

    ``wk`` is ``(Np, Kp)`` int8 contiguous: row ``n`` holds output channel
    ``n``'s taps in ``(dy, dx, c)`` order over ``cp`` channels (``cin``
    padded with zero channels to a multiple of 4), zero beyond ``K = kh *
    kw * cp`` and ``cout``; ``wk.t()`` is the column-major ``(Kp, Np)``
    operand.
    """

    wk: torch.Tensor
    kh: int
    kw: int
    cin: int
    cout: int

    @property
    def cp(self) -> int:
        return _round_up(self.cin, 4)

    def to(self, device) -> "Int8Weight":
        return dataclasses.replace(self, wk=self.wk.to(device))

    def hwio(self) -> torch.Tensor:
        """The filter as ``(kh, kw, cin, cout)`` int8, as the bundle holds it."""
        k = self.kh * self.kw * self.cp
        w = self.wk[: self.cout, :k].t().reshape(self.kh, self.kw, self.cp, self.cout)
        return w[:, :, : self.cin]


def stage_int8_weight(wq) -> Int8Weight:
    """HWIO int8 filter ``wq`` (tensor or numpy) -> :class:`Int8Weight`."""
    wq = torch.as_tensor(wq)
    if wq.dtype != torch.int8 or wq.dim() != 4:
        raise ValueError(f"stage_int8_weight: wq must be (kh, kw, cin, cout) int8, got "
                         f"{tuple(wq.shape)} {wq.dtype}")
    kh, kw, cin, cout = wq.shape
    cp = _round_up(cin, 4)
    k = kh * kw * cp
    wk = wq.new_zeros((_round_up(cout, 16), _round_up(k, 16)))
    wk[:cout, :k] = F.pad(wq, (0, 0, 0, cp - cin)).reshape(k, cout).t()
    return Int8Weight(wk.contiguous(), kh, kw, cin, cout)


def _geometry(h: int, w: int, wt: Int8Weight, stride: int, padding: str, dilation: int):
    """``((top, bottom), (left, right), Ho, Wo)`` of a convolution."""
    if padding == "SAME":
        ph = _same_pads(h, wt.kh, stride, dilation)
        pw = _same_pads(w, wt.kw, stride, dilation)
    elif padding == "VALID":
        ph = pw = (0, 0)
    else:
        raise ValueError(f"padding must be 'SAME' or 'VALID', got {padding!r}")
    ho = (h + sum(ph) - (wt.kh - 1) * dilation - 1) // stride + 1
    wo = (w + sum(pw) - (wt.kw - 1) * dilation - 1) // stride + 1
    if ho <= 0 or wo <= 0:
        raise ValueError(f"int8_conv: a {wt.kh}x{wt.kw} filter (dilation {dilation}) does not "
                         f"fit a {h}x{w} input with {padding} padding")
    return ph, pw, ho, wo


def _check(xq, wt: Int8Weight):
    if xq.dtype != torch.int8 or xq.dim() != 4 or xq.shape[-1] != wt.cin:
        raise ValueError(f"int8_conv: xq must be (B, H, W, {wt.cin}) int8, got "
                         f"{tuple(xq.shape)} {xq.dtype}")


def int8_conv_plain(xq, wt: Int8Weight, stride: int = 1, padding: str = "SAME",
                    dilation: int = 1):
    """Plain version of :func:`int8_conv`, same contract: a float32
    ``F.conv2d`` of the int8 values, exact below 2^24 (see the module doc)."""
    _check(xq, wt)
    ph, pw, _, _ = _geometry(xq.shape[1], xq.shape[2], wt, stride, padding, dilation)
    x = F.pad(xq.float(), (0, 0, pw[0], pw[1], ph[0], ph[1])).permute(0, 3, 1, 2)
    w = wt.hwio().to(xq.device).permute(3, 2, 0, 1).float()
    with torch.backends.cudnn.flags(enabled=False):
        y = F.conv2d(x, w, None, stride, 0, dilation)
    # NHWC contiguous, as the card route returns them: what follows may
    # round differently for another layout of the same sums
    return y.permute(0, 2, 3, 1).to(torch.int32, memory_format=torch.contiguous_format)


#: the integer type of each copy word size, widest first
_WORDS = ((8, torch.int64), (4, torch.int32))


def _word(wt: Int8Weight):
    """``(bytes, dtype)`` of the widest word that divides a pixel's ``cp``."""
    return next(w for w in _WORDS if wt.cp % w[0] == 0)


def _padded_words(xq, wt: Int8Weight, ph, pw):
    """``xq`` zero-padded to ``cp`` channels and by ``ph`` / ``pw`` pixels,
    as a contiguous ``(B, Hp, Wp, cp / word)`` tensor of words."""
    _, dtype = _word(wt)
    if wt.cp != wt.cin:  # bytes, then words (conv1_1's small input only)
        return F.pad(xq, (0, wt.cp - wt.cin, pw[0], pw[1], ph[0], ph[1])).view(dtype)
    xw = xq.contiguous().view(dtype)
    return F.pad(xw, (0, 0, pw[0], pw[1], ph[0], ph[1])) if sum(ph) + sum(pw) else xw


def _im2col(src, wt: Int8Weight, stride: int, dilation: int, ho: int, wo: int, out):
    """Fill ``out`` ``(b, ho, wo, Kp)`` int8 with the im2col of the padded
    chunk ``src`` (:func:`_padded_words`): tap ``(dy, dx)`` at channels
    ``(dy * kw + dx) * cp``, copied as words; the columns beyond K are
    left as they are."""
    size, dtype = _word(wt)
    c = wt.cp // size
    dst = out.view(dtype)
    for dy in range(wt.kh):
        for dx in range(wt.kw):
            t = dy * wt.kw + dx
            y0, x0 = dy * dilation, dx * dilation
            dst[..., t * c:(t + 1) * c] = src[:, y0:y0 + (ho - 1) * stride + 1:stride,
                                              x0:x0 + (wo - 1) * stride + 1:stride]


def chunk_images(b: int, ho: int, wo: int, kp: int, chunk_bytes: int = IM2COL_BYTES) -> int:
    """Images per im2col chunk: as many as ``chunk_bytes`` hold, at least one."""
    return max(1, min(b, chunk_bytes // (ho * wo * kp)))


def _gemm_into(a, wt: Int8Weight, dst):
    """``dst`` ``(M, cout)`` int32 = ``a`` ``(M, Kp)`` int8 @ the staged
    filter; straight into ``dst`` unless N or M needs padding."""
    m = a.shape[0]
    if m > _MIN_ROWS and wt.wk.shape[0] == wt.cout:
        torch._int_mm(a, wt.wk.t(), out=dst)
        return
    if m <= _MIN_ROWS:
        a = torch.cat([a, a.new_zeros((_MIN_ROWS + 1 - m, a.shape[1]))])
    dst.copy_(torch._int_mm(a, wt.wk.t())[:m, : wt.cout])


def int8_conv_im2col(xq, wt: Int8Weight, stride: int = 1, padding: str = "SAME",
                     dilation: int = 1, chunk_bytes: int = IM2COL_BYTES):
    """The card route of :func:`int8_conv` on any device, uncounted: im2col
    chunks of at most ``chunk_bytes`` (at least one image) times the staged
    filter by ``torch._int_mm``."""
    _check(xq, wt)
    b, h, w, _ = xq.shape
    ph, pw, ho, wo = _geometry(h, w, wt, stride, padding, dilation)
    kp = wt.wk.shape[1]
    out = torch.empty((b, ho, wo, wt.cout), dtype=torch.int32, device=xq.device)
    if out.numel() == 0:
        return out
    if wt.kh == wt.kw == 1 and stride == 1 and kp == wt.cin:
        _gemm_into(xq.contiguous().view(-1, wt.cin), wt, out.view(-1, wt.cout))
        return out
    xp = _padded_words(xq, wt, ph, pw)
    chunk = chunk_images(b, ho, wo, kp, chunk_bytes)
    cols = torch.empty((chunk, ho, wo, kp), dtype=torch.int8, device=xq.device)
    cols[..., wt.kh * wt.kw * wt.cp:] = 0  # K padding: no tap writes it
    for b0 in range(0, b, chunk):
        n = min(chunk, b - b0)
        _im2col(xp[b0:b0 + n], wt, stride, dilation, ho, wo, cols[:n])
        _gemm_into(cols[:n].view(-1, kp), wt, out[b0:b0 + n].view(-1, wt.cout))
    return out


def int8_conv(xq, wt: Int8Weight, stride: int = 1, padding: str = "SAME", dilation: int = 1):
    """Exact int32 sums of the int8 convolution of NHWC ``xq`` with the
    staged filter ``wt``: ``(B, H', W', cout)`` int32 (see the module doc).
    CUDA tensors take the im2col + ``torch._int_mm`` route (one count in
    ``int8_conv.launches``); CPU tensors the plain version."""
    _check(xq, wt)
    if xq.device.type == "cpu":
        return int8_conv_plain(xq, wt, stride, padding, dilation)
    if xq.device.type != "cuda" or wt.wk.device != xq.device:
        raise ValueError(f"int8_conv: xq and the staged filter must share one CUDA device, got "
                         f"{xq.device} and {wt.wk.device}")
    out = int8_conv_im2col(xq, wt, stride, padding, dilation)
    int8_conv.launches += 1
    return out


int8_conv.launches = 0
