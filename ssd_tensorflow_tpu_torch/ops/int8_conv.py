"""The int8 (W8A8) convolution of the int8 deploy path, whole and in parts.

:func:`int8_qconv` is the forward's convolution: bf16 NHWC activations
and one conv staged by ``weights.stage_qparams`` (``{"w": Int8Weight,
"inv", "mult", "b"}``) in, ``bf16(act(sums * mult + b))`` out, with
``sums`` the exact int32 sums of the int8 convolution of ``quantize(x)``
(see ``models/quantized.py`` for the order of operations): SAME (TF
semantics, stride 1 or 2, any dilation) or VALID padding, any kernel
size, any cin and cout. On the card it is one hand-written kernel
(``csrc/int8_conv.cu``: quantize as the input is loaded, an implicit GEMM
on int8 tensor cores, requantize in the epilogue; its source note says
what bounds it and how its design meets that): no quantized copy, im2col
or int32 tensor reaches device memory. For cin a multiple of 16 it reads
the filter as :attr:`Int8Weight.tiles`, made once on the card.
``int8_qconv.launches`` counts its calls; each opens a span
``ssd.int8.conv`` while a profiler runs.

Its plain version, :func:`int8_qconv_plain`, is the same function as
three passes: :func:`quantize`, :func:`int8_conv`, :func:`requant`. CPU
tensors take it; on the card it is the fused kernel's bit-exact
yardstick, which no forward calls.

:func:`int8_conv` takes int8 NHWC activations and an int8 filter staged
by :func:`stage_int8_weight` and returns the exact int32 sums
``(B, H', W', cout)``. The padding is int8 zeros, the quantized zeros the
JAX package's XLA conv pads ``xq`` with. The JAX package computes this
product with ``lax.conv_general_dilated`` on int8 operands, outside any
Pallas kernel. On the card, :func:`int8_conv_im2col` computes it with a
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

:func:`int8_conv_plain` (the CPU's route of :func:`int8_conv`) is
``F.conv2d`` in float32 of the int8 values, converted: exact while every
partial sum stays below 2^24 in magnitude, the condition the JAX package
states for its own float32 accumulation. On the card it runs with cuDNN
off (PyTorch's im2col + float32 GEMM; TF32 must be off), since cuDNN may
pick a Winograd or FFT algorithm, whose transforms are not exact on
integers.

A CUDA tensor given to :func:`int8_conv` runs the im2col route or raises;
CPU tensors take the plain version. ``int8_conv.launches`` counts the
im2col route's calls (one a convolution, however many chunks). While a
profiler runs, :func:`quantize` and :func:`requant` are spans
``ssd.int8.quantize`` and ``ssd.int8.requant``, each chunk's im2col (the
first also pads the input) a span ``ssd.int8.im2col`` and each GEMM
(``_gemm_into``, with any padding copy) a span ``ssd.int8.gemm``
(``utils/profiling.span``).
"""

from __future__ import annotations

import ctypes
import dataclasses
import functools

import torch
import torch.nn.functional as F

from ssd_tensorflow_tpu_torch.models.layers import _same_pads
from ssd_tensorflow_tpu_torch.ops import _build
from ssd_tensorflow_tpu_torch.utils.profiling import span

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

    @property
    def stage_channels(self) -> int:
        """Channels a step of the fused kernel's channel route (cin a
        multiple of 16) reads: 32 for a filter with several taps, 64 for a
        1x1 one (a step then carries 64 to 288 bytes of K)."""
        return 32 if self.kh * self.kw > 1 or self.cin <= 32 else 64

    @functools.cached_property
    def tiles(self) -> torch.Tensor:
        """The filter as the fused kernel's channel route copies it, one
        contiguous block per 8 output channels and step: ``(Np / 8, stages,
        kh * kw, kc / 16, 8, 16)`` int8 with ``kc`` :attr:`stage_channels`,
        channels past cin zero; block ``[j, s]`` lands in shared memory as
        the wgmma's core matrices (8 rows x 16 bytes) of output channels
        ``8j ..`` for channels ``s * kc ..`` of every tap. Made on the
        filter's device at first use."""
        kc, taps = self.stage_channels, self.kh * self.kw
        stages = -(-self.cin // kc)
        w = self.wk[:, : taps * self.cin].reshape(-1, taps, self.cin)
        w = F.pad(w, (0, stages * kc - self.cin)).reshape(-1, 8, taps, stages, kc // 16, 16)
        return w.permute(0, 3, 2, 4, 1, 5).contiguous()

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
    with span("ssd.int8.gemm"):
        if m > _MIN_ROWS and wt.wk.shape[0] == wt.cout:
            torch._int_mm(a, wt.wk.t(), out=dst)
            return
        if m <= _MIN_ROWS:
            a = torch.cat([a, a.new_zeros((_MIN_ROWS + 1 - m, a.shape[1]))])
        dst.copy_(torch._int_mm(a, wt.wk.t())[:m, : wt.cout])


def int8_conv_im2col(xq, wt: Int8Weight, stride: int = 1, padding: str = "SAME",
                     dilation: int = 1, chunk_bytes: int = IM2COL_BYTES):
    """The card's yardstick route of :func:`int8_conv` on any device, uncounted: im2col
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
    chunk = chunk_images(b, ho, wo, kp, chunk_bytes)
    for b0 in range(0, b, chunk):
        n = min(chunk, b - b0)
        with span("ssd.int8.im2col"):  # the first chunk's also pads the input
            if b0 == 0:
                xp = _padded_words(xq, wt, ph, pw)
                cols = torch.empty((chunk, ho, wo, kp), dtype=torch.int8, device=xq.device)
                cols[..., wt.kh * wt.kw * wt.cp:] = 0  # K padding: no tap writes it
            _im2col(xp[b0:b0 + n], wt, stride, dilation, ho, wo, cols[:n])
        _gemm_into(cols[:n].view(-1, kp), wt, out[b0:b0 + n].view(-1, wt.cout))
    return out


def int8_conv(xq, wt: Int8Weight, stride: int = 1, padding: str = "SAME", dilation: int = 1):
    """Exact int32 sums of the int8 convolution of NHWC ``xq`` with the
    staged filter ``wt``: ``(B, H', W', cout)`` int32 (see the module doc).
    CUDA tensors take the im2col + ``torch._int_mm`` route (one count in
    ``int8_conv.launches``); CPU tensors the plain version. No forward
    calls it on the card: :func:`int8_qconv` computes the whole conv
    there."""
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


def quantize(x, inv):
    """int8 ``clip(round(float32(x) * inv), -127, 127)``; ``inv`` is the
    staged float32 inverse scale, ``(1,)`` or one per channel (a tensor, so
    that a bf16 ``x`` is multiplied in float32). A span
    ``ssd.int8.quantize`` while a profiler runs."""
    with span("ssd.int8.quantize"):
        return torch.mul(x, inv).round_().clamp_(-127, 127).to(torch.int8)


def requant(sums, layer, relu=True):
    """``bf16(act(sums * m + b))``: the multiply-add in float32, rounded
    once to bf16 as it is stored; ReLU then on the bf16 values (rounding
    is monotone and keeps 0, so it commutes with ReLU). A span
    ``ssd.int8.requant`` while a profiler runs."""
    with span("ssd.int8.requant"):
        out = torch.empty(sums.shape, dtype=torch.bfloat16, device=sums.device)
        torch.addcmul(layer["b"], sums, layer["mult"], out=out)
        return out.relu_() if relu else out


def _check_qconv(x, layer):
    wt = layer["w"]
    if x.dtype != torch.bfloat16 or x.dim() != 4 or x.shape[-1] != wt.cin:
        raise ValueError(f"int8_qconv: x must be (B, H, W, {wt.cin}) bf16, got "
                         f"{tuple(x.shape)} {x.dtype}")
    inv = layer["inv"]
    if inv.dtype != torch.float32 or tuple(inv.shape) not in ((1,), (wt.cin,)):
        raise ValueError(f"int8_qconv: inv must be float32 of shape (1,) or ({wt.cin},), got "
                         f"{tuple(inv.shape)} {inv.dtype}")
    for key in ("mult", "b"):
        if layer[key].dtype != torch.float32 or tuple(layer[key].shape) != (wt.cout,):
            raise ValueError(f"int8_qconv: {key} must be float32 of shape ({wt.cout},), got "
                             f"{tuple(layer[key].shape)} {layer[key].dtype}")


def int8_qconv_plain(x, layer, stride: int = 1, padding: str = "SAME", dilation: int = 1,
                     relu: bool = True):
    """Plain version of :func:`int8_qconv`, same contract: :func:`quantize`,
    :func:`int8_conv`, :func:`requant` (on the card the im2col route, the
    fused kernel's bit-exact yardstick)."""
    _check_qconv(x, layer)
    sums = int8_conv(quantize(x, layer["inv"]), layer["w"], stride, padding, dilation)
    return requant(sums, layer, relu)


@functools.cache
def _launcher():
    fn = _build.libraries()["int8_conv"].int8_qconv_launch
    fn.argtypes = [ctypes.c_void_p] * 7 + [ctypes.c_int] * 18 + [ctypes.c_void_p]
    fn.restype = ctypes.c_int
    return fn


def int8_qconv(x, layer, stride: int = 1, padding: str = "SAME", dilation: int = 1,
               relu: bool = True):
    """The int8 conv of one staged layer: ``bf16(act(sums * mult + b))`` of
    NHWC bf16 ``x`` (see the module doc), ``(B, H', W', cout)`` bf16.

    CUDA tensors run ``csrc/int8_conv.cu`` (``x`` contiguous, every
    operand on its device; one count in ``int8_qconv.launches``, a span
    ``ssd.int8.conv``); CPU tensors the plain version. Raises on anything
    else."""
    _check_qconv(x, layer)
    if x.device.type == "cpu":
        return int8_qconv_plain(x, layer, stride, padding, dilation, relu)
    wt = layer["w"]
    operands = (wt.wk, layer["inv"], layer["mult"], layer["b"])
    if x.device.type != "cuda" or any(t.device != x.device for t in operands):
        raise ValueError(f"int8_qconv: x and the staged layer must share one CUDA device, got "
                         f"{x.device} and {[str(t.device) for t in operands]}")
    if not x.is_contiguous() or x.data_ptr() % 16 or not all(t.is_contiguous() for t in operands):
        raise ValueError("int8_qconv: x must be contiguous NHWC at a 16-byte aligned address, "
                         "the staged operands contiguous")
    b, h, w, _ = x.shape
    ph, pw, ho, wo = _geometry(h, w, wt, stride, padding, dilation)
    out = torch.empty((b, ho, wo, wt.cout), dtype=torch.bfloat16, device=x.device)
    if out.numel() == 0:
        return out
    np_, kp = wt.wk.shape
    channels = wt.cin % 16 == 0  # the channel route, else the small-cin one
    tiles = wt.tiles.data_ptr() if channels else 0
    with span("ssd.int8.conv"), torch.cuda.device(x.device):
        stream = torch.cuda.current_stream(x.device).cuda_stream
        rc = _launcher()(x.data_ptr(), wt.wk.data_ptr(), tiles, layer["inv"].data_ptr(),
                         layer["mult"].data_ptr(), layer["b"].data_ptr(), out.data_ptr(),
                         b, h, w, wt.cin, wt.cout, wt.kh, wt.kw, stride, dilation, ph[0], pw[0],
                         ho, wo, kp, np_, wt.stage_channels, layer["inv"].numel(), int(relu),
                         stream)
    _build.check(rc, "int8_qconv")
    int8_qconv.launches += 1
    return out


int8_qconv.launches = 0
