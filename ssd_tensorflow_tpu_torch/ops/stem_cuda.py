"""VGG conv1 stem: the CUDA kernels, their plain versions and the three
whole-stem entry points of ``ssd_tensorflow_tpu/ops/stem_pallas.py``.

Two kernels:

* ``fused_stem`` (``csrc/stem.cu``) — conv1_2 + pool1 over conv1_1's
  un-biased bf16 output: b1 + ReLU + the zero border, conv1_2 with float32
  accumulation, b2 + ReLU and the 2x2/s2 max-pool, so conv1_2's activation
  never reaches device memory. conv1_1 runs outside it (bf16 in and out,
  no bias, :func:`conv1_1_unbiased`).
* ``fused_stem_uint8`` (``csrc/stem_uint8.cu``) — the whole stem from the
  raw uint8 image: preprocess, conv1_1 + b1 + ReLU rounded once, conv1_2,
  b2, ReLU and pool1; only the image is read and only pool1 written.

The whole-stem entry points keep the JAX package's names and signature
``(params, images, mean_bgr)`` -> bf16 pool1 ``(B, H/2, W/2, 64)``:
:func:`fused_stem_pallas_dma`, :func:`fused_stem_pallas` (both the split
stem) and :func:`fused_stem_uint8`. CUDA tensors run the kernels (and
raise on what they do not take); CPU tensors take the plain versions,
which compute the same functions in float32 from the same bf16 values
with the kernels' rounding points. The plain versions' float32
convolutions want TF32 off on the card
(``torch.backends.cudnn.allow_tf32 = False``). The source notes in
``csrc/`` say what bounds each kernel and how its design meets that.
"""

from __future__ import annotations

import ctypes
import functools

import torch
import torch.nn.functional as F

from ssd_tensorflow_tpu_torch.models.layers import conv2d, split_terms
from ssd_tensorflow_tpu_torch.ops import _build

_C = 64


def _preprocess(images, mean_bgr):
    """Raw BGR images -> bf16 after a float32 mean subtraction."""
    mean = torch.tensor(mean_bgr, dtype=torch.float32, device=images.device)
    return (images.float() - mean).to(torch.bfloat16)


def conv1_1_unbiased(params, x):
    """conv1_1 of a preprocessed bf16 NHWC batch, without its bias: the
    split stem kernel's input (the kernel adds b1)."""
    return conv2d(x, params["conv1_1"]["w"]).contiguous()


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
def _launcher(name: str):
    fn = getattr(_build.libraries()[name], f"{name}_launch")
    n_ptr, n_int = {"stem": (5, 4), "stem_uint8": (7, 4)}[name]
    fn.argtypes = [ctypes.c_void_p] * n_ptr + [ctypes.c_int] * n_int + [ctypes.c_void_p]
    fn.restype = ctypes.c_int
    return fn


@functools.cache
def _sm_count(index: int) -> int:
    return torch.cuda.get_device_properties(index).multi_processor_count


#: conv rows x conv columns of one output tile of the stem kernels
TILE_ROWS, TILE_COLS = 8, 32


def stem_tiles(b: int, h: int, w: int):
    """The stem kernels' walk over a ``(b, h, w)`` conv1_2 output, as
    ``csrc/stem_common.cuh`` (``tile_at``) computes it: tile ``i`` is
    ``(image, first conv row, first conv column)``, images outermost, then
    tile rows, then tile columns; ragged edges are whole tiles whose
    out-of-image part the kernels mask."""
    tiles_y, tiles_x = -(-h // TILE_ROWS), -(-w // TILE_COLS)
    return [(i // (tiles_y * tiles_x), (i % (tiles_y * tiles_x)) // tiles_x * TILE_ROWS,
             (i % tiles_x) * TILE_COLS) for i in range(b * tiles_y * tiles_x)]


def _launch(name, device, pointers, b, h, w):
    """Launch ``csrc/<name>.cu`` on the current stream with one persistent
    block per SM (at most one per 8 x 32 conv-pixel tile)."""
    tiles = b * -(-h // TILE_ROWS) * -(-w // TILE_COLS)
    index = device.index if device.index is not None else torch.cuda.current_device()
    with torch.cuda.device(device):
        stream = torch.cuda.current_stream(device).cuda_stream
        rc = _launcher(name)(*pointers, b, h, w, min(tiles, _sm_count(index)), stream)
    _build.check(rc, name)


def _check_device(name, x, *others):
    if x.device.type != "cuda":
        raise ValueError(f"{name}: unsupported device {x.device}")
    if any(t.device != x.device for t in others):
        raise ValueError(f"{name}: all operands must be on one device")


def _check_stem_args(c1, b1, w2, b2):
    if c1.dtype != torch.bfloat16 or c1.dim() != 4 or c1.shape[-1] != _C:
        raise ValueError(f"fused_stem: c1 must be (B, H, W, 64) bf16, got "
                         f"{tuple(c1.shape)} {c1.dtype}")
    if c1.shape[1] % 2 or c1.shape[2] % 2:
        raise ValueError(f"fused_stem: H and W must be even, got {c1.shape[1]}x{c1.shape[2]}")
    if w2.shape != (_C, _C, 3, 3) or b1.shape != (_C,) or b2.shape != (_C,):
        raise ValueError("fused_stem: expected w2 (64, 64, 3, 3), b1 and b2 (64,)")


# The two kernels are operators of the ``ssd_torch`` library
# (``torch.ops.ssd_torch.fused_stem`` / ``fused_stem_uint8``): the CPU
# implementation is the plain version, the CUDA one the kernel's launch, and
# a shape function lets ``torch.export`` trace a forward through them, so
# that an exported program holds the kernel's operator and not its plain
# version. Loading such a program needs this module imported.
@torch.library.custom_op("ssd_torch::fused_stem", mutates_args=(), device_types="cpu")
def _fused_stem_op(c1: torch.Tensor, b1: torch.Tensor, w2: torch.Tensor,
                   b2: torch.Tensor) -> torch.Tensor:
    return fused_stem_plain(c1, b1, w2, b2)


@_fused_stem_op.register_kernel("cuda")
def _fused_stem_cuda(c1, b1, w2, b2):
    _check_device("fused_stem", c1, b1, w2, b2)
    _check_stem_args(c1, b1, w2, b2)
    if not c1.is_contiguous():
        raise ValueError("fused_stem: c1 must be contiguous NHWC")
    b, h, w, _ = c1.shape
    out = torch.empty((b, h // 2, w // 2, _C), dtype=torch.bfloat16, device=c1.device)
    if out.numel() == 0:
        return out
    # [dy*3 + dx][cout][cin], the kernel's shared-memory weight layout
    w2t = w2.to(torch.bfloat16).permute(2, 3, 0, 1).contiguous()
    b1f = b1.float().contiguous()
    b2f = b2.float().contiguous()
    _launch("stem", c1.device, (c1.data_ptr(), b1f.data_ptr(), w2t.data_ptr(), b2f.data_ptr(),
                                out.data_ptr()), b, h, w)
    _COUNTED["stem"].launches += 1
    return out


@_fused_stem_op.register_fake
def _fused_stem_shape(c1, b1, w2, b2):
    _check_stem_args(c1, b1, w2, b2)
    b, h, w, _ = c1.shape
    return c1.new_empty((b, h // 2, w // 2, _C))


def _known_device(name, *tensors):
    """The kernels' operators run on the CPU (plain version) and the card;
    any other device raises here, before a shape function could accept it."""
    for t in tensors:
        if t.device.type not in ("cpu", "cuda"):
            raise ValueError(f"{name}: unsupported device {t.device}")


def fused_stem(c1, b1, w2, b2):
    """conv1_2 + ReLU + pool1 over conv1_1's un-biased output.

    Args:
      c1: ``(B, H, W, 64)`` bf16 NHWC, contiguous; H and W even.
      b1: ``(64,)`` conv1_1 bias.
      w2: ``(64, 64, 3, 3)`` conv1_2 weights (OIHW).
      b2: ``(64,)`` conv1_2 bias.

    Returns:
      ``(B, H/2, W/2, 64)`` bf16 pool1, through the operator
      ``torch.ops.ssd_torch.fused_stem``: CUDA tensors run the kernel (and
      count one launch in ``fused_stem.launches``); CPU tensors the plain
      version.
    """
    _known_device("fused_stem", c1, b1, w2, b2)
    return torch.ops.ssd_torch.fused_stem(c1, b1, w2, b2)


fused_stem.launches = 0


def fused_stem_pallas_dma(params, images, mean_bgr):
    """Counterpart of JAX ``stem_pallas.fused_stem_pallas_dma``: preprocess,
    conv1_1 as an un-biased bf16 convolution, then the :func:`fused_stem`
    kernel. ``images`` is ``(B, H, W, 3)`` raw BGR (uint8 or float), H and
    W even; returns bf16 pool1 ``(B, H/2, W/2, 64)``."""
    c1 = conv1_1_unbiased(params, _preprocess(images, mean_bgr))
    p2 = params["conv1_2"]
    return fused_stem(c1, params["conv1_1"]["b"], p2["w"], p2["b"])


def fused_stem_pallas(params, images, mean_bgr):
    """Counterpart of JAX ``stem_pallas.fused_stem_pallas``, the same
    function as :func:`fused_stem_pallas_dma`. The two TPU kernels differ
    only in how they feed conv1_1's halo rows (three BlockSpec streams
    there, manual DMA in the dma one); on this card both are the
    :func:`fused_stem` kernel behind preprocess + conv1_1."""
    return fused_stem_pallas_dma(params, images, mean_bgr)


def fused_stem_uint8_plain(params, images, mean_bgr):
    """Plain PyTorch version of :func:`fused_stem_uint8`, same contract and
    the TPU kernel's rounding points: ``x = bf16(u8 - mean)`` (zero SAME
    padding after the subtraction), conv1_1 in float32 on bf16 weights +
    b1 on the float32 sum, ReLU, one bf16 rounding (zero outside the
    image, not relu(b1)), conv1_2 in float32 + b2, ReLU, 2x2/s2 max-pool,
    one bf16 rounding."""
    x = _preprocess(images, mean_bgr).float().permute(0, 3, 1, 2)
    p1, p2 = params["conv1_1"], params["conv1_2"]
    c1 = F.conv2d(x, p1["w"].to(torch.bfloat16).float(), padding=1)
    y1 = torch.relu(c1 + p1["b"].float().view(1, -1, 1, 1)).to(torch.bfloat16).float()
    y = F.conv2d(y1, p2["w"].to(torch.bfloat16).float(), p2["b"].float(), padding=1)
    y = F.max_pool2d(torch.relu(y), 2, 2)
    return y.to(torch.bfloat16).permute(0, 2, 3, 1).contiguous()


def uint8_stem_weights(params):
    """``(w1k, b1, w2t, b2)`` in ``csrc/stem_uint8.cu``'s layouts.

    w1k ``(64, 48)`` bf16 is conv1_1's B operand, ``[cout][dy*16 + dx*4 +
    c]``: one 16-wide K step per filter row, a filter row being 4 pixels of
    4 channels in the kernel's image strip. conv1_1's weights sit at
    ``dx < 3, c < 3``; the strip's fourth channel is 1.0, and b1 rides on
    it as three bf16 terms (``layers.split_terms``) at ``dx = 0, c = 3`` of the
    three rows (k = 3, 19, 35), so the float32 accumulator receives b1
    exactly; every other slot is zero. w2t ``(9, 64, 64)`` bf16 is
    ``[dy*3 + dx][cout][cin]``; the biases are float32.
    """
    p1, p2 = params["conv1_1"], params["conv1_2"]
    b1 = p1["b"].float().contiguous()
    w1k = torch.zeros((_C, 3, 4, 4), dtype=torch.bfloat16, device=p1["w"].device)
    w1k[:, :, :3, :3] = p1["w"].to(torch.bfloat16).permute(0, 2, 3, 1)  # OIHW -> O, dy, dx, c
    w1k[:, :, 0, 3] = torch.stack(split_terms(b1, torch.bfloat16), dim=1)
    w2t = p2["w"].to(torch.bfloat16).permute(2, 3, 0, 1).reshape(9, _C, _C).contiguous()
    return w1k.reshape(_C, 48), b1, w2t, p2["b"].float().contiguous()


def _check_uint8_images(images):
    if images.dtype != torch.uint8 or images.dim() != 4 or images.shape[-1] != 3:
        raise ValueError(f"fused_stem_uint8: images must be (B, H, W, 3) uint8, got "
                         f"{tuple(images.shape)} {images.dtype}")
    if images.shape[1] % 2 or images.shape[2] % 2:
        raise ValueError(f"fused_stem_uint8: H and W must be even, got "
                         f"{images.shape[1]}x{images.shape[2]}")


def _conv1_params(w1, b1, w2, b2):
    return {"conv1_1": {"w": w1, "b": b1}, "conv1_2": {"w": w2, "b": b2}}


@torch.library.custom_op("ssd_torch::fused_stem_uint8", mutates_args=(), device_types="cpu")
def _fused_stem_uint8_op(images: torch.Tensor, w1: torch.Tensor, b1: torch.Tensor,
                         w2: torch.Tensor, b2: torch.Tensor,
                         mean_bgr: list[float]) -> torch.Tensor:
    return fused_stem_uint8_plain(_conv1_params(w1, b1, w2, b2), images, mean_bgr)


@_fused_stem_uint8_op.register_kernel("cuda")
def _fused_stem_uint8_cuda(images, w1, b1, w2, b2, mean_bgr):
    _check_uint8_images(images)
    weights = uint8_stem_weights(_conv1_params(w1, b1, w2, b2))
    _check_device("fused_stem_uint8", images, *weights)
    if not images.is_contiguous():
        raise ValueError("fused_stem_uint8: images must be contiguous NHWC")
    if weights[0].shape != (_C, 48) or weights[2].shape != (9, _C, _C):
        raise ValueError("fused_stem_uint8: expected conv1_1 (64, 3, 3, 3), conv1_2 (64, 64, 3, 3)")
    b, h, w, _ = images.shape
    out = torch.empty((b, h // 2, w // 2, _C), dtype=torch.bfloat16, device=images.device)
    if out.numel() == 0:
        return out
    mean = torch.tensor(mean_bgr, dtype=torch.float32, device=images.device)
    w1k, b1f, w2t, b2f = weights
    _launch("stem_uint8", images.device, (images.data_ptr(), mean.data_ptr(), w1k.data_ptr(),
                                          b1f.data_ptr(), w2t.data_ptr(), b2f.data_ptr(),
                                          out.data_ptr()), b, h, w)
    _COUNTED["stem_uint8"].launches += 1
    return out


@_fused_stem_uint8_op.register_fake
def _fused_stem_uint8_shape(images, w1, b1, w2, b2, mean_bgr):
    _check_uint8_images(images)
    b, h, w, _ = images.shape
    return images.new_empty((b, h // 2, w // 2, _C), dtype=torch.bfloat16)


def fused_stem_uint8(params, images, mean_bgr, nine_taps: bool = False):
    """The whole stem (preprocess + conv1_1 + conv1_2 + pool1) in one
    kernel reading the raw uint8 image: counterpart of JAX
    ``stem_pallas.fused_stem_uint8``.

    Args:
      params: the model's parameters (uses ``conv1_1`` and ``conv1_2``,
        OIHW weights, float32 biases).
      images: ``(B, H, W, 3)`` uint8 BGR, contiguous; H and W even.
      mean_bgr: the channel means subtracted in float32.
      nine_taps: accepted for the JAX signature and ignored. The TPU
        kernel has two conv1_1 tap layouts (K = 18 after merging the dy
        taps, or nine K = 6 dots) that compute one function; the port has
        one layout (``csrc/stem_uint8.cu``).

    Returns:
      ``(B, H/2, W/2, 64)`` bf16 pool1, through the operator
      ``torch.ops.ssd_torch.fused_stem_uint8``: CUDA tensors run the kernel
      (and count one launch in ``fused_stem_uint8.launches``); CPU tensors
      the plain version.
    """
    del nine_taps
    _check_uint8_images(images)
    p1, p2 = params["conv1_1"], params["conv1_2"]
    _known_device("fused_stem_uint8", images, p1["w"], p1["b"], p2["w"], p2["b"])
    return torch.ops.ssd_torch.fused_stem_uint8(images, p1["w"], p1["b"], p2["w"], p2["b"],
                                                [float(m) for m in mean_bgr])


fused_stem_uint8.launches = 0

#: the wrappers whose ``launches`` each kernel's launch counts in
_COUNTED = {"stem": fused_stem, "stem_uint8": fused_stem_uint8}
