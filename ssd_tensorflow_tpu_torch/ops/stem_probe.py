"""The stem probes' kernels: CUDA counterparts of the Pallas kernels in
``tools/stem_kernel_probe.py`` and ``tools/stem_uint8_probe.py``, with
their plain versions.

* :func:`stem_probe` — the split stem's cost bisection on the probe's own
  shapes: a1 ``(B, T, 34, WP, 64)`` bf16 row tiles (each with its two
  halo rows), w1 ``(64, 128)``, w2 ``(3, 3, 128, 128)`` -> ``(B, T, 16,
  WP, 64)`` bf16, one variant of :data:`PROBE_VARIANTS` per call.
* :func:`lane_unflatten_sum` — the lane-unflatten probe's function:
  ``(R, 6N)`` bf16 -> ``(R, N)``, each group of 6 summed in float32 in
  order and rounded once.

``tools/torch_stem_probe.py`` times them; ``chip_smoke.py`` holds each
against its plain version. CUDA tensors run ``csrc/stem_probe.cu`` (and
count launches); CPU tensors take the plain versions. The plain
convolutions want TF32 off on the card.
"""

from __future__ import annotations

import ctypes
import functools

import torch
import torch.nn.functional as F

from ssd_tensorflow_tpu_torch.ops import _build

#: variant -> (kernel code, taps), in the TPU probe's order
PROBE_VARIANTS = {
    "copy": (0, 0),
    "conv1_1": (1, 0),
    "conv1_1_store": (2, 0),
    "taps1": (3, 1),
    "taps3": (3, 3),
    "taps9": (3, 9),
    "taps9_aligned": (4, 9),
}

_ROWS_IN, _ROWS_OUT, _CIN, _CMID = 34, 16, 64, 128
#: the TPU probe's shape: batch, row tiles, packed columns
PROBE_SHAPE = (64, 16, 256)


def probe_inputs(seed: int, device, shape=PROBE_SHAPE):
    """``(a1, w1, w2)`` of the stem probe from ``torch.Generator(seed)``:
    a1 ``(B, T, 34, WP, 64)``, w1 ``(64, 128)`` and w2 ``(3, 3, 128, 128)``,
    bf16 standard normal as in the TPU probe."""
    b, t, wp = shape
    g = torch.Generator(device=device).manual_seed(seed)
    a1 = torch.randn((b, t, _ROWS_IN, wp, _CIN), generator=g, device=device).to(torch.bfloat16)
    w1 = torch.randn((_CIN, _CMID), generator=g, device=device).to(torch.bfloat16)
    w2 = torch.randn((3, 3, _CMID, _CMID), generator=g, device=device).to(torch.bfloat16)
    return a1, w1, w2


def stem_probe_plain(a1, w1, w2, variant: str):
    """Plain PyTorch version of :func:`stem_probe`, same contract."""
    code, n_taps = PROBE_VARIANTS[variant]
    bsz, tiles, _, wp, _ = a1.shape
    if code == 0:
        return a1[:, :, :_ROWS_OUT].contiguous()
    w1f = w1.to(torch.bfloat16).float()
    if code in (1, 2):
        y = torch.relu(a1[:, :, :_ROWS_OUT].float() @ w1f[:, : _CIN])
        return y.to(torch.bfloat16)
    y1 = torch.relu(a1.float() @ w1f).to(torch.bfloat16).float()
    y1 = F.pad(y1.reshape(bsz * tiles, _ROWS_IN, wp, _CMID), (0, 0, 1, 1))  # zero column border
    w2f = w2.to(torch.bfloat16).float()
    acc = None
    for tap in range(n_taps):
        dy, dx = divmod(tap, 3)
        col = 0 if code == 4 else dx  # the aligned variant reads every tap at offset 0
        term = y1[:, dy : dy + 2 * _ROWS_OUT, col : col + wp] @ w2f[dy, dx]
        acc = term if acc is None else acc.add_(term)
    z = torch.relu(acc).reshape(bsz * tiles, _ROWS_OUT, 2, wp, _CMID).amax(dim=2)
    out = torch.maximum(z[..., : _CIN], z[..., _CIN :])
    return out.to(torch.bfloat16).reshape(bsz, tiles, _ROWS_OUT, wp, _CIN)


def lane_unflatten_sum_plain(x):
    """Plain PyTorch version of :func:`lane_unflatten_sum`, same contract."""
    g = x.reshape(x.shape[0], -1, 6).float()
    s = g[..., 0]
    for k in range(1, 6):
        s = s + g[..., k]
    return s.to(torch.bfloat16)


#: weight slots of the kernel: w1, then the two K halves of each of the 9 taps
WEIGHT_SLOTS = 19


def probe_weight_slots(w1, w2):
    """The kernel's weight stream: ``(19, 128, 64)`` bf16, contiguous.

    Slot 0 is w1 and slot ``1 + 2 * (3 * dy + dx) + h`` the input channels
    ``64 h .. 64 h + 63`` of tap ``w2[dy, dx]``, each as ``[cout][cin]``
    rows of 128 bytes in the 128-byte swizzle that ``wgmma``'s matrix
    descriptor reads: the 16-byte chunk ``c`` of row ``r`` sits at chunk
    ``c ^ (r & 7)``. A slot then needs no rearranging on the card: one
    bulk copy lands it in shared memory. ``w1`` ``(64, 128)`` and ``w2``
    ``(3, 3, 128, 128)`` may be any views."""
    w1t = w1.to(torch.bfloat16).t()  # [cout][cin]
    w2t = w2.to(torch.bfloat16).permute(0, 1, 3, 2).reshape(9, _CMID, 2, _CIN)  # [tap][cout][h][cin]
    slots = torch.cat([w1t[None], w2t.permute(0, 2, 1, 3).reshape(18, _CMID, _CIN)])
    row = torch.arange(_CMID, device=slots.device)[:, None]
    chunk = torch.arange(8, device=slots.device)[None, :]
    # the chunk stored at position c is the row's chunk c ^ (r & 7)
    swizzled = slots.reshape(WEIGHT_SLOTS, _CMID, 8, 8)[:, row, chunk ^ (row & 7)]
    return swizzled.reshape(WEIGHT_SLOTS, _CMID, _CIN).contiguous()


@functools.cache
def _launchers():
    lib = _build.libraries()["stem_probe"]
    probe, unflatten = lib.stem_probe_launch, lib.lane_unflatten_sum_launch
    floor = lib.launch_floor_launch
    probe.argtypes = ([ctypes.c_int] + [ctypes.c_void_p] * 3 + [ctypes.c_int] * 4
                      + [ctypes.c_void_p])
    unflatten.argtypes = [ctypes.c_void_p] * 2 + [ctypes.c_int] * 3 + [ctypes.c_void_p]
    floor.argtypes = [ctypes.c_int] * 3 + [ctypes.c_void_p]
    probe.restype = unflatten.restype = floor.restype = ctypes.c_int
    return probe, unflatten, floor


def _stream(device):
    return torch.cuda.current_stream(device).cuda_stream


def _one_wave(device) -> int:
    """Blocks of the lane sum's 128 threads that one wave holds: 16 a SM."""
    return 16 * torch.cuda.get_device_properties(device).multi_processor_count


def stem_probe(a1, w1, w2, variant: str):
    """One stem-probe variant (see the module docstring and
    ``csrc/stem_probe.cu``). ``a1`` is ``(B, T, 34, WP, 64)`` bf16
    contiguous with WP a multiple of 16, ``w1`` ``(64, 128)``, ``w2``
    ``(3, 3, 128, 128)`` [dy][dx][cin][cout]. Returns ``(B, T, 16, WP, 64)``
    bf16. CUDA tensors run the kernel (one launch in
    ``stem_probe.launches``); CPU tensors the plain version."""
    if variant not in PROBE_VARIANTS:
        raise ValueError(f"stem_probe: variant must be one of {list(PROBE_VARIANTS)}, "
                         f"got {variant!r}")
    if a1.device.type == "cpu":
        return stem_probe_plain(a1, w1, w2, variant)
    if a1.device.type != "cuda" or w1.device != a1.device or w2.device != a1.device:
        raise ValueError(f"stem_probe: operands must share one CUDA device, got {a1.device}")
    if (a1.dtype != torch.bfloat16 or a1.dim() != 5 or a1.shape[2] != _ROWS_IN
            or a1.shape[4] != _CIN or a1.shape[3] % 16 or not a1.is_contiguous()):
        raise ValueError(f"stem_probe: a1 must be contiguous (B, T, 34, WP, 64) bf16 with WP "
                         f"a multiple of 16, got {tuple(a1.shape)} {a1.dtype}")
    if w1.shape != (_CIN, _CMID) or w2.shape != (3, 3, _CMID, _CMID):
        raise ValueError("stem_probe: expected w1 (64, 128) and w2 (3, 3, 128, 128)")
    bsz, tiles, _, wp, _ = a1.shape
    out = torch.empty((bsz, tiles, _ROWS_OUT, wp, _CIN), dtype=torch.bfloat16, device=a1.device)
    if out.numel() == 0:
        return out
    code, n_taps = PROBE_VARIANTS[variant]
    wslots = probe_weight_slots(w1, w2)
    per_sm = 8 if code == 0 else 1  # the copy needs no shared memory
    sms = torch.cuda.get_device_properties(a1.device).multi_processor_count
    with torch.cuda.device(a1.device):
        rc = _launchers()[0](code, a1.data_ptr(), wslots.data_ptr(), out.data_ptr(), bsz * tiles,
                             wp, n_taps, sms * per_sm, _stream(a1.device))
    _build.check(rc, f"stem_probe({variant})")
    stem_probe.launches += 1
    return out


stem_probe.launches = 0


def lane_unflatten_sum(x):
    """``(R, 6N)`` bf16 -> ``(R, N)`` bf16: each group of 6 consecutive
    values summed in float32 in order, rounded once. CUDA tensors run the
    kernel (one launch in ``lane_unflatten_sum.launches``), four groups a
    thread by 16-byte loads where ``x`` is 16-byte aligned; CPU tensors
    the plain version."""
    if x.dim() != 2 or x.shape[1] % 6:
        raise ValueError(f"lane_unflatten_sum: x must be (R, 6N), got {tuple(x.shape)}")
    if x.device.type == "cpu":
        return lane_unflatten_sum_plain(x)
    if x.device.type != "cuda":
        raise ValueError(f"lane_unflatten_sum: unsupported device {x.device}")
    if x.dtype != torch.bfloat16 or not x.is_contiguous():
        raise ValueError("lane_unflatten_sum: x must be contiguous bf16")
    rows, n = x.shape[0], x.shape[1] // 6
    out = torch.empty((rows, n), dtype=torch.bfloat16, device=x.device)
    if out.numel() == 0:
        return out
    with torch.cuda.device(x.device):
        rc = _launchers()[1](x.data_ptr(), out.data_ptr(), rows, n, _one_wave(x.device),
                             _stream(x.device))
    _build.check(rc, "lane_unflatten_sum")
    lane_unflatten_sum.launches += 1
    return out


lane_unflatten_sum.launches = 0


def launch_floor(x):
    """Launch an empty kernel on the grid :func:`lane_unflatten_sum` gives
    the CUDA tensor ``x``: what a launch of that grid costs, the practical
    bound of launch-sized work. A measuring aid; counts nothing."""
    if x.device.type != "cuda" or x.dim() != 2 or x.shape[1] % 6 or x.numel() == 0:
        raise ValueError(f"launch_floor: x must be a non-empty (R, 6N) CUDA tensor, got "
                         f"{tuple(x.shape)} on {x.device}")
    with torch.cuda.device(x.device):
        rc = _launchers()[2](x.shape[0], x.shape[1] // 6, _one_wave(x.device), _stream(x.device))
    _build.check(rc, "launch_floor")
