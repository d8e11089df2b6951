"""MobileNet's depthwise convs on the CPU (``models/layers.depthwise_conv2d``,
``ops/depthwise_cuda``): the kernel's plain version against the
``F.conv2d(groups=C)`` route at the depthwise shapes of mobilenet320 and
mntest64 (batch 2) and at odd sizes, both epilogues; the route rule; the
wrapper's argument checks; and the call through the kernel's route with
the plain version in the kernel's place. The kernel itself is held to the
plain version on the card
(``tests/test_torch_cuda.py::test_depthwise_kernel_matches_plain``)."""

from unittest import mock

import pytest
import torch

from ssd_tensorflow_tpu_torch.models import layers, mobilenet
from ssd_tensorflow_tpu_torch.ops import _build, depthwise_cuda as dwc


def _model_shapes(side: int):
    """``(H, W, C, stride)`` of the 13 depthwise convs of a MobileNetV1
    trunk on ``side`` x ``side`` images (after the stride-2 stem), one per
    distinct shape."""
    shapes, hw, c = [], -(-side // 2), 32
    for stride, cout in mobilenet.BLOCKS:
        if (hw, hw, c, stride) not in shapes:
            shapes.append((hw, hw, c, stride))
        hw, c = -(-hw // stride), cout
    return shapes


#: mobilenet320's and mntest64's depthwise shapes (even sizes: a stride-2
#: TF SAME pads 0 on top and 1 below), then odd and non-square maps (a
#: stride-2 SAME pads 1 on each side) and ragged widths
SHAPES = _model_shapes(320) + _model_shapes(64) + [
    (21, 21, 48, 2), (9, 9, 16, 1), (7, 5, 8, 2), (5, 8, 24, 2), (1, 1, 64, 1), (2, 3, 40, 2)]
#: the wrapper's two epilogues
FORMS = [True, False]


def _inputs(h, w, c, seed, bias_dtype=torch.float32):
    g = torch.Generator().manual_seed(seed)
    x = (2 * torch.randn((2, h, w, c), generator=g)).to(torch.bfloat16)
    wt = (torch.randn((c, 1, 3, 3), generator=g) / 3).to(torch.bfloat16)
    b = torch.randn(c, generator=g).to(bias_dtype)
    return x, wt, b


def test_the_model_shapes():
    """The 13 convs of mobilenet320 come to 9 distinct shapes, from
    160x160x32 down to 10x10x1024."""
    assert _model_shapes(320) == [(160, 160, 32, 1), (160, 160, 64, 2), (80, 80, 128, 1),
                                  (80, 80, 128, 2), (40, 40, 256, 1), (40, 40, 256, 2),
                                  (20, 20, 512, 1), (20, 20, 512, 2), (10, 10, 1024, 1)]


@pytest.mark.parametrize("f32_out", FORMS, ids=["f32_out", "two_roundings"])
@pytest.mark.parametrize("h,w,c,stride", SHAPES)
def test_plain_equals_the_library_route(h, w, c, stride, f32_out):
    """``depthwise_plain`` (the 9-tap shifted-slice float32 sum in the
    kernel's order, then the epilogue) gives the bits of
    ``F.conv2d(groups=C)``, the route every CPU tensor takes, at TF SAME
    padding, symmetric or not; the bias of the int8 route is bf16."""
    x, wt, b = _inputs(h, w, c, h * c + stride, torch.float32 if f32_out else torch.bfloat16)
    pads = layers._pads(x, wt, stride, "SAME", 1)
    want = layers.depthwise_conv2d(x, wt, b, stride, "SAME", f32_out)
    got = dwc.depthwise_plain(x, wt, b, stride, pads, f32_out)
    assert got.dtype == torch.bfloat16 and got.shape == want.shape
    assert want.shape[1:3] == (-(-h // stride), -(-w // stride))
    assert torch.equal(got, want)


@pytest.mark.parametrize("padding", ["VALID", 1, 2])
@pytest.mark.parametrize("f32_out", FORMS, ids=["f32_out", "two_roundings"])
def test_plain_equals_the_library_route_at_other_paddings(padding, f32_out):
    """VALID and int padding (on every side), and no bias, as well."""
    x, wt, b = _inputs(11, 10, 16, 3)
    for stride in (1, 2):
        pads = layers._pads(x, wt, stride, padding, 1)
        for bias in (b, None):
            want = layers.depthwise_conv2d(x, wt, bias, stride, padding, f32_out)
            assert torch.equal(dwc.depthwise_plain(x, wt, bias, stride, pads, f32_out), want)


@pytest.mark.parametrize("case", ["bf16", "float32", "float16", "rank3", "grad_x", "grad_w",
                                  "grad_b", "no_grad"])
def test_route_rule(case):
    """``eligible``: an NHWC bf16 map, and no gradient needed through it;
    ``engages`` also needs the card, so every CPU tensor stays on the
    ``F.conv2d`` route."""
    dtype = {"float32": torch.float32, "float16": torch.float16}.get(case, torch.bfloat16)
    x = torch.zeros((4, 4, 8) if case == "rank3" else (1, 4, 4, 8), dtype=dtype)
    w, b = torch.zeros((8, 1, 3, 3)), torch.zeros(8)
    if case in ("grad_x", "grad_w", "grad_b", "no_grad"):
        {"grad_x": x, "grad_b": b}.get(case, w).requires_grad_(True)
    want = case in ("bf16", "no_grad")
    if case == "no_grad":
        with torch.no_grad():
            assert dwc.eligible(x, w, b)
    else:
        assert dwc.eligible(x, w, None, b) is want
    assert not dwc.engages(x, w, b)


@pytest.mark.parametrize("case", ["cpu_bf16", "cpu_float32", "requires_grad"])
def test_cpu_takes_the_library_route(case):
    """A CPU map, bf16 or float32, and a forward that needs gradients take
    ``depthwise_conv2d_library``, bit for bit, and never the kernel; each
    counts one call and its gradients flow."""
    x, wt, b = _inputs(9, 9, 16, 7)
    if case == "cpu_float32":
        x = x.float()
    if case == "requires_grad":
        x.requires_grad_(True)
    before, calls = dwc.depthwise_cuda.launches, layers.depthwise_conv2d.calls
    got = layers.depthwise_conv2d(x, wt, b, 2)
    assert layers.depthwise_conv2d.calls == calls + 1
    assert torch.equal(got, layers.depthwise_conv2d_library(x, wt, b, 2))
    assert dwc.depthwise_cuda.launches == before == 0
    if case == "requires_grad":
        got.float().sum().backward()
        assert x.grad is not None and x.grad.shape == x.shape


@pytest.mark.parametrize("f32_out", FORMS, ids=["f32_out", "two_roundings"])
@pytest.mark.parametrize("bias", ["float32", "bf16", "none"])
@pytest.mark.parametrize("h,w,c,stride", [(10, 10, 64, 2), (9, 7, 32, 2), (8, 8, 16, 1)])
def test_the_kernel_route_hands_over_its_arguments(h, w, c, stride, bias, f32_out):
    """Where the route rule holds, ``depthwise_conv2d`` hands the kernel a
    contiguous map, the bf16 filter, the bias in the epilogue's dtype
    (float32 for ``f32_out``, else bf16) and the TF SAME pads; with the
    plain version in the kernel's place the result is the library
    route's, and the call still counts once in ``ssd.depthwise``."""
    x, wt, b = _inputs(h, w, c, c + h, torch.bfloat16 if bias == "bf16" else torch.float32)
    b = None if bias == "none" else b
    x = x.permute(0, 3, 1, 2).contiguous().permute(0, 2, 3, 1)  # NCHW memory
    seen = []

    def kernel(*args):
        seen.append(args)
        xk, wk, bk = args[:3]
        assert xk.is_contiguous() and wk.dtype is torch.bfloat16
        assert bk is None or bk.dtype is (torch.float32 if f32_out else torch.bfloat16)
        return dwc.depthwise_plain(*args)

    calls = layers.depthwise_conv2d.calls
    with mock.patch.object(dwc, "engages", lambda *a: True), \
            mock.patch.object(dwc, "depthwise_cuda", kernel):
        got = layers.depthwise_conv2d(x, wt.float(), b, stride, "SAME", f32_out)
    assert len(seen) == 1 and layers.depthwise_conv2d.calls == calls + 1
    assert seen[0][3:] == (stride, layers._pads(x, wt, stride, "SAME", 1), f32_out)
    assert torch.equal(got, layers.depthwise_conv2d_library(x, wt, b, stride, "SAME", f32_out))


@pytest.mark.parametrize("case", ["filter_5x5", "stride_3", "non_contiguous", "float32", "rank3",
                                  "channels_12", "filter_dtype", "bias_dtype_f32_out",
                                  "bias_dtype_two_roundings", "bias_shape", "no_output", "cpu"])
def test_wrapper_checks_raise_without_building(case):
    """``depthwise_cuda`` raises ValueError on what the kernel does not
    take, before it builds or loads the kernel library. The device is
    checked last, so each case but ``cpu`` (arguments the kernel takes, on
    the CPU) raises for its own fault here."""
    x = torch.zeros((1, 6, 6, 16), dtype=torch.bfloat16)
    w, b = torch.zeros((16, 1, 3, 3), dtype=torch.bfloat16), torch.zeros(16)
    stride, pads, f32_out = 1, ((1, 1), (1, 1)), True
    if case == "filter_5x5":
        w = torch.zeros((16, 1, 5, 5), dtype=torch.bfloat16)
    elif case == "stride_3":
        stride = 3
    elif case == "non_contiguous":
        x = torch.zeros((1, 16, 6, 6), dtype=torch.bfloat16).permute(0, 2, 3, 1)
    elif case == "float32":
        x = x.float()
    elif case == "rank3":
        x = x[0]
    elif case == "channels_12":
        x, w, b = x[..., :12].contiguous(), w[:12].contiguous(), b[:12]
    elif case == "filter_dtype":
        w = w.float()
    elif case == "bias_dtype_f32_out":
        b = b.to(torch.bfloat16)
    elif case == "bias_dtype_two_roundings":
        f32_out = False
    elif case == "bias_shape":
        b = torch.zeros(8)
    elif case == "no_output":
        x, pads = torch.zeros((1, 2, 6, 16), dtype=torch.bfloat16), ((0, 0), (0, 0))
    match = "CUDA tensor" if case == "cpu" else "depthwise_cuda"
    with mock.patch.object(_build, "libraries", side_effect=AssertionError("built")), \
            pytest.raises(ValueError, match=match) as err:
        dwc.depthwise_cuda(x, w, b, stride, pads, f32_out)
    assert (case == "cpu") == ("CUDA tensor" in str(err.value))


def test_the_source_is_built():
    """``csrc/depthwise_conv.cu`` is one of the built libraries, and its
    launch function is the one the wrapper binds."""
    assert "depthwise_conv" in _build.SOURCES
    src = (_build.CSRC / "depthwise_conv.cu").read_text()
    assert 'extern "C" int depthwise3x3_launch(' in src
    assert "depthwise3x3_nhwc" in src
