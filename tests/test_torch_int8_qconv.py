"""``ops/int8_conv.int8_qconv`` on the CPU: its checks raise on what the
card kernel does not take, and its CPU route is the three-pass chain
(``quantize`` -> ``int8_conv_plain`` -> ``requant``) bit for bit at every
geometry class the int8 forwards run, uncounted. The kernel itself is
held against the chain on the card in ``tests/test_torch_cuda.py``."""

import pytest
import torch

from ssd_tensorflow_tpu_torch.models import quantized
from ssd_tensorflow_tpu_torch.ops import int8_conv as ic


def _layer(cin, k, cout, seed, per_channel=False):
    g = torch.Generator().manual_seed(seed)
    wq = torch.randint(-127, 128, (k, k, cin, cout), generator=g, dtype=torch.int8)
    return {"w": ic.stage_int8_weight(wq),
            "inv": 1.0 / (0.02 + 0.08 * torch.rand(cin if per_channel else 1, generator=g)),
            "mult": 1e-6 + 1e-4 * torch.rand(cout, generator=g),
            "b": torch.randn(cout, generator=g)}


def _x(b, h, w, cin, seed):
    g = torch.Generator().manual_seed(seed + 1)
    return (3 * torch.randn((b, h, w, cin), generator=g)).to(torch.bfloat16)


#: (name, x (B, H, W, cin), k, cout, stride, padding, dilation, per-channel inv)
GEOMETRIES = [
    ("3x3", (2, 9, 11, 32), 3, 64, 1, "SAME", 1, False),
    ("1x1", (2, 5, 7, 64), 1, 96, 1, "SAME", 1, False),
    ("stride2", (2, 9, 8, 32), 3, 48, 2, "SAME", 1, False),
    ("dilation6", (1, 14, 13, 16), 3, 32, 1, "SAME", 6, False),
    ("valid", (2, 4, 4, 32), 3, 32, 1, "VALID", 1, False),
    ("cin3", (2, 12, 10, 3), 3, 64, 1, "SAME", 1, False),
    ("7x7_stride2_cin3", (1, 16, 15, 3), 7, 64, 2, "SAME", 1, True),
    ("head_n100", (2, 6, 6, 32), 3, 100, 1, "SAME", 1, True),
    ("head_n150_1x1_map", (3, 1, 1, 64), 3, 150, 1, "SAME", 1, True),
    ("pointwise_stride2", (2, 9, 9, 32), 1, 64, 2, "SAME", 1, True),
]


@pytest.mark.parametrize("relu", [True, False], ids=["relu", "linear"])
@pytest.mark.parametrize("name,shape,k,cout,stride,padding,dilation,per_channel", GEOMETRIES,
                         ids=[g[0] for g in GEOMETRIES])
def test_int8_qconv_cpu_route_is_the_chain(name, shape, k, cout, stride, padding, dilation,
                                           per_channel, relu):
    layer = _layer(shape[-1], k, cout, len(name), per_channel)
    x = _x(*shape, len(name))
    want = ic.requant(ic.int8_conv_plain(ic.quantize(x, layer["inv"]), layer["w"], stride,
                                         padding, dilation), layer, relu)
    got = ic.int8_qconv(x, layer, stride, padding, dilation, relu)
    assert got.dtype == torch.bfloat16 and got.shape == want.shape
    assert torch.equal(got, want)
    # the model's conv is this call
    conv = quantized._qconv_executor({name: layer})
    got = conv(name, x, stride=stride, padding=padding, dilation=dilation, relu=relu)
    assert torch.equal(got, want)


def test_int8_qconv_does_not_count_on_the_cpu():
    layer, x = _layer(32, 3, 64, 5), _x(1, 6, 6, 32, 5)
    before, im2col = ic.int8_qconv.launches, ic.int8_conv.launches
    ic.int8_qconv(x, layer)
    ic.int8_qconv_plain(x, layer)
    assert ic.int8_qconv.launches == before and ic.int8_conv.launches == im2col


def test_int8_qconv_rejects_bad_input():
    layer = _layer(8, 3, 16, 3)
    x = _x(1, 4, 4, 8, 3)
    with pytest.raises(ValueError, match="bf16"):
        ic.int8_qconv(x.float(), layer)
    with pytest.raises(ValueError, match="bf16"):
        ic.int8_qconv(x.permute(0, 3, 1, 2), layer)  # NCHW: cin is not the last axis
    with pytest.raises(ValueError, match="bf16"):
        ic.int8_qconv(x[0], layer)
    with pytest.raises(ValueError, match="inv"):
        ic.int8_qconv(x, {**layer, "inv": torch.ones(2)})
    with pytest.raises(ValueError, match="inv"):
        ic.int8_qconv(x, {**layer, "inv": torch.ones(1, dtype=torch.float64)})
    with pytest.raises(ValueError, match="mult"):
        ic.int8_qconv(x, {**layer, "mult": torch.ones(15)})
    with pytest.raises(ValueError, match="CUDA device"):
        ic.int8_qconv(x.to("meta"), layer)
    with pytest.raises(ValueError, match="padding"):
        ic.int8_qconv(x, layer, padding="FULL")
