"""The port's CUDA kernels against their plain versions, on the card.

Marked ``cuda``: each test skips without a GPU. Run on a machine with
one:  ``python -m pytest -m cuda tests/test_torch_cuda.py``.

NMS keep masks, the lane-unflatten sums and the int8 convolution's int32
sums must be identical. The stem
kernels and the stem probe may differ from their plain versions by one
bf16 step of the largest output (2^-7 relative): both sum exact bf16
products in float32, in different orders. The fused conv + bias + ReLU
of ``layers.conv_relu`` must round once: equal to
``bf16(relu(conv_f32 + b))`` on >= 99 % of elements and within one bf16
step of the largest output; the heads' ``layers.conv2d_bias_in`` likewise
on >= 99.9 %.
"""

import contextlib

import numpy as np
import pytest
import torch

from ssd_tensorflow_tpu_torch.models import layers, ssd_vgg
from ssd_tensorflow_tpu_torch.models.ssd_vgg import ModelConfig, init_params
from ssd_tensorflow_tpu_torch.ops import int8_conv, nms_cuda, stem_cuda, stem_probe
from ssd_tensorflow_tpu_torch.ops.boxes import box_canvas_corners
from ssd_tensorflow_tpu_torch.ops.nms import class_shifted

from torch_nms_cases import nms_cases

pytestmark = pytest.mark.cuda

NMS_CASES = nms_cases()


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU (torch.cuda.is_available() is False)")
    torch.backends.cudnn.allow_tf32 = False
    return torch.device("cuda")


@pytest.mark.parametrize("b,d", [(64, 200), (3, 57), (2, 256), (1, 1), (2, 1024), (2, 1025),
                                 (2, 5000)])
def test_nms_kernel_matches_plain(cuda, b, d):
    rng = np.random.default_rng(d)
    w, h = rng.uniform(0.05, 0.5, (2, b, d))
    boxes = np.stack([rng.uniform(w / 2, 1 - w / 2), rng.uniform(h / 2, 1 - h / 2), w, h], -1)
    boxes[:, : d // 2] = np.clip(boxes[:, np.arange(d // 2) % 8] + rng.normal(0, 0.01, (b, d // 2, 4)),
                                 0.02, 0.98)
    corners = box_canvas_corners(torch.tensor(boxes, dtype=torch.float32))
    shifted = class_shifted(corners, torch.tensor(rng.integers(0, 5, (b, d)))).contiguous()
    valid = torch.tensor(np.sort(rng.uniform(0, 1, (b, d)), 1)[:, ::-1] > 0.2)
    want = nms_cuda.nms_keep(shifted, valid)  # CPU: the plain version
    before = nms_cuda.nms_keep.launches
    got = nms_cuda.nms_keep(shifted.to(cuda), valid.to(cuda))
    assert nms_cuda.nms_keep.launches == before + 1
    assert torch.equal(got.cpu(), want)


@pytest.mark.parametrize("name", list(NMS_CASES))
def test_nms_kernel_matches_plain_on_block_scan_cases(cuda, name):
    corners, valid, threshold, expected = NMS_CASES[name]
    corners, valid = torch.from_numpy(corners), torch.from_numpy(valid)
    want = nms_cuda.nms_keep_plain(corners, valid, threshold)
    got = nms_cuda.nms_keep(corners.to(cuda), valid.to(cuda), threshold)
    assert torch.equal(got.cpu(), want)
    if expected is not None:
        assert torch.equal(want, torch.from_numpy(expected))


@pytest.mark.parametrize("threshold", [0.45, 0.5, 0.0, 1.0, -0.25, 1e-3, 0.999])
def test_nms_kernel_thresholds_and_fractional_corners(cuda, threshold):
    """The kernel divides only where the rounding of the quotient could
    decide: many IoUs of nested boxes are simple fractions (k / 100) that
    sit exactly at or one ulp from such thresholds; fractional corners,
    zero and negative areas and infinities take every other branch."""
    rng = np.random.default_rng(17)
    b, d = 4, 200
    nested = np.zeros((b, d, 4), dtype=np.float32)  # x in [0, 99], rows [0, k): IoU k / 100
    nested[..., 1] = 99
    nested[..., 3] = rng.integers(0, 100, (b, d))
    frac = rng.uniform(0, 300, (b, d, 4)).astype(np.float32)
    frac[..., 1] += frac[..., 0]
    frac[..., 3] = frac[..., 2] + rng.uniform(-2, 200, (b, d))  # some areas <= 0
    frac[0, 3, 1] = np.inf
    frac[1, 9, :] = 1e30
    frac[2, 5, 2] = -np.inf
    valid = torch.from_numpy(rng.uniform(0, 1, (b, d)) > 0.1)
    for corners in (nested, frac):
        corners = torch.from_numpy(corners)
        want = nms_cuda.nms_keep_plain(corners, valid, threshold)
        got = nms_cuda.nms_keep(corners.to(cuda), valid.to(cuda), threshold)
        assert torch.equal(got.cpu(), want)


def test_nms_kernel_alternating_chain_at_the_largest_d(cuda):
    """D = 1024, 32 blocks: every candidate overlaps only its predecessor,
    so each block's first live bit depends on the block before."""
    d = nms_cuda.MAX_CANDIDATES
    idx = torch.arange(d, dtype=torch.float32)
    corners = torch.stack([30 * idx, 30 * idx + 99, torch.zeros(d), torch.full((d,), 99.0)], -1)[None]
    valid = torch.ones((1, d), dtype=torch.bool)
    got = nms_cuda.nms_keep(corners.to(cuda), valid.to(cuda))
    assert torch.equal(got.cpu()[0], torch.arange(d) % 2 == 0)
    assert torch.equal(got.cpu(), nms_cuda.nms_keep_plain(corners, valid))


@pytest.mark.parametrize("d", [1025, 5000])
def test_nms_kernel_alternating_chain_in_device_memory(cuda, d):
    """The device-memory mask's scan: every candidate overlaps only its
    predecessor, 157 blocks at D = 5000."""
    idx = torch.arange(d, dtype=torch.float32)
    corners = torch.stack([30 * idx, 30 * idx + 99, torch.zeros(d), torch.full((d,), 99.0)], -1)[None]
    valid = torch.ones((1, d), dtype=torch.bool)
    got = nms_cuda.nms_keep(corners.to(cuda), valid.to(cuda))
    assert torch.equal(got.cpu()[0], torch.arange(d) % 2 == 0)


def test_nms_kernel_multi_label_candidates(cuda):
    """RetinaNet's shape of input: 5 levels x 1000 candidates of 264
    classes, sorted by score, many boxes of one class on one object, a
    fifth invalid, at NMS 0.5."""
    rng = np.random.default_rng(5000)
    b, d = 3, 5000
    centers = rng.uniform(0.1, 0.9, (b, 40, 2))
    obj = rng.integers(0, 40, (b, d))
    c = np.take_along_axis(centers, obj[..., None], 1) + rng.normal(0, 0.02, (b, d, 2))
    wh = rng.uniform(0.05, 0.4, (b, d, 2))
    boxes = torch.tensor(np.concatenate([c, wh], -1), dtype=torch.float32)
    classes = torch.tensor((obj * 7 + rng.integers(0, 3, (b, d))) % 264)
    shifted = class_shifted(box_canvas_corners(boxes), classes).contiguous()
    valid = torch.tensor(rng.uniform(0, 1, (b, d)) > 0.2)
    want = nms_cuda.nms_keep_plain(shifted, valid, 0.5)
    got = nms_cuda.nms_keep(shifted.to(cuda), valid.to(cuda), 0.5)
    assert torch.equal(got.cpu(), want) and 0 < int(want.sum()) < int(valid.sum())


def test_nms_kernel_rejects_too_many_candidates(cuda):
    corners = torch.zeros((1, nms_cuda.MAX_CANDIDATES_GLOBAL + 1, 4), device=cuda)
    valid = torch.ones(corners.shape[:2], dtype=torch.bool, device=cuda)
    with pytest.raises(ValueError, match="exceeds"):
        nms_cuda.nms_keep(corners, valid)


#: the original shapes, then a batch that does not divide the grid, exactly
#: one tile, shapes narrower and shorter than one tile, and more tiles than SMs
STEM_SHAPES = [(2, 32, 64), (1, 300, 300), (2, 18, 34), (4, 512, 512), (3, 96, 160), (1, 8, 32),
               (1, 8, 10), (2, 2, 2), (5, 40, 30)]


@pytest.mark.parametrize("b,h,w", STEM_SHAPES)
def test_stem_kernel_matches_plain(cuda, b, h, w):
    params = init_params(ModelConfig(preset_name="vgg300"), seed=1)
    rng = np.random.default_rng(h)
    c1 = torch.tensor(rng.normal(0, 20, (b, h, w, 64)), dtype=torch.bfloat16, device=cuda)
    b1 = torch.tensor(rng.normal(0, 5, 64), dtype=torch.float32, device=cuda)
    w2 = params["conv1_2"]["w"].to(cuda)
    b2 = torch.tensor(rng.normal(0, 1, 64), dtype=torch.float32, device=cuda)
    got = stem_cuda.fused_stem(c1, b1, w2, b2)
    want = stem_cuda.fused_stem_plain(c1, b1, w2, b2)
    assert got.shape == want.shape == (b, h // 2, w // 2, 64) and got.dtype == torch.bfloat16
    scale = float(want.float().abs().max())
    assert float((got.float() - want.float()).abs().max()) <= scale * 2.0 ** -7


def test_stem_kernel_rejects_bad_input(cuda):
    c1 = torch.zeros((1, 6, 7, 64), dtype=torch.bfloat16, device=cuda)
    z = torch.zeros(64, device=cuda)
    with pytest.raises(ValueError, match="even"):
        stem_cuda.fused_stem(c1, z, torch.zeros((64, 64, 3, 3), device=cuda), z)
    with pytest.raises(ValueError, match="bf16"):
        stem_cuda.fused_stem(c1.float(), z, torch.zeros((64, 64, 3, 3), device=cuda), z)


def _one_step(got, want):
    scale = float(want.float().abs().max())
    assert scale > 0
    assert float((got.float() - want.float()).abs().max()) <= scale * 2.0 ** -7


@pytest.mark.parametrize("b,h,w", STEM_SHAPES)
def test_uint8_stem_kernel_matches_plain(cuda, b, h, w):
    params = {k: {n: v.to(cuda) for n, v in p.items()}
              for k, p in init_params(ModelConfig(preset_name="vgg300"), seed=2).items()
              if k in ("conv1_1", "conv1_2")}
    rng = np.random.default_rng(h + w)
    for name in params:
        params[name]["b"] = torch.tensor(rng.normal(0, 2, 64), dtype=torch.float32, device=cuda)
    img = torch.tensor(rng.integers(0, 256, (b, h, w, 3)), dtype=torch.uint8, device=cuda)
    mean = (104.0, 117.0, 123.0)
    before = stem_cuda.fused_stem_uint8.launches
    got = stem_cuda.fused_stem_uint8(params, img, mean)
    assert stem_cuda.fused_stem_uint8.launches == before + 1
    want = stem_cuda.fused_stem_uint8_plain(params, img, mean)
    assert got.shape == want.shape == (b, h // 2, w // 2, 64) and got.dtype == torch.bfloat16
    _one_step(got, want)


def test_uint8_stem_kernel_rejects_bad_input(cuda):
    params = init_params(ModelConfig(preset_name="vgg300"), seed=0)
    params = {k: {n: v.to(cuda) for n, v in params[k].items()} for k in ("conv1_1", "conv1_2")}
    with pytest.raises(ValueError, match="even"):
        stem_cuda.fused_stem_uint8(params, torch.zeros((1, 6, 7, 3), dtype=torch.uint8,
                                                       device=cuda), (0.0, 0.0, 0.0))
    with pytest.raises(ValueError, match="uint8"):
        stem_cuda.fused_stem_uint8(params, torch.zeros((1, 6, 6, 3), device=cuda), (0.0,) * 3)


@pytest.mark.parametrize("variant", list(stem_probe.PROBE_VARIANTS))
def test_stem_probe_kernel_matches_plain(cuda, variant):
    a1, w1, w2 = stem_probe.probe_inputs(3, cuda, shape=(2, 3, 48))
    before = stem_probe.stem_probe.launches
    got = stem_probe.stem_probe(a1, w1, w2, variant)
    assert stem_probe.stem_probe.launches == before + 1
    want = stem_probe.stem_probe_plain(a1, w1, w2, variant)
    assert got.shape == want.shape == (2, 3, 16, 48, 64)
    if variant == "copy":
        assert torch.equal(got, want)
    else:
        _one_step(got, want)


#: one column tile narrower than 32, exactly one, a ragged second one, fewer
#: tiles than SMs and more, a single (b, t) tile
PROBE_SHAPES = [(1, 1, 16), (1, 2, 32), (3, 1, 80), (2, 5, 64), (1, 1, 256)]


@pytest.mark.parametrize("shape", PROBE_SHAPES)
@pytest.mark.parametrize("variant", ["conv1_1", "conv1_1_store", "taps3", "taps9", "taps9_aligned"])
def test_stem_probe_kernel_shapes(cuda, variant, shape):
    a1, w1, w2 = stem_probe.probe_inputs(sum(shape), cuda, shape=shape)
    got = stem_probe.stem_probe(a1, w1, w2, variant)
    want = stem_probe.stem_probe_plain(a1, w1, w2, variant)
    assert got.shape == want.shape == (*shape[:2], 16, shape[2], 64)
    _one_step(got, want)
    assert float((got == want).float().mean()) > 0.98


def test_stem_probe_kernel_takes_weight_views(cuda):
    a1, w1, w2 = stem_probe.probe_inputs(5, cuda, shape=(1, 2, 32))
    want = stem_probe.stem_probe(a1, w1, w2, "taps9")
    got = stem_probe.stem_probe(a1, w1.t().contiguous().t(),
                                w2.permute(0, 1, 3, 2).contiguous().permute(0, 1, 3, 2), "taps9")
    assert torch.equal(got, want)


def test_lane_unflatten_sum_kernel_is_bit_exact(cuda):
    x = torch.randn((36, 1536), generator=torch.Generator(device=cuda).manual_seed(4),
                    device=cuda).to(torch.bfloat16)
    assert torch.equal(stem_probe.lane_unflatten_sum(x), stem_probe.lane_unflatten_sum_plain(x))


#: R * N % 4 of 1, 2, 3 and 0; one group; more quads than one wave's threads
LANE_SHAPES = [(1, 6), (3, 18), (5, 42), (7, 66), (2, 24), (36, 1536), (1000, 3000)]


@pytest.mark.parametrize("rows,cols", LANE_SHAPES)
@pytest.mark.parametrize("offset", [0, 1], ids=["aligned", "misaligned"])
def test_lane_unflatten_sum_kernel_shapes(cuda, rows, cols, offset):
    """Four groups a thread where x is 16-byte aligned, the R * N % 4 tail
    one at a time, and every group one at a time on a 2-byte offset view."""
    g = torch.Generator(device=cuda).manual_seed(rows * cols + offset)
    flat = (torch.randn(rows * cols + offset, generator=g, device=cuda) * 100).to(torch.bfloat16)
    x = flat[offset:].view(rows, cols)
    before = stem_probe.lane_unflatten_sum.launches
    got = stem_probe.lane_unflatten_sum(x)
    assert stem_probe.lane_unflatten_sum.launches == before + 1
    assert torch.equal(got, stem_probe.lane_unflatten_sum_plain(x))
    stem_probe.launch_floor(x)
    torch.cuda.synchronize()


#: every int8 conv of vgg512, 21 classes: (H, W, cin, kh, cout, stride, padding, dilation)
VGG512_INT8_CONVS = [
    (512, 512, 3, 3, 64, 1, "SAME", 1), (512, 512, 64, 3, 64, 1, "SAME", 1),
    (256, 256, 64, 3, 128, 1, "SAME", 1), (256, 256, 128, 3, 128, 1, "SAME", 1),
    (128, 128, 128, 3, 256, 1, "SAME", 1), (128, 128, 256, 3, 256, 1, "SAME", 1),
    (64, 64, 256, 3, 512, 1, "SAME", 1), (64, 64, 512, 3, 512, 1, "SAME", 1),
    (32, 32, 512, 3, 512, 1, "SAME", 1), (32, 32, 512, 3, 1024, 1, "SAME", 6),
    (32, 32, 1024, 1, 1024, 1, "SAME", 1), (32, 32, 1024, 1, 256, 1, "SAME", 1),
    (32, 32, 256, 3, 512, 2, "SAME", 1), (16, 16, 512, 1, 128, 1, "SAME", 1),
    (16, 16, 128, 3, 256, 2, "SAME", 1), (8, 8, 256, 1, 128, 1, "SAME", 1),
    (8, 8, 128, 3, 256, 2, "SAME", 1), (4, 4, 256, 1, 128, 1, "SAME", 1),
    (4, 4, 128, 3, 256, 1, "VALID", 1), (2, 2, 256, 1, 128, 1, "SAME", 1),
    (3, 3, 128, 3, 256, 1, "VALID", 1),
    (64, 64, 512, 3, 100, 1, "SAME", 1), (32, 32, 1024, 3, 150, 1, "SAME", 1),
    (16, 16, 512, 3, 150, 1, "SAME", 1), (8, 8, 256, 3, 150, 1, "SAME", 1),
    (4, 4, 256, 3, 150, 1, "SAME", 1), (2, 2, 256, 3, 100, 1, "SAME", 1),
    (1, 1, 256, 3, 100, 1, "SAME", 1),
]


def _family_int8_convs():
    """Every int8 conv of resnet320 (80 classes) and mobilenet320 (20),
    as ``VGG512_INT8_CONVS``; heads from the presets."""
    from ssd_tensorflow_tpu_torch import get_preset_by_name
    from ssd_tensorflow_tpu_torch.models import mobilenet, resnet

    convs = [(320, 320, 3, 7, 64, 2, "SAME"), (80, 80, 64, 3, 64, 1, "SAME"),
             (80, 80, 64, 3, 128, 2, "SAME"), (40, 40, 128, 3, 128, 1, "SAME"),
             (80, 80, 64, 1, 128, 2, "SAME"), (40, 40, 128, 3, 256, 2, "SAME"),
             (20, 20, 256, 3, 256, 1, "SAME"), (40, 40, 128, 1, 256, 2, "SAME"),
             (20, 20, 256, 3, 512, 2, "SAME"), (10, 10, 512, 3, 512, 1, "SAME"),
             (20, 20, 256, 1, 512, 2, "SAME"),
             (320, 320, 3, 3, 32, 2, "SAME")]
    cin, hw = 32, 160
    for stride, cout in mobilenet.BLOCKS:
        hw = -(-hw // stride)
        convs.append((hw, hw, cin, 1, cout, 1, "SAME"))
        cin = cout
    for fam, cin, nv in ((resnet, 512, 85), (mobilenet, 1024, 25)):
        preset = get_preset_by_name(f"{fam.__name__.rsplit('.', 1)[1]}320")
        hw = preset.maps[len(fam.TRUNK_TAP_CHANNELS) - 1].size.h
        for name, cout, k, stride, padding in fam.extra_layer_defs(preset):
            convs.append((hw, hw, cin, k, cout, stride, padding))
            if stride == 2:
                hw = -(-hw // 2)
            elif padding == "VALID":
                hw -= 2
            cin = cout
        for m, c in zip(preset.maps, fam.map_channels(preset)):
            convs.append((m.size.h, m.size.w, c, 3, m.num_shapes * nv, 1, "SAME"))
    return [(h, w, cin, k, cout, stride, padding, 1)
            for h, w, cin, k, cout, stride, padding in convs]


@pytest.mark.parametrize("h,w,cin,k,cout,stride,padding,dilation",
                         VGG512_INT8_CONVS + _family_int8_convs())
def test_int8_conv_card_route_matches_plain(cuda, h, w, cin, k, cout, stride, padding, dilation):
    """The im2col + ``torch._int_mm`` route equals the plain route (a
    float32 conv with cuDNN off, exact below 2^24) bit for bit, at every
    int8 conv shape of the three shipped bundles, on 3
    images: once as ``int8_conv`` runs it, once in chunks of 2 images so
    that the batch ends in a chunk of one."""
    g = torch.Generator(device=cuda).manual_seed(h * cin + cout)
    xq = torch.randint(-127, 128, (3, h, w, cin), generator=g, device=cuda, dtype=torch.int8)
    wq = torch.randint(-127, 128, (k, k, cin, cout), generator=g, device=cuda, dtype=torch.int8)
    wt = int8_conv.stage_int8_weight(wq)
    want = int8_conv.int8_conv_plain(xq, wt, stride, padding, dilation)
    before = int8_conv.int8_conv.launches
    got = int8_conv.int8_conv(xq, wt, stride, padding, dilation)
    assert int8_conv.int8_conv.launches == before + 1
    assert got.dtype == torch.int32 and got.shape == want.shape
    assert torch.equal(got, want)
    ho, wo = got.shape[1:3]
    chunked = int8_conv.int8_conv_im2col(xq, wt, stride, padding, dilation,
                                         chunk_bytes=2 * ho * wo * wt.wk.shape[1])
    assert torch.equal(chunked, want)


@pytest.mark.parametrize("relu", [True, False], ids=["relu", "head"])
def test_int8_quantize_and_requant_match_the_cpu(cuda, relu):
    """The int8 path's elementwise steps give the CPU's bits on the card:
    ``quantize`` (float32 multiply, round half to even, clip) and
    ``requant`` (one float32 multiply-add, bf16, ReLU), which the CPU tests
    hold against the JAX package."""
    rng = np.random.default_rng(11)
    x = torch.tensor(rng.normal(0, 3, (2, 9, 7, 96)), dtype=torch.float32).to(torch.bfloat16)
    inv = torch.tensor([1.0 / 0.0371], dtype=torch.float32)
    assert torch.equal(int8_conv.quantize(x.to(cuda), inv.to(cuda)).cpu(),
                       int8_conv.quantize(x, inv))
    sums = torch.tensor(rng.integers(-2**22, 2**22, (2, 9, 7, 96)), dtype=torch.int32)
    layer = {"b": torch.tensor(rng.normal(0, 1, 96), dtype=torch.float32),
             "mult": torch.tensor(rng.uniform(1e-6, 1e-3, 96), dtype=torch.float32)}
    want = int8_conv.requant(sums, layer, relu)
    got = int8_conv.requant(sums.to(cuda), {k: v.to(cuda) for k, v in layer.items()}, relu)
    assert got.dtype == torch.bfloat16 and torch.equal(got.cpu(), want)


def test_int8_conv_rejects_a_filter_on_another_device(cuda):
    wt = int8_conv.stage_int8_weight(torch.zeros((3, 3, 8, 8), dtype=torch.int8))
    with pytest.raises(ValueError, match="CUDA device"):
        int8_conv.int8_conv(torch.zeros((1, 4, 4, 8), dtype=torch.int8, device=cuda), wt)


def _qconv_layer(cin, k, cout, g, device, per_channel=False):
    """A staged int8 conv of random values: an int8 filter, an inverse scale
    ``(1,)`` or ``(cin,)``, requant multipliers and a bias."""
    from ssd_tensorflow_tpu_torch.ops.int8_conv import stage_int8_weight

    wq = torch.randint(-127, 128, (k, k, cin, cout), generator=g, device=device, dtype=torch.int8)
    n_inv = cin if per_channel else 1
    return {"w": stage_int8_weight(wq),
            "inv": 1.0 / (0.02 + 0.08 * torch.rand(n_inv, generator=g, device=device)),
            "mult": 1e-6 + 1e-4 * torch.rand(cout, generator=g, device=device),
            "b": torch.randn(cout, generator=g, device=device)}


@pytest.mark.parametrize("h,w,cin,k,cout,stride,padding,dilation",
                         VGG512_INT8_CONVS + _family_int8_convs())
def test_int8_qconv_kernel_matches_the_chain(cuda, h, w, cin, k, cout, stride, padding, dilation):
    """``csrc/int8_conv.cu`` equals quantize -> im2col + ``_int_mm`` ->
    requant on the card bit for bit, at every int8 conv shape of the three
    shipped bundles, on seeded random bf16 inputs (a tenth of them beyond
    the clip) and random scales; per-channel ``inv`` at every family shape,
    with and without ReLU, batch 2."""
    g = torch.Generator(device=cuda).manual_seed(h * cin + cout + k)
    family = (h, w, cin, k, cout, stride, padding, dilation) not in VGG512_INT8_CONVS
    layer = _qconv_layer(cin, k, cout, g, cuda, per_channel=family)
    x = (3 * torch.randn((2, h, w, cin), generator=g, device=cuda)).to(torch.bfloat16)
    for relu in (True, False):
        want = int8_conv.int8_qconv_plain(x, layer, stride, padding, dilation, relu)
        before = int8_conv.int8_qconv.launches
        got = int8_conv.int8_qconv(x, layer, stride, padding, dilation, relu)
        assert int8_conv.int8_qconv.launches == before + 1
        assert got.dtype == torch.bfloat16 and got.shape == want.shape
        assert torch.equal(got, want), f"{int((got != want).sum())} of {want.numel()} differ"


@pytest.mark.parametrize("b,h,w,cin,k,cout,stride,padding,dilation", [
    (1, 1, 1, 32, 3, 8, 1, "SAME", 1), (3, 37, 21, 48, 3, 200, 1, "SAME", 1),
    (2, 13, 45, 16, 3, 24, 2, "SAME", 1), (1, 30, 19, 96, 1, 72, 1, "SAME", 1),
    (2, 25, 25, 160, 1, 136, 2, "SAME", 1), (1, 29, 31, 64, 3, 66, 1, "SAME", 6),
    (2, 9, 11, 32, 3, 130, 1, "VALID", 2), (1, 33, 17, 5, 3, 17, 1, "SAME", 1),
    (2, 23, 19, 7, 5, 64, 2, "SAME", 1), (1, 12, 12, 12, 2, 31, 1, "VALID", 1)])
def test_int8_qconv_kernel_ragged_shapes(cuda, b, h, w, cin, k, cout, stride, padding, dilation):
    """The kernel's masked edges: odd maps, a 1x1 image, couts that are not
    a multiple of 8 or of the 64 / 128 channel tiles, cin tails past a
    stage (96, 160), small and odd cin (the gathered route), an even
    kernel, dilation 2 and 6, per-channel ``inv``."""
    g = torch.Generator(device=cuda).manual_seed(b * h * w + cin * k + cout)
    layer = _qconv_layer(cin, k, cout, g, cuda, per_channel=bool(cout % 2))
    x = (3 * torch.randn((b, h, w, cin), generator=g, device=cuda)).to(torch.bfloat16)
    want = int8_conv.int8_qconv_plain(x, layer, stride, padding, dilation)
    got = int8_conv.int8_qconv(x, layer, stride, padding, dilation)
    assert torch.equal(got, want), f"{int((got != want).sum())} of {want.numel()} differ"


#: the shipped int8 bundles: (file, image side)
INT8_BUNDLES = [("assets/vgg512_int8_minivoc.ssdtpu.npz", 512),
                ("assets/resnet320_int8_minicoco.ssdtpu.npz", 320),
                ("assets/mobilenet320_int8_qat_minivoc.ssdtpu.npz", 320)]


@pytest.mark.parametrize("bundle,side,b", [(*INT8_BUNDLES[0], 2), (*INT8_BUNDLES[0], 1),
                                           (*INT8_BUNDLES[0], 3), (*INT8_BUNDLES[1], 2),
                                           (*INT8_BUNDLES[2], 2)])
def test_int8_qconv_kernel_matches_the_chain_in_the_bundles(cuda, bundle, side, b):
    """Every W8A8 conv of a shipped bundle's forward, on the bundle's own
    input to that conv: the kernel equals the card chain bit for bit, and
    the forward runs the kernel once a conv and the im2col route never."""
    from unittest import mock

    from ssd_tensorflow_tpu_torch.inference import InferenceModel
    from ssd_tensorflow_tpu_torch.models import quantized

    model = InferenceModel.from_bundle(bundle, device=cuda)
    rng = np.random.default_rng(side + b)
    images = torch.from_numpy(rng.integers(0, 256, (b, side, side, 3), dtype=np.uint8)).to(cuda)
    real, checked = quantized.int8_qconv, []

    def check(x, layer, stride=1, padding="SAME", dilation=1, relu=True):
        got = real(x, layer, stride, padding, dilation, relu)
        want = int8_conv.int8_qconv_plain(x, layer, stride, padding, dilation, relu)
        checked.append((tuple(x.shape), layer["w"].kh, stride, dilation, torch.equal(got, want)))
        return got

    with torch.inference_mode(), mock.patch.object(quantized, "int8_qconv", check):
        model.forward_scores(images)
    assert checked and all(ok for *_, ok in checked), [c for c in checked if not c[-1]]
    if "vgg512" in bundle:
        assert len(checked) == 32
    int8_conv.int8_qconv.launches = int8_conv.int8_conv.launches = 0
    with torch.inference_mode():
        model.forward_scores(images)
    torch.cuda.synchronize()
    assert int8_conv.int8_qconv.launches == len(checked) and int8_conv.int8_conv.launches == 0


@pytest.mark.parametrize("b", [64, 8])
@pytest.mark.parametrize("bundle,side", INT8_BUNDLES)
def test_int8_forward_graph_replays_the_eager_forward(cuda, bundle, side, b):
    """``forward_scores`` of a shipped int8 bundle under inference mode, four
    calls on new inputs: call 1 eager, call 2 captures the graph, calls 2-4
    replay it; each equal to ``quantized._forward_scores`` of the same input
    bit for bit, call 3's still after call 4, and one capture and three
    replays counted for the shape."""
    from ssd_tensorflow_tpu_torch.inference import InferenceModel, forward_graph
    from ssd_tensorflow_tpu_torch.models import quantized

    model = InferenceModel.from_bundle(bundle, device=cuda)
    rng = np.random.default_rng(side + b)
    before = (forward_graph.captures, forward_graph.replays)
    got, want = [], []
    with torch.inference_mode():
        for _ in range(4):
            x = torch.from_numpy(rng.integers(0, 256, (b, side, side, 3), dtype=np.uint8)).to(cuda)
            got.append(model.forward_scores(x))
            want.append(quantized._forward_scores(model.params, x, model.config))
    torch.cuda.synchronize()
    assert (forward_graph.captures - before[0], forward_graph.replays - before[1]) == (1, 3)
    assert len(model._graphs) == 1
    for i, (g, w) in enumerate(zip(got, want)):
        assert all(a.dtype == c.dtype and torch.equal(a, c) for a, c in zip(g, w)), i
    assert not torch.equal(got[2][0], got[3][0])  # new inputs: the replay read call 4's


def test_float_forward_never_captures(cuda):
    """The float route stays eager: three calls of one shape, no graph."""
    from ssd_tensorflow_tpu_torch.inference import InferenceModel, forward_graph

    cfg = ModelConfig(preset_name="mobilenet320", num_classes=20)
    model = InferenceModel(init_params(cfg, seed=0), cfg, device=cuda)
    x = torch.from_numpy(np.random.default_rng(1).integers(0, 256, (8, 320, 320, 3),
                                                           dtype=np.uint8)).to(cuda)
    before = (forward_graph.captures, forward_graph.replays)
    with torch.inference_mode():
        first = model.forward_scores(x)
        for _ in range(2):
            again = model.forward_scores(x)
    torch.cuda.synchronize()
    assert (forward_graph.captures, forward_graph.replays) == before and model._graphs == {}
    assert all(torch.equal(a, c) for a, c in zip(first, again))


#: the multibox head convs (H = W, cin, anchor shapes, K + 5) of vgg512 and
#: mobilenet320 (21 classes) and resnet320 (81)
VGG512_HEADS = [(64, 512, 4, 25), (32, 1024, 6, 25), (16, 512, 6, 25), (8, 256, 6, 25),
                (4, 256, 6, 25), (2, 256, 4, 25), (1, 256, 4, 25)]
FAMILY_HEADS = [(40, 128, 4, 85), (20, 256, 6, 85), (10, 512, 6, 85), (5, 256, 6, 85),
                (3, 256, 4, 85), (1, 256, 4, 85),
                (20, 512, 4, 25), (10, 1024, 6, 25), (5, 512, 6, 25), (3, 256, 6, 25),
                (2, 256, 4, 25), (1, 128, 4, 25)]


@pytest.mark.parametrize("hw,cin,shapes,nv", VGG512_HEADS + FAMILY_HEADS)
def test_head_conv_rounds_once(cuda, hw, cin, shapes, nv):
    """``layers.conv2d_bias_in`` on the card rounds once: it equals
    ``bf16(conv_f32 + b)`` on >= 99 % of elements and no more than 0.1 %
    (or two elements of a small map) less often than cuDNN's bias-free
    conv equals ``bf16(conv_f32)``, whose float32 accumulation on the
    tensor cores is what is left of 100 %; the rest one bf16 step apart.
    These zero-mean inputs cancel more than the model's maps, on which
    ``chip_smoke.py`` holds the 256-channel heads to 99.9 %."""
    g = torch.Generator(device=cuda).manual_seed(hw * cin + shapes)
    cout = shapes * nv
    x = (2 * torch.randn((2, hw, hw, cin), generator=g, device=cuda)).to(torch.bfloat16)
    w = (torch.randn((cout, cin, 3, 3), generator=g, device=cuda) / (9 * cin) ** 0.5).to(
        torch.bfloat16).contiguous(memory_format=torch.channels_last)
    b = torch.randn(cout, generator=g, device=cuda) * 0.5
    got = layers.conv2d_bias_in(x, layers.widen_bias(w, b))
    conv32 = torch.nn.functional.conv2d(x.permute(0, 3, 1, 2).float(), w.float(), None, 1, 1)
    want = (conv32 + b.view(1, -1, 1, 1)).to(torch.bfloat16).permute(0, 2, 3, 1)
    assert got.shape == want.shape and got.dtype == torch.bfloat16
    _one_step(got, want)
    conv_only = layers.conv2d(x, w) == conv32.to(torch.bfloat16).permute(0, 2, 3, 1)
    floor = max(0.99, float(conv_only.float().mean()) - max(0.001, 2.0 / want.numel()))
    assert float((got == want).float().mean()) >= floor
    # the route it replaced: a bf16 bias pass after the rounded conv
    assert float((layers.conv2d(x, w, b) == want).float().mean()) < 0.95


#: every conv + bias + ReLU shape of vgg512: (H = W, cin, cout, k, stride, padding, dilation)
VGG512_CONV_RELU = [
    (256, 64, 128, 3, 1, "SAME", 1), (256, 128, 128, 3, 1, "SAME", 1),
    (128, 128, 256, 3, 1, "SAME", 1), (128, 256, 256, 3, 1, "SAME", 1),
    (64, 256, 512, 3, 1, "SAME", 1), (64, 512, 512, 3, 1, "SAME", 1),
    (32, 512, 512, 3, 1, "SAME", 1), (32, 512, 1024, 3, 1, "SAME", 6),
    (32, 1024, 1024, 1, 1, "SAME", 1), (32, 1024, 256, 1, 1, "SAME", 1),
    (32, 256, 512, 3, 2, "SAME", 1), (16, 512, 128, 1, 1, "SAME", 1),
    (16, 128, 256, 3, 2, "SAME", 1), (8, 256, 128, 1, 1, "SAME", 1),
    (8, 128, 256, 3, 2, "SAME", 1), (4, 256, 128, 1, 1, "SAME", 1),
    (4, 128, 256, 3, 1, "VALID", 1), (2, 256, 128, 1, 1, "SAME", 1),
    (3, 128, 256, 3, 1, "VALID", 1),
]


@pytest.mark.parametrize("hw,cin,cout,k,stride,padding,dilation", VGG512_CONV_RELU)
def test_conv_relu_rounds_once(cuda, hw, cin, cout, k, stride, padding, dilation):
    g = torch.Generator(device=cuda).manual_seed(hw * cin + cout)
    x = (2 * torch.randn((2, hw, hw, cin), generator=g, device=cuda)).to(torch.bfloat16)
    w = (torch.randn((cout, cin, k, k), generator=g, device=cuda) / (k * k * cin) ** 0.5).to(
        torch.bfloat16).contiguous(memory_format=torch.channels_last)
    b = torch.randn(cout, generator=g, device=cuda) * 0.5
    got = layers.conv_relu({"w": w, "b": b}, x, stride, padding, dilation)
    xn, pad = layers._same_input(x, w, stride, padding, dilation)
    want = torch.relu(torch.nn.functional.conv2d(xn.float(), w.float(), None, stride, pad, dilation)
                      + b.view(1, -1, 1, 1)).to(torch.bfloat16).permute(0, 2, 3, 1)
    assert got.shape == want.shape and got.dtype == torch.bfloat16
    _one_step(got, want)
    assert float((got == want).float().mean()) >= 0.99


def test_float32_forward_turns_tf32_off_itself(cuda):
    """A float32 forward on the card runs its convs in full float32 even
    when the caller leaves cuDNN's TF32 on (PyTorch's default), and gives
    the caller's flag back: within 1e-5 of the largest output of the same
    forward with TF32 off (TF32's 10-bit mantissa would leave ~2^-11)."""
    cfg = ModelConfig(preset_name="vgg300", num_classes=20, compute_dtype="float32")
    params = {n: {k: v.to(cuda) for k, v in d.items()} for n, d in init_params(cfg, 2).items()}
    img = torch.from_numpy(np.random.default_rng(2).integers(0, 256, (2, 300, 300, 3),
                                                             dtype=np.uint8)).to(cuda)
    saved = torch.backends.cudnn.allow_tf32
    try:
        outs = []
        for tf32 in (True, False):
            torch.backends.cudnn.allow_tf32 = tf32
            with torch.inference_mode():
                outs.append(ssd_vgg.apply_model(params, img, cfg))
            assert torch.backends.cudnn.allow_tf32 is tf32
    finally:
        torch.backends.cudnn.allow_tf32 = saved
    for got, want in zip(*outs):
        assert float((got - want).abs().max()) <= 1e-5 * float(want.abs().max())


def _train_batch(seed, b=2, g=6, k=20):
    rng = np.random.default_rng(seed)
    w, h = rng.uniform(0.05, 0.5, (2, b, g))
    boxes = np.stack([rng.uniform(w / 2, 1 - w / 2), rng.uniform(h / 2, 1 - h / 2), w, h], -1)
    return {"images": torch.from_numpy(rng.integers(0, 256, (b, 64, 64, 3), dtype=np.uint8)),
            "gt_boxes": torch.tensor(boxes, dtype=torch.float32),
            "gt_labels": torch.from_numpy(rng.integers(0, k, (b, g))),
            "gt_mask": torch.ones((b, g), dtype=torch.bool)}


def test_float32_train_step_card_matches_cpu(cuda):
    """One float32 test64 step on the card against the same step on the
    CPU, cuDNN's TF32 flag at PyTorch's default (on): targets equal, losses
    within 1e-4 relative, each leaf's update within 1e-2 of its largest (or
    two ulps of its largest parameter; cuDNN's float32 algorithms sum in
    other orders than oneDNN's), the step's NMS on the card."""
    from ssd_tensorflow_tpu_torch.ops.anchors import anchors_for_preset
    from ssd_tensorflow_tpu_torch.ops.matching import encode_targets_batch
    from ssd_tensorflow_tpu_torch.ops.postprocess import DetectionConfig
    from ssd_tensorflow_tpu_torch.parallel import train_step

    cfg = train_step.TrainConfig(
        model=ModelConfig(preset_name="test64", num_classes=20, compute_dtype="float32"),
        detect=DetectionConfig(top_k=32, confidence_threshold=0.05))
    params = init_params(cfg.model, seed=4)
    anchors = anchors_for_preset(cfg.model.preset)
    batch = _train_batch(4)
    targets = [encode_targets_batch(batch["gt_boxes"].to(dev), batch["gt_labels"].to(dev),
                                    batch["gt_mask"].to(dev), torch.from_numpy(anchors).to(dev),
                                    20).cpu() for dev in ("cpu", cuda)]
    assert torch.equal(targets[0], targets[1])
    step = train_step.make_train_step(cfg, anchors)
    saved = torch.backends.cudnn.allow_tf32
    torch.backends.cudnn.allow_tf32 = True
    try:
        before = nms_cuda.nms_keep.launches
        (gs, gl, gd), (ws, wl, wd) = (
            step(train_step.make_train_state(params, cfg, device=dev), batch)
            for dev in (cuda, "cpu"))
        assert nms_cuda.nms_keep.launches == before + 1
    finally:
        torch.backends.cudnn.allow_tf32 = saved
    for k in wl:
        assert abs(float(gl[k]) - float(wl[k])) <= 1e-4 * abs(float(wl[k])), k
    for n, leaves in params.items():
        for k, old in leaves.items():
            want, got = ws.params[n][k] - old, gs.params[n][k].cpu() - old
            tol = max(1e-2 * float(want.abs().max()), 2.0 ** -22 * float(old.abs().max()))
            assert float((got - want).abs().max()) <= tol, (n, k)
    assert gd.boxes.is_cuda and gd.boxes.shape == wd.boxes.shape == (2, 32, 4)


def test_decode_detections_launches_nms(cuda):
    """``decode_detections`` on CUDA tensors runs NMS as the kernel, once,
    and gives the CPU's detections bit for bit: zero offsets decode to the
    anchors (``exp(0) = 1`` on both devices), and the decode's divisions
    are divisions on the card too (``boxes.true_div``)."""
    from ssd_tensorflow_tpu_torch.ops.anchors import anchors_for_preset
    from ssd_tensorflow_tpu_torch.ops.postprocess import DetectionConfig, decode_detections

    anchors = torch.from_numpy(anchors_for_preset(ModelConfig(preset_name="vgg300").preset))
    g = torch.Generator().manual_seed(5)
    probs = torch.softmax(3 * torch.randn((4, anchors.shape[0], 21), generator=g), -1)
    locs = torch.zeros((4, anchors.shape[0], 4))
    cfg = DetectionConfig(top_k=200, confidence_threshold=0.3)
    want = decode_detections(probs, locs, anchors, cfg)
    before = nms_cuda.nms_keep.launches
    got = decode_detections(probs.to(cuda), locs.to(cuda), anchors.to(cuda), cfg)
    assert nms_cuda.nms_keep.launches == before + 1
    assert want.valid.any()
    for field in ("valid", "classes", "boxes", "scores"):
        assert torch.equal(getattr(got, field).cpu(), getattr(want, field)), field



def test_decode_locations_equals_the_cpu_bit_for_bit(cuda):
    """The decode on the card gives the CPU's boxes bit for bit on offsets
    of any size: its ``exp`` is rounded once from float64, where the
    card's ``expf`` sits an ulp from the CPU's on some inputs, enough to
    move a box across a pixel edge of the integer canvas."""
    from ssd_tensorflow_tpu_torch.ops.anchors import anchors_for_preset
    from ssd_tensorflow_tpu_torch.ops.boxes import clamp_boxes
    from ssd_tensorflow_tpu_torch.ops.codec import decode_locations

    anchors = torch.from_numpy(anchors_for_preset(ModelConfig(preset_name="vgg512").preset))
    g = torch.Generator().manual_seed(6)
    locs = torch.randn((16, anchors.shape[0], 4), generator=g) * 20
    x = torch.linspace(-80, 80, 2 ** 20)
    raw_cpu, raw_card = torch.exp(x), torch.exp(x.to(cuda)).cpu()
    assert not torch.equal(raw_cpu, raw_card)  # what the rounding-once repairs
    want = clamp_boxes(decode_locations(locs, anchors))
    got = clamp_boxes(decode_locations(locs.to(cuda), anchors.to(cuda))).cpu()
    assert torch.equal(got, want)

def test_true_div_divides_on_the_card(cuda):
    """``x / 1000.0`` on a CUDA tensor is ``x * (1 / 1000)``, one bit off
    the CPU's division on some elements; ``boxes.true_div`` is not."""
    from ssd_tensorflow_tpu_torch.ops.boxes import true_div

    x = torch.arange(0, 2 ** 16, dtype=torch.float32) * 0.37
    for c in (1000.0, 10.0, 5.0):
        assert torch.equal(true_div(x.to(cuda), c).cpu(), x / c)


@pytest.mark.parametrize("f32_out", [True, False])
@pytest.mark.parametrize("hw,c,stride", [(160, 32, 1), (160, 64, 2), (20, 512, 1), (10, 1024, 1),
                                         (21, 48, 2)])
def test_depthwise_conv_card_matches_cpu(cuda, hw, c, stride, f32_out):
    """``layers.depthwise_conv2d`` (``F.conv2d(groups=C)`` in float32 on
    both devices) on the card against the CPU route: the two-rounding form
    (the int8 path's weight-only depthwise) bit for bit, as found at every
    mobilenet320 depthwise shape on an H100; the float32 inference form,
    whose bias cuDNN may add in another place, equal on >= 99.9 % of
    elements and within one bf16 step of the largest output."""
    g = torch.Generator().manual_seed(hw * c + stride)
    x = (2 * torch.randn((2, hw, hw, c), generator=g)).to(torch.bfloat16)
    w = (torch.randn((c, 1, 3, 3), generator=g) / 3).to(torch.bfloat16)
    b = torch.randn(c, generator=g)
    want = layers.depthwise_conv2d(x, w, b, stride, f32_out=f32_out)
    got = layers.depthwise_conv2d(x.to(cuda), w.to(cuda), b.to(cuda), stride,
                                  f32_out=f32_out).cpu()
    assert got.dtype == torch.bfloat16 and got.shape == want.shape
    if not f32_out:
        assert torch.equal(got, want)
    else:
        _one_step(got, want)
        assert float((got == want).float().mean()) >= 0.999


#: every distinct GroupNorm input of resnet320 and mobilenet320 at b2
#: (resnet320's five are among mobilenet320's ten); at b64 two shapes that
#: the launch's plan (``csrc/group_norm.cu``) gives a cluster of 16 blocks
#: an image on an H100 (80x80x64, 160x160x64) and two it gives a cluster
#: of 8 (mobilenet320's blocks 7-11 at 20x20x512, its stem and first
#: depthwise at 160x160x32); a ragged map of 3 channels (g = 1); and 12
#: channels (g = 1) over a map whose float32 slices exceed shared memory,
#: so each pass reads device memory
GROUP_NORM_SHAPES = [
    (2, 160, 160, 32), (2, 160, 160, 64), (2, 80, 80, 64), (2, 80, 80, 128), (2, 40, 40, 128),
    (2, 40, 40, 256), (2, 20, 20, 256), (2, 20, 20, 512), (2, 10, 10, 512), (2, 10, 10, 1024),
    (64, 80, 80, 64), (64, 160, 160, 64), (64, 20, 20, 512), (64, 160, 160, 32), (2, 5, 7, 3),
    (2, 300, 300, 12),
]


@pytest.mark.parametrize("shape", GROUP_NORM_SHAPES)
@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32])
def test_group_norm_card_matches_cpu(cuda, shape, dtype):
    """``resnet.norm_act`` on the card is one launch of
    ``csrc/group_norm.cu`` and gives the CPU route's bits (float64-summed
    statistics and a float64 rsqrt, each rounded once, then single float32
    operations): the GroupNorm alone, with ReLU, with ReLU6, and with a
    skip added before ReLU (a tensor of its own, and at b2 a strided slice
    as resnet's stride-2 skips are)."""
    from ssd_tensorflow_tpu_torch.models import resnet
    from ssd_tensorflow_tpu_torch.ops.group_norm_cuda import group_norm_cuda

    g = torch.Generator().manual_seed(sum(shape))
    x = (3 * torch.randn(shape, generator=g) + 0.5).to(dtype)
    gn = {"scale": torch.randn(shape[-1], generator=g), "bias": torch.randn(shape[-1], generator=g)}
    b, h, w, c = shape
    skips = {"same": (2 * torch.randn(shape, generator=g)).to(dtype)}
    if b <= 2:
        skips["strided"] = (2 * torch.randn((b, 2 * h, 2 * w, c), generator=g)).to(dtype)
    xc, gnc = x.to(cuda), {k: v.to(cuda) for k, v in gn.items()}
    with torch.inference_mode():
        y = resnet.group_norm(x, gn)
        forms = {"none": (None, None, y), "relu": ("relu", None, torch.relu(y)),
                 "relu6": ("relu6", None, torch.relu(y).clamp_max(6.0))}
        for name, skip in skips.items():
            cut = skip[:, ::2, ::2, :] if name == "strided" else skip
            forms[f"skip_{name}"] = ("relu", skip, torch.relu(y + cut))
        for form, (act, skip, want) in forms.items():
            if skip is not None:
                skip = skip.to(cuda)
                skip = skip[:, ::2, ::2, :] if form == "skip_strided" else skip
            before = group_norm_cuda.launches
            got = resnet.norm_act(xc, gnc, act, skip).cpu()
            assert group_norm_cuda.launches == before + 1, form
            assert got.dtype == dtype and torch.equal(got, want), form


def test_group_norm_card_needs_no_gradient(cuda):
    """Under autograd the card takes the plain route, and its gradients flow."""
    from ssd_tensorflow_tpu_torch.models import resnet
    from ssd_tensorflow_tpu_torch.ops.group_norm_cuda import group_norm_cuda

    x = torch.randn((2, 8, 8, 64), device=cuda, requires_grad=True)
    gn = {"scale": torch.ones(64, device=cuda), "bias": torch.zeros(64, device=cuda)}
    before = group_norm_cuda.launches
    y = resnet.norm_act(x, gn, "relu")
    y.sum().backward()
    assert group_norm_cuda.launches == before and x.grad is not None


#: every conv + bias of the two families' float paths that is not
#: depthwise: (H, W, cin, cout, k, stride, padding), the K = 9 * 512 = 4608
#: convs of resnet320's layer4 among them
FAMILY_BIAS_IN = [
    (320, 320, 3, 64, 7, 2, "SAME"), (80, 80, 64, 64, 3, 1, "SAME"), (80, 80, 64, 128, 3, 2, "SAME"),
    (80, 80, 64, 128, 1, 2, "SAME"), (20, 20, 256, 512, 3, 2, "SAME"),
    (10, 10, 512, 512, 3, 1, "SAME"), (10, 10, 512, 128, 1, 1, "SAME"), (5, 5, 128, 256, 3, 2, "SAME"),
    (3, 3, 128, 256, 3, 1, "VALID"), (320, 320, 3, 32, 3, 2, "SAME"), (160, 160, 32, 64, 1, 1, "SAME"),
    (10, 10, 1024, 1024, 1, 1, "SAME"), (3, 3, 128, 256, 3, 2, "SAME"), (2, 2, 64, 128, 3, 2, "SAME"),
]


@pytest.mark.parametrize("h,w,cin,cout,k,stride,padding", FAMILY_BIAS_IN)
def test_family_conv_bias_in_rounds_once(cuda, h, w, cin, cout, k, stride, padding):
    """``layers.conv2d_bias_in`` at the families' strides, paddings and
    kernels on the card: a zero input gives ``bf16(b)`` at every output,
    borders included; random inputs equal ``bf16(conv_f32 + b)`` on >= 99 %
    of elements and no more than 0.1 % (or two elements of a small map)
    less often than cuDNN's bias-free conv equals ``bf16(conv_f32)``, as
    ``test_head_conv_rounds_once`` holds the heads (these zero-mean inputs
    cancel more than the model's maps, on which ``chip_smoke.py`` holds
    K <= 2304 to 99.9 %); the rest one bf16 step apart."""
    g = torch.Generator(device=cuda).manual_seed(h * cin + cout + k)
    wt = (torch.randn((cout, cin, k, k), generator=g, device=cuda) / (k * k * cin) ** 0.5).to(
        torch.bfloat16).contiguous(memory_format=torch.channels_last)
    b = torch.randn(cout, generator=g, device=cuda) * 0.5
    wb = layers.widen_bias(wt, b)
    zero = layers.conv2d_bias_in(torch.zeros((2, h, w, cin), dtype=torch.bfloat16, device=cuda),
                                 wb, stride, padding)
    assert torch.equal(zero, b.to(torch.bfloat16).expand_as(zero))
    x = (2 * torch.randn((2, h, w, cin), generator=g, device=cuda)).to(torch.bfloat16)
    got = layers.conv2d_bias_in(x, wb, stride, padding)
    xn, pad = layers._same_input(x, wt, stride, padding, 1)
    conv32 = torch.nn.functional.conv2d(xn.float(), wt.float(), None, stride, pad)
    want = (conv32 + b.view(1, -1, 1, 1)).to(torch.bfloat16).permute(0, 2, 3, 1)
    assert got.shape == want.shape
    _one_step(got, want)
    conv_only = layers.conv2d(x, wt, None, stride, padding) == \
        conv32.to(torch.bfloat16).permute(0, 2, 3, 1)
    floor = max(0.99, float(conv_only.float().mean()) - max(0.001, 2.0 / want.numel()))
    assert float((got == want).float().mean()) >= floor


def _aug_batch(seed, b, size, g=8):
    rng = np.random.default_rng(seed)
    n = rng.integers(1, g + 1, b)
    w, h = rng.uniform(0.05, 0.5, (2, b, g))
    boxes = np.stack([rng.uniform(w / 2, 1 - w / 2), rng.uniform(h / 2, 1 - h / 2), w, h], -1)
    return {"images": torch.from_numpy(rng.integers(0, 256, (b, size, size, 3), dtype=np.uint8)),
            "gt_boxes": torch.tensor(boxes, dtype=torch.float32),
            "gt_labels": torch.from_numpy(rng.integers(0, 20, (b, g))),
            "gt_mask": torch.from_numpy(np.arange(g)[None, :] < n[:, None])}


@pytest.mark.parametrize("preset,b", [("vgg300", 8), ("test64", 16)])
def test_augment_card_matches_cpu_on_the_same_draws(cuda, preset, b):
    """The augmentation on the card against the CPU on the same draws, the
    caller's TF32 flags on (cuDNN's and cuBLAS's): uint8 images equal on
    >= 99.9 % of pixels and within 1 elsewhere, boxes within 1e-6, labels
    and masks equal; the caller's flags come back."""
    from ssd_tensorflow_tpu_torch.data import device_augment as da
    from ssd_tensorflow_tpu_torch.ops.anchors import anchors_for_preset

    cfg = ModelConfig(preset_name=preset)
    acfg = da.augment_config_for(cfg.preset)
    anchors = torch.from_numpy(anchors_for_preset(cfg.preset))
    batch = _aug_batch(b, b, cfg.preset.image_size.h)
    draws = da.draw_augment(torch.Generator(cuda).manual_seed(b), b, acfg)
    saved = torch.backends.cudnn.allow_tf32, torch.get_float32_matmul_precision()
    torch.backends.cudnn.allow_tf32 = True
    torch.set_float32_matmul_precision("high")
    try:
        got = da.apply_augment(draws, {k: v.to(cuda) for k, v in batch.items()}, anchors.to(cuda),
                               acfg)
        assert torch.get_float32_matmul_precision() == "high"
    finally:
        torch.backends.cudnn.allow_tf32 = saved[0]
        torch.set_float32_matmul_precision(saved[1])
    want = da.apply_augment(draws.to("cpu"), batch, anchors, acfg)
    assert got["images"].device.type == "cuda"
    diff = (got["images"].cpu().int() - want["images"].int()).abs()
    assert int(diff.max()) <= 1 and float((diff == 0).float().mean()) >= 0.999
    assert float((got["gt_boxes"].cpu() - want["gt_boxes"]).abs().max()) <= 1e-6
    for k in ("gt_labels", "gt_mask"):
        assert torch.equal(got[k].cpu(), want[k]), k


@contextlib.contextmanager
def _qat_grids(record=None, forced=None):
    """The port's activation fake quantization recording its integer grids
    into ``record``, or taking each grid from ``forced`` in turn."""
    from unittest import mock

    from ssd_tensorflow_tpu_torch.models import qat

    real, it = qat.fake_quant_act, iter(forced or ())

    def fq(x, scale):
        if record is not None:
            s = scale if torch.is_tensor(scale) else torch.tensor(scale, device=x.device)
            record.append(torch.clamp(torch.round(x.detach() / s), -127, 127).cpu())
            return real(x, scale)
        grid = next(it).to(x.device)
        in_range = (x.abs() <= 127.5 * scale).to(x.dtype)
        return (grid * scale).detach() + in_range * (x - x.detach())

    with mock.patch.object(qat, "fake_quant_act", fq):
        yield


@pytest.mark.parametrize("preset", ["test64", "mntest64"])
def test_qat_forward_card_matches_cpu(cuda, preset):
    """The float32 fake-quant forward on the card, cuDNN's TF32 flag on,
    against the CPU's: with the CPU's activation grids handed in, logits
    and locs within 1e-4 of their largest; left to its own roundings,
    argmax equal on >= 99 % of anchors."""
    from ssd_tensorflow_tpu_torch.models import qat, quantized

    cfg = qat.qat_model_config(ModelConfig(preset_name=preset, num_classes=3))
    params = init_params(cfg, seed=6)
    img = torch.from_numpy(np.random.default_rng(6).integers(0, 256, (2, 64, 64, 3),
                                                             dtype=np.uint8))
    calibrate = (quantized.calibrate_activation_scales if preset == "test64"
                 else quantized.calibrate_activation_amax)
    scales = calibrate(params, img, cfg)
    fwd = qat.make_qat_forward(cfg, scales)
    on_card = {n: {k: v.to(cuda) for k, v in d.items()} for n, d in params.items()}
    grids = []
    saved = torch.backends.cudnn.allow_tf32
    torch.backends.cudnn.allow_tf32 = True
    try:
        with torch.no_grad():
            with _qat_grids(record=grids):
                want = fwd(params, img)
            with _qat_grids(forced=grids):
                got = [v.cpu() for v in fwd(on_card, img.to(cuda))]
            free = fwd(on_card, img.to(cuda))[0].cpu()
        assert torch.backends.cudnn.allow_tf32
    finally:
        torch.backends.cudnn.allow_tf32 = saved
    for g, w in zip(got, want):
        assert float((g - w).abs().max()) <= 1e-4 * float(w.abs().max())
    assert float((free.argmax(-1) == want[0].argmax(-1)).float().mean()) >= 0.99


def test_qat_export_on_the_card(cuda, tmp_path):
    """The QAT contract on the card: the amax calibrated on the card, stored
    in a checkpoint, exported without recalibrating (calibration patched to
    raise) bit for bit as the CPU's export of the same checkpoint; the
    bundle runs on the card with the fused ``int8_qconv`` once a conv, the
    im2col route never, and NMS once."""
    from unittest import mock

    from ssd_tensorflow_tpu_torch import inference
    from ssd_tensorflow_tpu_torch.models import qat, quantized
    from ssd_tensorflow_tpu_torch.parallel import train_step
    from ssd_tensorflow_tpu_torch.utils.checkpoint import save_checkpoint

    cfg = qat.qat_model_config(ModelConfig(preset_name="mntest64", num_classes=3))
    state = train_step.make_train_state(init_params(cfg, seed=7), train_step.TrainConfig(model=cfg),
                                        device=cuda)
    img = np.random.default_rng(7).integers(0, 256, (4, 64, 64, 3), dtype=np.uint8)
    _, entry = qat.qat_scales(state.params, cfg, None, img)
    ckpt = str(tmp_path / "e1.ckpt.npz")
    save_checkpoint(ckpt, state, {"model": inference.model_config_to_dict(cfg), **entry})
    boom = AssertionError("recalibrated")
    with mock.patch.object(quantized, "calibrate_activation_amax", side_effect=boom), \
            mock.patch.object(quantized, "QuantizedModel", side_effect=boom):
        for name, dev in (("card", cuda), ("cpu", "cpu")):
            assert qat.export_int8_bundle(ckpt, str(tmp_path / f"{name}.npz"), device=dev) == {}
    with np.load(str(tmp_path / "card.npz")) as a, np.load(str(tmp_path / "cpu.npz")) as b:
        assert all(np.array_equal(a[f], b[f]) for f in b.files)
    model = inference.InferenceModel.from_bundle(str(tmp_path / "card.npz"), device=cuda)
    before = (int8_conv.int8_qconv.launches, nms_cuda.nms_keep.launches,
              int8_conv.int8_conv.launches)
    dets = model.run_scores(img)
    n_convs = sum("a_scale" in leaf for leaf in inference.load_bundle(
        str(tmp_path / "card.npz"))[0].values())
    assert int8_conv.int8_qconv.launches - before[0] == n_convs > 0
    assert int8_conv.int8_conv.launches == before[2]
    assert nms_cuda.nms_keep.launches - before[1] == 1 and dets.boxes.device.type == "cuda"


# -- the parallel modules and the train CLI on the card -----------------------


def test_prefetch_to_the_card_is_bit_exact(cuda):
    from ssd_tensorflow_tpu_torch.parallel.prefetch import prefetch_to_device

    rng = np.random.default_rng(0)
    host = [{"x": rng.integers(0, 256, (4, 64, 64, 3), dtype=np.uint8),
             "y": rng.normal(size=(4, 7)).astype(np.float32)} for _ in range(6)]
    seen = 0
    for i, (dev, meta) in enumerate(prefetch_to_device(iter([(h, i) for i, h in enumerate(host)]),
                                                       device="cuda", transform=lambda it: it)):
        assert meta == i and dev["x"].is_cuda
        y = dev["y"] * 2  # a consumer's work on the current stream
        assert torch.equal(dev["x"].cpu(), torch.from_numpy(host[i]["x"]))
        assert torch.equal(y.cpu(), torch.from_numpy(host[i]["y"]) * 2)
        seen += 1
    assert seen == len(host)


def _one_rank_group():
    import os
    import socket

    with socket.socket() as sock:
        sock.bind(("127.0.0.1", 0))
        port = sock.getsockname()[1]
    os.environ.update(RANK="0", WORLD_SIZE="1", LOCAL_RANK="0", MASTER_ADDR="127.0.0.1",
                      MASTER_PORT=str(port))


@pytest.fixture
def nccl_group(cuda):
    """A one-rank NCCL group, as a one-process ``torchrun`` launch gives;
    destroyed after the test."""
    import os

    import torch.distributed as dist

    saved = {k: os.environ.get(k) for k in ("RANK", "WORLD_SIZE", "LOCAL_RANK", "MASTER_ADDR",
                                            "MASTER_PORT")}
    _one_rank_group()
    try:
        yield cuda
    finally:
        if dist.is_initialized():
            dist.destroy_process_group()
        for k, v in saved.items():
            if v is None:
                os.environ.pop(k, None)
            else:
                os.environ[k] = v


def test_one_rank_nccl_step_equals_the_step_without_a_group(cuda):
    import torch.distributed as dist

    from ssd_tensorflow_tpu_torch.ops.anchors import anchors_for_preset
    from ssd_tensorflow_tpu_torch.parallel import mesh, train_step

    cfg = train_step.TrainConfig(model=ModelConfig(preset_name="test64", num_classes=5,
                                                   compute_dtype="float32"))
    anchors = anchors_for_preset(cfg.model.preset)
    rng = np.random.default_rng(1)
    batch = {"images": rng.integers(0, 256, (4, 64, 64, 3), dtype=np.uint8),
             "gt_boxes": np.tile(np.float32([[0.5, 0.5, 0.4, 0.3]]), (4, 2, 1)),
             "gt_labels": np.ones((4, 2), np.int32), "gt_mask": np.ones((4, 2), bool)}
    params = init_params(cfg.model, seed=2)
    step = train_step.make_train_step(cfg, anchors)
    saved = torch.backends.cudnn.deterministic
    torch.backends.cudnn.deterministic = True
    try:
        want, want_losses, _ = step(train_step.make_train_state(params, cfg, device=cuda), batch)
        import os

        env = dict(os.environ)
        _one_rank_group()
        try:
            m = mesh.make_mesh(device="cuda")
            assert dist.get_backend() == "nccl" and dist.get_world_size() == 1
            got, losses, _ = step(train_step.shard_state(
                train_step.make_train_state(params, cfg, device=cuda), m),
                train_step.shard_batch(batch, m))
        finally:
            if dist.is_initialized():
                dist.destroy_process_group()
            os.environ.clear()
            os.environ.update(env)
    finally:
        torch.backends.cudnn.deterministic = saved
    assert all(torch.equal(losses[k], want_losses[k]) for k in want_losses)
    assert all(torch.equal(got.params[n][k], want.params[n][k]) for n in params
               for k in params[n])


def test_train_cli_epochs_on_the_card(nccl_group, tmp_path):
    """Two epochs and a resumed third of the train CLI on the card, on a
    staged test64 dataset (``chip_smoke.staged_dataset``; the card machine
    has no OpenCV to decode images), with two forked workers over the
    shared-memory transport, under a one-rank NCCL group."""
    import chip_smoke
    import ssd_tensorflow_tpu_torch.cli.train as cli
    from ssd_tensorflow_tpu_torch.utils.checkpoint import checkpoint_config

    data = chip_smoke.staged_dataset(tmp_path / "data", 0, preset="test64", n_train=16,
                                     n_valid=8)
    argv = ["--name", str(tmp_path / "p"), "--data-dir", data, "--batch-size", "8",
            "--tensorboard-dir", str(tmp_path / "tb"), "--num-workers", "2",
            "--checkpoint-interval", "1", "--device", "cuda"]
    before = nms_cuda.nms_keep.launches
    with chip_smoke.staged_cli(cli, threshold=0.01):
        assert cli.main(argv + ["--epochs", "2"]) == 0
        assert cli.main(argv + ["--epochs", "3", "--continue-training", "yes"]) == 0
    assert nms_cuda.nms_keep.launches - before == 3 * (2 + 1)
    final = str(tmp_path / "p" / "final.ckpt.npz")
    assert checkpoint_config(final)["epoch"] == 3


#: RetinaNet's grouped 3x3 convs (32 groups): (hw, channels, stride) of a
#: stage's first and later blocks at retina800
RETINA_GROUPED = [(200, 128, 1), (200, 256, 2), (100, 256, 1), (100, 512, 2), (25, 1024, 1)]


@pytest.mark.parametrize("hw,c,stride", RETINA_GROUPED)
def test_grouped_conv_relu_rounds_once(cuda, hw, c, stride):
    g = torch.Generator(device=cuda).manual_seed(hw * c + stride)
    x = (2 * torch.randn((2, hw, hw, c), generator=g, device=cuda)).to(torch.bfloat16)
    w = (torch.randn((c, c // 32, 3, 3), generator=g, device=cuda) / (9 * c // 32) ** 0.5).to(
        torch.bfloat16).contiguous(memory_format=torch.channels_last)
    b = torch.randn(c, generator=g, device=cuda) * 0.5
    before = layers.grouped_conv.calls
    got = layers.grouped_conv({"w": w, "b": b}, x, stride, 1, 32)
    assert layers.grouped_conv.calls == before + 1
    want = torch.relu(torch.nn.functional.conv2d(x.permute(0, 3, 1, 2).float(), w.float(), b,
                                                 stride, 1, 1, 32)).to(torch.bfloat16)
    want = want.permute(0, 2, 3, 1)
    assert got.shape == want.shape and got.dtype == torch.bfloat16
    _one_step(got, want)
    assert float((got == want).float().mean()) >= 0.99


#: a bottleneck's last 1x1 conv with its skip: (hw, width, out) at retina800
RETINA_ADD_RELU = [(200, 128, 256), (100, 256, 512), (50, 512, 1024), (25, 1024, 2048)]


@pytest.mark.parametrize("hw,cin,cout", RETINA_ADD_RELU)
def test_conv_add_relu_rounds_once(cuda, hw, cin, cout):
    """cuDNN's fused conv + bias + skip + ReLU rounds once, as the CPU route
    (``layers.conv_add_relu``) does."""
    g = torch.Generator(device=cuda).manual_seed(hw * cin + cout)
    x = (2 * torch.randn((2, hw, hw, cin), generator=g, device=cuda)).to(torch.bfloat16)
    skip = (2 * torch.randn((2, hw, hw, cout), generator=g, device=cuda)).to(torch.bfloat16)
    w = (torch.randn((cout, cin, 1, 1), generator=g, device=cuda) / cin ** 0.5).to(
        torch.bfloat16).contiguous(memory_format=torch.channels_last)
    b = torch.randn(cout, generator=g, device=cuda) * 0.5
    got = layers.conv_add_relu({"w": w, "b": b}, x, skip, 1, 0)
    want = layers.conv_add_relu({"w": w.cpu(), "b": b.cpu()}, x.cpu(), skip.cpu(), 1, 0)
    assert got.shape == want.shape and got.dtype == torch.bfloat16
    _one_step(got.cpu(), want)
    assert float((got.cpu() == want).float().mean()) >= 0.99


def _retina_case(cuda, b=2):
    """The retina800 configuration of the benchmark, its reference module,
    seeded parameters (on the CPU) and ``b`` staged images."""
    import json
    import sys
    from pathlib import Path

    bench = Path(__file__).resolve().parents[1] / "h100bench"
    if str(bench) not in sys.path:
        sys.path.insert(0, str(bench))
    from benchlib import pool
    from reference import retinanet_resnext50fpn as ref

    cfg = json.loads((bench / "configs" / "retinanet800-resnext50fpn-bf16.json").read_text())
    traffic = json.loads((bench / "traffic" / "serve-b64.json").read_text())
    params = ref.seeded_params(cfg, 3_000_000_011, torch.device("cpu"))
    images = pool.images(b, tuple(cfg["preset"]["image_size"]), traffic["augment"], 17,
                         torch.device("cpu"))
    return cfg, ref, params, images


def test_retina800_forward_card_matches_cpu_reference(cuda):
    """retina800 at b2 on the card against the plain float32 reference on the
    CPU, seeded weights. float32 (TF32 off): within 1e-3 of the largest
    logit / offset (sums in other orders over ~70 layers; ~1e-5 expected).
    bf16, the served precision: every score (sigmoid of a logit) within
    0.05 of the reference's, and the mean within 0.005 (bf16 keeps 8
    significant bits per activation over ~70 layers)."""
    from ssd_tensorflow_tpu_torch.inference import model_config_from_dict

    cfg, ref, params, images = _retina_case(cuda)
    with ref.full_float32():
        want_l, want_c = ref.float_forward(params, images, cfg)
    on_card = {n: {k: v.to(cuda) for k, v in leaf.items()} for n, leaf in params.items()}
    for dtype in ("float32", "bfloat16"):
        mc = model_config_from_dict({**cfg["model"], "compute_dtype": dtype})
        staged = ssd_vgg.stage_conv_weights(
            {n: {k: (v.to(mc.dtype) if v.dim() == 4 else v) for k, v in leaf.items()}
             for n, leaf in on_card.items()}, mc)
        with torch.inference_mode():
            got_l, got_c = ssd_vgg.apply_model(staged, images.to(cuda), mc)
        got_l, got_c = got_l.cpu(), got_c.cpu()
        if dtype == "float32":
            assert float((got_l - want_l).abs().max()) <= 1e-3 * float(want_l.abs().max())
            assert float((got_c - want_c).abs().max()) <= 1e-3 * float(want_c.abs().max())
        else:
            gap = (torch.sigmoid(got_l) - torch.sigmoid(want_l)).abs()
            assert float(gap.max()) <= 0.05 and float(gap.mean()) <= 0.005
