"""Layers, trunk and model of the PyTorch port against the JAX package, in
float32 on the same inputs and weights.

Tolerance: 1e-4 relative to the largest magnitude of the reference —
both sides accumulate in float32 but in different orders.
"""

from unittest import mock

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from ssd_tensorflow_tpu.models import layers as jax_layers
from ssd_tensorflow_tpu.models import ssd_vgg as jax_ssd
from ssd_tensorflow_tpu.models import vgg16 as jax_vgg16
from ssd_tensorflow_tpu_torch.models import layers, ssd_vgg, vgg16
from ssd_tensorflow_tpu_torch.ops import stem_cuda
from ssd_tensorflow_tpu_torch.weights import params_from_jax

RTOL = 1e-4


def _close(got, want, rtol=RTOL):
    got = got.detach().float().numpy() if torch.is_tensor(got) else np.asarray(got)
    want = np.asarray(want, dtype=np.float32)
    assert got.shape == want.shape
    scale = max(float(np.abs(want).max()), 1e-6)
    assert float(np.abs(got - want).max()) <= rtol * scale


@pytest.mark.parametrize(
    "size,k,stride,padding,dilation",
    [
        (9, 3, 1, "SAME", 1),
        (10, 3, 2, "SAME", 1),   # even: TF pads (0 top, 1 bottom)
        (9, 3, 2, "SAME", 1),    # odd: symmetric
        (8, 1, 1, "SAME", 1),
        (19, 3, 1, "SAME", 6),   # the a-trous conv6
        (5, 3, 1, "VALID", 1),
        (4, 3, 1, "VALID", 1),
    ],
)
def test_conv2d_matches_jax(rng, size, k, stride, padding, dilation):
    x = rng.normal(0, 1, (2, size, size + 1, 5)).astype(np.float32)
    w = rng.normal(0, 0.3, (k, k, 5, 7)).astype(np.float32)
    b = rng.normal(0, 0.3, (7,)).astype(np.float32)
    want = jax_layers.conv2d(x, w, b, stride, padding, dilation)
    got = layers.conv2d(torch.from_numpy(x), torch.from_numpy(w.transpose(3, 2, 0, 1).copy()),
                        torch.from_numpy(b), stride, padding, dilation)
    _close(got, want)


def test_bf16_conv2d_matches_jax_f32_out(rng):
    """On the CPU a bf16 conv with a float32 bias (``conv2d``, and
    ``conv_relu`` through it) sums the exact bf16 products in float32, adds
    the float32 bias and rounds once, as the JAX package's
    ``conv2d(..., f32_out=True)`` does: equal on >= 99.9 % of elements, the
    rest within one bf16 step of the largest output. Measured: 100 % of the
    first layer, 99.994 % and 99.985 % of the wider two (a float32 sum in
    another order may round the other way). The bias rounded to bf16
    before the add, as before, held 76-83 % of them."""
    for shape, wshape, sd in (((2, 9, 10, 16), (8, 16, 3, 3), 0.3),
                              ((2, 16, 17, 64), (32, 64, 3, 3), 0.1),
                              ((2, 12, 13, 128), (64, 128, 3, 3), 0.1)):
        x = torch.tensor(rng.normal(0, 1, shape), dtype=torch.bfloat16)
        w = torch.tensor(rng.normal(0, sd, wshape), dtype=torch.float32)
        b = torch.tensor(rng.normal(0, 1, (wshape[0],)), dtype=torch.float32)
        assert not torch.equal(b.to(torch.bfloat16).float(), b)
        want = np.asarray(jax_layers.conv2d(
            jnp.asarray(x.float().numpy(), jnp.bfloat16), w.permute(2, 3, 1, 0).numpy(),
            b.numpy(), f32_out=True), dtype=np.float32)
        for got, ref in ((layers.conv2d(x, w, b), want),
                         (layers.conv_relu({"w": w, "b": b}, x), np.maximum(want, 0))):
            assert got.dtype == torch.bfloat16
            got = got.float().numpy()
            assert float((got == ref).mean()) >= 0.999
            assert np.abs(got - ref).max() <= 2.0 ** -7 * np.abs(ref).max()


def _fine_bias(rng, n):
    """float32 biases that bf16 cannot hold: eight more mantissa bits set."""
    b = rng.normal(0, 1, (n,)).astype(np.float32)
    b = (b.view(np.uint32) | np.uint32(0x5A5A)).view(np.float32)
    assert not np.array_equal(torch.from_numpy(b).to(torch.bfloat16).float().numpy(), b)
    return b


@pytest.mark.parametrize("hw,cin,cout", [(8, 64, 32), (5, 48, 24), (1, 32, 16)])
def test_head_conv_rounds_once_like_jax_f32_out(rng, hw, cin, cout):
    """The multibox heads' route (the bias carried in as input channels)
    against the JAX package's ``conv2d(..., f32_out=True)`` in bf16, with
    nonzero float32 biases too fine for bf16: equal on >= 99.9 % of
    elements, the rest one bf16 step (2^-7 of the largest output) apart
    (float32 sums in another order may round the other way)."""
    x = torch.tensor(rng.normal(0, 1, (2, hw, hw + 1, cin)), dtype=torch.bfloat16)
    w = torch.tensor(rng.normal(0, 0.2, (cout, cin, 3, 3)), dtype=torch.float32)
    b = _fine_bias(rng, cout)
    got = layers.conv2d_bias_in(x, layers.widen_bias(w.to(torch.bfloat16), torch.from_numpy(b)))
    assert got.dtype == torch.bfloat16
    want = np.asarray(jax_layers.conv2d(
        jnp.asarray(x.float().numpy(), jnp.bfloat16), w.permute(2, 3, 1, 0).numpy(), b,
        f32_out=True), dtype=np.float32)
    got = got.float().numpy()
    assert got.shape == want.shape
    assert float((got == want).mean()) >= 0.999
    assert np.abs(got - want).max() <= 2.0 ** -7 * np.abs(want).max()
    # the route it replaces, a bf16 bias pass after the rounded conv, does not hold
    twice = (layers.conv2d(x, w) + torch.from_numpy(b).to(torch.bfloat16)).float().numpy()
    assert float((twice == want).mean()) < 0.999


def test_head_conv_float32_matches_jax(rng):
    """In float32 the bias channels carry b whole (b_lo is zero)."""
    x = rng.normal(0, 1, (2, 6, 7, 10)).astype(np.float32)
    w = rng.normal(0, 0.3, (3, 3, 10, 12)).astype(np.float32)
    b = rng.normal(0, 0.3, (12,)).astype(np.float32)
    wb = layers.widen_bias(torch.from_numpy(w.transpose(3, 2, 0, 1).copy()), torch.from_numpy(b))
    assert not wb[:, 11:].any()
    _close(layers.conv2d_bias_in(torch.from_numpy(x), wb), jax_layers.conv2d(x, w, b))


@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32])
def test_widen_bias_layout(rng, dtype):
    """``widen_bias``: the filter untouched, eight more input channels,
    the bias's three terms at the centre tap of the first three and zero
    elsewhere, channels-last contiguous; b_hi + b_lo within 2^-16 relative
    of b, and the three terms add up to b exactly."""
    w = torch.tensor(rng.normal(0, 0.2, (24, 40, 3, 3)), dtype=dtype)
    b = torch.from_numpy(_fine_bias(rng, 24))
    for fmt in (torch.contiguous_format, torch.channels_last):
        wb = layers.widen_bias(w.contiguous(memory_format=fmt), b)
        assert wb.shape == (24, 48, 3, 3) and wb.dtype == dtype
        assert wb.is_contiguous(memory_format=torch.channels_last)
        assert torch.equal(wb[:, :40], w)
        extra = wb[:, 40:].float()
        hi, lo, rest = extra[:, 0, 1, 1], extra[:, 1, 1, 1], extra[:, 2, 1, 1]
        assert torch.equal(hi, b.to(dtype).float())
        assert float(((hi + lo - b).abs() / b.abs()).max()) <= 2.0 ** -16
        assert torch.equal(hi + lo + rest, b)
        extra[:, :3, 1, 1] = 0
        assert not extra.any()
    with pytest.raises(ValueError, match="centre"):
        layers.widen_bias(torch.zeros((4, 4, 2, 2)), torch.zeros(4))
    with pytest.raises(ValueError, match="widen_bias"):
        layers.conv2d_bias_in(torch.zeros((1, 4, 4, 40)), torch.zeros((24, 40, 3, 3)))


def test_head_weights_are_staged_once():
    """``InferenceModel`` stages each head's widened filter; the forward
    uses it, and gives what the unstaged parameters give."""
    from ssd_tensorflow_tpu_torch.inference import InferenceModel

    cfg = ssd_vgg.ModelConfig(preset_name="test64", num_classes=3)
    params = ssd_vgg.init_params(cfg, seed=3)
    rng = np.random.default_rng(3)
    for i in range(len(cfg.preset.maps)):
        hp = params[f"classifier{i}"]
        hp["b"] = torch.from_numpy(_fine_bias(rng, hp["b"].shape[0]))
    model = InferenceModel(params, cfg, device="cpu")
    for i in range(len(cfg.preset.maps)):
        hp = model.params[f"classifier{i}"]
        assert torch.equal(hp["wb"], layers.widen_bias(hp["w"], hp["b"]))
        assert "wb" not in params[f"classifier{i}"]
    img = torch.from_numpy(rng.integers(0, 255, (1, 64, 64, 3), dtype=np.uint8))
    with mock.patch.object(ssd_vgg, "widen_bias", side_effect=AssertionError("not staged")):
        staged = ssd_vgg.apply_scores(model.params, img, cfg)
    for got, want in zip(staged, ssd_vgg.apply_scores(params, img, cfg)):
        assert torch.equal(got, want)


@pytest.mark.parametrize("size,window,stride", [(75, 2, 2), (64, 2, 2), (19, 3, 1), (5, 2, 2)])
def test_max_pool_matches_jax(rng, size, window, stride):
    x = rng.normal(0, 1, (2, size, size, 3)).astype(np.float32)
    got = layers.max_pool(torch.from_numpy(x), window, stride)
    np.testing.assert_array_equal(got.numpy(), np.asarray(jax_layers.max_pool(x, window, stride)))


def test_max_pool_pads_with_minus_inf():
    x = -torch.ones((1, 3, 3, 1)) * 5.0  # a zero pad would win the max
    assert float(layers.max_pool(x, 2, 2).max()) == -5.0


def test_l2_normalize_scale(rng):
    x = rng.normal(0, 1, (2, 4, 4, 16)).astype(np.float32)
    scale = rng.uniform(1, 20, (16,)).astype(np.float32)
    got = layers.l2_normalize_scale(torch.from_numpy(x), torch.from_numpy(scale), eps=1e-3)
    _close(got, jax_layers.l2_normalize_scale(x, scale, eps=1e-3))


def _f32_models(preset, num_classes=3, seed=0):
    jcfg = jax_ssd.ModelConfig(preset_name=preset, num_classes=num_classes,
                               compute_dtype="float32")
    jp = jax_ssd.init_params(jax.random.PRNGKey(seed), jcfg)
    tcfg = ssd_vgg.ModelConfig(preset_name=preset, num_classes=num_classes,
                               compute_dtype="float32")
    return jcfg, jp, tcfg, params_from_jax(jp)


def test_param_shapes_match_jax_init():
    jcfg, jp, tcfg, _ = _f32_models("vgg512")
    shapes = ssd_vgg.param_shapes(tcfg)
    assert sorted(shapes) == sorted(jp)
    for name, leaves in jp.items():
        assert {k: tuple(v.shape) for k, v in leaves.items()} == shapes[name]
    own = ssd_vgg.init_params(tcfg, seed=1)
    for name, leaves in own.items():
        for key, v in leaves.items():
            want = shapes[name][key]
            assert tuple(v.shape) == (want if v.dim() < 4 else
                                      (want[3], want[2], want[0], want[1]))


def test_apply_backbone_matches_jax(rng):
    _, jp, _, tp = _f32_models("test64")
    x = rng.normal(0, 30, (2, 64, 64, 3)).astype(np.float32)
    jc4, jx = jax_vgg16.apply_backbone(jp, jnp.asarray(x))
    tc4, tx = vgg16.apply_backbone(tp, torch.from_numpy(x))
    _close(tc4, jc4)
    _close(tx, jx)


@pytest.mark.parametrize("preset,batch", [("test64", 2), ("vgg300", 1)])
def test_apply_model_matches_jax(preset, batch):
    jcfg, jp, tcfg, tp = _f32_models(preset)
    size = jcfg.preset.image_size
    img = np.random.default_rng(1).integers(0, 255, (batch, size.h, size.w, 3), dtype=np.uint8)
    jl, jloc = jax_ssd.apply_model(jp, img, jcfg, inference=True)
    tl, tloc = ssd_vgg.apply_model(tp, torch.from_numpy(img), tcfg)
    _close(tl, jl)
    _close(tloc, jloc)


def test_apply_result_and_scores_match_jax():
    jcfg, jp, tcfg, tp = _f32_models("test64", num_classes=4, seed=2)
    img = np.random.default_rng(2).integers(0, 255, (2, 64, 64, 3), dtype=np.uint8)
    timg = torch.from_numpy(img)
    _close(ssd_vgg.apply_result(tp, timg, tcfg), jax_ssd.apply_result(jp, img, jcfg))
    jconf, jcls, jlocs = jax_ssd.apply_scores(jp, img, jcfg)
    tconf, tcls, tlocs = ssd_vgg.apply_scores(tp, timg, tcfg)
    _close(tconf, jconf)
    _close(tlocs, jlocs)
    assert tcls.dtype == torch.int32
    np.testing.assert_array_equal(tcls.numpy(), np.asarray(jcls))


@pytest.mark.parametrize("dtype,stem_calls", [("bfloat16", 1), ("float32", 0)])
def test_bf16_forward_always_takes_the_stem(dtype, stem_calls):
    cfg = ssd_vgg.ModelConfig(preset_name="test64", num_classes=3, compute_dtype=dtype)
    params = ssd_vgg.init_params(cfg, seed=0)
    img = torch.from_numpy(np.random.default_rng(0).integers(0, 255, (1, 64, 64, 3), dtype=np.uint8))
    with mock.patch.object(stem_cuda, "fused_stem", wraps=stem_cuda.fused_stem) as stem:
        ssd_vgg.apply_scores(params, img, cfg)
        ssd_vgg.apply_model(params, img, cfg)
    assert stem.call_count == 2 * stem_calls


def test_argmax_ties_take_first_class():
    cfg = ssd_vgg.ModelConfig(preset_name="test64", num_classes=3, compute_dtype="float32")
    heads = [torch.zeros((1, m.size.h, m.size.w, m.num_shapes * cfg.num_vars))
             for m in cfg.preset.maps]
    conf, cls, locs = ssd_vgg.reduce_head_maps(heads, cfg)
    assert not cls.any()
    torch.testing.assert_close(conf, torch.full_like(conf, 0.25))


def test_non_vgg_presets_wait():
    """The family presets are accepted now (``models/resnet.py``,
    ``models/mobilenet.py``) and walk their own trunk, never the VGG one;
    a family takes no VGG stem kernel."""
    for preset, backbone, module in (("resnet320", "resnet34", "resnet"),
                                     ("mobilenet320", "mobilenetv1", "mobilenet")):
        cfg = ssd_vgg.ModelConfig(preset_name=preset)
        assert cfg.preset.backbone == backbone
        assert ssd_vgg._backbone_module(cfg.preset).__name__.endswith(f".{module}")
        with pytest.raises(ValueError, match="VGG conv1-block"):
            ssd_vgg.ModelConfig(preset_name=preset, pallas_stem_variant="uint8")
    assert ssd_vgg._backbone_module(ssd_vgg.ModelConfig(preset_name="vgg512").preset) is None


@pytest.mark.parametrize("cin", [512, 1024], ids=["K4608", "K9216"])
def test_jax_head_conv_one_rounding_share(cin):
    """The yardstick of the long-K heads (ROADMAP.md section 3): how often
    the JAX package's own ``conv2d(f32_out=True)`` + bias on the CPU equals
    the exact one-rounding ``bf16(conv + b)`` (a float64 sum), at K = 9 *
    cin = 4608 and 9216 on random bf16 operands, 16 x 16 maps, 150 outputs.
    float32 accumulation over K terms leaves a few outputs one bf16 step
    off: found 99.987 % (K = 4608) and 99.982 % (K = 9216) on an x86 CPU,
    the port's CPU route (``layers.conv2d_bias_in``, oneDNN) 99.982 % and
    99.969 %, held to the same floor; the card's cuDNN conv reaches
    99.63-99.75 % (``chip_smoke.py`` conv_epilogue)."""
    rng = np.random.default_rng(cin)
    x = torch.tensor(rng.normal(0, 2, (1, 16, 16, cin)), dtype=torch.bfloat16)
    w = torch.tensor(rng.normal(0, 1 / np.sqrt(9 * cin), (150, cin, 3, 3)), dtype=torch.bfloat16)
    b = torch.tensor(rng.normal(0, 0.5, 150), dtype=torch.float32)
    exact = torch.nn.functional.conv2d(x.permute(0, 3, 1, 2).double(), w.double(), None, 1, 1)
    exact = (exact + b.double().view(1, -1, 1, 1)).float().to(torch.bfloat16)
    exact = exact.permute(0, 2, 3, 1).float().numpy()
    jax_out = np.asarray(jax_layers.conv2d(
        jnp.asarray(x.float().numpy(), jnp.bfloat16), w.float().permute(2, 3, 1, 0).numpy(),
        b.numpy(), f32_out=True), np.float32)
    port = layers.conv2d_bias_in(x, layers.widen_bias(w, b)).float().numpy()
    for got in (jax_out, port):
        assert got.shape == exact.shape
        assert float(np.mean(got == exact)) >= 0.9995
        assert float(np.abs(got - exact).max()) <= 2.0 ** -7 * float(np.abs(exact).max())
