"""The port's whole-stem entry points against the JAX package's Pallas
stems (interpret mode): ``fused_stem_uint8`` (both TPU tap layouts) and
``fused_stem_pallas``.

Tolerance ``0.005 * max|ref| + 0.25``, as tests/test_stem_pallas.py: the
stems round to bf16 at the same points but sum in different orders, so
a value may land one bf16 step apart, and that step propagates through
conv1_2. The conv1 biases are nonzero and seeded (the JAX init gives
zeros, which would hide the order of the bias add and the roundings).
"""

import jax
import numpy as np
import pytest
import torch
import torch.nn.functional as F

from ssd_tensorflow_tpu.models.ssd_vgg import ModelConfig as JaxModelConfig
from ssd_tensorflow_tpu.models.ssd_vgg import init_params as jax_init_params
from ssd_tensorflow_tpu.ops.stem_pallas import fused_stem_pallas as jax_fused_stem_pallas
from ssd_tensorflow_tpu.ops.stem_pallas import fused_stem_uint8 as jax_fused_stem_uint8
from ssd_tensorflow_tpu_torch.models import layers, vgg16
from ssd_tensorflow_tpu_torch.ops import stem_cuda
from ssd_tensorflow_tpu_torch.weights import params_from_jax

MEAN = (104.0, 117.0, 123.0)


@pytest.fixture(scope="module")
def params():
    jp = jax_init_params(jax.random.PRNGKey(0), JaxModelConfig(preset_name="vgg300"))
    rng = np.random.default_rng(11)
    for name in ("conv1_1", "conv1_2"):
        jp[name] = dict(jp[name], b=rng.normal(0, 2.0, 64).astype(np.float32))
    jp = {k: jp[k] for k in ("conv1_1", "conv1_2")}
    return jp, params_from_jax(jp)


def _image(b, h, w, seed=42):
    return np.random.default_rng(seed).integers(0, 256, (b, h, w, 3), dtype=np.uint8)


def _close(got, ref):
    got = got.float().numpy()
    ref = np.asarray(ref.astype(np.float32))
    assert got.shape == ref.shape
    scale = np.abs(ref).max()
    assert scale > 1.0
    assert np.abs(got - ref).max() <= 0.005 * scale + 0.25


@pytest.mark.parametrize("nine_taps", [False, True])
@pytest.mark.parametrize("b,h,w", [(2, 32, 64), (2, 96, 64), (2, 40, 48)])
def test_uint8_stem_matches_jax(params, b, h, w, nine_taps):
    jp, tp = params
    img = _image(b, h, w)
    got = stem_cuda.fused_stem_uint8(tp, torch.from_numpy(img), MEAN, nine_taps=nine_taps)
    assert got.shape == (b, h // 2, w // 2, 64) and got.dtype == torch.bfloat16
    _close(got, jax_fused_stem_uint8(jp, img, MEAN, "bfloat16", interpret=True,
                                     nine_taps=nine_taps))


@pytest.mark.parametrize("b,h,w", [(2, 32, 64), (2, 40, 48)])
def test_fused_stem_pallas_entry_matches_jax(params, b, h, w):
    jp, tp = params
    img = _image(b, h, w, seed=7)
    got = stem_cuda.fused_stem_pallas(tp, torch.from_numpy(img), MEAN)
    _close(got, jax_fused_stem_pallas(jp, img, MEAN, "bfloat16", interpret=True))
    torch.testing.assert_close(stem_cuda.fused_stem_pallas_dma(tp, torch.from_numpy(img), MEAN),
                               got, rtol=0, atol=0)


def test_uint8_block_is_the_entry(params):
    _, tp = params
    img = torch.from_numpy(_image(1, 32, 32, seed=3))
    torch.testing.assert_close(vgg16.conv1_block_uint8(tp, img, MEAN),
                               stem_cuda.fused_stem_uint8(tp, img, MEAN), rtol=0, atol=0)


def test_uint8_stem_zero_border(params):
    """Outside the image, conv1_1 sees zeros in preprocessed space and
    conv1_2 sees zeros, not relu(b1): with relu(b1) > 0 the plain version
    must equal an explicit zero-padded computation at the image edge."""
    _, tp = params
    p = {"conv1_1": dict(tp["conv1_1"], b=torch.full((64,), 3.0)), "conv1_2": tp["conv1_2"]}
    img = torch.from_numpy(_image(1, 4, 6, seed=9))
    got = stem_cuda.fused_stem_uint8(p, img, MEAN)
    x = (img.float() - torch.tensor(MEAN)).to(torch.bfloat16).float().permute(0, 3, 1, 2)
    c1 = F.conv2d(F.pad(x, (1, 1, 1, 1)), p["conv1_1"]["w"].to(torch.bfloat16).float())
    y1 = torch.relu(c1 + 3.0).to(torch.bfloat16).float()
    y = F.conv2d(F.pad(y1, (1, 1, 1, 1)), p["conv1_2"]["w"].to(torch.bfloat16).float(),
                 p["conv1_2"]["b"])
    want = F.max_pool2d(torch.relu(y), 2).to(torch.bfloat16).permute(0, 2, 3, 1)
    torch.testing.assert_close(got, want, rtol=0, atol=0)
    # a relu(b1) border would change the edge outputs
    leak = F.conv2d(F.pad(y1, (1, 1, 1, 1), value=3.0), p["conv1_2"]["w"].to(torch.bfloat16).float(),
                    p["conv1_2"]["b"])
    leak = F.max_pool2d(torch.relu(leak), 2).to(torch.bfloat16).permute(0, 2, 3, 1)
    assert not torch.equal(got, leak)


def test_uint8_kernel_weight_layout(params):
    """``uint8_stem_weights`` stages w1 as [cout][dy*16 + dx*4 + c] with b1
    riding on the strip's fourth channel (1.0): the kernel's K steps are
    the window's rows of 4 pixels x 4 channels. The same product on the
    CPU, gathered with numpy-style slices, equals the float32 conv1_1 + b1."""
    _, tp = params
    tp = {k: dict(v) for k, v in tp.items()}
    tp["conv1_1"]["b"] = torch.tensor(np.random.default_rng(7).normal(0, 2, 64), dtype=torch.float32)
    img = torch.from_numpy(_image(1, 8, 10, seed=5))
    x = (img.float() - torch.tensor(MEAN)).to(torch.bfloat16).float()  # (1, 8, 10, 3)
    # the strip: zero SAME padding (one more column on the right for the
    # fourth, zero-weighted pixel of a row), then the channel of ones everywhere
    xp = F.pad(F.pad(x, (0, 0, 1, 2, 1, 1)), (0, 1), value=1.0)
    cols = torch.stack([xp[:, dy:dy + 8, dx:dx + 10, :] for dy in range(3) for dx in range(4)],
                       dim=3).reshape(1, 8, 10, 48)
    w1k, b1, w2t, b2 = stem_cuda.uint8_stem_weights(tp)
    assert w1k.shape == (64, 48) and w1k.dtype == torch.bfloat16
    got = cols @ w1k.float().t()
    want = F.conv2d(x.permute(0, 3, 1, 2), tp["conv1_1"]["w"].to(torch.bfloat16).float(),
                    tp["conv1_1"]["b"], padding=1).permute(0, 2, 3, 1)
    torch.testing.assert_close(got, want, rtol=1e-5, atol=1e-3)
    # every slot that is neither a weight nor a bias term is zero
    slots = w1k.reshape(64, 3, 4, 4)
    assert not slots[:, :, 3, :].any() and not slots[:, :, 1:3, 3].any()
    # b1 arrives exactly: three bf16 terms cover float32's 24 bits
    assert torch.equal(slots[:, 0, 0, 3].float() + slots[:, 1, 0, 3].float()
                       + slots[:, 2, 0, 3].float(), tp["conv1_1"]["b"])
    assert torch.equal(b1, tp["conv1_1"]["b"])
    assert w2t.shape == (9, 64, 64)
    # the kernel reads every operand as a contiguous array, whatever the
    # parameters' memory format (InferenceModel stages channels-last)
    for fmt in (torch.contiguous_format, torch.channels_last):
        staged = {k: {"w": v["w"].contiguous(memory_format=fmt), "b": v["b"]} for k, v in tp.items()}
        assert all(t.is_contiguous() for t in stem_cuda.uint8_stem_weights(staged))
    torch.testing.assert_close(w2t[1 * 3 + 2].float(),
                               tp["conv1_2"]["w"][:, :, 1, 2].to(torch.bfloat16).float())


@pytest.mark.parametrize("scale", [1e-3, 1.0, 300.0])
def test_split_bf16_is_exact(scale):
    x = torch.tensor(np.random.default_rng(3).normal(0, scale, 257), dtype=torch.float32)
    parts = layers.split_terms(x, torch.bfloat16)
    assert len(parts) == 3 and all(p.dtype == torch.bfloat16 for p in parts)
    assert torch.equal(parts[0].float() + parts[1].float() + parts[2].float(), x)


def test_uint8_stem_rejects_bad_input(params):
    _, tp = params
    with pytest.raises(ValueError, match="even"):
        stem_cuda.fused_stem_uint8(tp, torch.zeros((1, 6, 7, 3), dtype=torch.uint8), MEAN)
    with pytest.raises(ValueError, match="uint8"):
        stem_cuda.fused_stem_uint8(tp, torch.zeros((1, 6, 6, 3)), MEAN)
    with pytest.raises(ValueError, match="unsupported device"):
        stem_cuda.fused_stem_uint8(tp, torch.zeros((1, 6, 6, 3), dtype=torch.uint8,
                                                   device="meta"), MEAN)
