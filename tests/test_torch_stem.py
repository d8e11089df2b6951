"""The port's conv1 stem (conv1_1 + the fused conv1_2/pool1 op) against the
JAX package's Pallas split stem (interpret mode) and its packed XLA stem.

Tolerance ``0.005 * max|ref| + 0.25``, as tests/test_stem_pallas.py: the
stems round to bf16 at the same points (conv1_1 out, relu(c1 + b1), the
pooled output) but sum in different orders, so a value may land one bf16
step apart, and that step propagates through conv1_2.
"""

import jax
import numpy as np
import pytest
import torch

from ssd_tensorflow_tpu.models.packed_conv import conv1_block_packed
from ssd_tensorflow_tpu.models.ssd_vgg import ModelConfig as JaxModelConfig
from ssd_tensorflow_tpu.models.ssd_vgg import init_params as jax_init_params
from ssd_tensorflow_tpu.ops.stem_pallas import fused_stem_pallas_dma
from ssd_tensorflow_tpu_torch.models import vgg16
from ssd_tensorflow_tpu_torch.models.ssd_vgg import ModelConfig, preprocess
from ssd_tensorflow_tpu_torch.ops import stem_cuda
from ssd_tensorflow_tpu_torch.weights import params_from_jax

MEAN = (104.0, 117.0, 123.0)


@pytest.fixture(scope="module")
def params():
    jp = jax_init_params(jax.random.PRNGKey(0), JaxModelConfig(preset_name="vgg300"))
    # a non-zero conv1 bias, so b1 and b2 are really added (init gives zeros)
    rng = np.random.default_rng(5)
    for name in ("conv1_1", "conv1_2"):
        jp[name] = dict(jp[name], b=rng.normal(0, 2.0, 64).astype(np.float32))
    return jp, params_from_jax(jp)


def _port_stem(tp, img):
    x = preprocess(torch.from_numpy(img), ModelConfig(preset_name="vgg300"))
    return vgg16.conv1_block(tp, x).float().numpy()


@pytest.mark.parametrize("h,w", [(32, 64), (96, 64), (300, 300)])
def test_stem_matches_jax(params, h, w):
    jp, tp = params
    img = np.random.default_rng(42).integers(0, 255, (2, h, w, 3), dtype=np.uint8)
    got = _port_stem(tp, img)
    assert got.shape == (2, h // 2, w // 2, 64)
    for ref in (
        fused_stem_pallas_dma(jp, img, MEAN, "bfloat16", interpret=True),
        conv1_block_packed(jp, img, MEAN, "bfloat16", f32_out=True),
    ):
        ref = np.asarray(ref.astype(np.float32))
        scale = np.abs(ref).max()
        assert scale > 1.0
        assert np.abs(got - ref).max() <= 0.005 * scale + 0.25


def test_plain_stem_zero_border(params):
    """Outside the image conv1_2 sees zeros, not relu(b1): a one-pixel
    image edge must equal the plain conv with explicit zero padding."""
    _, tp = params
    c1 = torch.randn(1, 4, 6, 64).to(torch.bfloat16)
    b1 = torch.full((64,), 3.0)  # relu(b1) > 0 would leak in if padded wrongly
    w2, b2 = tp["conv1_2"]["w"], tp["conv1_2"]["b"]
    got = stem_cuda.fused_stem(c1, b1, w2, b2)
    y1 = torch.relu(c1.float() + b1).to(torch.bfloat16).float().permute(0, 3, 1, 2)
    y1 = torch.nn.functional.pad(y1, (1, 1, 1, 1))
    y = torch.nn.functional.conv2d(y1, w2.to(torch.bfloat16).float(), b2)
    want = torch.nn.functional.max_pool2d(torch.relu(y), 2).to(torch.bfloat16)
    torch.testing.assert_close(got, want.permute(0, 2, 3, 1), rtol=0, atol=0)


def test_wrapper_rejects_other_devices(params):
    _, tp = params
    c1 = torch.zeros((1, 4, 4, 64), dtype=torch.bfloat16, device="meta")
    with pytest.raises(ValueError, match="unsupported device"):
        stem_cuda.fused_stem(c1, tp["conv1_1"]["b"], tp["conv1_2"]["w"], tp["conv1_2"]["b"])


@pytest.mark.parametrize("b,h,w", [(1, 8, 32), (2, 18, 34), (3, 300, 300), (1, 6, 10), (2, 64, 64)])
def test_stem_tile_walk_covers_every_pixel_once(b, h, w):
    """``stem_tiles`` mirrors the kernels' tile walk: over ragged shapes
    every conv pixel lies in exactly one tile (a numpy count), tiles never
    start outside the image, and the count is the launch grid's bound."""
    tiles = stem_cuda.stem_tiles(b, h, w)
    assert len(tiles) == b * -(-h // stem_cuda.TILE_ROWS) * -(-w // stem_cuda.TILE_COLS)
    count = np.zeros((b, h, w), dtype=np.int64)
    for n, y0, x0 in tiles:
        assert 0 <= n < b and 0 <= y0 < h and 0 <= x0 < w
        assert y0 % stem_cuda.TILE_ROWS == 0 and x0 % stem_cuda.TILE_COLS == 0
        count[n, y0:y0 + stem_cuda.TILE_ROWS, x0:x0 + stem_cuda.TILE_COLS] += 1
    assert (count == 1).all()
    assert tiles == sorted(tiles)  # images outermost, then tile rows, then tile columns
