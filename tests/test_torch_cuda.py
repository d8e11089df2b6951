"""The port's CUDA kernels against their plain versions, on the card.

Marked ``cuda``: each test skips without a GPU. Run on a machine with
one:  ``python -m pytest -m cuda tests/test_torch_cuda.py``.

NMS keep masks must be identical. The stem may differ by one bf16 step
of its largest output (2^-7 relative): both sum exact bf16 products in
float32, in different orders.
"""

import numpy as np
import pytest
import torch

from ssd_tensorflow_tpu_torch.models.ssd_vgg import ModelConfig, init_params
from ssd_tensorflow_tpu_torch.ops import nms_cuda, stem_cuda
from ssd_tensorflow_tpu_torch.ops.boxes import box_canvas_corners
from ssd_tensorflow_tpu_torch.ops.nms import class_shifted

pytestmark = pytest.mark.cuda


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU (torch.cuda.is_available() is False)")
    torch.backends.cudnn.allow_tf32 = False
    return torch.device("cuda")


@pytest.mark.parametrize("b,d", [(64, 200), (3, 57), (2, 256), (1, 1), (2, 1024)])
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


def test_nms_kernel_rejects_too_many_candidates(cuda):
    corners = torch.zeros((1, nms_cuda.MAX_CANDIDATES + 1, 4), device=cuda)
    valid = torch.ones(corners.shape[:2], dtype=torch.bool, device=cuda)
    with pytest.raises(ValueError, match="exceeds"):
        nms_cuda.nms_keep(corners, valid)


@pytest.mark.parametrize("b,h,w", [(2, 32, 64), (1, 300, 300), (2, 18, 34), (4, 512, 512)])
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
