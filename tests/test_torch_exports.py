"""The JAX package's public names in the port: each subpackage's
``__all__`` (every name importable, each loaded from its module on first
use), the root's ``Label`` and ``Sample``, and the functions and types
the port lacked, each held against the JAX package on the CPU:
``ops/iou.pairwise_iou`` and ``types.normalize_box`` bit for bit,
``ops/anchors.anchors_by_name`` / ``num_anchors_per_map`` equal,
``data/device_augment.augment_image`` on JAX's draws at the batch
augmentation's bounds (``tests/test_torch_device_augment.py``: images
within 1 on >= 99.9 % equal, boxes within 1e-6), and
``utils/summaries.draw_box`` the same pixels.
"""

import importlib
import math
import subprocess
import sys
from pathlib import Path

import jax
import numpy as np
import pytest
import torch

import ssd_tensorflow_tpu
import ssd_tensorflow_tpu_torch
from ssd_tensorflow_tpu import types as jax_types
from ssd_tensorflow_tpu.data import device_augment as jda
from ssd_tensorflow_tpu.ops import anchors as jax_anchors
from ssd_tensorflow_tpu.ops import iou as jax_iou
from ssd_tensorflow_tpu.presets import get_preset_by_name as jax_preset
from ssd_tensorflow_tpu_torch import types
from ssd_tensorflow_tpu_torch.data import device_augment as da
from ssd_tensorflow_tpu_torch.ops import anchors, iou
from ssd_tensorflow_tpu_torch.presets import get_preset_by_name

ROOT = Path(__file__).resolve().parent.parent
sys.path.insert(0, str(Path(__file__).resolve().parent))
from test_torch_device_augment import _batch, _jax_draws  # noqa: E402

SUBPACKAGES = ["ops", "models", "parallel", "utils", "eval", "data"]
#: ROADMAP.md's "Not to port" list, as public names (none is exported by
#: a JAX subpackage's ``__all__``)
NOT_TO_PORT = {"packed_conv", "pad_head_vars", "pad_head_channels"}


@pytest.mark.parametrize("name", SUBPACKAGES)
def test_subpackage_all_equals_jax(name):
    jax_pkg = importlib.import_module(f"ssd_tensorflow_tpu.{name}")
    port_pkg = importlib.import_module(f"ssd_tensorflow_tpu_torch.{name}")
    assert sorted(port_pkg.__all__) == sorted(set(jax_pkg.__all__) - NOT_TO_PORT)
    for n in port_pkg.__all__:
        assert getattr(port_pkg, n) is not None, n
    with pytest.raises(AttributeError):
        port_pkg.no_such_name  # noqa: B018


def test_root_exports_label_and_sample():
    assert set(ssd_tensorflow_tpu.__all__) <= set(ssd_tensorflow_tpu_torch.__all__)
    assert set(ssd_tensorflow_tpu_torch.__all__) - set(ssd_tensorflow_tpu.__all__) == {
        "resolve_device"}
    assert ssd_tensorflow_tpu_torch.Label._fields == ssd_tensorflow_tpu.Label._fields
    assert ssd_tensorflow_tpu_torch.Sample._fields == ssd_tensorflow_tpu.Sample._fields


def test_subpackages_import_their_names_lazily():
    """Importing a subpackage loads none of its modules, so the serving
    façade still loads nothing of training and ``data`` never loads the
    OpenCV image I/O until asked."""
    code = (
        "import sys; sys.modules['jax'] = None\n"
        + "".join(f"import ssd_tensorflow_tpu_torch.{n}\n" for n in SUBPACKAGES)
        + "loaded = [m for m in sys.modules if m.startswith(tuple("
        + repr([f"ssd_tensorflow_tpu_torch.{n}." for n in SUBPACKAGES]) + "))]\n"
        "assert not loaded, loaded\n"
        "from ssd_tensorflow_tpu_torch.data import TrainingData\n"
        "assert 'ssd_tensorflow_tpu_torch.data.image_io' not in sys.modules\n"
    )
    subprocess.run([sys.executable, "-c", code], cwd=ROOT, check=True, timeout=120)


def test_pairwise_iou_matches_jax():
    rng = np.random.default_rng(0)
    lo = rng.uniform(0, 0.6, (2, 7, 2, 2)).astype(np.float32)
    size = rng.uniform(0.01, 0.4, (2, 7, 2, 2)).astype(np.float32)
    # (xmin, xmax, ymin, ymax)
    a = np.stack([lo[..., 0, 0], lo[..., 0, 0] + size[..., 0, 0],
                  lo[..., 1, 0], lo[..., 1, 0] + size[..., 1, 0]], -1)
    b = np.stack([lo[..., 0, 1], lo[..., 0, 1] + size[..., 0, 1],
                  lo[..., 1, 1], lo[..., 1, 1] + size[..., 1, 1]], -1)
    b[0, 0] = a[0, 0]  # an identical pair
    got = iou.pairwise_iou(torch.from_numpy(a), torch.from_numpy(b)).numpy()
    want = np.asarray(jax_iou.pairwise_iou(a, b))
    assert got.shape == (2, 7, 7) and got[0, 0, 0] == 1.0 and (got == 0).any()
    np.testing.assert_array_equal(got, want)


@pytest.mark.parametrize("preset", ["test64", "rtest64", "mntest64", "vgg300"])
def test_anchors_by_name_and_per_map_match_jax(preset):
    got = anchors.anchors_by_name(preset)
    np.testing.assert_array_equal(got, jax_anchors.anchors_by_name(preset))
    assert anchors.anchors_by_name(preset) is got and not got.flags.writeable
    per_map = anchors.num_anchors_per_map(get_preset_by_name(preset))
    assert per_map == jax_anchors.num_anchors_per_map(jax_preset(preset))
    assert sum(per_map) == len(got)


def _box(module, cx, cy, w, h):
    return module.Box("cat", 7, module.Point(cx, cy), module.Size(w, h))


BOXES = [(0.5, 0.5, 0.2, 0.3), (0.05, 0.95, 0.4, 0.3), (1.2, -0.1, 0.5, 0.5),
         (0.3, 0.3, -0.1, 0.2), (math.nan, 0.5, 0.1, 0.1), (0.5, 0.5, math.inf, 0.1),
         (0.0, 0.0, 0.0, 0.0), (0.9995, 0.0004, 0.001, 0.0009)]


@pytest.mark.parametrize("params", BOXES)
def test_box_is_valid_and_normalize_box_match_jax(params):
    got, want = _box(types, *params), _box(jax_types, *params)
    assert types.box_is_valid(got) == jax_types.box_is_valid(want)
    a, b = types.normalize_box(got), jax_types.normalize_box(want)
    if not types.box_is_valid(got):
        assert a is got
        return
    assert (a.label, a.labelid) == (b.label, b.labelid)
    assert tuple(a.center) == tuple(b.center) and tuple(a.size) == tuple(b.size)


def test_score_and_overlap_are_the_jax_types():
    assert types.Score._fields == jax_types.Score._fields
    assert types.Overlap._fields == jax_types.Overlap._fields
    assert types.Score(3, 0.5).score == 0.5 and types.Overlap(1, [2]).good == [2]


@pytest.mark.parametrize("expand", [0.0, 1.0])
def test_augment_image_matches_jax(expand):
    """One image through the port's ``augment_image`` on JAX's draws
    against the JAX package's ``augment_image`` under the same key; the
    port's generator form gives the batch form's first row."""
    kw = dict(out_h=64, out_w=64, sampler_trials=8, expand_prob=expand)
    jcfg, tcfg = jda.AugmentConfig(**kw), da.AugmentConfig(**kw)
    preset_anchors = anchors.anchors_by_name("test64")
    batch = _batch(7, 1, 48)
    one = {k: v[0] for k, v in batch.items()}
    key = jax.random.PRNGKey(3)
    want = [np.asarray(v) for v in jda.augment_image(
        jax.random.split(key, 1)[0], one["images"], one["gt_boxes"], one["gt_labels"],
        one["gt_mask"], preset_anchors, jcfg)]
    t = {k: torch.from_numpy(np.asarray(v)) for k, v in one.items()}
    args = (t["images"], t["gt_boxes"], t["gt_labels"], t["gt_mask"],
            torch.from_numpy(preset_anchors.copy()), tcfg)
    got = [v.numpy() for v in da.augment_image(_jax_draws(key, 1, jcfg), *args)]
    assert got[0].dtype == np.uint8 and got[0].shape == want[0].shape == (64, 64, 3)
    diff = np.abs(got[0].astype(int) - want[0].astype(int))
    assert diff.max() <= 1 and (diff == 0).mean() >= 0.999
    np.testing.assert_allclose(got[1], want[1], atol=1e-6, rtol=0)
    np.testing.assert_array_equal(got[2], want[2])
    np.testing.assert_array_equal(got[3], want[3])

    gen = lambda: torch.Generator().manual_seed(11)  # noqa: E731
    single = da.augment_image(gen(), *args)
    batched = da.make_augment_fn(tcfg, preset_anchors.copy())(gen(),
                                                               {k: v[None] for k, v in t.items()})
    for a, k in zip(single, ("images", "gt_boxes", "gt_labels", "gt_mask")):
        assert torch.equal(a, batched[k][0]), k


def test_draw_box_is_reexported_and_draws_jax_pixels():
    cv2 = pytest.importorskip("cv2")  # noqa: F841
    from ssd_tensorflow_tpu.utils import summaries as jax_summaries
    from ssd_tensorflow_tpu_torch.data import image_io
    from ssd_tensorflow_tpu_torch.utils import summaries

    assert summaries.draw_box is image_io.draw_box
    img = np.random.default_rng(1).integers(0, 256, (60, 80, 3), dtype=np.uint8)
    got, want = img.copy(), img.copy()
    summaries.draw_box(got, _box(types, 0.4, 0.5, 0.5, 0.4), (0, 255, 0))
    jax_summaries.draw_box(want, _box(jax_types, 0.4, 0.5, 0.5, 0.4), (0, 255, 0))
    assert (got != img).any()
    np.testing.assert_array_equal(got, want)
