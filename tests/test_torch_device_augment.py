"""The port's on-device augmentation (``data/device_augment.py``) against
the JAX package's, on the CPU with 16-64 px images.

The port splits the random draws from the math, so the JAX package's own
draws can be handed to it: ``_jax_draws`` makes the same
``jax.random.split`` / ``uniform`` / ``randint`` calls as the JAX module
(the per-image ``split(key, B)``, then ``split(k)`` into the photometric
and the geometric key) and returns their values as the port's ``Draws``.

Tolerances: uint8 images equal on >= 99.9 % of pixels and within 1
everywhere (both sum the bilinear products in float32, in another order);
windows, boxes within 1e-6; sampler picks, flips, labels and masks equal;
HSV within 1e-4 on the 0-255 scale; ``resample_window`` within 1e-3.
The port's own ``torch.Generator`` draws are held to the JAX package's
rate tests (``tests/test_device_augment.py``).
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from ssd_tensorflow_tpu.data import device_augment as jda
from ssd_tensorflow_tpu.ops.anchors import anchors_for_preset
from ssd_tensorflow_tpu.presets import get_preset_by_name
from ssd_tensorflow_tpu_torch.data import device_augment as da
from ssd_tensorflow_tpu_torch.presets import get_preset_by_name as port_preset

ANCHORS = anchors_for_preset(get_preset_by_name("test64"))
FULL_IMAGE_ANCHOR = np.asarray([[0.5, 0.5, 0.9, 0.9]], np.float32)


def _jax_draws(key, b, cfg):
    """JAX's draws for a batch of ``b`` under ``key``, as the port's Draws."""
    s, t = len(cfg.sampler_overlaps), cfg.sampler_trials
    u, ri = jax.random.uniform, jax.random.randint

    def one(k):
        k_photo, k_geom = jax.random.split(k)
        ks = jax.random.split(k_photo, 11)
        k_exp, k_ratio, k_off, k_samp, k_pick, k_flip = jax.random.split(k_geom, 6)
        k4 = jax.random.split(k_samp, 4)
        return dict(
            brightness_u=u(ks[0]),
            brightness_delta=ri(ks[1], (), -cfg.brightness_delta, cfg.brightness_delta + 1),
            contrast_u=u(ks[2]),
            contrast=u(ks[3], (), minval=cfg.contrast_lower, maxval=cfg.contrast_upper),
            saturation_u=u(ks[4]),
            saturation=u(ks[5], (), minval=cfg.saturation_lower, maxval=cfg.saturation_upper),
            hue_u=u(ks[6]), hue_delta=ri(ks[7], (), -cfg.hue_delta, cfg.hue_delta + 1),
            order_u=u(ks[8]), reorder_u=u(ks[9]), perm=ri(ks[10], (), 0, len(jda._PERMS)),
            expand_u=u(k_exp),
            expand_ratio=u(k_ratio, (), minval=1.0, maxval=cfg.expand_max_ratio),
            expand_offset=u(k_off, (2,)),
            sampler_scale=u(k4[0], (s, t), minval=cfg.sampler_min_scale,
                            maxval=cfg.sampler_max_scale),
            sampler_ar=u(k4[1], (s, t), minval=cfg.sampler_min_ar, maxval=cfg.sampler_max_ar),
            sampler_cx=u(k4[2], (s, t)), sampler_cy=u(k4[3], (s, t)),
            pick_u=u(k_pick, (s + 1,)), flip_u=u(k_flip))

    values = jax.jit(jax.vmap(one))(jax.random.split(key, b))
    return da.Draws(**{k: torch.tensor(np.asarray(v)).to(
        torch.int64 if np.asarray(v).dtype.kind == "i" else torch.float32)
        for k, v in values.items()})


def _jax_geometry(key, batch, cfg):
    """JAX's sampler pick, window and flip of each image (before the
    positive fallback), by the JAX module's own ``_sample_geometry`` and
    ``_sampler_windows`` under the same keys."""

    def one(k, boxes, mask):
        k_geom = jax.random.split(k)[1]
        window, flip = jda._sample_geometry(k_geom, boxes, mask, cfg)
        k_exp, k_ratio, k_off, k_samp, k_pick, _ = jax.random.split(k_geom, 6)
        ratio = jnp.where(jax.random.uniform(k_exp) < cfg.expand_prob,
                          jax.random.uniform(k_ratio, (), minval=1.0,
                                             maxval=cfg.expand_max_ratio), 1.0)
        ox, oy = jax.random.uniform(k_off, (2,)) * (ratio - 1.0)
        cx, cy = (boxes[:, 0] + ox) / ratio, (boxes[:, 1] + oy) / ratio
        w2, h2 = boxes[:, 2] / (2.0 * ratio), boxes[:, 3] / (2.0 * ratio)
        ok, _ = jda._sampler_windows(
            k_samp, jnp.stack([cx - w2, cy - h2, cx + w2, cy + h2], -1), mask, cfg)
        ok = jnp.concatenate([jnp.ones((1,), bool), ok])
        pick = jnp.argmax(jnp.where(ok, jax.random.uniform(k_pick, (ok.shape[0],)), -1.0))
        return window, flip, pick

    b = batch["images"].shape[0]
    out = jax.jit(jax.vmap(one))(jax.random.split(key, b), batch["gt_boxes"], batch["gt_mask"])
    return [np.asarray(v) for v in out]


def _batch(seed, b, size, g=5, num_classes=20):
    rng = np.random.default_rng(seed)
    n = rng.integers(1, g + 1, b)
    w, h = rng.uniform(0.05, 0.6, (2, b, g))
    boxes = np.stack([rng.uniform(w / 2, 1 - w / 2), rng.uniform(h / 2, 1 - h / 2), w, h], -1)
    return {"images": rng.integers(0, 256, (b, size, size, 3), dtype=np.uint8),
            "gt_boxes": boxes.astype(np.float32),
            "gt_labels": rng.integers(0, num_classes, (b, g)).astype(np.int32),
            "gt_mask": np.arange(g)[None, :] < n[:, None]}


def _identity_cfg(**kw):
    """Every random branch off but those in ``kw``: a pure resize."""
    base = dict(out_h=16, out_w=16, sampler_trials=8, brightness_prob=0.0, contrast_prob=0.0,
                hue_prob=0.0, saturation_prob=0.0, reorder_prob=0.0, expand_prob=0.0,
                sampler_overlaps=(), flip_prob=0.0, ensure_positive=False)
    base.update(kw)
    return base


def _torch_batch(batch):
    return {k: torch.from_numpy(np.asarray(v)) for k, v in batch.items()}


CASES = {
    # the preset's chain at 64 x 64 from 64 px staged images
    "test64": (dict(out_h=64, out_w=64, sampler_trials=8), ANCHORS, 64, 8),
    # 48 px staged, resized to 64, every branch forced on
    "all_on": (dict(out_h=64, out_w=64, sampler_trials=6, brightness_prob=1.0,
                    contrast_prob=1.0, hue_prob=1.0, saturation_prob=1.0, reorder_prob=1.0,
                    expand_prob=1.0, flip_prob=1.0), ANCHORS, 48, 8),
    # anchors that match only a full-image box: the positive fallback fires
    "fallback": (dict(out_h=32, out_w=32, sampler_trials=8, expand_prob=1.0),
                 FULL_IMAGE_ANCHOR, 32, 12),
    # a pure pass-through. (Resampling 16 px to 24 puts every third row and
    # column at weights 1/2 : 1/2, exact half-integer ties that float32 noise
    # rounds either way: 97 % equal there.)
    "identity": (_identity_cfg(), ANCHORS, 16, 4),
}


@pytest.mark.parametrize("case", list(CASES))
def test_augment_matches_jax_on_jax_draws(case):
    kw, anchors, size, b = CASES[case]
    jcfg, tcfg = jda.AugmentConfig(**kw), da.AugmentConfig(**kw)
    batch = _batch(sum(map(ord, case)), b, size)
    if case == "fallback":
        batch["gt_boxes"][:] = [0.5, 0.5, 0.9, 0.9]
    key = jax.random.PRNGKey(len(case))
    want = {k: np.asarray(v) for k, v in jda.make_augment_fn(jcfg, anchors)(key, batch).items()}
    draws = _jax_draws(key, b, jcfg)
    got = da.apply_augment(draws, _torch_batch(batch), torch.from_numpy(anchors), tcfg)
    got = {k: v.numpy() for k, v in got.items()}

    assert got["images"].dtype == np.uint8 and got["images"].shape == want["images"].shape
    diff = np.abs(got["images"].astype(int) - want["images"].astype(int))
    assert diff.max() <= 1 and (diff == 0).mean() >= 0.999, ((diff == 0).mean(), diff.max())
    np.testing.assert_allclose(got["gt_boxes"], want["gt_boxes"], atol=1e-6, rtol=0)
    np.testing.assert_array_equal(got["gt_labels"], want["gt_labels"])
    np.testing.assert_array_equal(got["gt_mask"], want["gt_mask"])

    jw, jflip, jpick = _jax_geometry(key, batch, jcfg)
    tb = _torch_batch(batch)
    window, flip, pick = da.sample_geometry(draws, tb["gt_boxes"], tb["gt_mask"], tcfg)
    np.testing.assert_allclose(window.numpy(), jw, atol=1e-6, rtol=0)
    np.testing.assert_array_equal(flip.numpy(), jflip)
    np.testing.assert_array_equal(pick.numpy(), jpick)
    *_, has_pos = da.augment_geometry(draws, tb, torch.from_numpy(anchors), tcfg)
    if case == "identity":
        np.testing.assert_array_equal(got["images"], batch["images"])
    if case == "fallback":
        assert not has_pos.all(), "the fallback case took no fallback"
        from ssd_tensorflow_tpu_torch.ops.matching import has_positive_anchor

        for i in range(b):
            assert has_positive_anchor(got["gt_boxes"][i], got["gt_mask"][i], anchors)


def _rand_image(seed, shape=(2, 16, 16, 3)):
    img = np.random.default_rng(seed).integers(0, 256, shape).astype(np.float32)
    img[0, 0, :4] = [[0, 0, 0], [255, 255, 255], [7, 7, 7], [0, 255, 0]]  # grey, pure
    return img


def test_hsv_matches_jax():
    img = _rand_image(1)
    hsv = da.bgr_to_hsv(torch.from_numpy(img)).numpy()
    np.testing.assert_allclose(hsv, np.asarray(jda.bgr_to_hsv(jnp.asarray(img))), atol=1e-4,
                               rtol=0)
    rng = np.random.default_rng(2)
    h = np.stack([rng.uniform(0, 180, (64, 64)), rng.uniform(0, 255, (64, 64)),
                  rng.uniform(0, 255, (64, 64))], -1).astype(np.float32)
    np.testing.assert_allclose(da.hsv_to_bgr(torch.from_numpy(h)).numpy(),
                               np.asarray(jda.hsv_to_bgr(jnp.asarray(h))), atol=1e-4, rtol=0)
    np.testing.assert_allclose(da.hsv_to_bgr(torch.from_numpy(hsv)).numpy(), img, atol=1e-3)


def test_remap_boxes_matches_jax():
    rng = np.random.default_rng(3)
    boxes = rng.uniform(0.05, 0.95, (6, 7, 4)).astype(np.float32)
    mask = rng.uniform(size=(6, 7)) < 0.8
    lo = rng.uniform(-0.6, 0.5, (6, 2))
    window = np.concatenate([lo, lo + rng.uniform(0.3, 1.8, (6, 2))], 1).astype(np.float32)
    flip = np.array([False, True, False, True, True, False])
    want_b, want_k = jax.vmap(jda.remap_boxes)(boxes, mask, window, flip)
    got_b, got_k = da.remap_boxes(*(torch.from_numpy(a) for a in (boxes, mask, window, flip)))
    np.testing.assert_allclose(got_b.numpy(), np.asarray(want_b), atol=1e-6, rtol=0)
    np.testing.assert_array_equal(got_k.numpy(), np.asarray(want_k))


@pytest.mark.parametrize("window,flip", [((0.0, 0.0, 1.0, 1.0), False), ((0.1, 0.25, 0.7, 0.9), True),
                                         ((-0.5, -0.25, 1.2, 1.0), False),
                                         ((-3.0, 0.0, -2.0, 1.0), True)])
def test_resample_window_matches_jax(window, flip):
    img = _rand_image(4, (1, 20, 16, 3))
    mean = (104.0, 117.0, 123.0)
    want = jda.resample_window(jnp.asarray(img[0]), jnp.asarray(window), jnp.asarray(flip), 9, 10,
                               mean)
    got = da.resample_window(torch.from_numpy(img), torch.tensor([window]), torch.tensor([flip]),
                             9, 10, mean)
    np.testing.assert_allclose(got[0].numpy(), np.asarray(want), atol=1e-3, rtol=0)
    if window == (0.0, 0.0, 1.0, 1.0):
        ident = da.resample_window(torch.from_numpy(img), torch.tensor([window]),
                                   torch.tensor([False]), 20, 16, mean)
        np.testing.assert_allclose(ident.numpy(), img, atol=1e-3)


def test_sampler_windows_match_jax():
    cfg = jda.AugmentConfig(sampler_trials=64)
    boxes_c = np.asarray([[0.3, 0.3, 0.7, 0.7], [0.1, 0.6, 0.3, 0.9]], np.float32)
    for seed in range(6):
        mask = np.array([True, seed % 3 != 0]) if seed != 5 else np.array([False, False])
        key = jax.random.PRNGKey(seed)
        want_ok, want_w = jda._sampler_windows(key, jnp.asarray(boxes_c), jnp.asarray(mask), cfg)
        k4 = jax.random.split(key, 4)
        s, t = len(cfg.sampler_overlaps), cfg.sampler_trials
        u = jax.random.uniform
        draws = dict(
            sampler_scale=u(k4[0], (s, t), minval=cfg.sampler_min_scale,
                            maxval=cfg.sampler_max_scale),
            sampler_ar=u(k4[1], (s, t), minval=cfg.sampler_min_ar, maxval=cfg.sampler_max_ar),
            sampler_cx=u(k4[2], (s, t)), sampler_cy=u(k4[3], (s, t)))
        draws = da.Draws(**{f.name: torch.tensor(np.asarray(draws[f.name]))[None]
                            if f.name in draws else None for f in dataclasses.fields(da.Draws)})
        ok, windows = da._sampler_windows(draws, torch.from_numpy(boxes_c)[None],
                                          torch.from_numpy(mask)[None], da.AugmentConfig(
                                              sampler_trials=64))
        np.testing.assert_array_equal(ok[0].numpy(), np.asarray(want_ok))
        np.testing.assert_allclose(windows[0].numpy(), np.asarray(want_w), atol=1e-6, rtol=0)
        if seed == 5:
            assert not ok.any()


def test_augment_config_for_matches_jax():
    for aug in ({}, {"sampler_trials": 8}, {"expand_probability": 0.25, "sampler_trials": 3}):
        want = jda.augment_config_for(get_preset_by_name("vgg512"), aug)
        got = da.augment_config_for(port_preset("vgg512"), aug)
        assert dataclasses.asdict(got) == dataclasses.asdict(want)
    with pytest.raises(ValueError, match="unknown augmentation key"):
        da.augment_config_for(port_preset("test64"), {"flip": 0.5})


# ---------------------------------------------------------------------------
# The port's own draws
# ---------------------------------------------------------------------------


def test_port_draws_repeat_under_a_seed_and_batch_equals_per_image():
    cfg = da.augment_config_for(port_preset("test64"), {"sampler_trials": 8})
    fn = da.make_augment_fn(cfg, ANCHORS)
    batch = _torch_batch(_batch(5, 4, 64))
    a = fn(torch.Generator().manual_seed(7), batch)
    b = fn(torch.Generator().manual_seed(7), batch)
    c = fn(torch.Generator().manual_seed(8), batch)
    for k in a:
        assert torch.equal(a[k], b[k]), k
    assert not torch.equal(a["images"], c["images"])
    assert a["images"].device.type == "cpu" and a["images"].dtype == torch.uint8

    draws = da.draw_augment(torch.Generator().manual_seed(9), 4, cfg)
    whole = da.apply_augment(draws, batch, torch.from_numpy(ANCHORS), cfg)
    for i in range(4):
        one = da.Draws(**{f.name: getattr(draws, f.name)[i:i + 1]
                          for f in dataclasses.fields(da.Draws)})
        part = da.apply_augment(one, {k: v[i:i + 1] for k, v in batch.items()},
                                torch.from_numpy(ANCHORS), cfg)
        for k in whole:
            assert torch.equal(whole[k][i:i + 1], part[k]), (i, k)
    numpy_in = fn(torch.Generator().manual_seed(7), {k: v.numpy() for k, v in batch.items()})
    assert torch.equal(numpy_in["images"], a["images"])


def test_port_draws_are_in_range():
    cfg = da.AugmentConfig(sampler_trials=16)
    d = da.draw_augment(torch.Generator().manual_seed(0), 512, cfg)
    assert d.brightness_delta.min() == -32 and d.brightness_delta.max() == 32
    assert d.hue_delta.min() == -18 and d.hue_delta.max() == 18
    assert set(d.perm.tolist()) == set(range(6))
    assert 0.5 <= float(d.contrast.min()) and float(d.contrast.max()) < 1.5
    assert 1.0 <= float(d.expand_ratio.min()) and float(d.expand_ratio.max()) < 4.0
    assert 0.3 <= float(d.sampler_scale.min()) and float(d.sampler_scale.max()) < 1.0
    assert d.sampler_scale.shape == (512, 6, 16) and d.pick_u.shape == (512, 7)


def _run_many(cfg, boxes, n=256, hw=16, seed=0):
    rng = np.random.default_rng(seed)
    batch = {"images": torch.from_numpy(rng.integers(0, 256, (n, hw, hw, 3), dtype=np.uint8)),
             "gt_boxes": torch.tensor(boxes, dtype=torch.float32).expand(n, 1, 4).contiguous(),
             "gt_labels": torch.zeros((n, 1), dtype=torch.int32),
             "gt_mask": torch.ones((n, 1), dtype=torch.bool)}
    return da.make_augment_fn(cfg, np.asarray([[0.5, 0.5, 0.6, 0.6]], np.float32))(
        torch.Generator().manual_seed(seed), batch)


def test_flip_rate_is_half():
    out = _run_many(da.AugmentConfig(**_identity_cfg(flip_prob=0.5)), [[0.3, 0.5, 0.2, 0.2]])
    flipped = np.isclose(out["gt_boxes"][:, 0, 0].numpy(), 0.7).mean()
    assert 0.35 < flipped < 0.65, flipped


def test_expand_shrinks_boxes_at_the_configured_rate():
    out = _run_many(da.AugmentConfig(**_identity_cfg(expand_prob=0.5)), [[0.5, 0.5, 0.6, 0.6]])
    w = out["gt_boxes"][:, 0, 2].numpy()[out["gt_mask"][:, 0].numpy()]
    shrunk = (w < 0.6 - 1e-6).mean()
    assert 0.3 < shrunk < 0.7, shrunk
    assert (w >= 0.6 / 4.0 - 1e-6).all()


def test_brightness_stays_within_its_delta():
    n = 64
    img = np.random.default_rng(3).integers(100, 150, (32, 32, 3), dtype=np.uint8)
    cfg = da.AugmentConfig(**_identity_cfg(brightness_prob=1.0, out_h=32, out_w=32))
    batch = {"images": torch.from_numpy(np.tile(img, (n, 1, 1, 1))),
             "gt_boxes": torch.tensor([[[0.5, 0.5, 0.6, 0.6]]]).expand(n, 1, 4).contiguous(),
             "gt_labels": torch.zeros((n, 1), dtype=torch.int32),
             "gt_mask": torch.ones((n, 1), dtype=torch.bool)}
    out = da.make_augment_fn(cfg, np.asarray([[0.5, 0.5, 0.6, 0.6]], np.float32))(
        torch.Generator().manual_seed(4), batch)
    per_image = (out["images"].numpy().astype(int) - img.astype(int)).reshape(n, -1)
    assert (per_image.max(1) == per_image.min(1)).all()
    assert per_image.max() <= 32 and per_image.min() >= -32 and per_image.std() > 5


def test_matmul_precision_is_full_float32_inside_and_restored():
    """The interpolation products run without TF32 whatever the caller
    set, and the caller's setting comes back."""
    seen = []
    real_bmm = torch.bmm

    def bmm(*args):
        seen.append(torch.get_float32_matmul_precision())
        return real_bmm(*args)

    saved = torch.get_float32_matmul_precision()
    torch.set_float32_matmul_precision("high")
    try:
        cfg = da.AugmentConfig(out_h=16, out_w=16, sampler_trials=4)
        from unittest import mock

        with mock.patch.object(torch, "bmm", bmm):
            da.make_augment_fn(cfg, ANCHORS)(torch.Generator().manual_seed(0),
                                             _torch_batch(_batch(6, 2, 16)))
        assert seen == ["highest"]
        assert torch.get_float32_matmul_precision() == "high"
    finally:
        torch.set_float32_matmul_precision(saved)
