"""Batched on-device SSD augmentation, as the JAX package's
``data/device_augment.py``.

The SSD augmentation chain (photometric distortion, channel reorder,
mean-filled expand, the min-IoU crop sampler, horizontal flip, the final
resize) runs as tensor code over a fixed-shape ``(B, H, W, 3)`` uint8
batch on the batch's device, so the host only decodes and stages images.
Expand, crop and resize collapse into one source window ``(x0, y0, x1,
y1)`` per image in normalized image coordinates, applied with two bilinear
interpolation products; interpolation mass that falls outside the staged
image (the expand canvas) takes the per-channel mean. The deviations from
the reference's host chain are the JAX package's (see its module doc):
continuous-coordinate sampler IoU, the staged image resampled, bilinear
only, continuous box-centre drop, and a branch-free >= 1-positive fallback
to the identity window.

The random draws are split from the math: :func:`draw_augment` makes every
per-image value the chain consumes (:class:`Draws`) from a
``torch.Generator``, and :func:`apply_augment` is deterministic in them.
So the JAX package's ``jax.random`` values can be handed to the port and
the two held to each other element for element. The math follows the
JAX package's operation order; every division by a number is a true
division (``ops/boxes.true_div``), and the interpolation products run in
full float32 whatever the caller's TF32 setting
(:func:`full_float32_matmul`): TF32 would move pixels by many uint8 steps.
"""

from __future__ import annotations

import contextlib
import dataclasses
from typing import Tuple

import numpy as np
import torch

from ssd_tensorflow_tpu_torch.ops.boxes import true_div
from ssd_tensorflow_tpu_torch.ops.iou import canvas_iou

#: the six channel permutations of the reference's channel reorder
PERMS = ((0, 1, 2), (0, 2, 1), (1, 0, 2), (1, 2, 0), (2, 0, 1), (2, 1, 0))

#: the keys of training-data.json's "augmentation" section (the JAX
#: package's ``data/pipeline.AUGMENTATION_KEYS``)
AUGMENTATION_KEYS = frozenset({"sampler_trials", "expand_probability"})


def validate_augmentation_config(aug: dict, where: str) -> dict:
    """Reject unknown keys in a declarative augmentation dict: a key read
    by name with a default would otherwise silently do nothing."""
    unknown = set(aug) - AUGMENTATION_KEYS
    if unknown:
        raise ValueError(f"unknown augmentation key(s) {sorted(unknown)} in {where}; "
                         f"known keys: {sorted(AUGMENTATION_KEYS)}")
    return aug


@dataclasses.dataclass(frozen=True)
class AugmentConfig:
    """Static augmentation parameters; the defaults are the reference's
    canonical SSD chain."""

    out_h: int = 300
    out_w: int = 300
    mean_bgr: Tuple[float, float, float] = (104.0, 117.0, 123.0)
    brightness_prob: float = 0.5
    brightness_delta: int = 32
    contrast_prob: float = 0.5
    contrast_lower: float = 0.5
    contrast_upper: float = 1.5
    hue_prob: float = 0.5
    hue_delta: int = 18
    saturation_prob: float = 0.5
    saturation_lower: float = 0.5
    saturation_upper: float = 1.5
    reorder_prob: float = 0.5
    expand_prob: float = 0.5
    expand_max_ratio: float = 4.0
    sampler_overlaps: Tuple[float, ...] = (0.1, 0.3, 0.5, 0.7, 0.9, 1.0)
    sampler_trials: int = 50
    sampler_min_scale: float = 0.3
    sampler_max_scale: float = 1.0
    sampler_min_ar: float = 0.5
    sampler_max_ar: float = 2.0
    flip_prob: float = 0.5
    #: fall back to the identity window when the augmented geometry leaves
    #: no anchor with IoU > match_threshold
    ensure_positive: bool = True
    match_threshold: float = 0.5


def augment_config_for(preset, aug_params: dict | None = None) -> AugmentConfig:
    """AugmentConfig from a preset and the pipeline's declarative
    augmentation dict (training-data.json)."""
    aug_params = validate_augmentation_config(aug_params or {}, "augment_config_for")
    return AugmentConfig(out_h=preset.image_size.h, out_w=preset.image_size.w,
                         sampler_trials=aug_params.get("sampler_trials", 50),
                         expand_prob=aug_params.get("expand_probability", 0.5))


@contextlib.contextmanager
def full_float32_matmul():
    """Within the block, float32 matmuls run in full float32 (cuBLAS
    without TF32) whatever the caller's ``torch.set_float32_matmul_precision``
    / ``torch.backends.cuda.matmul.allow_tf32``; the caller's setting is
    restored after."""
    saved = torch.get_float32_matmul_precision()
    torch.set_float32_matmul_precision("highest")
    try:
        yield
    finally:
        torch.set_float32_matmul_precision(saved)


# ---------------------------------------------------------------------------
# The draws
# ---------------------------------------------------------------------------


@dataclasses.dataclass
class Draws:
    """Every random value of one batch's chain, one row per image: the
    values the JAX package's ``jax.random`` calls return, uniforms already
    scaled to their ``[minval, maxval)`` and integers as int64."""

    brightness_u: torch.Tensor      # (B,) uniform: brightness fires if < prob
    brightness_delta: torch.Tensor  # (B,) int in [-delta, delta]
    contrast_u: torch.Tensor        # (B,)
    contrast: torch.Tensor          # (B,) factor in [lower, upper)
    saturation_u: torch.Tensor      # (B,)
    saturation: torch.Tensor        # (B,) factor in [lower, upper)
    hue_u: torch.Tensor             # (B,)
    hue_delta: torch.Tensor         # (B,) int in [-delta, delta]
    order_u: torch.Tensor           # (B,) contrast first if < 0.5
    reorder_u: torch.Tensor         # (B,)
    perm: torch.Tensor              # (B,) int index into PERMS
    expand_u: torch.Tensor          # (B,)
    expand_ratio: torch.Tensor      # (B,) in [1, expand_max_ratio)
    expand_offset: torch.Tensor     # (B, 2) uniform (ox, oy) before scaling
    sampler_scale: torch.Tensor     # (B, S, T) in [min_scale, max_scale)
    sampler_ar: torch.Tensor        # (B, S, T) in [min_ar, max_ar)
    sampler_cx: torch.Tensor        # (B, S, T) uniform
    sampler_cy: torch.Tensor        # (B, S, T) uniform
    pick_u: torch.Tensor            # (B, S + 1) uniform per sampler, identity first
    flip_u: torch.Tensor            # (B,)

    def to(self, device) -> "Draws":
        return Draws(**{f.name: getattr(self, f.name).to(device)
                        for f in dataclasses.fields(self)})


def draw_augment(generator: torch.Generator, batch_size: int, cfg: AugmentConfig) -> Draws:
    """One batch's :class:`Draws` from ``generator``, on its device."""
    dev = generator.device
    b, s, t = batch_size, len(cfg.sampler_overlaps), cfg.sampler_trials

    def uniform(*shape, lo=0.0, hi=1.0):
        u = torch.rand((b, *shape), generator=generator, device=dev)
        return u if (lo, hi) == (0.0, 1.0) else torch.clamp_min(u * (hi - lo) + lo, lo)

    def randint(lo, hi):
        return torch.randint(lo, hi, (b,), generator=generator, device=dev)

    return Draws(
        brightness_u=uniform(),
        brightness_delta=randint(-cfg.brightness_delta, cfg.brightness_delta + 1),
        contrast_u=uniform(), contrast=uniform(lo=cfg.contrast_lower, hi=cfg.contrast_upper),
        saturation_u=uniform(),
        saturation=uniform(lo=cfg.saturation_lower, hi=cfg.saturation_upper),
        hue_u=uniform(), hue_delta=randint(-cfg.hue_delta, cfg.hue_delta + 1),
        order_u=uniform(), reorder_u=uniform(), perm=randint(0, len(PERMS)),
        expand_u=uniform(), expand_ratio=uniform(lo=1.0, hi=cfg.expand_max_ratio),
        expand_offset=uniform(2),
        sampler_scale=uniform(s, t, lo=cfg.sampler_min_scale, hi=cfg.sampler_max_scale),
        sampler_ar=uniform(s, t, lo=cfg.sampler_min_ar, hi=cfg.sampler_max_ar),
        sampler_cx=uniform(s, t), sampler_cy=uniform(s, t), pick_u=uniform(s + 1),
        flip_u=uniform())


# ---------------------------------------------------------------------------
# Color: OpenCV-convention HSV (H in [0, 180), S and V in [0, 255]) on BGR
# ---------------------------------------------------------------------------


def bgr_to_hsv(img):
    """``(..., 3)`` BGR float in [0, 255] -> ``(..., 3)`` HSV, OpenCV ranges."""
    b, g, r = img[..., 0], img[..., 1], img[..., 2]
    v = torch.maximum(torch.maximum(r, g), b)
    mn = torch.minimum(torch.minimum(r, g), b)
    delta = v - mn
    safe_delta = torch.where(delta > 0, delta, 1.0)
    h = torch.where(v == r, 60.0 * (g - b) / safe_delta,
                    torch.where(v == g, 120.0 + 60.0 * (b - r) / safe_delta,
                                240.0 + 60.0 * (r - g) / safe_delta))
    h = torch.where(delta > 0, h, 0.0)
    h = torch.where(h < 0, h + 360.0, h) * 0.5
    s = torch.where(v > 0, 255.0 * delta / torch.where(v > 0, v, 1.0), 0.0)
    return torch.stack([h, s, v], dim=-1)


def hsv_to_bgr(hsv):
    """Inverse of :func:`bgr_to_hsv` (OpenCV ranges)."""
    h, s, v = hsv[..., 0] * 2.0, hsv[..., 1], hsv[..., 2]
    c = true_div(v * s, 255.0)
    hp = true_div(h, 60.0)
    x = c * (1.0 - (torch.remainder(hp, 2.0) - 1.0).abs())
    m = v - c
    z = torch.zeros_like(c)
    sector = (torch.floor(hp).to(torch.int64) % 6).unsqueeze(-1)

    def pick(*values):
        return torch.gather(torch.stack(values, dim=-1), -1, sector)[..., 0] + m

    return torch.stack([pick(z, z, x, c, c, x), pick(x, c, c, x, z, z), pick(c, x, z, z, x, c)],
                       dim=-1)


def _photometric(draws: Draws, img, cfg: AugmentConfig):
    """Brightness, contrast / saturation / hue in either order, and the
    channel reorder on a float ``(B, H, W, 3)`` batch."""
    def per_image(t, dims=3):
        return t.reshape(-1, *(1,) * dims)

    delta_b = torch.where(draws.brightness_u < cfg.brightness_prob,
                          draws.brightness_delta.to(img.dtype), 0.0)
    img = torch.clamp(img + per_image(delta_b), 0.0, 255.0)
    fac_c = per_image(torch.where(draws.contrast_u < cfg.contrast_prob, draws.contrast, 1.0))
    fac_s = per_image(torch.where(draws.saturation_u < cfg.saturation_prob, draws.saturation,
                                  1.0), 2)
    delta_h = per_image(torch.where(draws.hue_u < cfg.hue_prob,
                                    draws.hue_delta.to(img.dtype), 0.0), 2)

    def contrast(x):
        return torch.clamp(x * fac_c, 0.0, 255.0)

    def hsv_pass(x):
        hsv = bgr_to_hsv(x)
        h = hsv[..., 0] + delta_h
        h = torch.where(h >= 180.0, h - 180.0, torch.where(h < 0, h + 180.0, h))
        s = torch.clamp(hsv[..., 1] * fac_s, 0.0, 255.0)
        return hsv_to_bgr(torch.stack([h, s, hsv[..., 2]], dim=-1))

    # contrast before the HSV pair for some images, after it for the others:
    # one HSV pass over the batch, the contrast selected in on either side
    first = per_image(draws.order_u < 0.5)
    out = hsv_pass(torch.where(first, contrast(img), img))
    img = torch.clamp(torch.where(first, out, contrast(out)), 0.0, 255.0)

    perms = torch.tensor(PERMS, device=img.device)[draws.perm]
    perms = torch.where((draws.reorder_u < cfg.reorder_prob)[:, None], perms,
                        torch.arange(3, device=img.device))
    return torch.gather(img, -1, perms[:, None, None, :].expand_as(img))


# ---------------------------------------------------------------------------
# Geometry: expand + crop sampler -> one source window
# ---------------------------------------------------------------------------


def _corner_iou(a, b):
    """Continuous IoU of ``[x0, y0, x1, y1]`` boxes: ``(..., T, 4)`` against
    ``(..., G, 4)`` -> ``(..., T, G)``."""
    x0 = torch.maximum(a[..., :, None, 0], b[..., None, :, 0])
    y0 = torch.maximum(a[..., :, None, 1], b[..., None, :, 1])
    x1 = torch.minimum(a[..., :, None, 2], b[..., None, :, 2])
    y1 = torch.minimum(a[..., :, None, 3], b[..., None, :, 3])
    inter = (x1 - x0).clamp_min(0) * (y1 - y0).clamp_min(0)
    area_a = (a[..., 2] - a[..., 0]) * (a[..., 3] - a[..., 1])
    area_b = (b[..., 2] - b[..., 0]) * (b[..., 3] - b[..., 1])
    union = area_a[..., :, None] + area_b[..., None, :] - inter
    return inter / torch.where(union > 0, union, 1.0)


def _sampler_windows(draws: Draws, boxes_c, mask, cfg: AugmentConfig):
    """Every min-IoU sampler over its trials, on gt boxes ``(B, G, 4)`` in
    canvas-normalized corner form -> ``(ok (B, S), windows (B, S, 4))``:
    the first passing trial of each sampler."""
    scale = draws.sampler_scale
    s2 = scale * scale
    ar = torch.clamp(draws.sampler_ar, s2, torch.reciprocal(s2))  # both extents <= 1
    w = scale * torch.sqrt(ar)
    h = scale / torch.sqrt(ar)
    cx = 0.5 * w + draws.sampler_cx * (1.0 - w).clamp_min(0.0)
    cy = 0.5 * h + draws.sampler_cy * (1.0 - h).clamp_min(0.0)
    trials = torch.stack([cx - w / 2, cy - h / 2, cx + w / 2, cy + h / 2], dim=-1)
    b, s, t, _ = trials.shape
    iou = _corner_iou(trials.reshape(b, s * t, 4), boxes_c).reshape(b, s, t, boxes_c.shape[1])
    best = torch.where(mask[:, None, None, :], iou, -1.0).amax(dim=-1)
    overlaps = torch.tensor(cfg.sampler_overlaps, dtype=torch.float32, device=best.device)
    ok_t = (best > 0.0) & (best >= overlaps[:, None])
    first = torch.argmax(ok_t.to(torch.int32), dim=2)  # the first passing trial
    ok = ok_t.any(dim=2) & mask.any(dim=1)[:, None]
    windows = torch.gather(trials, 2, first[:, :, None, None].expand(b, s, 1, 4))[:, :, 0]
    return ok, windows


def sample_geometry(draws: Draws, boxes, mask, cfg: AugmentConfig):
    """Expand, the sampler pick and the flip of a batch -> ``(window (B, 4),
    flip (B,), pick (B,))``. ``boxes`` ``(B, G, 4)`` are centre-form
    normalized; the window is ``[x0, y0, x1, y1]`` in image-normalized
    coordinates and may extend outside [0, 1] (the expand canvas); ``pick``
    is the chosen sampler, 0 for the identity."""
    ratio = torch.where(draws.expand_u < cfg.expand_prob, draws.expand_ratio, 1.0)
    off = draws.expand_offset * (ratio - 1.0)[:, None]
    ox, oy, r = off[:, 0:1], off[:, 1:2], ratio[:, None]
    cx = (boxes[..., 0] + ox) / r
    cy = (boxes[..., 1] + oy) / r
    w2 = boxes[..., 2] / (2.0 * r)
    h2 = boxes[..., 3] / (2.0 * r)
    boxes_c = torch.stack([cx - w2, cy - h2, cx + w2, cy + h2], dim=-1)

    ok, windows = _sampler_windows(draws, boxes_c, mask, cfg)
    b = ok.shape[0]
    identity = torch.tensor([0.0, 0.0, 1.0, 1.0], device=boxes.device)
    ok = torch.cat([torch.ones((b, 1), dtype=torch.bool, device=ok.device), ok], dim=1)
    windows = torch.cat([identity.expand(b, 1, 4), windows], dim=1)
    pick = torch.argmax(torch.where(ok, draws.pick_u, -1.0), dim=1)
    win_c = windows[torch.arange(b, device=pick.device), pick]
    window = torch.stack([win_c[:, 0] * ratio - off[:, 0], win_c[:, 1] * ratio - off[:, 1],
                          win_c[:, 2] * ratio - off[:, 0], win_c[:, 3] * ratio - off[:, 1]],
                         dim=-1)
    return window, draws.flip_u < cfg.flip_prob, pick


def remap_boxes(boxes, mask, window, flip):
    """Centre-form boxes ``(..., G, 4)`` into each image's window
    ``(..., 4)``: boxes whose centre leaves it are dropped, flipped images
    mirror the centre. Returns ``(boxes, mask)`` of the same shapes."""
    wx0, wy0, wx1, wy1 = (window[..., i, None] for i in range(4))
    ww, wh = wx1 - wx0, wy1 - wy0
    cx = (boxes[..., 0] - wx0) / ww
    cy = (boxes[..., 1] - wy0) / wh
    w = boxes[..., 2] / ww
    h = boxes[..., 3] / wh
    keep = mask & (cx >= 0) & (cx < 1) & (cy >= 0) & (cy < 1)
    cx = torch.where(flip[..., None], 1.0 - cx, cx)
    out = torch.stack([cx, cy, w, h], dim=-1)
    return torch.where(keep[..., None], out, 0.0), keep


def resample_window(img, window, flip, out_h: int, out_w: int, mean):
    """Resample each image's source window of the float ``(B, H, W, 3)``
    batch to ``(B, out_h, out_w, 3)`` with bilinear weights: two
    interpolation products (height, then width) in full float32;
    interpolation mass outside the image takes the ``mean`` colour (the
    expand canvas)."""
    b, h_in, w_in, _ = img.shape

    def interp_matrix(n_out, n_in, lo, hi):
        o = true_div(torch.arange(n_out, dtype=torch.float32, device=img.device) + 0.5,
                     float(n_out))
        src = (lo[:, None] + o * (hi - lo)[:, None]) * n_in - 0.5
        i = torch.arange(n_in, dtype=torch.float32, device=img.device)
        return (1.0 - (src[:, :, None] - i).abs()).clamp_min(0.0)

    ry = interp_matrix(out_h, h_in, window[:, 1], window[:, 3])  # (B, out_h, H)
    rx = interp_matrix(out_w, w_in, window[:, 0], window[:, 2])  # (B, out_w, W)
    with full_float32_matmul():
        tmp = torch.bmm(ry, img.reshape(b, h_in, w_in * 3)).reshape(b, out_h, w_in, 3)
        out = torch.einsum("bpw,bowc->bopc", rx, tmp)
    coverage = (ry.sum(dim=2)[:, :, None] * rx.sum(dim=2)[:, None, :]).clamp(0.0, 1.0)
    out = out + (1.0 - coverage)[..., None] * torch.tensor(mean, dtype=img.dtype,
                                                           device=img.device)
    return torch.where(flip[:, None, None, None], out.flip(2), out)


# ---------------------------------------------------------------------------
# The whole chain
# ---------------------------------------------------------------------------


def augment_geometry(draws: Draws, batch, anchors, cfg: AugmentConfig):
    """The chain's geometry of a batch -> ``(window (B, 4), flip (B,),
    gt_boxes, gt_mask, has_pos (B,))``. With ``cfg.ensure_positive`` an
    image whose augmented boxes match no anchor at IoU > match_threshold
    (``ops/iou.canvas_iou`` against all ``anchors``, batched) falls back to
    the identity window, no flip, and its own boxes; ``has_pos`` is False
    for those."""
    boxes, mask = batch["gt_boxes"].float(), batch["gt_mask"].bool()
    window, flip, _ = sample_geometry(draws, boxes, mask, cfg)
    new_boxes, new_mask = remap_boxes(boxes, mask, window, flip)
    has_pos = torch.ones_like(flip)
    if cfg.ensure_positive:
        iou = torch.where(new_mask[..., None], canvas_iou(new_boxes, anchors), -1.0)
        has_pos = (iou > cfg.match_threshold).flatten(1).any(dim=1)
        identity = torch.tensor([0.0, 0.0, 1.0, 1.0], device=window.device)
        window = torch.where(has_pos[:, None], window, identity)
        flip = flip & has_pos
        id_boxes = torch.where(mask[..., None], boxes, 0.0)
        new_boxes = torch.where(has_pos[:, None, None], new_boxes, id_boxes)
        new_mask = torch.where(has_pos[:, None], new_mask, mask)
    return window, flip, new_boxes, new_mask, has_pos


def apply_augment(draws: Draws, batch, anchors, cfg: AugmentConfig):
    """The whole chain on a batch dict (``images`` uint8 ``(B, H, W, 3)``,
    ``gt_boxes (B, G, 4)``, ``gt_labels (B, G)``, ``gt_mask (B, G)``, all on
    one device) with the given draws -> the augmented batch dict: images
    uint8 ``(B, out_h, out_w, 3)``, float32 boxes, the labels, the new mask."""
    images = batch["images"]
    draws = draws.to(images.device)
    anchors = torch.as_tensor(anchors, dtype=torch.float32).to(images.device)
    img = _photometric(draws, images.float(), cfg)
    window, flip, boxes, mask, _ = augment_geometry(draws, batch, anchors, cfg)
    out = resample_window(img, window, flip, cfg.out_h, cfg.out_w, cfg.mean_bgr)
    return {"images": torch.clamp(torch.round(out), 0, 255).to(torch.uint8),
            "gt_boxes": boxes, "gt_labels": batch["gt_labels"], "gt_mask": mask}


def draws_rows(draws: Draws, rows: slice) -> Draws:
    """The draws of ``rows`` of a batch."""
    return Draws(**{f.name: getattr(draws, f.name)[rows] for f in dataclasses.fields(draws)})


def step_generator(seed: int, epoch: int, batch_i: int, device) -> torch.Generator:
    """The generator of one training step's augmentation on ``device``,
    seeded from ``(seed, epoch, batch_i)`` alone: every rank of a data
    parallel run builds the same one."""
    state = np.random.SeedSequence([seed, epoch, batch_i]).generate_state(1, np.uint64)[0]
    return torch.Generator(device).manual_seed(int(state) >> 1)


def make_augment_fn(cfg: AugmentConfig, anchors, rank: int = 0, world: int = 1):
    """The batch augmentation ``(generator, batch) -> batch``: the draws of
    the global batch (``world`` times the batch's rows) from ``generator``
    (:func:`draw_augment`, made on the generator's device and moved to the
    batch's), then :func:`apply_augment` of this ``rank``'s rows of them.
    Every rank draws the same values, so an image's augmentation does not
    depend on the world size. Tensors stay on their device; numpy arrays
    are taken to the generator's."""
    anchors = torch.as_tensor(np.asarray(anchors, dtype=np.float32))
    cache = {}

    def fn(generator: torch.Generator, batch):
        batch = {k: v if torch.is_tensor(v) else torch.from_numpy(np.asarray(v)).to(
            generator.device) for k, v in batch.items()}
        device = batch["images"].device
        if device not in cache:
            cache[device] = anchors.to(device)
        b = batch["images"].shape[0]
        draws = draw_augment(generator, b * world, cfg)
        if world > 1:
            draws = draws_rows(draws, slice(rank * b, (rank + 1) * b))
        return apply_augment(draws, batch, cache[device], cfg)

    return fn
