"""Inputs made from ``--seed``: images as flips, crops and brightness
jitter of the 8 miniVOC test images in ``data/``, and ground-truth boxes.
The same seed gives the same inputs on one kind of device; every seed
gives the same sizes."""

from __future__ import annotations

import numpy as np
import torch
import torch.nn.functional as F

from benchlib.registry import BENCH_DIR

BASE_IMAGES = BENCH_DIR / "data" / "minivoc_test8.npz"


def generator(seed: int, device) -> torch.Generator:
    return torch.Generator(device=device).manual_seed(int(seed) % (1 << 63))


def images(n: int, size, augment: dict, seed: int, device, chunk: int = 32) -> torch.Tensor:
    """``(n, H, W, 3)`` uint8 BGR images on ``device``: each a square crop
    (side a ``crop_scale`` share of the base image, placed at random), flipped
    left-right with probability ``flip``, resized bilinearly to ``size``
    ``(W, H)`` and brightened by an integer in ``[-brightness, brightness]``."""
    with np.load(BASE_IMAGES) as d:
        base = torch.from_numpy(d["images"]).to(device)
    g = generator(seed, device)
    lo, hi = augment["crop_scale"]
    pick = torch.randint(0, base.shape[0], (n,), generator=g, device=device)
    scale = lo + (hi - lo) * torch.rand(n, generator=g, device=device)
    cx = (torch.rand(n, generator=g, device=device) * 2 - 1) * (1 - scale)
    cy = (torch.rand(n, generator=g, device=device) * 2 - 1) * (1 - scale)
    flip = torch.where(torch.rand(n, generator=g, device=device) < augment["flip"], -1.0, 1.0)
    bright = torch.randint(-augment["brightness"], augment["brightness"] + 1, (n,),
                           generator=g, device=device).float()
    w, h = size
    out = torch.empty((n, h, w, 3), dtype=torch.uint8, device=device)
    for s in range(0, n, chunk):
        e = min(n, s + chunk)
        theta = torch.zeros((e - s, 2, 3), device=device)
        theta[:, 0, 0] = scale[s:e] * flip[s:e]
        theta[:, 1, 1] = scale[s:e]
        theta[:, 0, 2] = cx[s:e]
        theta[:, 1, 2] = cy[s:e]
        src = base[pick[s:e]].permute(0, 3, 1, 2).float()
        grid = F.affine_grid(theta, (e - s, 3, h, w), align_corners=False)
        y = F.grid_sample(src, grid, mode="bilinear", padding_mode="border", align_corners=False)
        y = y + bright[s:e].view(-1, 1, 1, 1)
        out[s:e] = torch.round(y).clamp_(0, 255).to(torch.uint8).permute(0, 2, 3, 1)
    return out


def gt_boxes(n: int, per_image, size_range, num_classes: int, seed: int, max_gt: int = 8):
    """Host numpy ``(gt_boxes (n, G, 4) center form, gt_labels (n, G)
    int32, gt_mask (n, G) bool)``: ``per_image`` ``[lo, hi]`` boxes an
    image, sides uniform in ``size_range``, centres keeping the box inside."""
    rng = np.random.default_rng(int(seed) % (1 << 63))
    g = max(max_gt, per_image[1])
    count = rng.integers(per_image[0], per_image[1] + 1, size=n)
    wh = rng.uniform(size_range[0], size_range[1], size=(n, g, 2))
    c = wh / 2 + rng.uniform(0, 1, size=(n, g, 2)) * (1 - wh)
    boxes = np.concatenate([c, wh], axis=-1).astype(np.float32)
    labels = rng.integers(0, num_classes, size=(n, g)).astype(np.int32)
    mask = np.arange(g)[None, :] < count[:, None]
    return boxes, labels, mask
