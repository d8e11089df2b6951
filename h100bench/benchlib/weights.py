"""Float parameters of the SSD VGG model made on the device from
``--seed``: one uniform draw for every leaf, in the float32 type the
program takes and stages itself. Filters are Xavier-uniform over
``(k*k*cin + k*k*cout)`` as the program's ``init_params`` (each multibox
head shape counted as its own ``K+5``-wide conv); biases uniform in
``+-bias_range``; the conv4_3 L2-norm scale constant."""

from __future__ import annotations

import math

import torch

from benchlib.pool import generator
from reference import ssd_ref


def seeded_params(cfg: dict, seed: int, device) -> dict:
    """``{layer: {"w": OIHW float32, "b": float32}, "l2_norm_conv4_3":
    {"scale"}}`` on ``device``."""
    k = cfg["model"]["num_classes"]
    spec = cfg["weights"]
    layers = ssd_ref.conv_layers(cfg["preset"], k)
    sizes = [cout * cin * kk * kk + cout for _, kk, cin, cout, *_ in layers]
    u = torch.rand(sum(sizes), generator=generator(seed, device), device=device) * 2 - 1
    params, off = {}, 0
    for (name, kk, cin, cout, *_), n in zip(layers, sizes):
        fan_out = (k + 5) if name.startswith("classifier") else cout
        limit = math.sqrt(6.0 / (kk * kk * cin + kk * kk * fan_out))
        nw = cout * cin * kk * kk
        params[name] = {"w": (u[off:off + nw] * limit).view(cout, cin, kk, kk),
                        "b": u[off + nw:off + n] * spec["bias_range"]}
        off += n
    params["l2_norm_conv4_3"] = {"scale": torch.full((512,), float(spec["l2_norm_scale"]),
                                                     device=device)}
    return params
