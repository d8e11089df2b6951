"""Parameter conversion between the JAX package's layout and the port's.

The JAX package holds ``{layer: {"w": HWIO, "b": (cout,)}}`` (plus the
conv4_3 L2-norm ``scale``), as ``init_params`` or ``load_bundle`` yield
it. The port holds the same dict with OIHW filters as float32 tensors.

The port's float parameters of the ResNet-34 and MobileNetV1 families hold
GroupNorm ``{"scale", "bias"}`` leaves as they are, and depthwise filters,
HWIO ``(3, 3, 1, C)`` in the JAX package, as OIHW ``(C, 1, 3, 3)``: the
same transpose as every filter.

The int8 deploy path's q-params, ``{layer: {"wq": HWIO int8, "w_scale":
(cout,), "b": (cout,)}}`` (a family conv adds its folded ``"a_scale":
(cin,)``) plus the float leaves (the L2-norm ``scale``, the GroupNorms),
keep the JAX package's layout in both packages (``wq`` int8, the rest
float32); :func:`stage_qparams` lays them out for the forward on a
device.
"""

from __future__ import annotations

import numpy as np
import torch

from ssd_tensorflow_tpu_torch.ops.int8_conv import stage_int8_weight


def params_from_jax(tree) -> dict:
    """JAX-layout parameter dict (numpy or array-likes) -> port parameters."""
    out = {}
    for name, leaves in tree.items():
        out[name] = {}
        for key, value in leaves.items():
            a = np.asarray(value, dtype=np.float32)
            if a.ndim == 4:
                a = a.transpose(3, 2, 0, 1)  # HWIO -> OIHW
            out[name][key] = torch.tensor(np.ascontiguousarray(a))
    return out


def params_to_jax(params) -> dict:
    """Port parameters -> the JAX-layout dict of float32 numpy arrays."""
    out = {}
    for name, leaves in params.items():
        out[name] = {}
        for key, value in leaves.items():
            a = value.detach().float().cpu().numpy()
            if a.ndim == 4:
                a = a.transpose(2, 3, 1, 0)  # OIHW -> HWIO
            out[name][key] = np.ascontiguousarray(a)
    return out


def qparams_from_jax(tree) -> dict:
    """JAX-layout int8 q-param dict (numpy or array-likes) -> the port's:
    ``wq`` stays HWIO int8, every other leaf becomes float32."""
    out = {}
    for name, leaves in tree.items():
        out[name] = {}
        for key, value in leaves.items():
            a = np.asarray(value)
            if key == "wq":
                if a.dtype != np.int8:
                    raise ValueError(f"{name}/wq must be int8, got {a.dtype}")
            else:
                a = a.astype(np.float32)
            out[name][key] = torch.from_numpy(np.ascontiguousarray(a))
    return out


def qparams_to_jax(qparams) -> dict:
    """The port's q-params -> the JAX-layout dict of numpy arrays (``wq``
    int8, the rest float32)."""
    out = {}
    for name, leaves in qparams.items():
        out[name] = {}
        for key, value in leaves.items():
            a = value.detach().cpu().numpy()
            out[name][key] = np.ascontiguousarray(a if key == "wq" else a.astype(np.float32))
    return out


def stage_qparams(qparams, act_scales: dict, device) -> dict:
    """The q-params and activation scales laid out once for the int8
    forward (``models/quantized.py``) on ``device``. A VGG conv becomes
    ``{"w": ops.int8_conv.Int8Weight, "mult": float32(act_scale) * w_scale
    (computed in float32), "b": float32, "inv": (1,) float32 1 / act_scale
    (computed in double, rounded once)}``; a family conv, whose ``a_scale``
    is folded into its weights, ``"mult": w_scale`` and ``"inv": (cin,)
    float32 1 / a_scale`` (a float32 division, as the JAX package's); a
    weight-only depthwise conv (``*_dw``) ``{"w": bf16(float32(wq) *
    w_scale)`` OIHW, ``"b": bf16(b)}``. Other leaves move as they are."""
    staged = {}
    for name, leaves in qparams.items():
        if "wq" not in leaves:
            staged[name] = {k: v.to(device) for k, v in leaves.items()}
            continue
        w_scale = leaves["w_scale"].float()
        if name.endswith("_dw"):
            w = leaves["wq"].float() * w_scale
            staged[name] = {"w": w.to(torch.bfloat16).permute(3, 2, 0, 1).contiguous().to(device),
                            "b": leaves["b"].to(torch.bfloat16).to(device)}
            continue
        if "a_scale" in leaves:
            a_scale = leaves["a_scale"].float()
            mult, inv = w_scale, torch.ones_like(a_scale) / a_scale
        else:
            scale = float(act_scales[name])
            mult = torch.tensor(scale, dtype=torch.float32) * w_scale
            inv = torch.tensor([1.0 / scale], dtype=torch.float32)
        staged[name] = {
            "w": stage_int8_weight(leaves["wq"]).to(device),
            "mult": mult.to(device),
            "b": leaves["b"].float().to(device),
            "inv": inv.to(device),
        }
    return staged
