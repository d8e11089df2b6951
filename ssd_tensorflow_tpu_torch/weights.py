"""Parameter conversion between the JAX package's layout and the port's.

The JAX package holds ``{layer: {"w": HWIO, "b": (cout,)}}`` (plus the
conv4_3 L2-norm ``scale``), as ``init_params`` or ``load_bundle`` yield
it. The port holds the same dict with OIHW filters as float32 tensors.
"""

from __future__ import annotations

import numpy as np
import torch


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
