"""JAX's QAT activation grids handed to the port's quantizers, shared by
``tests/test_torch_qat.py`` and ``tests/test_torch_qat_finetune.py``.

Left to its own roundings the port's fake-quant forward drifts from JAX's:
a float32 conv sums in another order in each library, and an input one ulp
across a half step rounds to the next integer (ROADMAP.md section 3). With
JAX's grids handed in, every other step of the two forwards agrees to
float32 rounding."""

from functools import partial

import jax
import jax.numpy as jnp
import numpy as np
import torch


class Grids:
    """JAX's activation grids, recorded from inside its jitted programs (each
    quantizer's grid of every run, in run order) and handed to the port's
    quantizers in the same order: the port's ``c``-th call takes quantizer
    ``c mod n`` of JAX's ``c div n``-th run, ``n`` quantizers a forward. The
    port's own grid of each quantizer input is kept, to count the roundings
    that differ."""

    def __init__(self):
        self.jax, self.port, self.calls = {}, [], 0

    def recording(self, real):
        """JAX's ``fake_quant_act``, reporting its grid to the host."""
        traced = iter(range(10 ** 6))

        def fq(x, scale):
            grid = jnp.clip(jnp.round(x / scale), -127, 127)
            jax.debug.callback(partial(self._record, next(traced)), grid)
            return real(x, scale)
        return fq

    def _record(self, quantizer, grid):
        self.jax.setdefault(quantizer, []).append(np.asarray(grid))

    def _grid(self, call):
        n = len(self.jax)
        return self.jax[call % n][call // n]

    def forced(self):
        """The port's ``fake_quant_act`` with JAX's grid in place of its own
        rounding (the clipped STE from the port's input)."""
        def fq(x, scale):
            s = scale if torch.is_tensor(scale) else torch.tensor(scale, dtype=torch.float32)
            self.port.append(torch.clamp(torch.round(x.detach() / s), -127, 127).numpy())
            grid = torch.tensor(np.asarray(self._grid(self.calls), np.float32))
            self.calls += 1
            in_range = (x.abs() <= 127.5 * scale).to(x.dtype)
            return (grid * scale).detach() + in_range * (x - x.detach())
        return fq

    def differing(self):
        """``(roundings the port would take otherwise, all roundings)``."""
        assert self.calls == sum(len(g) for g in self.jax.values()) > 0
        grids = [self._grid(c) for c in range(self.calls)]
        return (sum(int((a != b).sum()) for a, b in zip(grids, self.port)),
                sum(g.size for g in grids))
