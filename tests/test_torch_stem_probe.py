"""The stem probes' plain versions (``ops/stem_probe.py``) against the JAX
tools they replace, on the CPU.

``tools/stem_kernel_probe.py`` and ``tools/stem_uint8_probe.py`` are
loaded by path, unedited. The kernel probe's module globals ``B, T, wp``
are set to a small shape and ``pl.pallas_call`` is patched in that
module's namespace to pass ``interpret=True``, so each variant runs the
tool's own ``make_call`` and kernel body in Pallas interpret mode.

Tolerances: ``copy`` is exact. Every other variant sums exact bf16
products in float32 in another order than the plain version and rounds
to bf16, so an output may sit one bf16 step (2^-7 of the largest output)
apart, no more. The lane sum likewise: ``jnp.sum`` may add the six
float32 terms in another order than the in-order plain version.
"""

import importlib.util
import sys
from pathlib import Path
from unittest import mock

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.experimental import pallas as pl

from ssd_tensorflow_tpu_torch.ops import stem_probe

ROOT = Path(__file__).resolve().parent.parent
SHAPE = (2, 2, 16)  # B, T, WP

#: variant of the port -> (kernel body of the tool, its n_taps)
TOOL_KERNELS = {
    "copy": ("k_copy", 0),
    "conv1_1": ("k_conv11", 0),
    "conv1_1_store": ("k_conv11_store", 0),
    "taps1": ("k_taps", 1),
    "taps3": ("k_taps", 3),
    "taps9": ("k_taps", 9),
    "taps9_aligned": ("k_taps_aligned", 9),
}


def _load_tool(name):
    spec = importlib.util.spec_from_file_location(f"_probe_tool_{name}", ROOT / "tools" / f"{name}.py")
    module = importlib.util.module_from_spec(spec)
    path = list(sys.path)
    try:
        spec.loader.exec_module(module)
    finally:
        sys.path[:] = path  # the tools put the repository root on sys.path
    return module


def _interpreted(fn):
    def call(*args, **kwargs):
        kwargs["interpret"] = True
        return fn(*args, **kwargs)
    return call


@pytest.fixture(scope="module")
def kernel_probe():
    tool = _load_tool("stem_kernel_probe")
    tool.B, tool.T, tool.wp = SHAPE
    return tool


def _inputs(seed):
    b, t, wp = SHAPE
    rng = np.random.default_rng(seed)
    bf16 = lambda a: torch.from_numpy(a.astype(np.float32)).to(torch.bfloat16)
    return (bf16(rng.standard_normal((b, t, 34, wp, 64))), bf16(rng.standard_normal((64, 128))),
            bf16(rng.standard_normal((3, 3, 128, 128))))


def _to_jax(x):
    return jnp.asarray(x.float().numpy(), jnp.bfloat16)


def _to_numpy(x):
    return np.asarray(jnp.asarray(x, jnp.float32))


def test_variants_cover_the_tool():
    assert list(TOOL_KERNELS) == list(stem_probe.PROBE_VARIANTS)
    assert [n for _, n in TOOL_KERNELS.values()] == [n for _, n in stem_probe.PROBE_VARIANTS.values()]


@pytest.mark.parametrize("variant", list(TOOL_KERNELS))
def test_plain_matches_tool_kernel(kernel_probe, variant):
    body, n_taps = TOOL_KERNELS[variant]
    a1, w1, w2 = _inputs(len(variant) + n_taps)
    with mock.patch.object(kernel_probe.pl, "pallas_call", _interpreted(pl.pallas_call)):
        want = kernel_probe.make_call(getattr(kernel_probe, body), n_taps)(
            _to_jax(a1), _to_jax(w1), _to_jax(w2))
    want = _to_numpy(want)
    got = stem_probe.stem_probe(a1, w1, w2, variant)  # CPU tensors: the plain version
    assert got.dtype == torch.bfloat16 and tuple(got.shape) == want.shape == (*SHAPE[:2], 16, SHAPE[2], 64)
    got = got.float().numpy()
    if variant == "copy":
        np.testing.assert_array_equal(got, want)
        return
    if variant == "taps9_aligned":
        # The tool's kernel never writes scratch column 0 in this variant, and
        # the dx = 0 taps read it into packed output column 0: undefined there
        # (the port reads its zero border), so that column is left out.
        got, want = got[..., 1:, :], want[..., 1:, :]
    assert np.isfinite(want).all() and np.abs(want).max() > 0
    np.testing.assert_allclose(got, want, rtol=0, atol=float(np.abs(want).max()) * 2.0 ** -7)
    # one step is the worst case, not the rule
    assert (got == want).mean() > 0.98


def _lane_sum_kernel(x_ref, o_ref, rows, n):
    # probe_reshape()'s kernel body at another shape
    o_ref[...] = jnp.sum(x_ref[...].reshape(rows, n, 6), axis=2)


def test_lane_sum_matches_probe_reshape():
    """The tool's own call (ones -> 6), in interpret mode."""
    tool = _load_tool("stem_uint8_probe")
    with mock.patch.object(tool.pl, "pallas_call", _interpreted(pl.pallas_call)):
        assert tool.probe_reshape() == "ok"
    ones = torch.ones((36, 1536), dtype=torch.bfloat16)
    got = stem_probe.lane_unflatten_sum(ones)
    assert got.shape == (36, 256) and got.dtype == torch.bfloat16
    assert (got.float() == 6.0).all()


@pytest.mark.parametrize("rows,n", [(36, 256), (5, 24)])
def test_lane_sum_matches_jax(rows, n):
    rng = np.random.default_rng(rows)
    x = torch.from_numpy(rng.standard_normal((rows, 6 * n)).astype(np.float32)).to(torch.bfloat16)
    got = stem_probe.lane_unflatten_sum(x).float().numpy()
    xj = _to_jax(x)
    want = _to_numpy(jnp.sum(xj.reshape(rows, n, 6), axis=2))
    kernel = _to_numpy(pl.pallas_call(
        lambda x_ref, o_ref: _lane_sum_kernel(x_ref, o_ref, rows, n),
        out_shape=jax.ShapeDtypeStruct((rows, n), jnp.bfloat16), interpret=True)(xj))
    tol = float(np.abs(want).max()) * 2.0 ** -7
    np.testing.assert_allclose(got, want, rtol=0, atol=tol)
    np.testing.assert_allclose(got, kernel, rtol=0, atol=tol)


def _unswizzled(slots):
    """Undo the 128-byte swizzle: chunk c of row r is stored at c ^ (r & 7)."""
    row, chunk = torch.arange(128)[:, None], torch.arange(8)[None, :]
    return slots.reshape(-1, 128, 8, 8)[:, row, chunk ^ (row & 7)].reshape(-1, 128, 64)


@pytest.mark.parametrize("views", ["contiguous", "transposed", "strided"])
def test_weight_slots_layout(views):
    """The kernel's weight stream: slot 0 is w1 as [cout][cin], slot
    1 + 2 tap + h the K half h of tap (dy, dx) as [cout][cin], each row's
    16-byte chunks swizzled; the same bytes whatever views come in."""
    rng = np.random.default_rng(11)
    w1 = torch.from_numpy(rng.standard_normal((64, 128)).astype(np.float32)).to(torch.bfloat16)
    w2 = torch.from_numpy(rng.standard_normal((3, 3, 128, 128)).astype(np.float32)).to(torch.bfloat16)
    want = stem_probe.probe_weight_slots(w1, w2)
    if views == "transposed":  # the same values behind non-contiguous views
        w1 = w1.t().contiguous().t()
        w2 = w2.permute(0, 1, 3, 2).contiguous().permute(0, 1, 3, 2)
        assert not w1.is_contiguous() and not w2.is_contiguous()
    elif views == "strided":
        w1 = torch.stack([w1, w1], dim=-1)[..., 0]
        w2 = torch.stack([w2, w2], dim=2)[:, :, 1]
        assert not w1.is_contiguous() and not w2.is_contiguous()
    got = stem_probe.probe_weight_slots(w1, w2)
    assert got.shape == (stem_probe.WEIGHT_SLOTS, 128, 64) and got.dtype == torch.bfloat16
    assert got.is_contiguous() and torch.equal(got, want)
    plain = _unswizzled(got)
    assert torch.equal(plain[0], w1.t())
    for dy in range(3):
        for dx in range(3):
            for h in range(2):
                assert torch.equal(plain[1 + 2 * (3 * dy + dx) + h],
                                   w2[dy, dx].t()[:, 64 * h:64 * h + 64])
    # a row's chunks stay in the row, and row 0 of every slot is not moved
    assert torch.equal(got[:, 0], plain[:, 0])
    assert torch.equal(got[:, 9].reshape(-1, 8, 8)[:, 1], plain[:, 9].reshape(-1, 8, 8)[:, 0])
