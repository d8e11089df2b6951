"""The families' GroupNorm routes on the CPU (``models/resnet.group_norm``,
``norm_act``; ``ops/group_norm_cuda``): the route rule, the plain route's
bits, the wrapper's argument checks, and the walks against the
composition they had before GroupNorm and its activation were one call.
The kernel itself is held to these bits on the card
(``tests/test_torch_cuda.py::test_group_norm_card_matches_cpu``)."""

from unittest import mock

import numpy as np
import pytest
import torch

from ssd_tensorflow_tpu_torch.models import layers, mobilenet, resnet, ssd_vgg
from ssd_tensorflow_tpu_torch.ops import _build, group_norm_cuda as gnc

#: GroupNorm inputs of the family tests' shapes: test_torch_resnet.py's
#: (g = 32 and g = 1) and the mntest64 walk's widths of 32 to 1024
SHAPES = [(2, 9, 7, 64), (2, 9, 7, 3), (1, 4, 4, 64), (2, 32, 32, 32), (2, 16, 16, 128),
          (2, 2, 2, 1024)]
#: the epilogues: (act, skip form)
FORMS = [(None, None), ("relu", None), ("relu6", None), ("relu", "same"), ("relu", "strided")]


def _inputs(shape, dtype, seed):
    g = torch.Generator().manual_seed(seed)
    x = (3 * torch.randn(shape, generator=g) + 0.5).to(dtype)
    c = shape[-1]
    gn = {"scale": torch.randn(c, generator=g), "bias": torch.randn(c, generator=g)}
    return x, gn, g


def _skip(form, shape, dtype, g):
    if form is None:
        return None
    b, h, w, c = shape
    if form == "same":
        return (2 * torch.randn(shape, generator=g)).to(dtype)
    return (2 * torch.randn((b, 2 * h, 2 * w, c), generator=g)).to(dtype)[:, ::2, ::2, :]


@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32])
@pytest.mark.parametrize("shape", SHAPES)
def test_cpu_takes_the_plain_route(shape, dtype):
    """A CPU tensor takes the plain ``group_norm``, bit for bit, and never
    the kernel."""
    x, gn, _ = _inputs(shape, dtype, sum(shape))
    before = gnc.group_norm_cuda.launches
    got = resnet.norm_act(x, gn)
    assert got.dtype == dtype and torch.equal(got, resnet.group_norm(x, gn))
    assert gnc.group_norm_cuda.launches == before == 0


@pytest.mark.parametrize("form", FORMS, ids=[f"{a}-{s}" for a, s in FORMS])
@pytest.mark.parametrize("shape", SHAPES)
def test_norm_act_is_group_norm_then_the_plain_activation(shape, form):
    """``norm_act`` on the CPU is ``group_norm``, the skip added in the
    dtype's arithmetic, then ``torch.relu`` or ``relu6``, bit for bit, and
    counts one GroupNorm."""
    act, skip_form = form
    x, gn, g = _inputs(shape, torch.bfloat16, 3 * sum(shape))
    skip = _skip(skip_form, shape, torch.bfloat16, g)
    y = resnet.group_norm(x, gn)
    if skip is not None:
        y = y + skip
    want = {None: y, "relu": torch.relu(y), "relu6": torch.relu(y).clamp_max(6.0)}[act]
    before = resnet.group_norm.calls
    got = resnet.norm_act(x, gn, act, skip)
    assert resnet.group_norm.calls == before + 1
    assert got.dtype == torch.bfloat16 and torch.equal(got, want)


def test_norm_act_calls_the_norm_it_is_handed():
    """Off the kernel's route ``norm_act`` calls the GroupNorm a walk hands
    in (the MobileNet walk's own module name) or this module's name at the
    call, so a patched name takes effect."""
    x, gn, _ = _inputs((1, 4, 4, 64), torch.bfloat16, 1)
    seen = []

    def norm(x, gn):
        seen.append(x)
        return torch.zeros_like(x)

    assert torch.equal(resnet.norm_act(x, gn, "relu6", norm=norm), torch.zeros_like(x))
    with mock.patch.object(resnet, "group_norm", norm):
        resnet.norm_act(x, gn, "relu")
    assert len(seen) == 2


@pytest.mark.parametrize("case", ["bf16", "float32", "float16", "float64", "rank3", "grad_x",
                                  "grad_scale", "grad_skip", "no_grad", "wide"])
def test_route_rule(case):
    """``eligible``: NHWC bf16 or float32, and no gradient needed through
    it; ``engages`` also needs the card, so every CPU tensor stays on the
    plain route. A width the kernel's layout does not take is eligible
    (the wrapper raises on it, ``test_wrapper_checks_raise_without_building``),
    so the card never leaves the kernel silently."""
    dtype = {"float32": torch.float32, "float16": torch.float16,
             "float64": torch.float64}.get(case, torch.bfloat16)
    shape = {"rank3": (4, 4, 64), "wide": (1, 2, 2, 1028)}.get(case, (1, 4, 4, 64))
    x = torch.zeros(shape, dtype=dtype)
    scale, skip = torch.ones(shape[-1]), torch.zeros(shape, dtype=dtype)
    if case == "grad_x":
        x.requires_grad_(True)
    elif case == "grad_scale":
        scale.requires_grad_(True)
    elif case in ("grad_skip", "no_grad"):
        skip.requires_grad_(True)
    want = case in ("bf16", "float32", "no_grad", "wide")
    if case == "no_grad":
        with torch.no_grad():
            assert gnc.eligible(x, scale, skip)
    else:
        assert gnc.eligible(x, scale, None, skip) is want
    assert not gnc.engages(x, scale, skip)
    # 1028 bf16 channels make no whole 16-byte vectors and are more than 1024
    # single ones; 1032 are 129 vectors, 2048 are 256 and 2056 are 257
    assert not gnc.channels_fit(1028, torch.bfloat16) and gnc.channels_fit(1032, torch.bfloat16)
    assert gnc.channels_fit(2048, torch.bfloat16) and not gnc.channels_fit(2056, torch.bfloat16)
    assert gnc.channels_fit(1024, torch.float32) and not gnc.channels_fit(1028, torch.float32)


@pytest.mark.parametrize("case", ["rank3", "non_contiguous", "float16", "groups", "act",
                                  "scale_dtype", "skip_shape", "skip_channel_stride", "cpu",
                                  "wide_bf16", "wide_float32"])
def test_wrapper_checks_raise_without_building(case):
    """``group_norm_cuda`` raises ValueError on what the kernel does not
    take, before it builds or loads the kernel library."""
    x = torch.zeros((1, 4, 4, 64), dtype=torch.bfloat16)
    scale, bias, skip, groups, act = torch.ones(64), torch.zeros(64), None, 32, "relu"
    if case == "rank3":
        x = x[0]
    elif case == "non_contiguous":
        x = torch.zeros((1, 64, 4, 4), dtype=torch.bfloat16).permute(0, 2, 3, 1)
    elif case == "float16":
        x = x.half()
    elif case == "groups":
        groups = 24
    elif case == "act":
        act = "gelu"
    elif case == "scale_dtype":
        scale = scale.to(torch.bfloat16)
    elif case == "skip_shape":
        skip = torch.zeros((1, 2, 2, 64), dtype=torch.bfloat16)
    elif case == "skip_channel_stride":
        skip = torch.zeros((1, 4, 4, 128), dtype=torch.bfloat16)[..., ::2]
    elif case.startswith("wide"):
        # more channels than the kernel's layout takes (channels_fit)
        dtype = torch.bfloat16 if case == "wide_bf16" else torch.float32
        x, scale, bias = torch.zeros((1, 2, 2, 1028), dtype=dtype), torch.ones(1028), torch.zeros(1028)
        groups = 4
    with mock.patch.object(_build, "libraries", side_effect=AssertionError("built")), \
            pytest.raises(ValueError, match="group_norm_cuda"):
        gnc.group_norm_cuda(x, scale, bias, groups, act=act, skip=skip)


def _old_resnet_walk(params, x, preset, conv):
    """``resnet.walk_feature_maps`` as it was written before ``norm_act``:
    every GroupNorm alone, then ``torch.relu`` and the skip add."""
    gn = resnet.group_norm
    x = layers.max_pool(torch.relu(gn(conv("stem_conv", x, stride=2), params["stem_gn"])), 3, 2)
    maps = []
    for si, (blocks, _, stage_stride) in enumerate(resnet.STAGES):
        for bi in range(blocks):
            name, stride = f"s{si}b{bi}", stage_stride if bi == 0 else 1
            y = torch.relu(gn(conv(f"{name}_conv1", x, stride=stride), params[f"{name}_gn1"]))
            y = gn(conv(f"{name}_conv2", y), params[f"{name}_gn2"])
            if f"{name}_proj" in params:
                skip = gn(conv(f"{name}_proj", x, stride=stride), params[f"{name}_proj_gn"])
            else:
                skip = x[:, ::stride, ::stride, :] if stride != 1 else x
            x = torch.relu(y + skip)
        if si >= 1:
            maps.append(x)
    for name, _, _, stride, padding in resnet.extra_layer_defs(preset):
        x = torch.relu(conv(name, x, stride=stride, padding=padding))
        if name.endswith("_2"):
            maps.append(x)
    return maps


def _old_mobilenet_walk(params, x, preset, conv):
    """``mobilenet.walk_feature_maps`` as it was written before ``norm_act``."""
    gn = resnet.group_norm
    x = layers.relu6(gn(conv("stem_conv", x, stride=2), params["stem_gn"]))
    maps = []
    for i, (stride, _) in enumerate(mobilenet.BLOCKS, start=1):
        x = layers.relu6(gn(conv(f"b{i}_dw", x, stride=stride, depthwise=True),
                            params[f"b{i}_dw_gn"]))
        x = layers.relu6(gn(conv(f"b{i}_pw", x), params[f"b{i}_pw_gn"]))
        if i in mobilenet.TAP_BLOCKS:
            maps.append(x)
    for name, _, _, stride, padding in mobilenet.extra_layer_defs(preset):
        x = layers.relu6(conv(name, x, stride=stride, padding=padding))
        if name.endswith("_2"):
            maps.append(x)
    return maps


@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32])
@pytest.mark.parametrize("preset_name", ["rtest64", "mntest64"])
def test_walks_keep_their_bits(preset_name, dtype):
    """Both family walks give the maps of their former composition bit for
    bit, with random GroupNorm leaves (so that no block starts as the
    identity), and run their GroupNorms in the same order."""
    cfg = ssd_vgg.ModelConfig(preset_name=preset_name, num_classes=3)
    params = ssd_vgg.init_params(cfg, seed=5)
    rng = np.random.default_rng(6)
    for leaf in params.values():
        if isinstance(leaf, dict) and "scale" in leaf:
            leaf["scale"] = torch.from_numpy(rng.normal(1, 0.5, leaf["scale"].shape).astype(np.float32))
            leaf["bias"] = torch.from_numpy(rng.normal(0, 0.5, leaf["bias"].shape).astype(np.float32))
    x = torch.from_numpy(rng.normal(0, 1, (2, 64, 64, 3)).astype(np.float32)).to(dtype)
    fam, old = ((mobilenet, _old_mobilenet_walk) if preset_name == "mntest64"
                else (resnet, _old_resnet_walk))
    conv = layers.float_conv_executor(params, inference=True)
    order = {"new": [], "old": []}
    real = resnet.group_norm

    def recording(key):
        def norm(x, gn, *args, **kwargs):
            order[key].append(next(n for n, leaf in params.items() if leaf is gn))
            return real(x, gn, *args, **kwargs)
        return norm

    maps = {}
    with torch.no_grad():
        for key, walk in (("new", fam.walk_feature_maps), ("old", old)):
            with mock.patch.object(resnet, "group_norm", recording(key)), \
                    mock.patch.object(mobilenet, "group_norm", recording(key)):
                maps[key] = walk(params, x, cfg.preset, conv)
    got, want = maps["new"], maps["old"]
    assert order["new"] == order["old"] and len(order["new"]) == {"r": 36, "m": 27}[preset_name[0]]
    assert len(got) == len(want) == cfg.preset.num_maps
    for a, b in zip(got, want):
        assert a.dtype == dtype and torch.equal(a, b)
