"""The reader ``depthwise_roofline.serve`` on hand-written traces: the
least time of mobilenet320's 13 depthwise convs over the device time a
batch of ``csrc/depthwise_conv.cu``'s kernel, None where the kernel did
not run, loud on another configuration's cell."""

import pytest
from test_h100bench_mobilenet import serve_events

from benchlib import counts, registry
from benchlib.trace import Trace

CONFIG = "ssd320-mobilenetv1-int8"


def _ctx(events, batch=64):
    cfg = registry.config(CONFIG)
    return {"trace": Trace(events), "device_trace": None, "batch": batch,
            "forward_ops_per_item": counts.forward_ops(cfg)}


def test_the_bound_is_the_depthwise_records():
    """The bound sums ``conv_bound_s`` over the 13 depthwise records, each
    byte-bound: the map read and the output written once in bf16, the
    filter in int8 (the configuration's precision), ~0.39 ms at b64."""
    mod = registry.reader("metrics", "depthwise_roofline.serve")
    cfg = registry.config(CONFIG)
    dw = [c for c in counts.conv_shapes(cfg, 64) if c["name"].endswith("_dw")]
    assert len(dw) == 13 and all(c["groups"] == c["cin"] == c["cout"] > 1 for c in dw)
    nbytes = sum(2 * (c["hin"] * c["win"] + c["ho"] * c["wo"]) * 64 * c["cin"] + 9 * c["cin"]
                 for c in dw)
    bound = mod.__globals__["bound_s"](cfg, 64)
    assert bound == pytest.approx(nbytes / counts.HBM_BYTES_PER_S)
    assert 0.38e-3 < bound < 0.40e-3


def test_depthwise_roofline_reads_the_kernel_a_batch():
    """Two forwards of one 30 us kernel each: the bound over 30 us a batch."""
    mod = registry.reader("metrics", "depthwise_roofline.serve")
    bound = mod.__globals__["bound_s"](registry.config(CONFIG), 64)
    kernel = "void (anonymous namespace)::depthwise3x3_nhwc<2>(CUtensorMap_st, Params)"
    assert mod(_ctx(serve_events(kernel))) == pytest.approx(100 * bound / 30e-6)


def test_depthwise_roofline_is_none_without_the_kernel():
    """cuDNN's stencil (the parent's route) or no trace reads None, before
    the configuration is checked."""
    mod = registry.reader("metrics", "depthwise_roofline.serve")
    ctx = _ctx(serve_events("void cudnn::conv2d_c1_k1_nhwc_kernel<float>"))
    assert mod(ctx) is None
    assert mod(dict(ctx, forward_ops_per_item=1.0)) is None
    assert mod({"trace": None, "device_trace": None}) is None


def test_depthwise_roofline_raises_on_another_configuration():
    mod = registry.reader("metrics", "depthwise_roofline.serve")
    ctx = _ctx(serve_events("depthwise3x3_nhwc<1>"))
    with pytest.raises(ValueError, match="describes"):
        mod(dict(ctx, forward_ops_per_item=180.4e9))
