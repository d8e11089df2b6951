"""The port's spans (``utils/profiling.span``) on the CPU: a span is the
shared null context while no profiler runs and a ``record_function``
while one does; the int8 conv's four stages, the train step's six parts,
the prefetch's wait and put, and the families' GroupNorms and depthwise
convs open their spans where and as often as the modules say (the last
two moving their counters by as much); the outputs are the same bit for
bit with the profiler on and off; and ``span_device_ms`` puts a trace's
device operations down to the spans that launched them."""

import contextlib

import numpy as np
import pytest
import torch
from torch.profiler import ProfilerActivity, profile, record_function

from ssd_tensorflow_tpu_torch.models import layers, mobilenet, quantized, resnet, ssd_vgg
from ssd_tensorflow_tpu_torch.ops import int8_conv as ic
from ssd_tensorflow_tpu_torch.ops.anchors import anchors_for_preset
from ssd_tensorflow_tpu_torch.ops.postprocess import DetectionConfig
from ssd_tensorflow_tpu_torch.parallel import train_step
from ssd_tensorflow_tpu_torch.parallel.prefetch import prefetch_to_device
from ssd_tensorflow_tpu_torch.utils import profiling

STEP_PARTS = ["ssd.step.targets", "ssd.step.forward", "ssd.step.loss", "ssd.step.backward",
              "ssd.step.optimizer", "ssd.step.detect"]


def _cpu_profile(all_threads=False):
    if all_threads:
        return profile(activities=[ProfilerActivity.CPU],
                       experimental_config=torch.profiler._ExperimentalConfig(
                           profile_all_threads=True))
    return profile(activities=[ProfilerActivity.CPU])


def _spans(prof, prefix="ssd."):
    """``(name, tid, ts)`` of the trace's spans that start with ``prefix``
    (a tuple of prefixes), in start order."""
    return sorted(((e["name"], e["tid"], float(e["ts"])) for e in profiling.profiler_events(prof)
                   if e.get("cat") == "user_annotation" and str(e["name"]).startswith(prefix)),
                  key=lambda s: s[2])


def _tid_of(spans, name):
    return next(tid for n, tid, _ in spans if n == name)


def test_span_is_the_shared_null_context_without_a_profiler(monkeypatch):
    calls = []
    monkeypatch.setattr(torch.profiler, "record_function", lambda name: calls.append(name))
    a, b = profiling.span("ssd.a"), profiling.span("ssd.b")
    assert a is b and isinstance(a, contextlib.nullcontext) and calls == []
    with a, b:
        pass


def test_span_records_while_a_profiler_runs():
    with _cpu_profile() as prof:
        s = profiling.span("ssd.test")
        assert isinstance(s, record_function)
        with s:
            torch.ones(4).add_(1)
    assert [n for n, _, _ in _spans(prof)] == ["ssd.test"]
    assert isinstance(profiling.span("ssd.test"), contextlib.nullcontext)


def _int8_inputs(seed, b=3, hw=10, cin=8, cout=16, k=3):
    g = torch.Generator().manual_seed(seed)
    xq = torch.randint(-127, 128, (b, hw, hw, cin), generator=g, dtype=torch.int8)
    wq = torch.randint(-127, 128, (k, k, cin, cout), generator=g, dtype=torch.int8)
    return xq, ic.stage_int8_weight(wq)


@pytest.mark.parametrize("stride", [1, 2])
def test_int8_conv_im2col_spans_once_a_chunk(stride):
    xq, wt = _int8_inputs(stride)
    ho = -(-10 // stride)
    kp = wt.wk.shape[1]
    one_image = ho * ho * kp  # chunks of one image: three chunks
    with _cpu_profile() as prof:
        got = ic.int8_conv_im2col(xq, wt, stride, "SAME", chunk_bytes=one_image)
    names = [n for n, _, _ in _spans(prof, "ssd.int8.")]
    assert names == ["ssd.int8.im2col", "ssd.int8.gemm"] * 3
    assert torch.equal(got, ic.int8_conv_plain(xq, wt, stride, "SAME"))


def test_int8_conv_pointwise_route_is_one_gemm_span():
    xq, wt = _int8_inputs(3, cin=16, k=1)
    with _cpu_profile() as prof:
        got = ic.int8_conv_im2col(xq, wt)
    assert [n for n, _, _ in _spans(prof, "ssd.int8.")] == ["ssd.int8.gemm"]
    assert torch.equal(got, ic.int8_conv_plain(xq, wt))


def test_qconv_spans_quantize_and_requant_once():
    xq, wt = _int8_inputs(4)
    layer = {"inv": torch.tensor([0.25]), "w": wt, "mult": torch.full((16,), 1e-3),
             "b": torch.linspace(-0.5, 0.5, 16)}
    x = xq.float().to(torch.bfloat16)
    with _cpu_profile() as prof:
        quantized._qconv_executor({"conv": layer})("conv", x, relu=True)
    assert [n for n, _, _ in _spans(prof, "ssd.int8.")] == ["ssd.int8.quantize",
                                                             "ssd.int8.requant"]


@pytest.fixture(scope="module")
def int8_model():
    cfg = ssd_vgg.ModelConfig(preset_name="test64", num_classes=3)
    images = np.random.default_rng(7).integers(0, 256, (2, 64, 64, 3), dtype=np.uint8)
    model = quantized.QuantizedModel(ssd_vgg.init_params(cfg, seed=1), cfg, images, device="cpu")
    return model, cfg, torch.from_numpy(images)


def test_int8_forward_same_bits_with_the_profiler_on(int8_model, monkeypatch):
    """The card's yardstick route (``int8_conv_im2col`` inside
    ``int8_qconv_plain``) through the whole forward, with and without a
    profiler: each stage's spans once a conv, and the outputs equal bit for
    bit."""
    model, cfg, images = int8_model
    monkeypatch.setattr(ic, "int8_conv", ic.int8_conv_im2col)
    off = quantized._forward_scores(model.staged, images, cfg)
    with _cpu_profile() as prof:
        on = quantized._forward_scores(model.staged, images, cfg)
    for a, b in zip(off, on):
        assert a.dtype == b.dtype and torch.equal(a, b)
    names = [n for n, _, _ in _spans(prof, "ssd.int8.")]
    convs = names.count("ssd.int8.quantize")
    assert convs > 10 and names.count("ssd.int8.requant") == convs
    assert names.count("ssd.int8.gemm") >= names.count("ssd.int8.im2col") > 0


def test_counted_span_counts_under_a_patched_name(monkeypatch):
    """A counted function keeps counting, inside its span, when a test
    patches its module's name and calls the real one (as the GroupNorm
    drift test and ``tools/torch_profile.py``'s recorder do)."""
    real, before = resnet.group_norm, resnet.group_norm.calls
    monkeypatch.setattr(resnet, "group_norm", lambda *a, **k: real(*a, **k))
    x = torch.ones((1, 2, 2, 32), dtype=torch.bfloat16)
    gn = {"scale": torch.ones(32), "bias": torch.zeros(32)}
    with _cpu_profile() as prof:
        resnet.group_norm(x, gn)
    assert resnet.group_norm is not real and real.calls == before + 1
    assert [n for n, _, _ in _spans(prof)] == ["ssd.group_norm"]
    assert real.__name__ == "group_norm" and "GroupNorm" in real.__doc__


def _norms_and_stencils(preset_name):
    """``(GroupNorms, depthwise convs)`` of a family's trunk and extras, by
    its ``backbone_shapes``."""
    preset = ssd_vgg.ModelConfig(preset_name=preset_name, num_classes=3).preset
    shapes = (mobilenet if preset.backbone == "mobilenetv1" else resnet).backbone_shapes(preset)
    return (sum("scale" in leaves for leaves in shapes.values()),
            sum(name.endswith("_dw") for name in shapes))


def test_mobilenet_counts_from_its_layer_table():
    assert _norms_and_stencils("mobilenet320") == (27, 13)
    assert _norms_and_stencils("mntest64") == (27, 13)
    assert _norms_and_stencils("rtest64") == (36, 0)


@pytest.fixture(scope="module")
def mobilenet_int8():
    cfg = ssd_vgg.ModelConfig(preset_name="mntest64", num_classes=3)
    images = np.random.default_rng(9).integers(0, 256, (2, 64, 64, 3), dtype=np.uint8)
    params = ssd_vgg.init_params(cfg, seed=3)
    model = quantized.QuantizedModel(params, cfg, images, device="cpu")
    return model, params, cfg, torch.from_numpy(images)


def _counters():
    return resnet.group_norm.calls, layers.depthwise_conv2d.calls


def test_mobilenet_int8_forward_spans_once_a_norm_and_a_stencil(mobilenet_int8):
    """One int8 forward opens ``ssd.group_norm`` once a GroupNorm and
    ``ssd.depthwise`` once a depthwise conv, and moves the counters by as
    much, with the profiler on and off."""
    model, _, cfg, images = mobilenet_int8
    norms, stencils = _norms_and_stencils("mntest64")
    before = _counters()
    quantized._forward_scores(model.staged, images, cfg)
    mid = _counters()
    with _cpu_profile() as prof:
        quantized._forward_scores(model.staged, images, cfg)
    after = _counters()
    assert (mid[0] - before[0], mid[1] - before[1]) == (norms, stencils)
    assert (after[0] - mid[0], after[1] - mid[1]) == (norms, stencils)
    names = [n for n, _, _ in _spans(prof, ("ssd.group_norm", "ssd.depthwise"))]
    assert names.count("ssd.group_norm") == norms and names.count("ssd.depthwise") == stencils
    # the walk's order: the stem's norm, then each block's stencil and its norm
    assert names[:4] == ["ssd.group_norm", "ssd.depthwise", "ssd.group_norm", "ssd.group_norm"]


def test_resnet_forward_counts_its_norms_and_no_stencil():
    cfg = ssd_vgg.ModelConfig(preset_name="rtest64", num_classes=3, compute_dtype="float32")
    images = torch.from_numpy(
        np.random.default_rng(4).integers(0, 256, (1, 64, 64, 3), dtype=np.uint8))
    params = ssd_vgg.init_params(cfg, seed=1)
    before = _counters()
    with _cpu_profile() as prof, torch.no_grad():
        ssd_vgg.apply_model(params, images, cfg)
    after = _counters()
    norms, _ = _norms_and_stencils("rtest64")
    assert (after[0] - before[0], after[1] - before[1]) == (norms, 0)
    names = [n for n, _, _ in _spans(prof, ("ssd.group_norm", "ssd.depthwise"))]
    assert names == ["ssd.group_norm"] * norms


@pytest.mark.parametrize("route", ["int8", "float"])
def test_mobilenet_forward_same_bits_with_the_profiler_on(mobilenet_int8, route):
    model, params, cfg, images = mobilenet_int8
    if route == "int8":
        def forward():
            return quantized._forward_scores(model.staged, images, cfg)
    else:
        def forward():
            with torch.no_grad():
                return ssd_vgg.apply_model(params, images, cfg)
    off = forward()
    with _cpu_profile():
        on = forward()
    for a, b in zip(off, on):
        assert a.dtype == b.dtype and torch.equal(a, b)


def _train_setup(threshold=0.01):
    cfg = train_step.TrainConfig(
        model=ssd_vgg.ModelConfig(preset_name="test64", num_classes=3, compute_dtype="float32"),
        detect=DetectionConfig(confidence_threshold=threshold))
    rng = np.random.default_rng(11)
    wh = rng.uniform(0.1, 0.5, (2, 3, 2))
    batch = {"images": torch.from_numpy(rng.integers(0, 256, (2, 64, 64, 3), dtype=np.uint8)),
             "gt_boxes": torch.from_numpy(np.concatenate(
                 [rng.uniform(wh / 2, 1 - wh / 2), wh], -1).astype(np.float32)),
             "gt_labels": torch.from_numpy(rng.integers(0, 3, (2, 3))),
             "gt_mask": torch.tensor([[True, True, False], [True, False, False]])}
    state = train_step.make_train_state(ssd_vgg.init_params(cfg.model, seed=2), cfg,
                                        device="cpu")
    step = train_step.make_train_step(cfg, anchors_for_preset(cfg.model.preset))
    return step, state, batch


def test_train_step_six_parts_in_order_on_the_calling_thread():
    step, state, batch = _train_setup()
    with _cpu_profile() as prof:
        with record_function("test.caller"):
            step(state, batch)
    spans = _spans(prof, ("ssd.step.", "test."))
    caller = _tid_of(spans, "test.caller")
    spans = [s for s in spans if s[0] != "test.caller"]
    assert [n for n, _, _ in spans] == STEP_PARTS
    assert {tid for _, tid, _ in spans} == {caller}


def test_train_step_same_bits_with_the_profiler_on():
    step, state, batch = _train_setup()
    new_off, losses_off, dets_off = step(state, batch)
    with _cpu_profile():
        new_on, losses_on, dets_on = step(state, batch)
    for name, leaves in new_off.params.items():
        for key, v in leaves.items():
            assert torch.equal(v, new_on.params[name][key]), (name, key)
            assert torch.equal(new_off.opt_state.trace[name][key],
                               new_on.opt_state.trace[name][key])
    assert losses_off.keys() == losses_on.keys()
    assert all(torch.equal(losses_off[k], losses_on[k]) for k in losses_off)
    for field in ("boxes", "scores", "classes", "valid"):
        assert torch.equal(getattr(dets_off, field), getattr(dets_on, field))


def test_prefetch_wait_on_the_consumer_put_on_the_producer():
    items = [{"x": np.full((4,), i, np.float32)} for i in range(3)]
    with _cpu_profile(all_threads=True) as prof:
        with record_function("test.consumer"):
            got = list(prefetch_to_device(iter(items), device="cpu"))
    assert [float(g["x"][0]) for g in got] == [0.0, 1.0, 2.0]
    spans = _spans(prof, ("ssd.prefetch.", "test."))
    consumer = _tid_of(spans, "test.consumer")
    waits = [tid for n, tid, _ in spans if n == "ssd.prefetch.wait"]
    puts = [tid for n, tid, _ in spans if n == "ssd.prefetch.put"]
    assert len(waits) == 4 and set(waits) == {consumer}  # three items, then the end
    assert len(puts) == 3 and len(set(puts)) == 1 and consumer not in puts


def _kernel(name, ts, dur, corr):
    return {"cat": "kernel", "name": name, "ts": ts, "dur": dur, "tid": 7,
            "args": {"correlation": corr}}


def _launch(ts, tid, corr):
    return {"cat": "cuda_runtime", "name": "cudaLaunchKernel", "ts": ts, "dur": 1, "tid": tid,
            "args": {"correlation": corr}}


def _span(name, ts, dur, tid):
    return {"cat": "user_annotation", "name": name, "ts": ts, "dur": dur, "tid": tid}


def test_span_device_ms_attribution():
    """Main thread 1 with nested spans and ten siblings, thread 2 followed
    (its ATen calls are in the trace, no spans), thread 3 not followed,
    thread 4 a producer followed inside its own span."""
    ev = [_span("ssd.step.forward", 0, 100, 1), _span("ssd.step.backward", 100, 100, 1),
          {"cat": "cpu_op", "name": "aten::mm", "ts": 120, "dur": 5, "tid": 2},
          {"cat": "cpu_op", "name": "aten::copy_", "ts": 160, "dur": 5, "tid": 4},
          _span("ssd.prefetch.put", 155, 20, 4), _launch(161, 4, 6),
          {"cat": "gpu_memcpy", "name": "Memcpy HtoD", "ts": 171, "dur": 3, "tid": 8,
           "args": {"correlation": 6}}]
    ev += [_span("ssd.int8.quantize", 2 + 5 * i, 3, 1) for i in range(10)]
    ev += [_launch(3, 1, 1), _kernel("a", 10, 4, 1),      # in the first quantize
           _launch(90, 1, 2), _kernel("b", 95, 5, 2),     # forward itself, after 10 siblings
           _launch(120, 2, 3), _kernel("c", 130, 10, 3),  # followed thread: backward
           _launch(150, 3, 4), _kernel("d", 150, 20, 4),  # producer: none
           _launch(250, 1, 5), _kernel("e", 250, 1, 5)]   # outside any span
    got = profiling.span_device_ms(ev)
    assert got == {"ssd.int8.quantize": 0.004, "ssd.step.forward": 0.005,
                   "ssd.step.backward": 0.01, "ssd.prefetch.put": 0.003}
    ops = profiling.span_ops(ev)
    assert {span: [name for name, _, _ in v] for span, v in ops.items()} == {
        "ssd.int8.quantize": ["a"], "ssd.step.forward": ["b"], "ssd.step.backward": ["c"],
        "ssd.prefetch.put": ["Memcpy HtoD"]}
    assert ops["ssd.step.backward"] == [("c", 130.0, 140.0)]
