"""The int8 forward's CUDA graphs at the façade (``inference.forward_graph``)
and the cached mean they need (``layers.mean_constant``), on the CPU.

On the CPU ``InferenceModel.forward_scores`` never captures and equals
``quantized._forward_scores`` bit for bit, on the three families' small
presets (``test64``, ``rtest64``, ``mntest64``); ``run_scores`` gives the
detections of the eager forward. ``forward_graph``'s order of events
(eager, capture, replays), its keys, counters and the ownership of what it
returns are held with the capture patched to a stand-in that re-runs the
forward at each replay into the captured outputs, as a graph writes into
its own memory. The card's graphs are ``tests/test_torch_cuda.py``'s."""

import numpy as np
import pytest
import torch

from ssd_tensorflow_tpu_torch import inference
from ssd_tensorflow_tpu_torch.models import layers, quantized, ssd_vgg
from ssd_tensorflow_tpu_torch.ops import stem_cuda
from ssd_tensorflow_tpu_torch.ops.postprocess import decode_scores
from ssd_tensorflow_tpu_torch.utils import profiling

PRESETS = ["test64", "rtest64", "mntest64"]


@pytest.fixture(scope="module", params=PRESETS)
def int8_model(request):
    cfg = ssd_vgg.ModelConfig(preset_name=request.param, num_classes=3)
    calib = np.random.default_rng(11).integers(0, 256, (2, 64, 64, 3), dtype=np.uint8)
    qm = quantized.QuantizedModel(ssd_vgg.init_params(cfg, seed=2), cfg, calib, device="cpu")
    model = inference.InferenceModel(qm.qparams, cfg, act_scales=qm.act_scales, device="cpu")
    return model


def _images(seed, b=2):
    return torch.from_numpy(
        np.random.default_rng(seed).integers(0, 256, (b, 64, 64, 3), dtype=np.uint8))


def _counters():
    return inference.forward_graph.captures, inference.forward_graph.replays


def test_cpu_forward_scores_never_captures_and_equals_the_eager_forward(int8_model, monkeypatch):
    def no_capture(*a, **k):
        raise AssertionError("captured on the CPU")

    monkeypatch.setattr(inference, "_capture", no_capture)
    before = _counters()
    for seed in range(4):
        x = _images(seed)
        with torch.inference_mode():
            got = int8_model.forward_scores(x)
            want = quantized._forward_scores(int8_model.params, x, int8_model.config)
        assert all(a.dtype == b.dtype and torch.equal(a, b) for a, b in zip(got, want))
    assert _counters() == before and int8_model._graphs == {}


def test_cpu_run_scores_detections_are_the_eager_forwards(int8_model):
    x = _images(5)
    for _ in range(3):
        dets = int8_model.run_scores(x)
    with torch.inference_mode():
        conf, cls, locs = quantized._forward_scores(int8_model.params, x, int8_model.config)
        want = decode_scores(conf, cls, locs, int8_model.anchors, int8_model.detection)
    for f in ("boxes", "scores", "classes", "valid"):
        assert torch.equal(getattr(dets, f), getattr(want, f)), f


class _Replayer:
    """A stand-in for a captured graph on the CPU: ``replay`` runs the
    forward on the input buffer and writes the result into the captured
    outputs, as a graph rewrites its private memory."""

    def __init__(self, forward, static_x, outs):
        self.forward, self.static_x, self.outs = forward, static_x, outs

    def replay(self):
        for buf, y in zip(self.outs, self.forward(self.static_x)):
            buf.copy_(y)


def _stand_in_capture(log):
    def capture(forward, x):
        log.append(("capture", tuple(x.shape)))
        static_x = torch.empty_like(x)
        outs = tuple(torch.zeros_like(t) for t in forward(x))
        return static_x, _Replayer(forward, static_x, outs), outs

    return capture


def test_forward_graph_eager_then_capture_then_replays(monkeypatch):
    """Call 1 eager on ``x`` itself, call 2 captures and replays, calls 3-4
    replay; each result the forward's, owned by the caller (call 3's
    unchanged by call 4), with the counters at 1 capture and 3 replays;
    another shape counts from its own first call."""
    log, graphs = [], {}
    monkeypatch.setattr(inference, "_capture", _stand_in_capture(log))

    def forward(x):
        log.append(("forward", x.data_ptr()))
        y = x.float() * 2
        return y + 1, y.sum(dim=-1)

    before = _counters()
    xs = [_images(seed) for seed in range(4)]
    outs = [inference.forward_graph(graphs, forward, x) for x in xs]
    assert log[0] == ("forward", xs[0].data_ptr())
    assert log[1][0] == "capture" and log[2][0] == "forward"
    assert [e[0] for e in log].count("capture") == 1
    assert _counters() == (before[0] + 1, before[1] + 3)
    for x, out in zip(xs, outs):
        want = forward(x)
        assert all(torch.equal(a, b) for a, b in zip(out, want))
    _, _, captured = graphs[((2, 64, 64, 3), torch.uint8, torch.device("cpu"))]
    assert not any(a.data_ptr() == b.data_ptr() for out in outs[1:] for a in out for b in captured)
    third = [t.clone() for t in outs[2]]
    inference.forward_graph(graphs, forward, _images(9))
    assert all(torch.equal(a, b) for a, b in zip(outs[2], third))
    one = _images(3, b=1)
    inference.forward_graph(graphs, forward, one)
    assert _counters()[0] == before[0] + 1 and log[-1] == ("forward", one.data_ptr())
    assert len(graphs) == 2


def test_forward_graph_spans_while_a_profiler_runs(monkeypatch):
    monkeypatch.setattr(inference, "_capture", _stand_in_capture([]))
    graphs, x = {}, _images(1)
    inference.forward_graph(graphs, lambda t: (t.float(),), x)
    with torch.profiler.profile(activities=[torch.profiler.ProfilerActivity.CPU]) as prof:
        inference.forward_graph(graphs, lambda t: (t.float(),), x)
        inference.forward_graph(graphs, lambda t: (t.float(),), x)
    names = [e["name"] for e in profiling.profiler_events(prof)
             if e.get("cat") == "user_annotation" and str(e["name"]).startswith("ssd.")]
    assert names.count("ssd.forward_graph.capture") == 1
    assert names.count("ssd.forward_graph.replay") == 2


@pytest.mark.parametrize("mean", [(104.0, 117.0, 123.0), (1, 2.5, 300)])
def test_mean_constant_is_the_old_tensor_and_one_object(mean):
    got = layers.mean_constant(mean, "cpu")
    want = torch.tensor(mean, dtype=torch.float32, device="cpu")
    assert got.dtype == torch.float32 and torch.equal(got, want)
    with torch.inference_mode():
        again = layers.mean_constant(list(mean), torch.device("cpu"))
    assert again is got and not again.is_inference()
    assert layers.mean_constant((0.0, 0.0, 0.0), "cpu") is not got


def test_preprocess_and_stem_keep_their_bits():
    """The walks' preprocess and the stem's, against the subtraction of a
    fresh mean tensor they made before."""
    cfg = ssd_vgg.ModelConfig(preset_name="test64", num_classes=3)
    x = _images(6)
    want = (x.float() - torch.tensor(cfg.mean_bgr, dtype=torch.float32)).to(cfg.dtype)
    assert torch.equal(layers.preprocess(x, cfg), want)
    assert torch.equal(stem_cuda._preprocess(x, cfg.mean_bgr),
                       (x.float() - torch.tensor(cfg.mean_bgr)).to(torch.bfloat16))


def test_mean_constant_while_exporting_is_a_program_constant():
    """Traced by ``torch.export``, the mean is a fresh constant of the
    program, and the cache keeps no traced tensor."""

    class Pre(torch.nn.Module):
        def forward(self, x):
            return x.float() - layers.mean_constant((7.0, 8.0, 9.0), x.device)

    program = torch.export.export(Pre(), (_images(0),))
    x = _images(4)
    assert torch.equal(program.module()(x), x.float() - torch.tensor((7.0, 8.0, 9.0)))
    cached = layers.mean_constant((7.0, 8.0, 9.0), "cpu")
    assert type(cached) is torch.Tensor and torch.equal(cached, torch.tensor((7.0, 8.0, 9.0)))
