"""The MobileNetV1 family (``reference/ssd_mobilenetv1.py``) and its cell
``mobilenet320-int8-serve-b64`` on the CPU: the lookup; the convolution
records and counts; the reference against the program at ``mntest64`` on
seeded weights (float32 and int8, and the int4 control failing); the
cell's faults, control and sound runs and the no-JAX check on the shipped
bundle at 320x320, batch 4; and the readers ``norm_launches.serve`` and
``depthwise_ms.serve`` on hand-written traces."""

import subprocess
import sys
import textwrap

import h100bench_cases as hc
import pytest
import torch
from test_h100bench_faults import _class_shift, _half_batch, _top1

import calibrate
from benchlib import check, counts, family, harness, pool, registry
from benchlib.trace import Trace

CPU = torch.device("cpu")
CONFIG = "ssd320-mobilenetv1-int8"
CELL = "mobilenet320-int8-serve-b64"
SEED = 2**32 + 5


def test_the_mobilenet_family_is_found():
    cfg = registry.config(CONFIG)
    assert family.of(cfg).__name__ == "reference.ssd_mobilenetv1"
    with pytest.raises(ValueError, match="no train reference"):
        family.train_reference(cfg)


# ---- the convolutions and their counts --------------------------------------

def test_conv_records_depthwise_groups():
    cfg = registry.config(CONFIG)
    recs = counts.conv_shapes(cfg, 64)
    dw = [c for c in recs if c["name"].endswith("_dw")]
    assert [c["name"] for c in dw] == [f"b{i}_dw" for i in range(1, 14)]
    assert all(c["groups"] == c["cin"] == c["cout"] and c["k"] == 3 for c in dw)
    assert all(c["groups"] == 1 for c in recs if c not in dw)
    assert len(recs) == 1 + 13 * 2 + 4 * 2 + 6
    assert [c["name"] for c in recs if c["reads_image"]] == ["stem_conv"]
    assert [c["name"] for c in recs[-6:]] == [f"classifier{i}" for i in range(6)]
    b1 = dw[0]  # 32 channels at 160x160, stride 1
    assert (b1["hin"], b1["ho"], b1["cin"]) == (160, 160, 32)
    assert counts.conv_ops(b1) == 2.0 * 64 * 160 * 160 * 32 * 9
    b2 = dw[1]  # stride 2: 160 -> 80
    assert (b2["hin"], b2["ho"], b2["cin"]) == (160, 80, 64)


def test_mobilenet320_totals():
    """3.128 GFLOP an image: the trunk's 2.32 at 320x320, the extras and the
    six heads; the convolutions' least time at b64 0.820 ms."""
    cfg = registry.config(CONFIG)
    assert counts.forward_ops(cfg) == 3128408064.0
    assert counts.convs_bound_s(cfg, 64) == pytest.approx(0.8199378837e-3, rel=1e-9)
    trunk = [c for c in counts.conv_shapes(cfg, 1) if c["name"].startswith(("stem", "b"))]
    assert sum(counts.conv_ops(c) for c in trunk) / 1e9 == pytest.approx(2.32, abs=0.01)


def test_records_are_the_programs_layers():
    """Every record's channels and kernel are the program's filter at
    ``mobilenet320`` (``models/mobilenet.backbone_shapes``, the heads from
    ``init_params``)."""
    from ssd_tensorflow_tpu_torch.models.ssd_vgg import ModelConfig, init_params

    cfg = registry.config(CONFIG)
    params = init_params(ModelConfig(preset_name="mobilenet320", num_classes=20), 0)
    recs = counts.conv_shapes(cfg, 1)
    assert [c["name"] for c in recs] == [n for n in params if "w" in params[n]]
    for c in recs:
        o, i, kh, kw = params[c["name"]]["w"].shape
        assert (o, i * c["groups"], kh, kw) == (c["cout"], c["cin"], c["k"], c["k"]), c["name"]


def test_the_shipped_bundle_reads_whole():
    cfg = registry.config(CONFIG)
    tree = family.of(cfg).read_int8_bundle(str(hc.ROOT / cfg["weights"]["path"]), cfg)
    assert sum(len(v) for v in tree.values()) == 205
    assert set(tree["b13_dw"]) == {"b", "w_scale", "wq"} and tree["b13_dw"]["wq"].shape == (
        3, 3, 1, 1024)
    other = dict(cfg, model=dict(cfg["model"], num_classes=80))
    with pytest.raises(ValueError, match="holds"):
        family.of(cfg).read_int8_bundle(str(hc.ROOT / cfg["weights"]["path"]), other)


# ---- the reference against the program at mntest64 -------------------------

def _mobilenet(precision: str, weights: dict) -> dict:
    cfg = hc.small_config(CONFIG)
    cfg["precision"], cfg["weights"] = precision, weights
    return cfg


@pytest.fixture(scope="module")
def mobilenet_case(tmp_path_factory):
    """Seeded float weights, the program's int8 bundle of them, and images."""
    cfg = _mobilenet("bfloat16", hc.SEEDED)
    params = family.of(cfg).seeded_params(cfg, 5, CPU)
    path = tmp_path_factory.mktemp("mobilenet") / "mntest64_int8.npz"
    bundle = hc.write_int8_bundle(path, seed=5, config=CONFIG)
    images = pool.images(8, (64, 64), registry.traffic("serve-b64")["augment"], 11, CPU)
    return cfg, params, bundle, images


def test_mobilenet_float_reference_matches_the_program(mobilenet_case):
    """The program's float32 forward (``layers.float_conv_executor``: the
    depthwise convs with their bias inside, GroupNorm's sums in float64)
    against the reference's float32 walk. Both are float32 with TF32 off,
    so they differ by the order of their sums alone: within 1e-5 of the
    largest logit (read: 3.8e-6)."""
    from ssd_tensorflow_tpu_torch.models.ssd_vgg import ModelConfig, apply_model

    cfg, params, _, images = mobilenet_case
    mc = ModelConfig(preset_name="mntest64", num_classes=20, compute_dtype="float32")
    with torch.no_grad():
        logits_p, locs_p = apply_model(params, images, mc)
        logits_r, locs_r = family.of(cfg).serving_forward(cfg, params)(images)
    assert logits_p.shape == logits_r.shape == (8, 116, 21)
    assert float((logits_p - logits_r).abs().max()) <= 1e-5 * float(logits_r.abs().max())
    assert float((locs_p - locs_r).abs().max()) <= 1e-5 * float(locs_r.abs().max())


def _int8_gaps(bundle, images, control: bool):
    from ssd_tensorflow_tpu_torch.inference import InferenceModel
    from ssd_tensorflow_tpu_torch.models import quantized

    model = InferenceModel.from_bundle(bundle, device="cpu")
    with torch.inference_mode():
        result = quantized._forward(model.params, images, model.config)
    icfg = _mobilenet("int8", {"kind": "bundle", "path": bundle})
    with torch.no_grad():
        logits, locs = family.of(icfg).serving_forward(icfg, bundle, control)(images)
    k = icfg["model"]["num_classes"] + 1
    probs_gap = float((result[..., :k] - torch.softmax(logits, -1)).abs().max())
    return probs_gap, float((result[..., k:] - locs).abs().max())


# The program rounds every conv output, each depthwise filter and stencil
# and every GroupNorm to bf16 and quantizes that; the reference keeps
# float32. Through 41 convs the two part where an activation lies near a
# rounding boundary of its int8 grid: over eight seeds (5-12) the program
# read a worst class-probability gap of 0.057-0.091 and a worst offset gap
# of 0.28-0.52 (offsets reach ~4); the int4 control read 0.25-0.36 and
# 1.88-2.73. Both limits are tighter than the ResNet family's 0.25 / 1.5 and
# leave about 1.6x room on each side.
PROBS_GAP, LOCS_GAP = 0.15, 1.0


def test_mobilenet_int8_reference_matches_the_program(mobilenet_case):
    _, _, bundle, images = mobilenet_case
    probs_gap, locs_gap = _int8_gaps(bundle, images, control=False)
    assert probs_gap <= PROBS_GAP and locs_gap <= LOCS_GAP


def test_mobilenet_int4_control_fails(mobilenet_case):
    _, _, bundle, images = mobilenet_case
    probs_gap, locs_gap = _int8_gaps(bundle, images, control=True)
    assert probs_gap > PROBS_GAP or locs_gap > LOCS_GAP


# ---- the cell on the shipped bundle at 320x320, batch 4 ---------------------

def _run(cell=None):
    return harness.run_cell(hc.ROOT, CELL, SEED, 0.5, False, "cpu", cell=cell or hc.cell(CELL))


def test_the_cell_runs_the_shipped_bundle():
    cell = hc.cell(CELL)
    assert cell.config["preset"]["image_size"] == [320, 320]
    assert cell.config["weights"]["path"] == "assets/mobilenet320_int8_qat_minivoc.ssdtpu.npz"
    assert cell.traffic["batch"] == 4 and cell.chips == 1
    assert {m["name"] for m in cell.per_layer} >= {"norm_launches.serve", "depthwise_ms.serve",
                                                   "mfu.serve", "conv_roofline.serve"}
    assert "stem_roofline.serve" not in {m["name"] for m in cell.per_layer}


def test_sound_run_passes():
    assert _run()["correct"] is True


def test_class_altered_where_produced(monkeypatch):
    _class_shift(monkeypatch, 20)
    assert _run()["correct"] is False


def test_half_of_the_batch_left_out(monkeypatch):
    _half_batch(monkeypatch)
    result = _run()
    gap = result["checks"]["top_score_gap"]
    assert result["correct"] is False and gap["value"] > gap["limit"]


def test_best_detection_alone(monkeypatch):
    _top1(monkeypatch)
    result = _run()
    missed = result["checks"]["missed_residual"]
    assert result["correct"] is False and missed["value"] > missed["limit"]


def test_control_a_precision_below_fails():
    cell = hc.cell(CELL)
    got = calibrate.serve_readings(cell, SEED, 0.5, CPU, control=True)
    ok, _ = check.judge(got["control"], cell.limits)
    assert not ok


def test_a_run_loads_neither_jax_nor_the_jax_package(tmp_path):
    code = textwrap.dedent(f"""
        import sys
        sys.path[:0] = [{str(hc.BENCH / 'tests')!r}]
        import conftest  # registers the family's cases
        import h100bench_cases as hc
        from benchlib import harness, nojax
        harness.run_cell(hc.ROOT, {CELL!r}, 11, 0.3, True, "cpu", cell=hc.cell({CELL!r}))
        import reference.ssd_mobilenetv1, calibrate
        print("FORBIDDEN", nojax.forbidden(sys.modules))
    """)
    env = {"PATH": "/usr/bin:/bin", "HOME": str(tmp_path), "TMPDIR": str(tmp_path),
           "OMP_NUM_THREADS": "2"}
    out = subprocess.run([sys.executable, "-c", code], capture_output=True, text=True,
                         cwd=str(hc.ROOT), env=env, timeout=300)
    assert out.returncode == 0, out.stderr[-2000:]
    assert "FORBIDDEN []" in out.stdout


# ---- the readers on hand-written traces ------------------------------------

MAIN, STREAM = 1, 7


def _span(name, ts, end, tid=MAIN):
    return {"ph": "X", "cat": "user_annotation", "name": name, "ts": ts, "dur": end - ts,
            "tid": tid}


def _launch(corr, ts, name="cudaLaunchKernel", tid=MAIN):
    return {"ph": "X", "cat": "cuda_runtime", "name": name, "ts": ts, "dur": 1, "tid": tid,
            "args": {"correlation": corr}}


def _kernel(corr, name, ts, end):
    return {"ph": "X", "cat": "kernel", "name": name, "ts": ts, "dur": end - ts, "tid": STREAM,
            "args": {"correlation": corr}}


def serve_events(kernel):
    """Two forwards of 400 us, each with two GroupNorms (three launches
    inside each: two runtime calls and one driver call) and one depthwise
    conv (its stencil ``kernel`` of 30 us beside a cast), launches outside
    the spans and a launch on another thread."""
    ev = [_span("h100bench.window", 0, 1000)]
    corr = 0
    for t0 in (100, 550):
        ev.append(_span("h100bench.forward", t0, t0 + 400))
        for g in (t0 + 20, t0 + 200):
            ev.append(_span("ssd.group_norm", g, g + 50))
            for j, name in enumerate(("cudaLaunchKernel", "cudaLaunchKernelExC", "cuLaunchKernel")):
                corr += 1
                ev += [_launch(corr, g + 5 + 10 * j, name), _kernel(corr, "elementwise", g + 300,
                                                                      g + 302)]
        ev.append(_span("ssd.depthwise", t0 + 100, t0 + 150))
        corr += 1
        ev += [_launch(corr, t0 + 110), _kernel(corr, kernel, t0 + 120, t0 + 150)]
        corr += 1
        ev += [_launch(corr, t0 + 130), _kernel(corr, "copy_cast", t0 + 150, t0 + 155)]
        corr += 1
        ev += [_launch(corr, t0 + 300), _kernel(corr, "int8_qconv", t0 + 305, t0 + 390)]
        corr += 1
        ev += [_launch(corr, t0 + 30, tid=9), _kernel(corr, "other_thread", t0 + 35, t0 + 36)]
    return ev


def _ctx(events):
    return {"trace": Trace(events), "device_trace": None}


def test_norm_launches_counts_launches_inside_group_norm():
    read = registry.reader("metrics", "norm_launches.serve")
    assert read(_ctx(serve_events("k"))) == 6.0


def test_norm_launches_none_without_spans_or_launches():
    read = registry.reader("metrics", "norm_launches.serve")
    ev = serve_events("k")
    assert read(_ctx([e for e in ev if e["name"] != "ssd.group_norm"])) is None
    assert read(_ctx([e for e in ev if e.get("cat") != "cuda_runtime"])) is None
    assert read({"trace": None, "device_trace": None}) is None


def test_depthwise_ms_is_the_stencils_device_time_a_batch():
    mod = registry.reader("metrics", "depthwise_ms.serve")
    kernels = mod.__globals__["KERNELS"]
    assert all(a == b or a not in b for a in kernels for b in kernels)
    for name in kernels:
        assert mod(_ctx(serve_events(f"void at::{name}_kernel<float>"))) == pytest.approx(0.030)
    assert mod(_ctx(serve_events("unrelated_stencil"))) is None
    assert mod({"trace": None, "device_trace": None}) is None
