"""``correct`` comes out false when the timed path is broken underneath
the harness, and for the lower-precision control, at the test64 preset on
the CPU under the cells' committed limits: the card's look and the
window's length are all that is skipped."""

import h100bench_cases as hc
import pytest
import torch

import calibrate
from benchlib import check, harness

SEED = 2**32 + 5


@pytest.fixture(scope="module")
def bundle(tmp_path_factory):
    return hc.write_int8_bundle(tmp_path_factory.mktemp("bundle") / "test64_int8.npz")


def _run(workload, bundle):
    return harness.run_cell(hc.ROOT, workload, SEED, 0.5, False, "cpu",
                            cell=hc.cell(workload, bundle))


def _class_shift(monkeypatch):
    from ssd_tensorflow_tpu_torch import inference
    from ssd_tensorflow_tpu_torch.ops import postprocess

    decode = postprocess.decode_scores

    def faulty(*args, **kwargs):
        dets = decode(*args, **kwargs)
        dets.classes = torch.where(dets.valid, (dets.classes + 1) % 20, dets.classes)
        return dets

    monkeypatch.setattr(inference, "decode_scores", faulty)
    monkeypatch.setattr(postprocess, "decode_scores", faulty)


def _top1(monkeypatch):
    from ssd_tensorflow_tpu_torch import inference
    from ssd_tensorflow_tpu_torch.ops import postprocess

    decode = postprocess.decode_scores

    def faulty(*args, **kwargs):
        dets = decode(*args, **kwargs)
        dets.valid[:, 1:] = False
        return dets

    monkeypatch.setattr(inference, "decode_scores", faulty)
    monkeypatch.setattr(postprocess, "decode_scores", faulty)


def _half_batch(monkeypatch):
    from ssd_tensorflow_tpu_torch.inference import InferenceModel

    batch = InferenceModel._batch
    monkeypatch.setattr(InferenceModel, "_batch",
                        lambda self, x: batch(self, x)[: max(1, x.shape[0] // 2)])


SERVE = ["vgg512-int8-serve-b64", "vgg512-bf16-serve-b64"]


@pytest.mark.parametrize("workload", SERVE)
def test_class_altered_where_produced(workload, bundle, monkeypatch):
    _class_shift(monkeypatch)
    assert _run(workload, bundle)["correct"] is False


@pytest.mark.parametrize("workload", SERVE)
def test_half_of_the_batch_left_out(workload, bundle, monkeypatch):
    _half_batch(monkeypatch)
    result = _run(workload, bundle)
    gap = result["checks"]["top_score_gap"]
    assert result["correct"] is False and gap["value"] > gap["limit"]


@pytest.mark.parametrize("workload", SERVE)
def test_best_detection_alone(workload, bundle, monkeypatch):
    _top1(monkeypatch)
    result = _run(workload, bundle)
    missed = result["checks"]["missed_residual"]
    assert result["correct"] is False and missed["value"] > missed["limit"]


@pytest.mark.parametrize("workload", SERVE)
def test_control_a_precision_below_fails(workload, bundle):
    cell = hc.cell(workload, bundle)
    got = calibrate.serve_readings(cell, SEED, 0.5, torch.device("cpu"), control=True)
    ok, _ = check.judge(got["control"], cell.limits)
    assert not ok


def _train_fault(monkeypatch, kind):
    from ssd_tensorflow_tpu_torch.parallel import train_step

    make = train_step.make_train_step

    def faulty_make(*args, **kwargs):
        step = make(*args, **kwargs)

        def faulty(state, batch):
            if kind == "unchanged":
                _, losses, dets = step(state, batch)
                return state, losses, dets
            n = next(iter(batch.values())).shape[0] // 2
            return step(state, {k: v[:n] for k, v in batch.items()})

        return faulty

    monkeypatch.setattr(train_step, "make_train_step", faulty_make)


@pytest.mark.parametrize("kind", ["unchanged", "half_batch"])
def test_train_step_faults(kind, monkeypatch):
    _train_fault(monkeypatch, kind)
    result = _run("vgg512-bf16-train-b32", None)
    assert result["correct"] is False


def test_train_learning_rate_ten_percent_high():
    cell = hc.cell("vgg512-bf16-train-b32")
    cell.config["train"]["lr_values"] = [1.1 * v for v in cell.config["train"]["lr_values"]]
    result = harness.run_cell(hc.ROOT, cell.name, SEED, 0.5, False, "cpu", cell=cell)
    gap = result["checks"]["change1_gap"]
    assert result["correct"] is False and gap["value"] > gap["limit"]


def test_train_control_a_precision_below_fails():
    cell = hc.cell("vgg512-bf16-train-b32")
    got = calibrate.train_readings(cell, SEED, torch.device("cpu"), control=True)
    ok, _ = check.judge(got["control"], cell.limits)
    assert not ok


def test_sound_runs_pass(bundle):
    for w in SERVE + ["vgg512-bf16-train-b32"]:
        assert _run(w, bundle)["correct"] is True, w
