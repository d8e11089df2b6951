"""``correct`` comes out false when the timed path is broken underneath
the harness, and for the lower-precision control, at each family's small
preset on the CPU under the cells' committed limits: the card's look and
the window's length are all that is skipped."""

import h100bench_cases as hc
import pytest
import torch

import calibrate
from benchlib import check, harness

SEED = 2**32 + 5


@pytest.fixture(scope="module")
def bundles(tmp_path_factory):
    return hc.write_bundles(tmp_path_factory.mktemp("bundles"))


def _run(workload, bundles):
    return harness.run_cell(hc.ROOT, workload, SEED, 0.5, False, "cpu",
                            cell=hc.cell(workload, bundles))


def _class_shift(monkeypatch, num_classes):
    from ssd_tensorflow_tpu_torch import inference
    from ssd_tensorflow_tpu_torch.ops import postprocess

    decode = postprocess.decode_scores

    def faulty(*args, **kwargs):
        dets = decode(*args, **kwargs)
        dets.classes = torch.where(dets.valid, (dets.classes + 1) % num_classes, dets.classes)
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


SERVE = ["vgg512-int8-serve-b64", "vgg512-bf16-serve-b64", "resnet320-int8-serve-b64"]


@pytest.mark.parametrize("workload", SERVE)
def test_class_altered_where_produced(workload, bundles, monkeypatch):
    _class_shift(monkeypatch, hc.cell(workload, bundles).config["model"]["num_classes"])
    assert _run(workload, bundles)["correct"] is False


@pytest.mark.parametrize("workload", SERVE)
def test_half_of_the_batch_left_out(workload, bundles, monkeypatch):
    _half_batch(monkeypatch)
    result = _run(workload, bundles)
    gap = result["checks"]["top_score_gap"]
    assert result["correct"] is False and gap["value"] > gap["limit"]


@pytest.mark.parametrize("workload", SERVE)
def test_best_detection_alone(workload, bundles, monkeypatch):
    _top1(monkeypatch)
    result = _run(workload, bundles)
    missed = result["checks"]["missed_residual"]
    assert result["correct"] is False and missed["value"] > missed["limit"]


@pytest.mark.parametrize("workload", SERVE)
def test_control_a_precision_below_fails(workload, bundles):
    cell = hc.cell(workload, bundles)
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


def test_sound_runs_pass(bundles):
    for w in SERVE + ["vgg512-bf16-train-b32"]:
        assert _run(w, bundles)["correct"] is True, w
