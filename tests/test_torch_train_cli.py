"""The port's training CLI (``python -m ssd_tensorflow_tpu_torch.cli.train``)
against the JAX package's ``cli/train.py``, on the CPU (``--device cpu``),
test64, float32, ``--num-workers 0`` unless stated.

- Against JAX: both resume for one epoch from the same JAX-written epoch-1
  checkpoint, ``random`` and numpy seeded alike, the steps' detection
  threshold at 0.05 in both (so that mAP counts detections), twice: with
  lr 0 (frozen parameters) and with the default lr. Per-epoch losses within
  1e-5 relative in both; mAP and per-class AP within 1e-6 with lr 0; with
  the default lr, the final parameters' update within the train step's
  bounds (1e-3 of each leaf's largest update, or two ulps of its largest
  parameter), and each package restores the other's ``final.ckpt.npz``.
  The epoch is one step of 8 (the batch size), so that both packages'
  steps start from the same state: chained steps drift apart by float32
  rounding, which can move the hard-negative mining's choice
  (``tests/test_torch_parallel.py``; with 2 steps an epoch, epoch losses
  came 1.9e-5 apart). After a step, the near-untrained model's many
  near-equal scores reorder under ~1e-7 parameter differences, so mAP is
  held with frozen parameters (with the default lr it came 3.8e-5 apart on
  one of three datasets).
- Two gloo processes against one, with the JAX package's
  ``tests/test_multihost_train_cli.py`` construction (the 2-process
  dataset's validation list is a duplicated half, so that each process's
  shard is the single run's list; lr 0): the same steps on every process,
  per-process valid mAP and validation losses equal to the single run's
  (1e-6 relative), training losses equal across processes.
- Stopping, budgets and QAT as the JAX package's ``tests/test_e2e.py``:
  SIGUSR1 stops at an epoch boundary with a resumable final checkpoint;
  ``--epochs-per-run``; ``--qat`` calibrates, stores its scales, exports
  them and resumes with them.
Each multi-process run has its own timeout (``tests/torch_dist_worker.py``).
"""

import io
import json
import os
import pickle
import random
import shutil
import signal
import sys
import threading
from contextlib import redirect_stdout
from pathlib import Path

import numpy as np
import pytest

cv2 = pytest.importorskip("cv2")

import ssd_tensorflow_tpu.cli.train as jax_cli  # noqa: E402
from ssd_tensorflow_tpu.ops.postprocess import DetectionConfig as JaxDetectionConfig  # noqa: E402
from ssd_tensorflow_tpu.presets import get_preset_by_name, preset_to_dict  # noqa: E402
from ssd_tensorflow_tpu.types import Box, Point, Sample, Size  # noqa: E402
from ssd_tensorflow_tpu.utils import checkpoint as jax_ckpt  # noqa: E402
import ssd_tensorflow_tpu_torch.cli.train as port_cli  # noqa: E402
from ssd_tensorflow_tpu_torch.ops.postprocess import DetectionConfig  # noqa: E402
from ssd_tensorflow_tpu_torch.utils.checkpoint import (  # noqa: E402
    checkpoint_config,
    read_leaves,
)

sys.path.insert(0, str(Path(__file__).resolve().parent))
from torch_dist_worker import run_ranks  # noqa: E402


def _make_dataset(root, n_train, n_valid, valid_samples=None, seed=0):
    """A test64 dataset dir like ``tests/test_e2e.py``'s; returns
    ``(data_dir, valid_samples)``."""
    img_dir = os.path.join(root, "images")
    os.makedirs(img_dir, exist_ok=True)
    rng = np.random.default_rng(seed)

    def make_sample(i):
        img = rng.integers(0, 40, (160, 160, 3), dtype=np.uint8)
        cx, cy, s = rng.uniform(0.3, 0.7), rng.uniform(0.3, 0.7), 0.3
        x0, y0 = int((cx - s / 2) * 160), int((cy - s / 2) * 160)
        x1, y1 = int((cx + s / 2) * 160), int((cy + s / 2) * 160)
        img[y0:y1, x0:x1] = (200, 220, 240)
        path = os.path.join(img_dir, f"img{i:03d}.jpg")
        cv2.imwrite(path, img)
        return Sample(path, [Box("square", 0, Point(cx, cy), Size(s, s))], Size(160, 160))

    train = [make_sample(i) for i in range(n_train)]
    if valid_samples is None:
        valid_samples = [make_sample(100 + i) for i in range(n_valid)]
    data_dir = os.path.join(root, "data")
    os.makedirs(data_dir, exist_ok=True)
    with open(os.path.join(data_dir, "train-samples.pkl"), "wb") as f:
        pickle.dump(train, f)
    with open(os.path.join(data_dir, "valid-samples.pkl"), "wb") as f:
        pickle.dump(valid_samples, f)
    with open(os.path.join(data_dir, "training-data.json"), "w") as f:
        json.dump({"preset": preset_to_dict(get_preset_by_name("test64")), "num-classes": 1,
                   "colors": {"square": [0, 0, 255]}, "lid2name": {"0": "square"},
                   "lname2id": {"square": 0},
                   "augmentation": {"sampler_trials": 3, "expand_probability": 0.3}}, f)
    return data_dir, valid_samples


@pytest.fixture(autouse=True)
def _drop_checkpoints(tmp_path):
    """Each test's directory goes after it: a test64 train state is ~200 MB."""
    yield
    shutil.rmtree(tmp_path, ignore_errors=True)


@pytest.fixture(scope="module")
def dataset(tmp_path_factory):
    return _make_dataset(str(tmp_path_factory.mktemp("cli")), 8, 4)[0]


def _tb(tb_dir):
    """tag -> {step: value} of a SummaryWriter dir's scalars."""
    from tensorboard.backend.event_processing.event_file_loader import RawEventFileLoader
    from tensorboard.compat.proto import event_pb2

    out = {}
    for fname in os.listdir(tb_dir):
        for raw in RawEventFileLoader(os.path.join(tb_dir, fname)).Load():
            ev = event_pb2.Event()
            ev.ParseFromString(raw)
            for v in ev.summary.value:
                if v.HasField("simple_value"):
                    out.setdefault(v.tag, {})[ev.step] = v.simple_value
    return out


def _common(name, data_dir, tb, *extra, batch=4):
    return ["--name", str(name), "--data-dir", data_dir, "--batch-size", str(batch),
            "--tensorboard-dir", str(tb), "--num-workers", "0", "--compute-dtype", "float32",
            *extra]


def _port(argv, device=True):
    buf = io.StringIO()
    with redirect_stdout(buf):
        rc = port_cli.main(list(argv) + (["--device", "cpu"] if device else []))
    return rc, buf.getvalue()


def test_cli_epoch_matches_jax_from_a_jax_checkpoint(dataset, tmp_path, monkeypatch):
    pytest.importorskip("tensorboard")
    monkeypatch.setattr(jax_cli, "DetectionConfig",
                        lambda **kw: JaxDetectionConfig(**dict(kw, confidence_threshold=0.05)))
    monkeypatch.setattr(port_cli, "DetectionConfig",
                        lambda **kw: DetectionConfig(**dict(kw, confidence_threshold=0.05)))
    first = tmp_path / "first"
    random.seed(5)
    np.random.seed(5)
    with redirect_stdout(io.StringIO()):
        assert jax_cli.main(_common(first, dataset, tmp_path / "tb0", "--epochs", "1",
                                    "--checkpoint-interval", "1", batch=8)) == 0
    for run, lr in enumerate(("0;0", "0.00075;0.0001")):
        runs = {}
        for pkg, main in (("jax", jax_cli.main), ("port", None)):
            proj = tmp_path / f"{pkg}{run}"
            os.makedirs(proj)
            shutil.copy(first / "e1.ckpt.npz", proj / "e1.ckpt.npz")
            argv = _common(proj, dataset, tmp_path / f"tb_{pkg}{run}", "--epochs", "2",
                           "--checkpoint-interval", "10", "--continue-training", "yes",
                           "--lr-values", lr, "--lr-boundaries", "100", batch=8)
            random.seed(11)
            np.random.seed(11)
            if main is None:
                rc, log = _port(argv)
            else:
                with redirect_stdout(io.StringIO()):
                    rc = main(argv)
            assert rc == 0
            runs[pkg] = _tb(str(tmp_path / f"tb_{pkg}{run}"))
        got, want = runs["port"], runs["jax"]
        assert sorted(got) == sorted(want)
        for tag in want:
            for step, v in want[tag].items():
                if tag.endswith("_loss"):
                    assert abs(got[tag][step] - v) <= 1e-5 * abs(v), (lr, tag, step)
                elif lr == "0;0":  # mAP and per-class AP
                    assert abs(got[tag][step] - v) <= 1e-6, (lr, tag, step)
        assert want["validation_mAP"][2] > 0 and want["training_mAP"][2] > 0

    # the final parameters, and each package restoring the other's
    (_, base), (_, pf), (_, jf) = (read_leaves(str(p)) for p in (
        first / "e1.ckpt.npz", tmp_path / "port1" / "final.ckpt.npz",
        tmp_path / "jax1" / "final.ckpt.npz"))
    n = (len(base) - 2) // 2
    for i in range(n):  # the parameter leaves
        want_u, got_u = jf[i] - base[i], pf[i] - base[i]
        tol = max(1e-3 * float(np.abs(want_u).max()), 2.0 ** -22 * float(np.abs(base[i]).max()))
        assert float(np.abs(got_u - want_u).max()) <= tol, i
    assert [int(pf[-2]), int(pf[-1])] == [int(jf[-2]), int(jf[-1])] == [2, 2]
    assert checkpoint_config(str(tmp_path / "port1" / "final.ckpt.npz"))["epoch"] == 2

    import jax

    from ssd_tensorflow_tpu.models.ssd_vgg import ModelConfig as JaxModelConfig, init_params
    from ssd_tensorflow_tpu.parallel.train_step import TrainConfig as JaxTrainConfig
    from ssd_tensorflow_tpu.parallel.train_step import make_train_state as jax_state
    from ssd_tensorflow_tpu_torch.models.ssd_vgg import ModelConfig, init_params as port_init
    from ssd_tensorflow_tpu_torch.parallel.train_step import TrainConfig, make_train_state
    from ssd_tensorflow_tpu_torch.utils.checkpoint import restore_checkpoint, train_state_to_jax

    jcfg = JaxTrainConfig(model=JaxModelConfig(preset_name="test64", num_classes=1,
                                               compute_dtype="float32"))
    js = jax_ckpt.restore_checkpoint(str(tmp_path / "port1" / "final.ckpt.npz"),
                                     jax_state(init_params(jax.random.PRNGKey(1), jcfg.model),
                                               jcfg))
    flat = [np.asarray(x) for x in jax.tree_util.tree_leaves(js)]
    assert all(np.array_equal(a, b) for a, b in zip(flat, pf)) and len(flat) == len(pf)
    tcfg = TrainConfig(model=ModelConfig(preset_name="test64", num_classes=1,
                                         compute_dtype="float32"))
    ps = train_state_to_jax(restore_checkpoint(
        str(tmp_path / "jax1" / "final.ckpt.npz"),
        make_train_state(port_init(tcfg.model, seed=1), tcfg, device="cpu")))
    names = [(a, b) for a in sorted(ps["params"]) for b in sorted(ps["params"][a])]
    assert all(np.array_equal(ps["params"][a][b], jf[i]) for i, (a, b) in enumerate(names))
    assert int(ps["step"]) == 2


def test_cli_two_processes_match_one(tmp_path):
    pytest.importorskip("tensorboard")
    data_single, valid_half = _make_dataset(str(tmp_path / "one"), 16, 4, seed=7)
    data_double, _ = _make_dataset(str(tmp_path / "two"), 16, 4, valid_samples=valid_half * 2,
                                   seed=7)
    common = ["--epochs", "2", "--batch-size", "8", "--checkpoint-interval", "2",
              "--num-workers", "0", "--compute-dtype", "float32", "--lr-values", "0;0",
              "--lr-boundaries", "100", "--device", "cpu"]
    run_ranks("cli", 2, {"argv": ["--name", str(tmp_path / "proj2"), "--data-dir", data_double,
                                  "--tensorboard-dir", str(tmp_path / "tb{rank}"), *common],
                         "out": str(tmp_path / "res{rank}.json")}, timeout=300)
    res = [json.loads((tmp_path / f"res{r}.json").read_text()) for r in range(2)]
    assert all(r["rc"] == 0 and r["world"] == 2 and r["local_train_samples"] == 8 for r in res)
    # 2 epochs x (train: 8 local samples / 4 local rows = 2, valid: 1)
    assert res[0]["batch_counts"] == res[1]["batch_counts"] == [2, 1, 2, 1]
    assert res[0]["valid_maps"] == res[1]["valid_maps"] and len(res[0]["valid_maps"]) == 1
    assert os.path.exists(tmp_path / "proj2" / "final.ckpt.npz")  # rank 0 wrote it

    rc, log = _port(["--name", str(tmp_path / "proj1"), "--data-dir", data_single,
                     "--tensorboard-dir", str(tmp_path / "tb_single"), *common], device=False)
    assert rc == 0
    tb = [_tb(str(tmp_path / f"tb{r}")) for r in range(2)]
    single = _tb(str(tmp_path / "tb_single"))
    for tag in ("validation_total_loss", "validation_confidence_loss",
                "validation_localization_loss", "validation_mAP"):
        for step in single[tag]:
            v = single[tag][step]
            assert tb[0][tag][step] == tb[1][tag][step], (tag, step)
            assert abs(tb[0][tag][step] - v) <= 1e-6 * max(abs(v), 1e-6), (tag, step)
    for step in (1, 2):
        assert tb[0]["training_total_loss"][step] == tb[1]["training_total_loss"][step]


def test_cli_signal_stops_at_an_epoch_boundary(dataset, tmp_path):
    name = tmp_path / "proj-sig"
    first_ckpt = name / "e1.ckpt.npz"
    stop_watcher = threading.Event()

    def fire_when_training_started():
        while not stop_watcher.wait(0.05):
            if first_ckpt.exists():
                os.kill(os.getpid(), signal.SIGUSR1)
                return

    watcher = threading.Thread(target=fire_when_training_started)
    watcher.start()
    try:
        rc, _ = _port(_common(name, dataset, tmp_path / "tb", "--epochs", "40",
                              "--checkpoint-interval", "1"))
    finally:
        stop_watcher.set()
        watcher.join(timeout=30)
        signal.signal(signal.SIGUSR1, signal.SIG_DFL)
        signal.signal(signal.SIGTERM, signal.SIG_DFL)
    assert rc == 0 and not watcher.is_alive()
    final = str(name / "final.ckpt.npz")
    reached = checkpoint_config(final).get("epoch")
    assert reached is not None and 1 <= reached < 40
    rc, _ = _port(_common(name, dataset, tmp_path / "tb", "--epochs", str(reached + 1),
                          "--checkpoint-interval", "5", "--continue-training", "yes"))
    assert rc == 0 and checkpoint_config(final).get("epoch") == reached + 1


def test_cli_epochs_per_run(dataset, tmp_path):
    """The first run goes through ``python -m`` in a child process (with a
    timeout) and forks the shared-memory workers there, away from this
    process's threads."""
    import subprocess

    name = tmp_path / "proj-seg"
    common = _common(name, dataset, tmp_path / "tb", "--epochs", "3",
                     "--checkpoint-interval", "10", "--epochs-per-run", "2", "--device", "cpu")
    i = common.index("--num-workers")
    env = {k: v for k, v in os.environ.items() if k not in ("JAX_PLATFORMS", "XLA_FLAGS")}
    env.update(PYTHONPATH=str(Path(__file__).resolve().parent.parent) + os.pathsep
               + env.get("PYTHONPATH", ""), OMP_NUM_THREADS="2")
    proc = subprocess.run([sys.executable, "-m", "ssd_tensorflow_tpu_torch.cli.train",
                           *common[:i + 1], "2", *common[i + 2:]], env=env, cwd=str(tmp_path),
                          capture_output=True, text=True, timeout=300)
    assert proc.returncode == 0, proc.stdout[-3000:] + proc.stderr[-3000:]
    assert "Per-process epoch budget reached (2)" in proc.stdout
    final = str(name / "final.ckpt.npz")
    assert checkpoint_config(final).get("epoch") == 2
    rc, _ = _port(common + ["--continue-training", "yes"], device=False)
    assert rc == 0 and checkpoint_config(final).get("epoch") == 3


def test_cli_qat_stores_exports_and_resumes_its_scales(dataset, tmp_path):
    from ssd_tensorflow_tpu_torch.models import qat

    name = tmp_path / "proj-qat"
    rc, log = _port(["--name", str(name), "--data-dir", dataset, "--epochs", "2",
                     "--batch-size", "4", "--tensorboard-dir", str(tmp_path / "tb"),
                     "--checkpoint-interval", "2", "--num-workers", "0", "--qat", "yes"])
    assert rc == 0 and "calibrating int8 scales" in log
    ckpt = str(name / "final.ckpt.npz")
    scales = checkpoint_config(ckpt).get("qat_act_scales")
    assert scales and "conv1_1" in scales
    assert checkpoint_config(ckpt)["model"]["l2_norm_eps"] == 1e-3
    assert checkpoint_config(ckpt)["model"]["compute_dtype"] == "float32"
    act_scales = qat.export_int8_bundle(ckpt, str(tmp_path / "qat.ssdtpu.npz"), device="cpu")
    assert act_scales == scales
    rc, log = _port(["--name", str(name), "--data-dir", dataset, "--epochs", "3",
                     "--batch-size", "4", "--tensorboard-dir", str(tmp_path / "tb"),
                     "--checkpoint-interval", "3", "--num-workers", "0", "--qat", "yes",
                     "--continue-training", "yes"])
    assert rc == 0 and "resuming with the checkpoint's activation scales" in log
    assert checkpoint_config(ckpt).get("qat_act_scales") == scales


def test_cli_device_augment_and_profile_dir(dataset, tmp_path):
    rc, log = _port(_common(tmp_path / "proj-da", dataset, tmp_path / "tb", "--epochs", "2",
                            "--checkpoint-interval", "2", "--device-augment", "yes",
                            "--profile-dir", str(tmp_path / "prof")))
    assert rc == 0 and "On-device augmentation" in log
    assert os.path.exists(tmp_path / "proj-da" / "final.ckpt.npz")
    trace = json.loads((tmp_path / "prof" / "trace.json").read_text())
    assert trace["traceEvents"]


@pytest.mark.parametrize("flag", [["--checkpoint-backend", "orbax"], ["--profiler-port", "9012"]])
def test_cli_refuses_what_it_has_no_counterpart_for(dataset, tmp_path, flag):
    rc, log = _port(_common(tmp_path / "p", dataset, tmp_path / "tb", "--epochs", "1", *flag))
    assert rc == 1 and "ROADMAP.md queue 1 item 11" in log


def test_cli_defaults_to_cuda(dataset, tmp_path):
    import torch

    if torch.cuda.is_available():
        pytest.skip("a GPU is present; the no-CUDA error cannot occur")
    with pytest.raises(RuntimeError, match="cuda"):
        _port(_common(tmp_path / "p", dataset, tmp_path / "tb", "--epochs", "1"), device=False)


def test_cli_continue_without_a_checkpoint_fails(dataset, tmp_path):
    rc, log = _port(_common(tmp_path / "none", dataset, tmp_path / "tb", "--epochs", "1",
                            "--continue-training", "yes"))
    assert rc == 1 and "No network state found" in log
