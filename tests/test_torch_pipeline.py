"""The port's host data pipeline, mAP and summaries against the JAX
package's, on the CPU: ``data/{pipeline,transforms,shm_queue}.py``,
``eval/average_precision.py``, ``utils/{tensorboard,summaries}.py``.

The dataset is written as ``tests/test_e2e.py`` writes it: JPEGs and the
JAX package's pickled ``Sample`` lists (test64, one class). Both pipelines
draw from Python's ``random`` and numpy's global generator, seeded alike
before each run, and call OpenCV alike, so that their batches are equal
bit for bit (valid always, train at ``num_workers=0``). The forked worker
paths are run in a child process with a timeout of its own, as is the
shared-memory consumer's supervision: workers killed once are replaced and
every sample still arrives once; workers killed again and again, or all
leaving with chunks pending (where the JAX package's consumer waits for
ever), make it raise. mAP equals JAX's within 1e-12; the event writer's
records decode to the same values.
"""

import json
import os
import pickle
import random
import subprocess
import sys
import textwrap
from pathlib import Path

import numpy as np
import pytest

cv2 = pytest.importorskip("cv2")

from ssd_tensorflow_tpu.data import pipeline as jax_pipeline  # noqa: E402
from ssd_tensorflow_tpu.data import transforms as jax_transforms  # noqa: E402
from ssd_tensorflow_tpu.eval import average_precision as jax_ap  # noqa: E402
from ssd_tensorflow_tpu.presets import get_preset_by_name, preset_to_dict  # noqa: E402
from ssd_tensorflow_tpu.types import Box as JBox, Point as JPoint, Sample  # noqa: E402
from ssd_tensorflow_tpu.types import Size as JSize  # noqa: E402
from ssd_tensorflow_tpu.utils import summaries as jax_summaries  # noqa: E402
from ssd_tensorflow_tpu.utils import tensorboard as jax_tb  # noqa: E402
from ssd_tensorflow_tpu_torch import types as port_types  # noqa: E402
from ssd_tensorflow_tpu_torch.data import pipeline, transforms  # noqa: E402
from ssd_tensorflow_tpu_torch.eval import average_precision as port_ap  # noqa: E402
from ssd_tensorflow_tpu_torch.utils import summaries as port_summaries  # noqa: E402
from ssd_tensorflow_tpu_torch.utils import tensorboard as port_tb  # noqa: E402

ROOT = Path(__file__).resolve().parent.parent


@pytest.fixture(scope="module")
def dataset(tmp_path_factory):
    """Bright squares on dark 160 x 160 JPEGs, one or two per image; 8
    train and 4 valid samples."""
    root = tmp_path_factory.mktemp("pipe")
    img_dir = root / "images"
    os.makedirs(img_dir)
    rng = np.random.default_rng(0)
    samples = []
    for i in range(12):
        img = rng.integers(0, 40, (160, 160, 3), dtype=np.uint8)
        boxes = []
        for _ in range(1 + i % 2):
            cx, cy, s = rng.uniform(0.3, 0.7), rng.uniform(0.3, 0.7), rng.uniform(0.2, 0.4)
            x0, y0 = int((cx - s / 2) * 160), int((cy - s / 2) * 160)
            x1, y1 = int((cx + s / 2) * 160), int((cy + s / 2) * 160)
            img[y0:y1, x0:x1] = (200, 220, 240)
            boxes.append(JBox("square", 0, JPoint(cx, cy), JSize(s, s)))
        path = str(img_dir / f"img{i:03d}.jpg")
        cv2.imwrite(path, img)
        samples.append(Sample(path, boxes, JSize(160, 160)))
    data_dir = root / "data"
    os.makedirs(data_dir)
    with open(data_dir / "train-samples.pkl", "wb") as f:
        pickle.dump(samples[:8], f)
    with open(data_dir / "valid-samples.pkl", "wb") as f:
        pickle.dump(samples[8:], f)
    with open(data_dir / "training-data.json", "w") as f:
        json.dump({"preset": preset_to_dict(get_preset_by_name("test64")), "num-classes": 1,
                   "colors": {"square": [0, 0, 255]}, "lid2name": {"0": "square"},
                   "lname2id": {"square": 0},
                   "augmentation": {"sampler_trials": 3, "expand_probability": 0.3}}, f)
    return str(data_dir), samples


def _seeded(gen_fn, seed=7):
    random.seed(seed)
    np.random.seed(seed)
    return list(gen_fn())


def _assert_batches_equal(got, want):
    assert len(got) == len(want)
    for (gb, gl, gn), (wb, wl, wn) in zip(got, want):
        assert gn == wn and sorted(gb) == sorted(wb)
        for k in wb:
            assert gb[k].dtype == wb[k].dtype
            np.testing.assert_array_equal(gb[k], wb[k], err_msg=k)
        assert [list(map(tuple, b)) for b in gl] == [list(map(tuple, b)) for b in wl]


def test_valid_batches_equal_jax(dataset):
    data_dir, _ = dataset
    got = _seeded(lambda: pipeline.TrainingData(data_dir).valid_generator(3))
    want = _seeded(lambda: jax_pipeline.TrainingData(data_dir).valid_generator(3))
    _assert_batches_equal(got, want)
    assert got[-1][2] == 1  # the last, partial batch keeps its padding


@pytest.mark.parametrize("raw", [False, True])
def test_train_batches_equal_jax_serial(dataset, raw):
    data_dir, _ = dataset
    for seed in (7, 8):
        got = _seeded(lambda: pipeline.TrainingData(data_dir).train_generator(4, raw=raw), seed)
        want = _seeded(lambda: jax_pipeline.TrainingData(data_dir).train_generator(4, raw=raw),
                       seed)
        _assert_batches_equal(got, want)


def test_training_data_metadata_and_types(dataset):
    data_dir, samples = dataset
    td, jtd = pipeline.TrainingData(data_dir), jax_pipeline.TrainingData(data_dir)
    for attr in ("num_classes", "label_colors", "lid2name", "lname2id", "augmentation",
                 "num_train", "num_valid"):
        assert getattr(td, attr) == getattr(jtd, attr), attr
    assert td.preset.name == jtd.preset.name and td.preset.num_anchors == jtd.preset.num_anchors
    assert td.num_train_batches(3) == jtd.num_train_batches(3) == 2
    assert td.num_valid_batches(3) == jtd.num_valid_batches(3) == 2
    s = td.train_samples[0]
    assert type(s) is port_types.Sample and type(s.boxes[0]) is port_types.Box
    assert type(s.boxes[0].center) is port_types.Point and type(s.imgsize) is port_types.Size
    assert td.train_samples == samples[:8]  # equal as tuples


def _run_py(code: str, timeout: float = 120.0) -> str:
    """Run ``code`` in a child Python (the repository on its path, ``jax``
    and the JAX package blocked); returns its output, fails on a non-zero
    exit or the timeout."""
    env = {k: v for k, v in os.environ.items() if k not in ("JAX_PLATFORMS", "XLA_FLAGS")}
    env.update(PYTHONPATH=str(ROOT) + os.pathsep + env.get("PYTHONPATH", ""),
               OMP_NUM_THREADS="1")
    head = ("import sys; sys.modules['jax'] = None; sys.modules['ssd_tensorflow_tpu'] = None\n")
    proc = subprocess.run([sys.executable, "-c", head + textwrap.dedent(code)], cwd=str(ROOT),
                          env=env, capture_output=True, text=True, timeout=timeout)
    assert proc.returncode == 0, proc.stdout[-3000:] + proc.stderr[-3000:]
    return proc.stdout


def test_jax_pickles_load_with_jax_blocked(dataset):
    data_dir, samples = dataset
    out = _run_py(f"""
        import json
        from ssd_tensorflow_tpu_torch.data.pipeline import TrainingData
        from ssd_tensorflow_tpu_torch import types
        td = TrainingData({data_dir!r})
        s = td.valid_samples[0]
        assert type(s) is types.Sample and type(s.boxes[0]) is types.Box
        assert not any(k == 'jax' or k.startswith(('jax.', 'ssd_tensorflow_tpu.'))
                       for k, v in sys.modules.items() if v is not None)
        print(json.dumps([list(map(tuple, x.boxes)) for x in td.valid_samples]))
    """)
    got = json.loads(out.strip().splitlines()[-1])
    want = json.loads(json.dumps([list(map(tuple, x.boxes)) for x in samples[8:]]))
    assert got == want


def test_unexpected_pickled_type_is_refused(tmp_path):
    path = tmp_path / "x.pkl"
    path.write_bytes(pickle.dumps(JBox("a", 0, JPoint(0.5, 0.5), JSize(0.1, 0.1))))
    assert pipeline.load_samples(str(path)) == port_types.Box("a", 0, port_types.Point(0.5, 0.5),
                                                                port_types.Size(0.1, 0.1))
    bad = pickle.dumps(JBox("a", 0, JPoint(0.5, 0.5), JSize(0.1, 0.1))).replace(
        b"Box", b"Xox")
    path.write_bytes(bad)
    with pytest.raises(pickle.UnpicklingError, match="Xox"):
        pipeline.load_samples(str(path))


#: a child's pipeline, slowed to 0.2 s a sample in the workers so that
#: killing them loses work, and the consumer's checks every 0.5 s
_SLOW_PIPELINE = """
    import json, os, random, signal, time, multiprocessing as mp
    import numpy as np
    from ssd_tensorflow_tpu_torch.data import pipeline
    pipeline.POLL_SECONDS = 0.5
    call = pipeline._SampleProcessor.__call__
    def slow(self, sample):
        time.sleep(0.2)
        return call(self, sample)
    pipeline._SampleProcessor.__call__ = slow
    td = pipeline.TrainingData({data_dir!r})
    def kill_all():
        for p in mp.active_children():
            os.kill(p.pid, signal.SIGKILL)
"""


@pytest.mark.parametrize("use_shm", [True, False])
def test_workers_deliver_every_sample_once(dataset, use_shm):
    data_dir, _ = dataset
    out = _run_py(f"""
        import json, random
        import numpy as np
        from ssd_tensorflow_tpu_torch.data.pipeline import TrainingData
        td = TrainingData({data_dir!r})
        serial = list(td.valid_generator(2))
        pooled = list(td.valid_generator(2, num_workers=2, use_shm={use_shm}))
        assert len(pooled) == len(serial)
        if {use_shm}:
            # the shared-memory transport yields batches as workers finish
            # them, as the JAX package's does: compare them in one order
            key = lambda item: (repr(item[1]), item[0]["images"].tobytes())
            pooled.sort(key=key)
            serial.sort(key=key)
        for (a, la, na), (b, lb, nb) in zip(pooled, serial):
            assert na == nb and la == lb
            assert all(np.array_equal(a[k], b[k]) for k in b)
        random.seed(3)
        raw = [g for _, gl, _ in td.train_generator(1, num_workers=2, use_shm={use_shm}, raw=True)
               for g in gl]
        print(json.dumps(sorted(tuple(map(tuple, g)) for g in raw)))
    """)
    got = json.loads(out.strip().splitlines()[-1])
    want = json.loads(json.dumps(sorted(
        tuple(tuple(b) for b in s.boxes) for s in pipeline.TrainingData(data_dir).train_samples)))
    assert got == want


def test_shm_consumer_recovers_from_killed_workers(dataset):
    data_dir, _ = dataset
    out = _run_py(_SLOW_PIPELINE.format(data_dir=data_dir) + """
    seen = []
    for i, (batch, gt, n) in enumerate(td.train_generator(1, num_workers=2, raw=True)):
        seen.append(tuple(map(tuple, gt[0])))
        if i == 0:
            kill_all()
    assert len(seen) == 8 and len(set(seen)) == len(set(tuple(map(tuple, s.boxes))
                                                          for s in td.train_samples))
    print("recovered")
    """)
    assert "worker(s) died" in out and "recovered" in out


def test_shm_consumer_gives_up_when_workers_keep_dying(dataset):
    data_dir, _ = dataset
    out = _run_py(_SLOW_PIPELINE.format(data_dir=data_dir) + """
    import threading
    stop = threading.Event()
    def killer():
        while not stop.wait(0.05):
            kill_all()
    threading.Thread(target=killer, daemon=True).start()
    try:
        list(td.train_generator(1, num_workers=2, raw=True))
    except RuntimeError as e:
        print("raised:", e)
    finally:
        stop.set()
    """, timeout=120)
    assert "raised:" in out and "giving up" in out


def test_shm_consumer_raises_when_every_worker_leaves_chunks_pending(dataset):
    """Every worker exits 0 with chunks still pending (the JAX package's
    consumer polls for ever there): the port's re-queues them to new
    workers, then raises once they too leave."""
    data_dir, _ = dataset
    out = _run_py(_SLOW_PIPELINE.format(data_dir=data_dir) + """
    pipeline._shm_producer = lambda *args: None  # leaves at once, exit code 0
    try:
        list(td.train_generator(1, num_workers=2, raw=True))
    except RuntimeError as e:
        print("raised:", e)
    """, timeout=120)
    assert "raised:" in out and "undelivered" in out and "left early" in out


def test_decode_cache_keeps_the_batches(dataset):
    data_dir, _ = dataset
    want = _seeded(lambda: pipeline.TrainingData(data_dir).valid_generator(4))
    transforms.enable_decode_cache(True)
    try:
        for _ in range(2):
            got = _seeded(lambda: pipeline.TrainingData(data_dir).valid_generator(4))
            _assert_batches_equal(got, want)
        assert len(transforms._DECODE_CACHE) == 4
    finally:
        transforms.enable_decode_cache(False)
    assert not transforms._DECODE_CACHE


def test_label_creator_matches_jax(dataset):
    data_dir, samples = dataset
    preset = get_preset_by_name("test64")
    from ssd_tensorflow_tpu_torch.presets import get_preset_by_name as port_preset

    want = jax_transforms.LabelCreatorTransform(preset=preset, num_classes=1)(None, None,
                                                                              samples[1])[1]
    sample = pipeline.TrainingData(data_dir).train_samples[1]
    got = transforms.LabelCreatorTransform(preset=port_preset("test64"), num_classes=1)(
        None, None, sample)[1]
    assert got.shape == want.shape == (372, 6)
    # all equal but the log columns (ROADMAP.md §3: XLA's float32 log)
    np.testing.assert_array_equal(got[:, :4], np.asarray(want)[:, :4])
    np.testing.assert_allclose(got, np.asarray(want), atol=1e-6)


# -- mAP --------------------------------------------------------------------


def _ap_inputs(seed, n_images=20, labels=("a", "b", "c")):
    rng = np.random.default_rng(seed)
    images = []
    for _ in range(n_images):
        gts, dets = [], []
        for _ in range(rng.integers(0, 5)):
            lid = int(rng.integers(0, len(labels)))
            w, h = rng.uniform(0.05, 0.5, 2)
            cx, cy = rng.uniform(w / 2, 1 - w / 2), rng.uniform(h / 2, 1 - h / 2)
            gts.append((labels[lid], lid, (cx, cy), (w, h)))
            if rng.uniform() < 0.8:  # a detection near it
                j = rng.normal(0, 0.02, 4)
                dets.append((float(rng.uniform(0.1, 1)),
                             (labels[lid], lid, (cx + j[0], cy + j[1]), (w + j[2], h + j[3]))))
        for _ in range(rng.integers(0, 4)):  # false positives
            lid = int(rng.integers(0, len(labels)))
            w, h = rng.uniform(0.05, 0.5, 2)
            dets.append((float(rng.uniform(0, 1)),
                         (labels[lid], lid, tuple(rng.uniform(0.2, 0.8, 2)), (w, h))))
        images.append((gts, dets))
    return images


def _ap_of(mod, box, point, size, images):
    calc = mod.APCalculator()
    mk = lambda t: box(t[0], t[1], point(*t[2]), size(*t[3]))  # noqa: E731
    for gts, dets in images:
        calc.add_detections([mk(g) for g in gts], [(c, mk(d)) for c, d in dets])
    aps = calc.compute_aps()
    return aps, mod.APs2mAP(aps)


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_ap_calculator_matches_jax(seed):
    images = _ap_inputs(seed)
    got, got_map = _ap_of(port_ap, port_types.Box, port_types.Point, port_types.Size, images)
    want, want_map = _ap_of(jax_ap, JBox, JPoint, JSize, images)
    assert sorted(got) == sorted(want) and len(got) == 3
    for k in want:
        assert abs(got[k] - want[k]) <= 1e-12, k
    assert abs(got_map - want_map) <= 1e-12 and 0 < got_map < 1
    assert port_ap.APs2mAP({}) == jax_ap.APs2mAP({}) == 0


# -- TensorBoard --------------------------------------------------------------


def _events(logdir):
    """Every event of a log dir as ``(step, tag, kind, value)`` rows, the
    wall time left out."""
    from tensorboard.backend.event_processing.event_file_loader import RawEventFileLoader
    from tensorboard.compat.proto import event_pb2

    rows = []
    for fname in sorted(os.listdir(logdir)):
        for raw in RawEventFileLoader(os.path.join(logdir, fname)).Load():
            ev = event_pb2.Event()
            ev.ParseFromString(raw)
            if ev.file_version:
                rows.append((ev.step, "", "version", ev.file_version))
            for v in ev.summary.value:
                if v.HasField("simple_value"):
                    rows.append((ev.step, v.tag, "scalar", v.simple_value))
                elif v.HasField("histo"):
                    h = v.histo
                    rows.append((ev.step, v.tag, "histo", (h.min, h.max, h.num, h.sum,
                                                             h.sum_squares, list(h.bucket_limit),
                                                             list(h.bucket))))
                elif v.HasField("image"):
                    rows.append((ev.step, v.tag, "image", (v.image.height, v.image.width,
                                                             v.image.encoded_image_string)))
    return rows


def _write_summaries(tb, summaries, box, point, size, logdir, params):
    writer = tb.SummaryWriter(logdir)
    writer.add_scalar("x", 1.25, 3)
    writer.add_histogram("h", np.linspace(-1, 2, 101), 4)
    writer.add_image("img", np.arange(2 * 3 * 3, dtype=np.uint8).reshape(2, 3, 3) * 10, 5)
    loss = summaries.LossSummary(writer, "training", 8)
    loss.add({"total": 3.0, "localization": 1.0, "confidence": 1.5, "l2": 0.5}, 4)
    loss.add({"total": 2.0, "localization": 0.5, "confidence": 1.0, "l2": 0.5}, 2)
    loss.push(1)
    summaries.PrecisionSummary(writer, "validation", ["a", "b"]).push(1, 0.5, {"a": 0.25,
                                                                               "b": 0.75})
    summaries.NetSummary(writer).push(1, params)
    summaries.ImageSummary(writer, "training", {"a": (0, 0, 255)}).push(
        1, [(np.full((20, 30, 3), 90, np.uint8),
             [(0.9, box("a", 0, point(0.5, 0.5), size(0.4, 0.3)))])])
    writer.flush()
    writer.close()


def test_tensorboard_records_match_jax(tmp_path):
    pytest.importorskip("tensorboard")
    rng = np.random.default_rng(5)
    params = {"conv1_1": {"w": rng.normal(size=(3, 3, 3, 4)).astype(np.float32),
                          "b": np.zeros(4, np.float32)},
              "l2_norm_conv4_3": {"scale": np.full(4, 20.0, np.float32)}}
    _write_summaries(port_tb, port_summaries, port_types.Box, port_types.Point, port_types.Size,
                     str(tmp_path / "port"), params)
    _write_summaries(jax_tb, jax_summaries, JBox, JPoint, JSize, str(tmp_path / "jax"), params)
    got, want = _events(str(tmp_path / "port")), _events(str(tmp_path / "jax"))
    assert got == want
    kinds = {r[2] for r in got}
    assert kinds == {"version", "scalar", "histo", "image"}
    assert ("training_total_loss" in {r[1] for r in got}
            and "filters/conv1_1" in {r[1] for r in got})


def test_png_is_skipped_without_an_encoder(tmp_path, monkeypatch):
    monkeypatch.setitem(sys.modules, "cv2", None)
    monkeypatch.setitem(sys.modules, "PIL", None)
    assert port_tb._encode_png(np.zeros((2, 2, 3), np.uint8)) is None
    writer = port_tb.SummaryWriter(str(tmp_path))
    writer.add_image("img", np.zeros((2, 2, 3), np.uint8), 1)
    writer.close()
    port_summaries.ImageSummary(writer, "t", {}).push(1, [(np.zeros((4, 4, 3)), [])])
