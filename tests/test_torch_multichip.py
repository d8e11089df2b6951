"""The port's multi-process paths against one process and against the JAX
package, on the CPU: data-parallel serving (``InferenceModel(mesh=...)``
and the serving CLIs' ``--data-parallel N``), tensor parallelism of
conv6 / conv7 (``make_mesh(model=2)``, ``shard_state(tensor_parallel=
True)``, ``parallel/tensor_parallel.py``) and the multichip dry run
(``multichip.dryrun_multichip``).

Multi-process runs are real gloo groups started as ``torchrun`` would
(``tests/torch_dist_worker.py``), each launch with its own timeout.
Tolerances:
- data-parallel serving on 2 ranks (test64 float32, rtest64 int8 from a
  ``QuantizedModel``'s q-params): the detections and ``run``'s result
  equal one process's exactly on every rank; against the JAX package's
  ``InferenceModel`` on a 2-device mesh, classes and ``valid`` equal,
  scores within 1e-5 and boxes within 1e-5, but for at most 0.1 % of the
  coordinates, which may sit one pixel of the 1000-pixel canvas the decode
  truncates them to apart (test64 float32: 2 of 4,800 were found so, the
  float32 bound of ``tests/test_torch_serving_facade.py``: a 1e-6 offset
  moves a corner across a pixel edge); the rtest64 int8
  forward drifts from JAX's by its GroupNorms' summation order (ROADMAP
  section 3), so there the detections of conf >= 0.1 are matched both
  ways by class with IoU >= 0.95 and conf within 0.02, the families'
  bound in ``tests/test_torch_quantized_families.py``;
- the CLIs on 2 ranks: the same files, bytes for bytes, and the same AP
  lines as one process with ``--data-parallel 0``;
- tensor parallelism on 4 ranks (data 2 x model 2), test64 float32, each
  step from a common state: against one process, each loss within 1e-6
  relative and each parameter's update within 1e-6 of that leaf's largest
  update (or two ulps of its largest parameter, the resolution of a
  difference of two float32 parameters: ``tests/test_torch_parallel.py``'s
  bound), and each momentum leaf's likewise, but for the VGG trunk's
  below conv6 within 2e-6 (their update is the gradient, and theirs flows
  back through conv6's input, where the two shards' gradients are summed
  in another order than one whole conv's backward sums them: conv1_1's,
  furthest from there, was found 1.15e-6 of its largest away); against the JAX
  package's ``shard_state(tensor_parallel=True)`` step on a data 2 x
  model 2 mesh, each loss within 1e-5 relative and each parameter within
  ``rtol=1e-4, atol=1e-6`` (``tests/test_train_step.py``'s bounds); the
  L2 term and the eval step's losses within 1e-6 relative of the
  unsharded ones; remat under tensor parallelism equal to tensor
  parallelism without it within 1e-7.
"""

import contextlib
import importlib
import json
import os
import shutil
import subprocess
import sys
import time
from pathlib import Path

import jax
import numpy as np
import pytest
import torch

from ssd_tensorflow_tpu import inference as jax_inference
from ssd_tensorflow_tpu.models import quantized as jq
from ssd_tensorflow_tpu.models import ssd_vgg as jax_ssd
from ssd_tensorflow_tpu.ops.anchors import anchors_for_preset
from ssd_tensorflow_tpu.ops.postprocess import DetectionConfig as JaxDetectionConfig
from ssd_tensorflow_tpu.parallel import mesh as jax_mesh
from ssd_tensorflow_tpu.parallel import train_step as jax_ts
from ssd_tensorflow_tpu.presets import get_preset_by_name
from ssd_tensorflow_tpu.utils.checkpoint import restore_checkpoint as jax_restore
from ssd_tensorflow_tpu_torch import inference
from ssd_tensorflow_tpu_torch.models import ssd_vgg
from ssd_tensorflow_tpu_torch.models.loss import l2_regularizer
from ssd_tensorflow_tpu_torch.parallel import train_step
from ssd_tensorflow_tpu_torch.utils.checkpoint import (
    read_leaves,
    restore_checkpoint,
    save_checkpoint,
    train_state_from_jax,
    train_state_to_jax,
)
from ssd_tensorflow_tpu_torch.weights import params_from_jax, qparams_from_jax

ROOT = Path(__file__).resolve().parent.parent
sys.path.insert(0, str(Path(__file__).resolve().parent))
from reference_impl import random_boxes  # noqa: E402
from torch_dist_worker import run_ranks  # noqa: E402

K = 20
SPEC = {"preset": "test64", "k": K, "dtype": "float32", "top_k": 32, "threshold": 0.5}
DET_FIELDS = ("boxes", "scores", "classes", "valid")
DETECTION = {"top_k": 200, "confidence_threshold": 0.01}


@pytest.fixture(scope="module")
def scratch(tmp_path_factory):
    """A module-wide directory, removed after the module (its test64 train
    states are ~200 MB each)."""
    tmp = tmp_path_factory.mktemp("multichip")
    yield tmp
    shutil.rmtree(tmp, ignore_errors=True)


@contextlib.contextmanager
def rank_threads():
    """This process's CPU work on 2 threads, as each rank's: with more, the
    first ``torch.exp`` of a process was seen 1e-4 off on some runs (in
    ``ssd_vgg.reduce_head_maps``; never on 1 or 2 threads), which an
    exact comparison with the ranks would catch."""
    saved = torch.get_num_threads()
    torch.set_num_threads(2)
    try:
        yield
    finally:
        torch.set_num_threads(saved)


def _seeded_biases(jp, seed):
    rng = np.random.default_rng(seed)
    return {n: {k: (rng.normal(0, 0.05, v.shape).astype(np.float32) if k == "b"
                    else np.asarray(v)) for k, v in d.items()} for n, d in jp.items()}


# ---------------------------------------------------------------------------
# data-parallel serving
# ---------------------------------------------------------------------------


def _serving_models(kind):
    """``(JAX params, JAX act_scales, port params, act_scales, preset)`` of
    a test64 float32 model or an rtest64 int8 one (a ``QuantizedModel`` of
    the JAX package, its q-params on both sides)."""
    preset = "test64" if kind == "float32" else "rtest64"
    jcfg = jax_ssd.ModelConfig(preset_name=preset, num_classes=K, compute_dtype="float32")
    jp = _seeded_biases(jax_ssd.init_params(jax.random.PRNGKey(5), jcfg), 21)
    if kind == "float32":
        return jcfg, jp, None, params_from_jax(jp), None
    calib = np.random.default_rng(9).integers(0, 255, (4, 64, 64, 3)).astype(np.float32)
    qm = jq.QuantizedModel(jp, jcfg, calib)
    qp = {n: {k: np.array(v) for k, v in d.items()} for n, d in qm.qparams.items()}
    return jcfg, qp, dict(qm.act_scales), qparams_from_jax(qp), dict(qm.act_scales)


@pytest.fixture(scope="module", params=["float32", "int8"])
def served(request, scratch):
    """2 gloo ranks serving a batch of 6 over a 2-process data mesh, and
    the same model in one process with ``mesh=None``, started alike (a
    fresh process on 2 threads: this test process's earlier work was seen
    to move a float32 forward by 1.5e-5 under the whole suite)."""
    kind = request.param
    jcfg, jparams, jscales, params, scales = _serving_models(kind)
    cfg = ssd_vgg.ModelConfig(preset_name=jcfg.preset_name, num_classes=K,
                              compute_dtype="float32")
    tmp = scratch / f"serve_{kind}"
    tmp.mkdir()
    inference.save_bundle(str(tmp / "model.ssdtpu.npz"), params, cfg, act_scales=scales)
    images = np.random.default_rng(13).integers(0, 256, (6, 64, 64, 3), dtype=np.uint8)
    np.savez(tmp / "images.npz", images=images)
    payload = {"bundle": str(tmp / "model.ssdtpu.npz"), "images": str(tmp / "images.npz"),
               "detection": DETECTION}
    run_ranks("serve", 2, dict(payload, out=str(tmp / "out")))
    run_ranks("serve", 1, dict(payload, out=str(tmp / "one"), one=True))
    ranks = [dict(np.load(tmp / f"out.rank{r}.npz")) for r in range(2)]
    return {"kind": kind, "ranks": ranks, "one": dict(np.load(tmp / "one.rank0.npz")),
            "images": images, "jax": (jcfg, jparams, jscales)}


def test_data_parallel_serving_equals_one_process(served):
    """Every rank holds the whole batch's detections and result, equal to
    one process's bit for bit (rank 1 perturbed its own parameters before:
    rank 0's are the ones broadcast)."""
    want = served["one"]
    assert int(want["valid"].sum()) > 0
    for got in served["ranks"]:
        for f in DET_FIELDS:
            np.testing.assert_array_equal(got[f], want[f], err_msg=f)
            np.testing.assert_array_equal(got["run_" + f], want["run_" + f], err_msg=f)
        np.testing.assert_array_equal(got["result"], want["result"])


def _matched(got, want, min_score=0.1, min_iou=0.95, score_tol=0.02):
    """Each detection of conf >= ``min_score`` on one side has one of the
    same class on the other with IoU >= ``min_iou`` and conf within
    ``score_tol``, both ways, image by image."""
    from ssd_tensorflow_tpu_torch.ops.iou import canvas_iou

    for b in range(got["valid"].shape[0]):
        for x, y in ((got, want), (want, got)):
            keep = x["valid"][b] & (x["scores"][b] >= min_score)
            other = y["valid"][b]
            for i in np.flatnonzero(keep):
                same = np.flatnonzero(other & (y["classes"][b] == x["classes"][b, i]))
                assert same.size, (b, i)
                iou = canvas_iou(torch.from_numpy(x["boxes"][b, i][None]),
                                 torch.from_numpy(y["boxes"][b, same])).numpy().ravel()
                close = np.abs(y["scores"][b, same] - x["scores"][b, i]) <= score_tol
                assert np.any((iou >= min_iou) & close), (b, i)


def test_data_parallel_serving_matches_jax_mesh(served):
    """The 2-rank detections against the JAX package's ``InferenceModel``
    on a 2-device data mesh, on the same images and weights."""
    jcfg, jparams, jscales = served["jax"]
    m = jax_mesh.make_mesh(data=2, devices=jax.devices()[:2])
    jm = jax_inference.InferenceModel(jparams, jcfg, act_scales=jscales, mesh=m,
                                      detection=JaxDetectionConfig(**DETECTION))
    _, jdets = jm.run(served["images"])
    want = {f: np.asarray(getattr(jdets, f)) for f in DET_FIELDS}
    got = served["ranks"][0]
    if served["kind"] == "float32":
        for f in ("classes", "valid"):
            np.testing.assert_array_equal(got[f], want[f], err_msg=f)
        np.testing.assert_allclose(got["scores"], want["scores"], rtol=0, atol=1e-5)
        gap = np.abs(got["boxes"] - want["boxes"])
        assert float(gap.max()) <= 1e-3 + 1e-6
        assert np.count_nonzero(gap > 1e-5) <= 1e-3 * gap.size
    else:
        assert got["valid"].sum(axis=1).tolist() == want["valid"].sum(axis=1).tolist()
        _matched(got, want)


def test_indivisible_batch_raises_jax_message(served):
    jcfg, jparams, jscales = served["jax"]
    m = jax_mesh.make_mesh(data=2, devices=jax.devices()[:2])
    jm = jax_inference.InferenceModel(jparams, jcfg, act_scales=jscales, mesh=m)
    with pytest.raises(ValueError) as e:
        jm.detect_boxes(served["images"][:5])
    for got in served["ranks"]:
        assert str(got["indivisible"]) == str(e.value)


# ---------------------------------------------------------------------------
# the serving CLIs
# ---------------------------------------------------------------------------

MINIVOC = str(ROOT / "tests" / "fixtures" / "minivoc")


def _tree(path):
    return {str(p.relative_to(path)): p.read_bytes() for p in sorted(Path(path).rglob("*"))
            if p.is_file()}


@pytest.fixture(scope="module")
def cli_bundle(scratch):
    """A test64 float32 bundle with seeded weights and 20 VOC labels."""
    from ssd_tensorflow_tpu_torch.data.source_pascal_voc import label_defs

    cfg = ssd_vgg.ModelConfig(preset_name="test64", num_classes=K, compute_dtype="float32")
    params = ssd_vgg.init_params(cfg, seed=3)
    rng = np.random.default_rng(4)
    for leaf in params.values():
        if "b" in leaf and leaf["b"].dim() == 1:
            leaf["b"] = torch.tensor(rng.normal(0, 0.3, leaf["b"].shape), dtype=torch.float32)
    path = scratch / "cli.ssdtpu.npz"
    inference.save_bundle(str(path), params, cfg, {i: d.name for i, d in enumerate(label_defs)})
    return str(path)


def _jpegs():
    return [str(p) for p in sorted((ROOT / "tests" / "fixtures" / "minivoc" / "test")
                                   .rglob("*.jpg"))][:6]


def _cli_argv(name, bundle, out):
    if name == "detect":
        return [*_jpegs(), "--model", bundle, "--output-dir", out, "--batch-size", "4",
                "--threshold", "0.01", "--device", "cpu"]
    return ["--bundle", bundle, "--data-source", "pascal_voc", "--data-dir", MINIVOC,
            "--output-dir", out, "--batch-size", "4", "--threshold", "0.01",
            "--dump-predictions", "true", "--annotate", "true", "--pascal-summary", "true",
            "--coco-results", "true", "--device", "cpu"]


def _ap_lines(log):
    return [ln for ln in log.splitlines() if ln.startswith(("[i] AP [", "[i] mAP"))]


@pytest.mark.parametrize("name", ["detect", "infer"])
def test_cli_data_parallel_two_ranks_equal_one_process(name, cli_bundle, scratch):
    """``--data-parallel 2`` under 2 gloo ranks writes, from rank 0 alone,
    the files one process writes with ``--data-parallel 0``, and prints the
    same AP."""
    from test_torch_serving_cli import _run

    cli = importlib.import_module(f"ssd_tensorflow_tpu_torch.cli.{name}")
    tmp = scratch / f"cli_{name}"
    one = str(tmp / "one")
    with rank_threads():
        rc, log = _run(cli, _cli_argv(name, cli_bundle, one) + ["--data-parallel", "0"])
    assert rc == 0, log[-3000:]
    run_ranks("cli_serve", 2, {"cli": name, "out": str(tmp / "rank{rank}.json"),
                               "argv": _cli_argv(name, cli_bundle, str(tmp / "out{rank}"))
                               + ["--data-parallel", "2"]})
    reports = [json.loads((tmp / f"rank{r}.json").read_text()) for r in range(2)]
    assert [r["rc"] for r in reports] == [0, 0]
    assert not (tmp / "out1").exists()  # only rank 0 writes
    want, got = _tree(one), _tree(tmp / "out0")
    assert sorted(got) == sorted(want) and len(want) >= 6
    for f in want:
        assert got[f] == want[f], f
    if name == "infer":
        assert _ap_lines(reports[0]["log"]) == _ap_lines(log) and _ap_lines(log)
        assert not _ap_lines(reports[1]["log"])


@pytest.mark.parametrize("name", ["detect", "infer"])
def test_cli_indivisible_batch_exits_with_jax_line(name, cli_bundle, tmp_path):
    from test_torch_serving_cli import _run

    port = importlib.import_module(f"ssd_tensorflow_tpu_torch.cli.{name}")
    jax_cli = importlib.import_module(f"ssd_tensorflow_tpu.cli.{name}")
    argv = [a for a in _cli_argv(name, cli_bundle, str(tmp_path)) if a not in ("--device",
                                                                               "cpu")]
    argv[argv.index("--batch-size") + 1] = "3"
    line = "[!] --batch-size 3 not divisible by --data-parallel 2"
    rc, out = _run(jax_cli, argv + ["--data-parallel", "2"])
    assert rc == 1 and line in out.splitlines()
    rc, out = _run(port, argv + ["--data-parallel", "2", "--device", "cpu"])
    assert rc == 1 and line in out.splitlines()


@pytest.mark.parametrize("name", ["detect", "infer"])
def test_cli_data_parallel_without_a_launch_exits_1(name, cli_bundle, tmp_path):
    """``--data-parallel 2`` in one process has one device for two: it
    exits 1 and says how to launch."""
    from test_torch_serving_cli import _run

    cli = importlib.import_module(f"ssd_tensorflow_tpu_torch.cli.{name}")
    rc, out = _run(cli, _cli_argv(name, cli_bundle, str(tmp_path)) + ["--data-parallel", "2"])
    assert rc == 1
    assert f"torchrun --nproc-per-node 2 -m ssd_tensorflow_tpu_torch.cli.{name}" in out
    assert not os.path.exists(tmp_path / "out")


# ---------------------------------------------------------------------------
# tensor parallelism
# ---------------------------------------------------------------------------


def _cfgs(remat_on=False):
    jcfg = jax_ts.TrainConfig(
        model=jax_ssd.ModelConfig(preset_name="test64", num_classes=K, compute_dtype="float32"),
        detect=JaxDetectionConfig(top_k=32, confidence_threshold=0.5), remat=remat_on)
    tcfg = train_step.TrainConfig(
        model=ssd_vgg.ModelConfig(preset_name="test64", num_classes=K, compute_dtype="float32"),
        detect=train_step.DetectionConfig(top_k=32, confidence_threshold=0.5), remat=remat_on)
    return jcfg, tcfg


def _batch(seed, b=4, g=8):
    rng = np.random.default_rng(seed)
    gt = np.stack([random_boxes(rng, g, tight=True) for _ in range(b)]).astype(np.float32)
    mask = np.ones((b, g), dtype=bool)
    mask[1, g - 3:] = False
    mask[b - 1, g - 5:] = False
    return {"images": rng.uniform(0, 255, (b, 64, 64, 3)).astype(np.float32),
            "gt_boxes": gt, "gt_labels": rng.integers(0, K, (b, g)).astype(np.int32),
            "gt_mask": mask}


@pytest.fixture(scope="module")
def tp_setup():
    jcfg, _ = _cfgs()
    jp = _seeded_biases(jax_ssd.init_params(jax.random.PRNGKey(0), jcfg.model), 11)
    rng = np.random.default_rng(12)
    trace = {n: {k: rng.normal(0, 0.01, v.shape).astype(np.float32) for k, v in d.items()}
             for n, d in jp.items()}
    anchors = anchors_for_preset(get_preset_by_name("test64"))
    return jp, trace, anchors, [_batch(0), _batch(1)]


@pytest.fixture(scope="module")
def tp_run(tp_setup, scratch):
    """4 gloo ranks on a data 2 x model 2 mesh: a step on each of 2 global
    batches of 4, the second from the first's gathered checkpoint restored
    and sharded again; the first also under remat."""
    jp, trace, _, batches = tp_setup
    tmp = scratch / "tp"
    tmp.mkdir()
    start = train_state_from_jax({"params": jp, "trace": trace, "count": 3, "step": 3})
    save_checkpoint(str(tmp / "state.ckpt.npz"), start)
    np.savez(tmp / "batches.npz", **{k: np.stack([b[k] for b in batches]) for k in batches[0]})
    run_ranks("tp_step", 4, {"cfg": SPEC, "state": str(tmp / "state.ckpt.npz"),
                             "batches": str(tmp / "batches.npz"), "remat": True,
                             "out": str(tmp / "out")})
    reports = [json.loads((tmp / f"out.rank{r}.json").read_text()) for r in range(4)]
    return {"dir": tmp, "reports": reports, "starts": [str(tmp / "state.ckpt.npz"),
                                                       str(tmp / "out.step0.ckpt.npz")]}


def _template(tcfg):
    return train_step.make_train_state(ssd_vgg.init_params(tcfg.model), tcfg, device="cpu")


@pytest.fixture(scope="module")
def tp_one_process(tp_setup, tp_run):
    """One process's step on each whole batch, from the state the 4-rank
    step started from; its losses and its state written by the same
    writer."""
    _, _, anchors, batches = tp_setup
    _, tcfg = _cfgs()
    step = train_step.make_train_step(tcfg, anchors)
    evaluate = train_step.make_eval_step(tcfg, anchors)
    out = []
    for i, (start, batch) in enumerate(zip(tp_run["starts"], batches)):
        before = restore_checkpoint(start, _template(tcfg))
        state, losses, _ = step(before, batch)
        path = str(tp_run["dir"] / f"one.step{i}.ckpt.npz")
        save_checkpoint(path, state)
        out.append({"before": train_state_to_jax(before), "path": path,
                    "losses": {k: float(v) for k, v in losses.items()}})
        if i == 0:
            out[0]["eval"] = {k: float(v) for k, v in evaluate(before.params, batch)[0].items()}
            out[0]["l2"] = float(l2_regularizer(before.params))
    return out


def _file_leaves(path):
    meta, leaves = read_leaves(path)
    return meta, leaves


#: the VGG trunk below conv6: its gradients flow back through conv6's input
TRUNK = {name for name, _ in ssd_vgg.vgg16.VGG_CONV_LAYERS}


def _updates_within(got_path, want_path, before, rel, rel_trunk_trace):
    """Each leaf of the checkpoint ``got_path`` against ``want_path``'s: its
    update from ``before`` within ``rel`` (a momentum leaf of ``TRUNK``:
    ``rel_trunk_trace``) of the largest update, or two ulps of the largest
    value."""
    gmeta, got = _file_leaves(got_path)
    wmeta, want = _file_leaves(want_path)
    assert gmeta == wmeta and len(got) == len(want)
    names = [(n, k) for n in sorted(before["params"]) for k in sorted(before["params"][n])]
    old = [before["params"][n][k] for n, k in names] + [before["trace"][n][k] for n, k in names]
    for j, o in enumerate(old):
        assert got[j].shape == want[j].shape and got[j].dtype == want[j].dtype, j
        upd = want[j] - o
        floor = 2.0 ** -22 * float(np.abs(o).max())
        err = float(np.abs(got[j] - want[j]).max())
        trunk_trace = j >= len(names) and names[j - len(names)][0] in TRUNK
        tol = rel_trunk_trace if trunk_trace else rel
        assert err <= max(tol * float(np.abs(upd).max()), floor), (j, err)
    for j in range(len(old), len(got)):  # count, step
        assert got[j] == want[j]


def test_tp_step_equals_one_process(tp_run, tp_one_process):
    """Each 4-rank step (the second restored from the first's gathered
    checkpoint and sharded again) against one process from the same state:
    losses within 1e-6 relative; the gathered checkpoint file against the
    one-process file leaf for leaf, params and momentum."""
    reports = tp_run["reports"]
    for i, one in enumerate(tp_one_process):
        for r in reports:
            assert r["losses"][i] == reports[0]["losses"][i]
        for k, v in one["losses"].items():
            assert abs(reports[0]["losses"][i][k] - v) <= 1e-6 * abs(v), (i, k)
        _updates_within(str(tp_run["dir"] / f"out.step{i}.ckpt.npz"), one["path"],
                        one["before"], 1e-6, 2e-6)


def test_tp_step_matches_jax_tensor_parallel(tp_setup, tp_run):
    """The first 4-rank step against the JAX package's step on a data 2 x
    model 2 mesh with ``shard_state(tensor_parallel=True)``, from the same
    checkpoint."""
    jp, _, anchors, batches = tp_setup
    jcfg, _ = _cfgs()
    m = jax_mesh.make_mesh(data=2, model=2, devices=jax.devices()[:4])
    before = jax_restore(tp_run["starts"][0], jax_ts.make_train_state(jp, jcfg))
    state, losses, _ = jax_ts.make_train_step(jcfg, anchors, donate=False)(
        jax_ts.shard_state(before, m, tensor_parallel=True), jax_ts.shard_batch(batches[0], m))
    assert "model" in str(state.params["mod_conv6"]["w"].sharding.spec)
    for k, v in losses.items():
        assert abs(tp_run["reports"][0]["losses"][0][k] - float(v)) <= 1e-5 * abs(float(v)), k
    got = train_state_to_jax(restore_checkpoint(str(tp_run["dir"] / "out.step0.ckpt.npz"),
                                                _template(_cfgs()[1])))
    for n in jp:
        for k in jp[n]:
            np.testing.assert_allclose(got["params"][n][k], np.asarray(state.params[n][k]),
                                       rtol=1e-4, atol=1e-6, err_msg=f"{n}/{k}")


def test_tp_shards_and_momentum_alike(tp_run):
    """Each rank holds its half of conv6's filters and bias and of conv7's
    input channels, conv7's bias whole, the momentum sharded as its
    parameter; the two ranks of a model group take the same rows."""
    want = {"mod_conv6/w": [512, 512, 3, 3], "mod_conv6/b": [512],
            "mod_conv7/w": [1024, 512, 1, 1], "mod_conv7/b": [1024]}
    rows = [[0, 2], [0, 2], [2, 4], [2, 4]]
    for r, report in enumerate(tp_run["reports"]):
        for t in ("params", "trace"):
            assert {k: report["shapes"][f"{t}/{k}"] for k in want} == want, (r, t)
        assert report["rows"] == rows[r]


def test_tp_l2_and_eval_are_the_unsharded_values(tp_run, tp_one_process):
    one = tp_one_process[0]
    for report in tp_run["reports"]:
        assert abs(report["l2"] - one["l2"]) <= 1e-6 * one["l2"]
        for k, v in one["eval"].items():
            assert abs(report["eval"][k] - v) <= 1e-6 * abs(v), k


def test_data_parallel_state_keeps_its_mesh(tp_run, tp_one_process):
    """A state placed on a data mesh of the 4 ranks, stepped after a
    ``model=2`` mesh was made, averages over its own mesh: the losses of
    the global batch, one process's within 1e-6 relative."""
    for report in tp_run["reports"]:
        for k, v in tp_one_process[0]["losses"].items():
            assert abs(report["dp_losses"][k] - v) <= 1e-6 * abs(v), k


def test_tp_remat_equals_tp(tp_run):
    """The same first step under remat (the forward and its two
    collectives run again in the backward pass) against it without."""
    got_meta, got = _file_leaves(str(tp_run["dir"] / "out.step0.remat.ckpt.npz"))
    want_meta, want = _file_leaves(str(tp_run["dir"] / "out.step0.ckpt.npz"))
    assert got_meta == want_meta
    for j, (a, b) in enumerate(zip(got, want)):
        assert float(np.abs(a - b).max()) <= 1e-7 * max(float(np.abs(b).max()), 1e-30), j
    report = tp_run["reports"][0]
    for k, v in report["losses"][0].items():
        assert abs(report["remat_losses"][k] - v) <= 1e-7 * abs(v), k


# ---------------------------------------------------------------------------
# the dry run
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("n", [2, 4])
def test_dryrun_multichip_prints_ok(n):
    """``multichip.dryrun_multichip(n, device="cpu")`` in a fresh process
    starts n gloo ranks on the CPU (2 threads each, as the other multi-process tests) and
    prints the JAX package's ok line."""
    env = {k: v for k, v in os.environ.items() if k not in ("JAX_PLATFORMS", "XLA_FLAGS")}
    env.update(PYTHONPATH=str(ROOT) + os.pathsep + env.get("PYTHONPATH", ""), OMP_NUM_THREADS="2")
    t0 = time.perf_counter()
    proc = subprocess.run(
        [sys.executable, "-c", "import sys; sys.modules['jax'] = None\n"
         f"from ssd_tensorflow_tpu_torch import multichip; "
         f"multichip.dryrun_multichip({n}, device='cpu')"],
        cwd=ROOT, env=env, capture_output=True, text=True, timeout=300)
    assert proc.returncode == 0, proc.stdout[-3000:] + proc.stderr[-3000:]
    model = 2 if n == 4 else 1
    assert (f"[i] dryrun_multichip ok: mesh={{'data': {n // model}, 'model': {model}}}, "
            in proc.stdout)
    assert f"dp-serving over {n} devices ok" in proc.stdout
    print(f"dryrun_multichip({n}): {time.perf_counter() - t0:.1f} s")


def test_entry_matches_jax_entry():
    """``multichip.entry("cpu")``'s vgg300 bf16 forward at batch 8 against
    ``__graft_entry__.entry()``'s on the same weights (``params_from_jax``
    of the JAX entry's): the bf16 whole-forward bounds of
    ``tests/test_torch_slice.py``, class probabilities within 0.01 and locs
    within 0.04."""
    import __graft_entry__
    from ssd_tensorflow_tpu_torch import multichip

    jfn, (jparams, jimages) = __graft_entry__.entry()
    fn, (params, images) = multichip.entry("cpu")
    assert images.dtype == torch.uint8 and tuple(images.shape) == jimages.shape
    assert sorted(params) == sorted(jparams)
    want = np.asarray(jax.jit(jfn)(jparams, jimages), np.float32)
    got = fn(params_from_jax(jparams), images).float().numpy()
    assert got.shape == want.shape == (8, 8732, K + 5)
    assert np.isfinite(got).all()
    assert float(np.abs(got[..., :K + 1] - want[..., :K + 1]).max()) < 0.01
    assert float(np.abs(got[..., K + 1:] - want[..., K + 1:]).max()) < 0.04
