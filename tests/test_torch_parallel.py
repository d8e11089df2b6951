"""The port's parallelism (``parallel/{mesh,multihost,sharding,prefetch,
remat}.py`` and the data-parallel train step) against one process and
against the JAX package, on the CPU at test64 (K = 20), float32.

Multi-process runs are real gloo groups of 2 ranks started as
``torchrun`` would (``tests/torch_dist_worker.py``), each launch with its
own timeout. Tolerances:
- the 2-rank step at a global batch of 4 against the one-process step on
  the whole batch, 2 steps: each loss within 1e-6 relative, each parameter
  leaf within 1e-6 of that leaf's largest value, and both ranks' states
  equal bit for bit after each step;
- the same 2-rank steps against the JAX package's step on a 2-device mesh
  (``shard_state`` / ``shard_batch``), each from the same state: the train
  step's bounds of ``tests/test_torch_train_step.py`` (each loss within
  1e-5 relative, each leaf's update within 1e-3 of that leaf's largest
  update, or two ulps of its largest parameter where the update is that
  small: the resolution of a difference of two float32 parameters, as in
  ``chip_smoke.py`` phase 6 b);
- remat against no remat, one process: each loss and each leaf within
  1e-7 relative; the remat step against JAX's remat step at the train
  step's bounds;
- the augmentation on 2 ranks against one process on the same seed:
  images within 1, boxes within 1e-5, labels and masks equal (the JAX
  package's own sharded-augmentation bound).
"""

import json
import re
import shutil
import sys
import time
from pathlib import Path

import jax
import numpy as np
import pytest
import torch

from ssd_tensorflow_tpu.models import ssd_vgg as jax_ssd
from ssd_tensorflow_tpu.ops.anchors import anchors_for_preset
from ssd_tensorflow_tpu.ops.postprocess import DetectionConfig as JaxDetectionConfig
from ssd_tensorflow_tpu.parallel import mesh as jax_mesh
from ssd_tensorflow_tpu.parallel import multihost as jax_multihost
from ssd_tensorflow_tpu.parallel import train_step as jax_ts
from ssd_tensorflow_tpu.presets import get_preset_by_name
from ssd_tensorflow_tpu_torch.data import device_augment as da
from ssd_tensorflow_tpu_torch.models import ssd_vgg
from ssd_tensorflow_tpu_torch.parallel import mesh, multihost, prefetch, remat, sharding
from ssd_tensorflow_tpu_torch.parallel import train_step
from ssd_tensorflow_tpu_torch.presets import get_preset_by_name as port_preset
from ssd_tensorflow_tpu_torch.utils.checkpoint import (
    save_checkpoint,
    train_state_from_jax,
    train_state_to_jax,
)
from ssd_tensorflow_tpu_torch.weights import params_from_jax, params_to_jax

sys.path.insert(0, str(Path(__file__).resolve().parent))
from reference_impl import random_boxes  # noqa: E402
from torch_dist_worker import run_ranks  # noqa: E402

K = 20
SPEC = {"preset": "test64", "k": K, "dtype": "float32", "top_k": 32, "threshold": 0.5}


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
def setup():
    jcfg, _ = _cfgs()
    jp = jax_ssd.init_params(jax.random.PRNGKey(0), jcfg.model)
    rng = np.random.default_rng(11)
    jp = {n: {k: (rng.normal(0, 0.05, v.shape).astype(np.float32) if k == "b" else np.asarray(v))
              for k, v in d.items()} for n, d in jp.items()}
    anchors = anchors_for_preset(get_preset_by_name("test64"))
    return jp, anchors, [_batch(0), _batch(1)]


def _port_state(jp):
    zeros = {n: {k: np.zeros_like(v) for k, v in d.items()} for n, d in jp.items()}
    return train_state_from_jax({"params": jp, "trace": zeros, "count": 0, "step": 0})


def _leaf_rel(got, want):
    got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
    return float(np.abs(got - want).max()) / max(float(np.abs(want).max()), 1e-30)


def _rank0_params(run, i):
    """Rank 0's parameters after step ``i``, JAX layout, in the
    checkpoint's leaf order."""
    with np.load(run["dir"] / f"out.step{i}.params.npz") as f:
        return [f[f"arr_{j}"] for j in range(len(f.files))]


def _run_two_ranks(tmp, jp, batches, states=None):
    save_checkpoint(str(tmp / "state.ckpt.npz"), _port_state(jp))
    np.savez(tmp / "batches.npz", **{k: np.stack([b[k] for b in batches]) for k in batches[0]})
    run_ranks("step", 2, {"cfg": SPEC, "state": str(tmp / "state.ckpt.npz"),
                          "batches": str(tmp / "batches.npz"), "steps": len(batches),
                          "states": states, "out": str(tmp / "out")})
    return {"dir": tmp, "losses": [json.loads((tmp / f"out.rank{r}.json").read_text())
                                   for r in range(2)]}


@pytest.fixture(scope="module")
def scratch(tmp_path_factory):
    """A module-wide directory, removed after the module (its train states
    are ~200 MB each)."""
    tmp = tmp_path_factory.mktemp("dp")
    yield tmp
    shutil.rmtree(tmp, ignore_errors=True)


@pytest.fixture(scope="module")
def one_process(setup, scratch):
    """The one-process port's 2 steps on the whole batches: the checkpoint
    of the state before each, and the state and losses after it."""
    jp, anchors, batches = setup
    tmp = scratch / "one"
    tmp.mkdir()
    _, tcfg = _cfgs()
    step = train_step.make_train_step(tcfg, anchors)
    state = train_step.make_train_state(params_from_jax(jp), tcfg, device="cpu")
    states, after = [], []
    for i, batch in enumerate(batches):
        states.append(str(tmp / f"one{i}.ckpt.npz"))
        save_checkpoint(states[-1], state)
        state, losses, _ = step(state, batch)
        after.append((train_state_to_jax(state), {k: float(v) for k, v in losses.items()}))
    return states, after


@pytest.fixture(scope="module")
def two_ranks(setup, scratch):
    """2 gloo ranks, global batch 4, 2 chained float32 steps from the JAX
    weights."""
    jp, _, batches = setup
    (scratch / "chained").mkdir()
    return _run_two_ranks(scratch / "chained", jp, batches)


@pytest.fixture(scope="module")
def stepwise(setup, one_process, scratch):
    """2 gloo ranks, each of the 2 steps from the one-process state before it."""
    jp, _, batches = setup
    (scratch / "stepwise").mkdir()
    return _run_two_ranks(scratch / "stepwise", jp, batches, one_process[0])


def _names(tree):
    return [(n, k) for n in sorted(tree) for k in sorted(tree[n])]


def test_two_ranks_equal_one_process(setup, one_process, two_ranks, stepwise):
    """Each of the 2 steps on 2 ranks from the one-process state before it
    equals the one-process step; the chained 2-rank run keeps both ranks
    equal bit for bit and its losses within 1e-6. (Chained, the second
    step's parameters may differ further: the first step's float32 rounding
    differences, ~1e-7, can move which negatives the hard-negative mining
    keeps.)"""
    _, after = one_process
    for run in (stepwise, two_ranks):
        r0, r1 = run["losses"]
        assert r0 == r1 and r0["step"] == 2 and r0["count"] == 2  # digests too
        for i, (one, losses) in enumerate(after):
            for k, v in losses.items():
                assert abs(r0["losses"][i][k] - v) <= 1e-6 * abs(v), (i, k)
            assert r0["digests"][i] == r1["digests"][i], f"ranks differ after step {i}"
            if run is two_ranks and i > 0:
                continue
            got = _rank0_params(run, i)
            for j, (n, k) in enumerate(_names(one["params"])):
                want = one["params"][n][k]
                err = float(np.abs(got[j] - want).max())
                assert err <= 1e-6 * float(np.abs(want).max()), (i, n, k, err)


def test_two_ranks_equal_jax_two_device_mesh(setup, one_process, stepwise):
    """Each 2-rank step against the JAX package's step on a 2-device mesh
    from the same state (the port's checkpoint, read by the JAX package)."""
    from ssd_tensorflow_tpu.utils.checkpoint import restore_checkpoint as jax_restore

    jp, anchors, batches = setup
    jcfg, _ = _cfgs()
    m = jax_mesh.make_mesh(data=2, devices=jax.devices()[:2])
    step = jax_ts.make_train_step(jcfg, anchors, donate=False)
    template = jax_ts.make_train_state(jp, jcfg)
    for i, batch in enumerate(batches):
        before = jax_restore(one_process[0][i], template)
        state, losses, _ = step(jax_ts.shard_state(before, m), jax_ts.shard_batch(batch, m))
        for k, v in losses.items():
            assert abs(stepwise["losses"][0]["losses"][i][k] - float(v)) <= 1e-5 * abs(float(v))
        got = _rank0_params(stepwise, i)
        for j, (n, k) in enumerate(_names(jp)):
            old = np.asarray(before.params[n][k])
            want = np.asarray(state.params[n][k]) - old
            # a difference of two float32 parameters resolves no finer than
            # about an ulp of the larger: two ulps of the leaf's largest
            floor = 2.0 ** -22 * float(np.abs(old).max())
            err = float(np.abs(got[j] - old - want).max())
            assert err <= max(1e-3 * float(np.abs(want).max()), floor), (i, n, k, err)


def test_global_batch_rows_match_jax_multihost(setup, two_ranks):
    """Each rank keeps its contiguous rows (``process_shard``,
    ``make_global_batch``, ``local_rows_many``); their concatenation in
    rank order is the global batch, as the JAX package's single-process
    ``local_rows(make_global_batch(...))`` returns it."""
    _, _, batches = setup
    got = [np.load(two_ranks["dir"] / f"out.rank{r}.npz") for r in range(2)]
    assert [g["rows"].tolist() for g in got] == [[0, 1], [2, 3]]
    images = batches[0]["images"]
    np.testing.assert_array_equal(np.concatenate([g["images"] for g in got]), images)
    m = jax_mesh.make_mesh(data=2, devices=jax.devices()[:2])
    want = jax_multihost.local_rows(jax_multihost.make_global_batch({"x": images}, m)["x"])
    np.testing.assert_array_equal(np.concatenate([g["images"] for g in got]), want)


@pytest.mark.parametrize("n", [0, 1, 5, 8, 13])
@pytest.mark.parametrize("count", [1, 2, 3, 4])
def test_process_shard_matches_jax(n, count):
    items = list(range(n))
    got = [multihost.process_shard(items, i, count) for i in range(count)]
    assert got == [jax_multihost.process_shard(items, i, count) for i in range(count)]
    assert sum(got, []) == items


def test_local_rows_and_global_batch_on_one_process():
    x = torch.arange(24, dtype=torch.float32).reshape(4, 6)
    np.testing.assert_array_equal(multihost.local_rows(x), x.numpy())
    a, b = multihost.local_rows_many([x, x[:2].to(torch.int64)])
    assert a.dtype == np.float32 and b.dtype == np.int64 and b.shape == (2, 6)
    out = multihost.make_global_batch({"x": x.numpy()}, None, device="cpu")
    assert out["x"].device.type == "cpu" and torch.equal(out["x"], x)



def test_global_batch_defaults_to_cuda():
    """Without a mesh the rows go to the card unless the caller asks for
    the CPU, as the JAX package's ``device_put`` goes to its accelerator."""
    batch = {"x": np.zeros((2, 3), np.float32)}
    if torch.cuda.is_available():
        assert multihost.make_global_batch(batch, None)["x"].is_cuda
    else:
        with pytest.raises(RuntimeError, match="cuda"):
            multihost.make_global_batch(batch, None)

def test_one_process_mesh_and_its_refusals():
    assert not mesh.launched() and mesh.make_mesh(device="cpu") is None
    assert mesh.world() == (0, 1)
    with pytest.raises(ValueError, match=re.escape("mesh 2x1 needs 2 devices, have 1")):
        mesh.make_mesh(data=2, device="cpu")
    with pytest.raises(ValueError, match=re.escape("mesh 16x1 needs 16 devices, have 8")):
        jax_mesh.make_mesh(data=16)  # the JAX package's message, for the form
    with pytest.raises(NotImplementedError, match="item 12"):
        mesh.make_mesh(model=2, device="cpu")
    assert sharding.batch_rows(6) == slice(0, 6)
    assert sharding.replicate([torch.ones(2)])[0].tolist() == [1.0, 1.0]


def test_shard_state_and_batch_without_a_group(setup):
    jp, _, batches = setup
    _, tcfg = _cfgs()
    state = train_step.make_train_state(params_from_jax(jp), tcfg, device="cpu")
    assert train_step.shard_state(state, None) is state
    assert train_step.shard_batch(batches[0], None) is batches[0]
    with pytest.raises(NotImplementedError, match="item 12"):
        train_step.shard_state(state, None, tensor_parallel=True)


def test_remat_equals_no_remat_and_jax_remat(setup):
    jp, anchors, batches = setup
    runs = []
    for on in (False, True):
        _, tcfg = _cfgs(on)
        state = train_step.make_train_state(params_from_jax(jp), tcfg, device="cpu")
        step = train_step.make_train_step(tcfg, anchors)
        for batch in batches:
            state, losses, _ = step(state, batch)
        runs.append((params_to_jax(state.params), losses))
    (p0, l0), (p1, l1) = runs
    for k in l0:
        assert abs(float(l1[k]) - float(l0[k])) <= 1e-7 * abs(float(l0[k])), k
    for n in p0:
        for k in p0[n]:
            assert _leaf_rel(p1[n][k], p0[n][k]) <= 1e-7, (n, k)

    jcfg, tcfg = _cfgs(True)
    js, jl, _ = jax_ts.make_train_step(jcfg, anchors, donate=False)(
        jax_ts.make_train_state(jp, jcfg), batches[0])
    ts, tl, _ = train_step.make_train_step(tcfg, anchors)(
        train_step.make_train_state(params_from_jax(jp), tcfg, device="cpu"), batches[0])
    for k in jl:
        assert abs(float(tl[k]) - float(jl[k])) <= 1e-5 * abs(float(jl[k])), k
    tp = params_to_jax(ts.params)
    for n in jp:
        for k in jp[n]:
            want = np.asarray(js.params[n][k]) - jp[n][k]
            if np.abs(want).max():
                assert _leaf_rel(tp[n][k] - jp[n][k], want) <= 1e-3, (n, k)


def test_remat_wrappers_recompute_and_keep_the_gradients():
    """Both wrappers run the forward again in the backward pass and give
    the plain gradients bit for bit."""
    calls = []

    def fn(w, x):
        calls.append(1)
        return torch.relu(torch.nn.functional.conv2d(x, w)).sum()

    x = torch.randn(1, 2, 5, 5, dtype=torch.float64)
    w = torch.randn(3, 2, 3, 3, dtype=torch.float64, requires_grad=True)
    (want,) = torch.autograd.grad(fn(w, x), w)
    for wrap in (remat.checkpoint_dots_only, remat.checkpoint_backbone):
        calls.clear()
        (got,) = torch.autograd.grad(wrap(fn)(w, x), w)
        assert len(calls) == 2  # the forward, then its recompute
        assert torch.equal(got, want)



@pytest.mark.parametrize("op,saved", [
    ("mm", True), ("addmm", True), ("bmm", False), ("convolution", False), ("relu", False)])
def test_dots_policy_saves_products_without_batch_dims(op, saved):
    """The selective policy keeps what JAX's
    ``dots_with_no_batch_dims_saveable`` keeps: a ``dot_general`` without
    batch dimensions. Batched products and convolutions are recomputed."""
    from torch.utils.checkpoint import CheckpointPolicy

    got = remat._dots_policy(None, getattr(torch.ops.aten, op).default)
    assert got == (CheckpointPolicy.MUST_SAVE if saved else CheckpointPolicy.PREFER_RECOMPUTE)

def test_sharded_augment_matches_one_process(tmp_path):
    preset = port_preset("test64")
    aug = {"sampler_trials": 4}
    rng = np.random.default_rng(3)
    b, g = 8, 3
    batch = {"images": rng.integers(0, 256, (b, 64, 64, 3), dtype=np.uint8),
             "gt_boxes": rng.uniform(0.3, 0.6, (b, g, 4)).astype(np.float32),
             "gt_labels": rng.integers(0, 5, (b, g)).astype(np.int32),
             "gt_mask": np.ones((b, g), bool)}
    np.savez(tmp_path / "batch.npz", **batch)
    fn = da.make_augment_fn(da.augment_config_for(preset, aug),
                            anchors_for_preset(get_preset_by_name("test64")))
    want = fn(da.step_generator(5, 0, 0, "cpu"), batch)
    run_ranks("augment", 2, {"preset": "test64", "aug": aug, "seed": 5,
                             "batch": str(tmp_path / "batch.npz"), "out": str(tmp_path / "aug")})
    got = [np.load(tmp_path / f"aug.rank{r}.npz") for r in range(2)]
    for k, v in want.items():
        cat = np.concatenate([g[k] for g in got])
        tol = {"images": 1.0, "gt_boxes": 1e-5}.get(k, 0.0)
        np.testing.assert_allclose(cat.astype(np.float64), v.numpy().astype(np.float64),
                                   atol=tol, err_msg=k)


def test_step_generator_is_the_same_on_every_call():
    a = torch.rand(4, generator=da.step_generator(1, 2, 3, "cpu"))
    assert torch.equal(a, torch.rand(4, generator=da.step_generator(1, 2, 3, "cpu")))
    assert not torch.equal(a, torch.rand(4, generator=da.step_generator(1, 2, 4, "cpu")))
    draws = da.draw_augment(da.step_generator(1, 2, 3, "cpu"), 6,
                            da.augment_config_for(port_preset("test64")))
    part = da.draws_rows(draws, slice(2, 4))
    assert torch.equal(part.sampler_cx, draws.sampler_cx[2:4]) and part.flip_u.shape == (2,)


# -- prefetch (the JAX package's tests/test_prefetch.py) -------------------


def test_prefetch_order_and_values():
    items = [np.full((4,), i, np.float32) for i in range(10)]
    out = list(prefetch.prefetch_to_device(iter(items), size=2, device="cpu"))
    assert len(out) == 10
    for i, x in enumerate(out):
        assert torch.is_tensor(x)
        np.testing.assert_array_equal(x.numpy(), items[i])



def test_prefetch_defaults_to_cuda():
    """The copy goes to the card unless the caller asks for the CPU; with
    no card that is an error at the call, before any batch is read."""
    items = [np.zeros((2,), np.float32)]
    if torch.cuda.is_available():
        assert next(prefetch.prefetch_to_device(iter(items))).is_cuda
    else:
        with pytest.raises(RuntimeError, match="cuda"):
            prefetch.prefetch_to_device(iter(items))

def test_prefetch_transform_splits_device_and_host():
    metas = [{"meta": i} for i in range(5)]
    items = [({"x": np.ones((2,), np.float32) * i}, metas[i]) for i in range(5)]
    out = list(prefetch.prefetch_to_device(iter(items), size=2, device="cpu",
                                           transform=lambda it: (it[0], it[1])))
    for i, (dev, host) in enumerate(out):
        assert host is metas[i]  # passed through untouched
        assert dev["x"].device.type == "cpu"
        np.testing.assert_array_equal(dev["x"].numpy(), items[i][0]["x"])


def test_prefetch_put_fn_replaces_the_copy():
    out = list(prefetch.prefetch_to_device(iter([1, 2]), put_fn=lambda x: x * 10))
    assert out == [10, 20]


def test_prefetch_producer_runs_ahead():
    produced = []

    def gen():
        for i in range(4):
            produced.append(i)
            yield np.zeros((1,), np.float32)

    it = prefetch.prefetch_to_device(gen(), size=2, device="cpu")
    next(it)
    deadline = time.monotonic() + 10
    while len(produced) < 3 and time.monotonic() < deadline:
        time.sleep(0.01)
    assert len(produced) >= 3
    list(it)


def test_prefetch_error_propagates():
    def gen():
        yield np.zeros((1,), np.float32)
        raise RuntimeError("pipeline boom")

    it = prefetch.prefetch_to_device(gen(), size=2, device="cpu")
    next(it)
    with pytest.raises(RuntimeError, match="pipeline boom"):
        list(it)
