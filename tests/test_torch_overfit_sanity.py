"""The port's overfit tool (``tools/torch_overfit_sanity.py``) against the
JAX package's (``tools/overfit_sanity.py``), on the CPU.

- ``make_dataset``: the same bytes at two seeds, at 300 x 300 and 64 x 64.
- The tool's loop (``train``) at test64 in float32 from JAX's
  ``PRNGKey(0)`` draw carried over: each of three steps' losses within
  1e-5 relative of JAX's ``make_train_step`` (the bound of
  ``tests/test_torch_train_step.py``).
- ``tests/torch_overfit_witness.py``: its nudge moves every parameter by
  ulps; from the port's seed-0 draw, the two packages' first two losses
  within 1e-4 relative (later steps part ways, ~10x a step: the run is
  chaotic, JAX against its own nudged run too, so the witness compares
  when each run memorizes).
- The tool's eval (``evaluate``) on a state that JAX trained until its eval
  finds detections: the same boxes (within 1e-5) and the same mAP (within
  1e-6) as the JAX tool's eval code.
- ``main``: one step at vgg300 on the CPU passes; with no card, the default
  device raises.
"""

import json
import sys
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from ssd_tensorflow_tpu.models.ssd_vgg import ModelConfig as JaxModelConfig
from ssd_tensorflow_tpu.models.ssd_vgg import init_params as jax_init_params
from ssd_tensorflow_tpu.ops.anchors import anchors_for_preset
from ssd_tensorflow_tpu.parallel import train_step as jax_ts
from ssd_tensorflow_tpu.presets import get_preset_by_name
from ssd_tensorflow_tpu_torch.weights import params_from_jax

sys.path.insert(0, str(Path(__file__).resolve().parent.parent / "tools"))
sys.path.insert(0, str(Path(__file__).resolve().parent))
import overfit_sanity as jax_tool  # noqa: E402
import torch_overfit_sanity as tool  # noqa: E402
import torch_overfit_witness as witness  # noqa: E402

IMAGES = 8
#: JAX steps before its eval: by then its eval keeps boxes above the tool's
#: 0.3 threshold, some on their objects
JAX_STEPS = 20


@pytest.fixture(scope="module", autouse=True)
def _two_torch_threads():
    """torch's CPU ops on 2 threads: under the suite's parallel workers the
    full-width VGG passes on every core thrash."""
    saved = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(saved)


@pytest.mark.parametrize("size", [300, 64])
@pytest.mark.parametrize("seed", [7, 11])
def test_make_dataset_matches_jax(seed, size):
    got = tool.make_dataset(5, np.random.default_rng(seed), size=size)
    want = jax_tool.make_dataset(5, np.random.default_rng(seed), size=size)
    for g, w in zip(got, want):
        assert g.dtype == w.dtype and np.array_equal(g, w)


@pytest.fixture(scope="module")
def jax_run():
    """The JAX package's steps of the tool's config at test64 in float32
    on the tool's data, from ``PRNGKey(0)``: each step's losses and the
    state after :data:`JAX_STEPS` steps."""
    data = tool.make_dataset(IMAGES, np.random.default_rng(7), size=64)
    cfg = jax_ts.TrainConfig(
        model=JaxModelConfig(preset_name="test64", num_classes=3, compute_dtype="float32"),
        lr_values=(0.001,), lr_boundaries=(), detect=None)
    anchors = anchors_for_preset(get_preset_by_name("test64"))
    state = jax_ts.make_train_state(jax_init_params(jax.random.PRNGKey(0), cfg.model), cfg)
    step = jax_ts.make_train_step(cfg, anchors)
    batch = {k: jnp.asarray(v) for k, v in tool.first_batch(data, IMAGES).items()}
    losses = []
    for _ in range(JAX_STEPS):
        state, step_losses, _ = step(state, batch)
        losses.append({k: float(v) for k, v in step_losses.items()})
    return {"data": data, "losses": losses, "state": state, "anchors": anchors,
            "model": cfg.model}


def test_train_loop_matches_jax(jax_run):
    cfg = tool.train_config(preset="test64", compute_dtype="float32")
    state, train_step, _ = tool.setup(
        cfg, params_from_jax(jax_init_params(jax.random.PRNGKey(0), jax_run["model"])), "cpu")
    seen = []

    def recording_step(state, batch):
        out = train_step(state, batch)
        seen.append({k: float(v) for k, v in out[1].items()})
        return out

    state, logged = tool.train(state, recording_step, tool.first_batch(jax_run["data"], IMAGES),
                               3)
    assert len(seen) == 3 and logged == [] and state.step == 3
    for got, want in zip(seen, jax_run["losses"]):
        for k in want:
            assert abs(got[k] - want[k]) <= 1e-5 * abs(want[k]), (k, got, want)


def test_eval_matches_jax_tool(jax_run):
    batch = tool.first_batch(jax_run["data"], IMAGES)
    params = jax_run["state"].params
    want_aps, want_map, want_boxes = witness.jax_tool_eval(params, batch, jax_run["anchors"],
                                                           jax_run["model"])
    assert want_map > 0
    cfg = tool.train_config(preset="test64", compute_dtype="float32")
    port_params = params_from_jax(params)
    _, _, eval_step = tool.setup(cfg, port_params, "cpu")
    aps, mAP, boxes = tool.evaluate(eval_step, port_params, batch)
    assert abs(mAP - want_map) <= 1e-6 and sorted(aps) == sorted(want_aps)
    assert [len(b) for b in boxes] == [len(b) for b in want_boxes]

    def rows(image):  # (class, [score, cx, cy, w, h]) of each box
        return [(b.labelid, np.array([s, b.center.x, b.center.y, b.size.w, b.size.h]))
                for s, b in image]

    for got_rows, want_rows in zip(boxes, want_boxes):
        # one to one, by class: scores a float32 rounding apart may swap places
        left = rows(want_rows)
        for cls, got in rows(got_rows):
            gaps = [np.abs(got - want).max() if c == cls else np.inf for c, want in left]
            i = int(np.argmin(gaps))
            assert gaps[i] <= 1e-5, (cls, got)
            del left[i]


def test_witness_nudges_by_ulps():
    cfg = tool.train_config(preset="test64").model
    base, nudged = (witness.nudged_params(cfg, 0, n) for n in (0, 2))
    for name, leaves in base.items():
        for k, v in leaves.items():
            up = torch.nextafter(torch.nextafter(v, torch.tensor(np.inf)), torch.tensor(np.inf))
            assert torch.equal(nudged[name][k], up), (name, k)


def test_witness_packages_agree_over_the_first_steps(tmp_path, capsys):
    out = tmp_path / "witness.json"
    assert witness.main(["--package", "port", "jax", "--preset", "test64", "--dtype", "float32",
                         "--images", str(IMAGES), "--steps", "2", "--every", "1",
                         "--device", "cpu", "--out", str(out)]) == 0
    port, jax_ = rows = json.loads(out.read_text())
    assert [(r["package"], r["seed"], r["nudge"]) for r in rows] == [("port", 0, 0), ("jax", 0, 0)]
    assert len(capsys.readouterr().out.splitlines()) == 2
    assert [s for s, _, _ in port["curve"]] == [s for s, _, _ in jax_["curve"]] == [1, 2]
    for (_, got, _), (_, want, _) in zip(port["curve"], jax_["curve"]):
        assert abs(got - want) <= 1e-4 * abs(want)


def test_main_runs_one_step_on_the_cpu(capsys):
    assert tool.main(["--device", "cpu", "--steps", "1", "--images", "2", "--batch-size", "2",
                      "--map-target", "0"]) == 0
    out = capsys.readouterr().out
    assert "[i] train mAP after 1 steps:" in out and "[i] PASS" in out


def test_main_defaults_to_cuda():
    if torch.cuda.is_available():
        pytest.skip("a GPU is present; the no-CUDA error cannot occur")
    with pytest.raises(RuntimeError, match="cuda"):
        tool.main([])
