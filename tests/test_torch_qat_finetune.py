"""The port's QAT finetune tool (``tools/torch_qat_finetune.py``) against
the JAX package's (``tools/qat_finetune.py``), on the CPU, at test64 (VGG,
per-layer ``qat_act_scales``) and mntest64 (a GroupNorm family,
per-input-channel ``qat_act_amax``).

Both tools run ``main`` with ``--epochs 2 --batch-size 4 --calib-images 4
--output`` on one dataset directory (``tests/torch_datasets.py``: 8 train
and 4 valid images, one class) from one float checkpoint of JAX parameters
(a seed, then a few JAX steps, :data:`PRETRAIN`), with ``random`` and numpy
seeded alike (the host pipeline's shuffle and augmentation draws). Each
tool's ``evaluate`` and QAT steps are recorded.

The port's own calibration is held to JAX's within 1e-5 of each layer's
largest (float32 forwards summed in another order), then JAX's values are
handed on, and JAX's activation grids to the port's QAT steps
(``tests/torch_qat_grids.py``): left to its own roundings the fake-quant
forward drifts (ROADMAP.md section 3), and an mAP over 4 images moves in
steps of 1/4 of a class's recall. With them:

- every QAT step's loss within 1e-4 relative, and the float mAP within
  1e-4;
- VGG: the PTQ and QAT int8 mAPs within 1e-4 (the int8 VGG path matches
  JAX's, ``tests/test_torch_quantized.py``);
- mntest64: each QAT checkpoint's int8 forward on the valid images against
  the JAX package's at ``tests/test_torch_quantized_families.py``'s bounds
  (conf within 0.05, argmax on >= 98 %, locs within 0.05 of the largest:
  its GroupNorms sum in another order than XLA's);
- the two QAT checkpoints' configs equal, each restores in the other
  package, and the port's ``cli/export_model.py --quantize`` of it writes
  the stored scales.
"""

import contextlib
import io
import random
import sys
from contextlib import redirect_stdout
from pathlib import Path
from unittest import mock

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from ssd_tensorflow_tpu import inference as jax_inference
from ssd_tensorflow_tpu.data.pipeline import TrainingData as JaxTrainingData
from ssd_tensorflow_tpu.models import qat as jax_qat
from ssd_tensorflow_tpu.models import quantized as jax_quantized
from ssd_tensorflow_tpu.models import ssd_vgg as jax_ssd
from ssd_tensorflow_tpu.ops.anchors import anchors_for_preset
from ssd_tensorflow_tpu.parallel import train_step as jax_ts
from ssd_tensorflow_tpu.utils import checkpoint as jax_ckpt
from ssd_tensorflow_tpu_torch.cli import export_model
from ssd_tensorflow_tpu_torch.data.pipeline import TrainingData
from ssd_tensorflow_tpu_torch.inference import load_bundle
from ssd_tensorflow_tpu_torch.models import qat, quantized
from ssd_tensorflow_tpu_torch.models.ssd_vgg import ModelConfig, init_params, param_shapes
from ssd_tensorflow_tpu_torch.parallel.train_step import TrainConfig, make_train_state
from ssd_tensorflow_tpu_torch.utils.checkpoint import (
    checkpoint_config,
    read_params,
    restore_checkpoint,
)
from ssd_tensorflow_tpu_torch.weights import params_to_jax, stage_qparams

pytest.importorskip("cv2")
ROOT = Path(__file__).resolve().parent.parent
sys.path.insert(0, str(ROOT / "tools"))
sys.path.insert(0, str(ROOT / "tests"))
import qat_finetune as jax_tool  # noqa: E402
import torch_family_checks as fc  # noqa: E402
import torch_qat_finetune as tool  # noqa: E402
from torch_datasets import make_dataset  # noqa: E402
from torch_qat_grids import Grids  # noqa: E402

ARGS = ["--epochs", "2", "--batch-size", "4", "--calib-images", "4"]


@pytest.fixture(scope="module", autouse=True)
def _two_torch_threads():
    """torch's CPU ops on 2 threads: under the suite's parallel workers the
    full-width weight passes of the QAT step on every core thrash."""
    saved = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(saved)


@pytest.fixture(scope="module")
def dataset(tmp_path_factory):
    return make_dataset(str(tmp_path_factory.mktemp("qat_data")), 8, 4)[0]


#: the float checkpoint's JAX training (lr, steps) on the 8 train images:
#: an untrained model's scores are near-equal, and float32 noise reorders
#: its detections and moves its mAP; trained, its scores stand apart
PRETRAIN = {"test64": (5e-4, 40), "mntest64": (1e-3, 30)}


def _float_checkpoint(project: Path, preset: str, data_dir: str):
    """``e1.ckpt.npz`` of JAX parameters from a seed, trained by the JAX
    package on the train images without augmentation (:data:`PRETRAIN`),
    with its model config and label map."""
    lr, steps = PRETRAIN[preset]
    cfg = jax_ssd.ModelConfig(preset_name=preset, num_classes=1, compute_dtype="float32")
    tcfg = jax_ts.TrainConfig(model=cfg, lr_values=(lr,), lr_boundaries=(), detect=None)
    td = JaxTrainingData(data_dir)
    td.valid_samples = td.train_samples  # the train images, unaugmented
    batch, _, _ = next(iter(td.valid_generator(8)))
    batch = {k: jnp.asarray(v) for k, v in batch.items()}
    step = jax_ts.make_train_step(tcfg, anchors_for_preset(cfg.preset))
    state = jax_ts.make_train_state(jax_ssd.init_params(jax.random.PRNGKey(0), cfg), tcfg)
    for _ in range(steps):
        state, _, _ = step(state, batch)
    project.mkdir(parents=True)
    jax_ckpt.save_checkpoint(str(project / "e1.ckpt.npz"), state,
                             {"model": jax_inference.model_config_to_dict(cfg),
                              "lid2name": {"0": "square"}, "epoch": 1})


class _Recorder:
    """What a tool's ``main`` hands to its ``evaluate`` and its QAT steps:
    the mAPs in the order evaluated and each step's total loss."""

    def __init__(self, tool_module, qat_module):
        self.maps, self.losses = [], []
        self.patches = [
            mock.patch.object(tool_module, "evaluate", self._evaluate(tool_module.evaluate)),
            mock.patch.object(qat_module, "make_qat_train_step",
                              self._make_step(qat_module.make_qat_train_step))]

    def _evaluate(self, real):
        def evaluate(*args, **kw):
            self.maps.append(float(real(*args, **kw)))
            return self.maps[-1]
        return evaluate

    def _make_step(self, real):
        def make_step(*args, **kw):
            step = real(*args, **kw)

            def call(state, batch):
                out = step(state, batch)
                self.losses.append(float(out[1]["total"]))
                return out
            return call
        return make_step


def _main(module, argv, patches):
    """``module.main(argv)`` under ``patches``, ``random`` and numpy seeded
    alike (the pipeline's shuffle and augmentation): its output."""
    random.seed(11)
    np.random.seed(11)
    buf = io.StringIO()
    with contextlib.ExitStack() as stack, redirect_stdout(buf):
        for p in patches:
            stack.enter_context(p)
        assert module.main(argv) == 0
    return buf.getvalue()


def _calibration_recorder(calibrations: list):
    """The JAX package's two calibrations, each result kept."""
    def wrap(real):
        def calibrate(*args, **kw):
            calibrations.append(real(*args, **kw))
            return calibrations[-1]
        return calibrate
    return [mock.patch.object(jax_quantized, name, wrap(getattr(jax_quantized, name)))
            for name in ("calibrate_activation_scales", "calibrate_activation_amax")]


def _handed_scales(jax_scales: list, own: list):
    """The port's ``qat_scales`` calibrating as it does (the result kept in
    ``own``), then handing on the JAX package's calibration as a resumed
    checkpoint's stored values."""
    real = qat.qat_scales

    def qat_scales(params, model_cfg, stored_config=None, calibration_images=None):
        own.append(real(params, model_cfg, stored_config, calibration_images)[0])
        return real(params, model_cfg, {qat.qat_checkpoint_key(model_cfg): jax_scales[0]})
    return mock.patch.object(qat, "qat_scales", qat_scales)


def _int8_scores(ckpt, preset, images):
    """The family int8 forward's ``(conf, cls, locs)`` of a QAT checkpoint
    through its stored amax, in both packages."""
    cfg = qat.qat_model_config(ModelConfig(preset_name=preset, num_classes=1))
    params = read_params(ckpt, param_shapes(cfg))
    amax = {k: np.asarray(v, np.float32) for k, v in checkpoint_config(ckpt)["qat_act_amax"].items()}
    staged = stage_qparams(quantized.quantize_weights_folded(params, amax), {}, "cpu")
    with torch.inference_mode():
        port = [v.numpy() for v in quantized._forward_scores(staged, torch.from_numpy(images), cfg)]
    jcfg = jax_ssd.ModelConfig(preset_name=preset, num_classes=1, compute_dtype="float32",
                               l2_norm_eps=1e-3)
    jqp = jax_quantized.quantize_weights_folded(params_to_jax(params), amax)
    want = jax.jit(lambda qp, x: jax_quantized._forward_scores(qp, {}, x, jcfg))(jqp, images)
    return port, [np.asarray(v) for v in want]


@pytest.mark.parametrize("preset", ["test64", "mntest64"])
def test_qat_finetune_matches_jax_tool(dataset, tmp_path, preset):
    _float_checkpoint(tmp_path / "float", preset, dataset)
    common = ["--name", str(tmp_path / "float"), "--data-dir", dataset, *ARGS]
    grids, jax_scales, own_scales = Grids(), [], []
    want, got = _Recorder(jax_tool, jax_qat), _Recorder(tool, qat)
    _main(jax_tool, [*common, "--output", str(tmp_path / "jax")],
          [*want.patches, *_calibration_recorder(jax_scales),
           mock.patch.object(jax_qat, "fake_quant_act", grids.recording(jax_qat.fake_quant_act))])
    jax.effects_barrier()
    log = _main(tool, [*common, "--output", str(tmp_path / "port"), "--device", "cpu"],
                [*got.patches, _handed_scales(jax_scales, own_scales),
                 mock.patch.object(qat, "fake_quant_act", grids.forced())])
    print(preset, "mAPs", got.maps, want.maps, "losses", got.losses, want.losses,
          "roundings differing, of all", grids.differing())
    assert "QAT int8:" in log and "[i] QAT epoch 2/2: loss" in log
    assert len(got.maps) == len(want.maps) == 3 and len(got.losses) == len(want.losses) == 4
    assert want.maps[0] > 0 and abs(got.maps[0] - want.maps[0]) <= 1e-4
    assert np.allclose(got.losses, want.losses, rtol=1e-4, atol=0)
    (jax_cal,), (own,) = jax_scales, own_scales
    assert sorted(own) == sorted(jax_cal)
    for layer in jax_cal:
        w = np.asarray(jax_cal[layer], np.float32)
        assert np.abs(np.asarray(own[layer], np.float32) - w).max() <= 1e-5 * np.abs(w).max()

    got_ckpt, want_ckpt = (str(tmp_path / p / "final.ckpt.npz") for p in ("port", "jax"))
    got_cfg, want_cfg = checkpoint_config(got_ckpt), checkpoint_config(want_ckpt)
    assert got_cfg == want_cfg and got_cfg["qat"] is True
    key = qat.qat_checkpoint_key(ModelConfig(preset_name=preset, num_classes=1))
    if key == "qat_act_scales":  # the int8 VGG path matches JAX's
        assert np.abs(np.subtract(got.maps, want.maps)).max() <= 1e-4
    else:  # a family's GroupNorms: tests/test_torch_quantized_families.py's bounds
        batch, _, _ = next(iter(TrainingData(dataset).valid_generator(4)))
        for ckpt in (got_ckpt, want_ckpt):
            port, jax_ = _int8_scores(ckpt, preset, batch["images"])
            assert float(np.abs(port[0] - jax_[0]).max()) < 0.05
            assert float(np.mean(port[1] == jax_[1])) >= 0.98
            assert fc.rel(port[2], jax_[2]) <= 0.05

    # each package restores the other's QAT checkpoint
    cfg = qat.qat_model_config(ModelConfig(preset_name=preset, num_classes=1))
    template = make_train_state(init_params(cfg), TrainConfig(model=cfg), device="cpu")
    assert restore_checkpoint(want_ckpt, template).step == 4
    jcfg = jax_ssd.ModelConfig(preset_name=preset, num_classes=1, compute_dtype="float32")
    jstate = jax_ckpt.restore_checkpoint(
        got_ckpt, jax_ts.make_train_state(jax_ssd.init_params(jax.random.PRNGKey(1), jcfg),
                                          jax_ts.TrainConfig(model=jcfg)))
    assert int(jstate.step) == 4

    # the export deploys the stored scales, with no calibration images
    bundle = str(tmp_path / "qat.ssdtpu.npz")
    with redirect_stdout(io.StringIO()):
        assert export_model.main(["--checkpoint-file", got_ckpt, "--output-file", bundle,
                                  "--quantize", "--device", "cpu"]) == 0
    qparams, _, _, act_scales = load_bundle(bundle)
    if key == "qat_act_scales":
        assert act_scales == got_cfg[key]
    else:
        assert act_scales == {}
        for layer, amax in got_cfg[key].items():
            want_scale = quantized.folded_a_scale(amax)
            assert np.array_equal(qparams[layer]["a_scale"].numpy(), want_scale), layer


def test_main_defaults_to_cuda(dataset, tmp_path):
    if torch.cuda.is_available():
        pytest.skip("a GPU is present; the no-CUDA error cannot occur")
    with pytest.raises(RuntimeError, match="cuda"):
        tool.main(["--name", str(tmp_path), "--data-dir", dataset])
