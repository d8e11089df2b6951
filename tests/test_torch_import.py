"""Import hygiene of the PyTorch port: it runs without JAX, imports nothing
of the JAX package, and never quietly falls back to the CPU."""

import re
import subprocess
import sys
from pathlib import Path

import pytest
import torch

ROOT = Path(__file__).resolve().parent.parent
PORT = ROOT / "ssd_tensorflow_tpu_torch"
TOOLS = [ROOT / "tools" / f"torch_{name}.py" for name in ("profile", "stem_probe", "conv_epilogue", "stem_bench", "kernel_bench", "int8_probe")]
_JAX_PACKAGE = re.compile(r"^\s*(from|import)\s+(ssd_tensorflow_tpu|jax)(\.|\s|$)", re.M)


def _port_sources():
    return sorted(PORT.rglob("*.py")) + [ROOT / "chip_smoke.py", *TOOLS]


def test_port_imports_with_jax_blocked():
    modules = sorted(
        ".".join(p.relative_to(ROOT).with_suffix("").parts).replace(".__init__", "")
        for p in PORT.rglob("*.py")
    )
    code = (
        "import sys; sys.modules['jax'] = None; sys.modules['ssd_tensorflow_tpu'] = None\n"
        + "".join(f"import {m}\n" for m in modules)
        + "import chip_smoke, importlib.util\n"
        + "".join(f"s = importlib.util.spec_from_file_location('t{i}', {str(p)!r}); "
                  "s.loader.exec_module(importlib.util.module_from_spec(s))\n"
                  for i, p in enumerate(TOOLS))
        + "assert not any(k == 'jax' or k.startswith(('jax.', 'ssd_tensorflow_tpu.'))"
        " for k, v in sys.modules.items() if v is not None)\n"
    )
    subprocess.run([sys.executable, "-c", code], cwd=ROOT, check=True, timeout=120)


def test_inference_loads_nothing_of_training():
    """The serving façade, its weight bridge and the checkpoint reader
    import none of the training step, the loss or the anchor matching."""
    code = (
        "import sys\n"
        "import ssd_tensorflow_tpu_torch.inference, ssd_tensorflow_tpu_torch.weights\n"
        "import ssd_tensorflow_tpu_torch.utils.checkpoint\n"
        "loaded = [m for m in ('ssd_tensorflow_tpu_torch.parallel.train_step',"
        " 'ssd_tensorflow_tpu_torch.models.loss', 'ssd_tensorflow_tpu_torch.ops.matching')"
        " if m in sys.modules]\n"
        "assert not loaded, loaded\n"
    )
    subprocess.run([sys.executable, "-c", code], cwd=ROOT, check=True, timeout=120)


def test_inference_loads_nothing_of_the_cli_pipeline_or_parallel():
    """The serving façade imports none of the train CLI, the host data
    pipeline or the parallel package (the process group, prefetch, remat)."""
    code = (
        "import sys\n"
        "import ssd_tensorflow_tpu_torch.inference\n"
        "loaded = [m for m in sys.modules if m.startswith(("
        "'ssd_tensorflow_tpu_torch.cli', 'ssd_tensorflow_tpu_torch.data.pipeline',"
        " 'ssd_tensorflow_tpu_torch.parallel'))]\n"
        "assert not loaded, loaded\n"
    )
    subprocess.run([sys.executable, "-c", code], cwd=ROOT, check=True, timeout=120)


def test_train_cli_pipeline_and_parallel_modules_are_scanned():
    """The train CLI, the host pipeline, mAP, summaries and the parallel
    modules are among the modules imported with ``jax`` blocked and scanned
    for imports of the JAX package."""
    sources = {str(p.relative_to(ROOT)) for p in _port_sources()}
    assert {f"ssd_tensorflow_tpu_torch/{m}.py" for m in (
        "cli/train", "data/pipeline", "data/transforms", "data/shm_queue",
        "eval/average_precision", "utils/profiling", "utils/tensorboard", "utils/summaries",
        "parallel/mesh", "parallel/multihost", "parallel/sharding", "parallel/prefetch",
        "parallel/remat")} <= sources


@pytest.mark.parametrize("path", _port_sources(), ids=lambda p: str(p.relative_to(ROOT)))
def test_source_names_no_jax_package(path):
    assert not _JAX_PACKAGE.search(path.read_text()), path


def test_cuda_request_without_cuda_raises():
    if torch.cuda.is_available():
        pytest.skip("a GPU is present; the no-CUDA error cannot occur")
    from ssd_tensorflow_tpu_torch.inference import InferenceModel
    from ssd_tensorflow_tpu_torch.models.ssd_vgg import ModelConfig, init_params

    cfg = ModelConfig(preset_name="test64", num_classes=3)
    with pytest.raises(RuntimeError, match="cuda"):
        InferenceModel(init_params(cfg), cfg)  # device="cuda" is the default


def test_int8_bundle_model_defaults_to_cuda():
    if torch.cuda.is_available():
        pytest.skip("a GPU is present; the no-CUDA error cannot occur")
    from ssd_tensorflow_tpu_torch.inference import InferenceModel

    with pytest.raises(RuntimeError, match="cuda"):
        InferenceModel.from_bundle(str(ROOT / "assets" / "vgg512_int8_minivoc.ssdtpu.npz"))


def test_training_entry_points_default_to_cuda(tmp_path):
    """The train state and the checkpoint-built model are placed on
    ``device="cuda"`` unless the caller asks for the CPU."""
    if torch.cuda.is_available():
        pytest.skip("a GPU is present; the no-CUDA error cannot occur")
    from ssd_tensorflow_tpu_torch.inference import InferenceModel, model_config_to_dict
    from ssd_tensorflow_tpu_torch.models.ssd_vgg import ModelConfig, init_params
    from ssd_tensorflow_tpu_torch.parallel.train_step import TrainConfig, make_train_state
    from ssd_tensorflow_tpu_torch.utils.checkpoint import save_checkpoint

    cfg = TrainConfig(model=ModelConfig(preset_name="test64", num_classes=3))
    with pytest.raises(RuntimeError, match="cuda"):
        make_train_state(init_params(cfg.model), cfg)
    path = str(tmp_path / "e1.ckpt.npz")
    save_checkpoint(path, make_train_state(init_params(cfg.model), cfg, device="cpu"),
                    {"model": model_config_to_dict(cfg.model)})
    with pytest.raises(RuntimeError, match="cuda"):
        InferenceModel.from_checkpoint(path)
    assert InferenceModel.from_checkpoint(path, device="cpu").config == cfg.model


def test_chip_smoke_refuses_without_the_repo_or_a_gpu(tmp_path):
    lone = tmp_path / "chip_smoke.py"
    lone.write_text((ROOT / "chip_smoke.py").read_text())
    for cwd, script in ((tmp_path, lone), (ROOT, ROOT / "chip_smoke.py")):
        if cwd == ROOT and torch.cuda.is_available():
            continue
        proc = subprocess.run([sys.executable, str(script)], cwd=cwd, capture_output=True,
                              text=True, timeout=120)
        assert proc.returncode != 0
        assert '"ok"' not in proc.stdout


@pytest.mark.parametrize("fname", ["resnet320_int8_minicoco.ssdtpu.npz",
                                   "mobilenet320_int8_qat_minivoc.ssdtpu.npz"])
def test_family_entry_points_default_to_cuda(fname):
    """The family bundles' models, a family float model and a family
    ``QuantizedModel`` are placed on ``device="cuda"`` unless the caller
    asks for the CPU."""
    if torch.cuda.is_available():
        pytest.skip("a GPU is present; the no-CUDA error cannot occur")
    import numpy as np

    from ssd_tensorflow_tpu_torch.inference import InferenceModel
    from ssd_tensorflow_tpu_torch.models.quantized import QuantizedModel
    from ssd_tensorflow_tpu_torch.models.ssd_vgg import ModelConfig, init_params

    with pytest.raises(RuntimeError, match="cuda"):
        InferenceModel.from_bundle(str(ROOT / "assets" / fname))
    preset = "rtest64" if fname.startswith("resnet") else "mntest64"
    cfg = ModelConfig(preset_name=preset, num_classes=3)
    with pytest.raises(RuntimeError, match="cuda"):
        InferenceModel(init_params(cfg), cfg)
    with pytest.raises(RuntimeError, match="cuda"):
        QuantizedModel(init_params(cfg), cfg, np.zeros((1, 64, 64, 3), np.uint8))


def test_qat_and_augmentation_modules_are_scanned():
    """The QAT module and the on-device augmentation are among the modules
    imported with ``jax`` blocked and scanned above."""
    sources = {str(p.relative_to(ROOT)) for p in _port_sources()}
    assert {"ssd_tensorflow_tpu_torch/models/qat.py",
            "ssd_tensorflow_tpu_torch/data/device_augment.py",
            "ssd_tensorflow_tpu_torch/data/__init__.py"} <= sources


def test_qat_export_calibrates_on_cuda_by_default(tmp_path):
    """The int8 export of a checkpoint without QAT scales calibrates on
    ``device="cuda"`` unless the caller asks for the CPU; a CUDA generator
    is the augmentation's way onto the card."""
    if torch.cuda.is_available():
        pytest.skip("a GPU is present; the no-CUDA error cannot occur")
    import numpy as np

    from ssd_tensorflow_tpu_torch.inference import model_config_to_dict
    from ssd_tensorflow_tpu_torch.models import qat
    from ssd_tensorflow_tpu_torch.models.ssd_vgg import ModelConfig, init_params
    from ssd_tensorflow_tpu_torch.parallel.train_step import TrainConfig, make_train_state
    from ssd_tensorflow_tpu_torch.utils.checkpoint import save_checkpoint

    cfg = qat.qat_model_config(ModelConfig(preset_name="mntest64", num_classes=3))
    path = str(tmp_path / "e1.ckpt.npz")
    save_checkpoint(path, make_train_state(init_params(cfg), TrainConfig(model=cfg), device="cpu"),
                    {"model": model_config_to_dict(cfg)})
    images = np.zeros((1, 64, 64, 3), np.uint8)
    with pytest.raises(RuntimeError, match="cuda"):
        qat.export_int8_bundle(path, str(tmp_path / "b.npz"), images)
    with pytest.raises(RuntimeError):
        torch.Generator("cuda")


def test_serving_modules_are_scanned():
    """The serving and evaluation CLIs, the data sources, host image I/O and
    the result writers are among the modules imported with ``jax`` blocked
    and scanned for imports of the JAX package."""
    sources = {str(p.relative_to(ROOT)) for p in _port_sources()}
    assert {f"ssd_tensorflow_tpu_torch/{m}.py" for m in (
        "cli/detect", "cli/infer", "cli/export_model", "cli/process_dataset", "data/sources",
        "data/source_pascal_voc", "data/source_coco", "data/source_synthetic", "data/image_io",
        "eval/pascal_summary", "eval/coco_results")} <= sources


def test_image_io_without_opencv_raises():
    """Without OpenCV the port's image I/O raises with a clear message (the
    package has no stand-in decoder); the serving modules still import."""
    code = (
        "import sys; sys.modules['cv2'] = None\n"
        "import ssd_tensorflow_tpu_torch.cli.detect, ssd_tensorflow_tpu_torch.cli.infer\n"
        "from ssd_tensorflow_tpu_torch.data import image_io\n"
        "for call in (lambda: image_io.imread('x.jpg'), lambda: image_io.resize(None, (2, 2)),\n"
        "             lambda: image_io.imwrite('x.jpg', None)):\n"
        "    try:\n"
        "        call()\n"
        "    except RuntimeError as e:\n"
        "        assert 'OpenCV' in str(e), e\n"
        "    else:\n"
        "        raise AssertionError('no error without cv2')\n"
    )
    subprocess.run([sys.executable, "-c", code], cwd=ROOT, check=True, timeout=120)


def test_multichip_and_tensor_parallel_modules_are_scanned():
    """The dry run and the tensor-parallel functions are among the modules
    imported with ``jax`` blocked and scanned for imports of the JAX
    package."""
    sources = {str(p.relative_to(ROOT)) for p in _port_sources()}
    assert {"ssd_tensorflow_tpu_torch/multichip.py",
            "ssd_tensorflow_tpu_torch/parallel/tensor_parallel.py"} <= sources
