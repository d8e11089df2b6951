"""The port's VGG weight converter (``tools/torch_convert_vgg_weights.py``)
against the JAX package's (``tools/convert_vgg_weights.py``), on the CPU.

One full-size state dict in torchvision's ``vgg16`` layout, random weights
from a seed (``tests/test_vgg_convert.py``'s construction), goes through
both converters: every output array equal bit for bit, the ``.pth`` path of
``main`` included. The port's npz lays over a vgg300 model through the
port's ``load_pretrained_vgg``. An npz with raw ``fc6`` / ``fc7`` decimates
as the JAX tool's does; without a card the default device raises.
"""

import sys
from pathlib import Path

import numpy as np
import pytest
import torch

from ssd_tensorflow_tpu_torch.models.ssd_vgg import ModelConfig, init_params
from ssd_tensorflow_tpu_torch.models.vgg16 import VGG_CONV_LAYERS, load_pretrained_vgg

sys.path.insert(0, str(Path(__file__).resolve().parent.parent / "tools"))
import convert_vgg_weights as jax_tool  # noqa: E402
import torch_convert_vgg_weights as tool  # noqa: E402


@pytest.fixture(scope="module")
def state_dict():
    torch.manual_seed(0)
    layer_channels = [
        (0, 3, 64), (2, 64, 64),
        (5, 64, 128), (7, 128, 128),
        (10, 128, 256), (12, 256, 256), (14, 256, 256),
        (17, 256, 512), (19, 512, 512), (21, 512, 512),
        (24, 512, 512), (26, 512, 512), (28, 512, 512),
    ]
    sd = {}
    for idx, cin, cout in layer_channels:
        sd[f"features.{idx}.weight"] = torch.randn(cout, cin, 3, 3) * 0.05
        sd[f"features.{idx}.bias"] = torch.randn(cout) * 0.05
    sd["classifier.0.weight"] = torch.randn(4096, 512 * 7 * 7) * 0.01
    sd["classifier.0.bias"] = torch.randn(4096) * 0.01
    sd["classifier.3.weight"] = torch.randn(4096, 4096) * 0.01
    sd["classifier.3.bias"] = torch.randn(4096) * 0.01
    # the 1000-way head of a real state dict, which the converters ignore
    sd["classifier.6.weight"] = torch.randn(1000, 4096) * 0.01
    sd["classifier.6.bias"] = torch.randn(1000) * 0.01
    return sd


def _equal(got: dict, want: dict):
    assert sorted(got) == sorted(want)
    for k in want:
        assert got[k].dtype == want[k].dtype and np.array_equal(got[k], want[k]), k


def test_torchvision_conversion_equals_jax_tool(state_dict, tmp_path):
    want = jax_tool.convert_torchvision(state_dict)
    _equal(tool.convert_torchvision(state_dict), want)
    pth, npz = tmp_path / "vgg16.pth", tmp_path / "vgg16.npz"
    torch.save(state_dict, str(pth))
    assert tool.main([str(pth), "--output", str(npz), "--device", "cpu"]) == 0
    pth.unlink()  # 0.5 GB
    with np.load(npz) as data:
        _equal(dict(data), want)

    cfg = ModelConfig(preset_name="vgg300", compute_dtype="float32")
    params = init_params(cfg)
    loaded = load_pretrained_vgg(str(npz), params)
    for name in [n for n, _ in VGG_CONV_LAYERS] + ["mod_conv6", "mod_conv7"]:
        w = loaded[name]["w"].numpy().transpose(2, 3, 1, 0)  # OIHW -> HWIO
        assert np.array_equal(w, want[f"{name}/w"]), name
        assert np.array_equal(loaded[name]["b"].numpy(), want[f"{name}/b"]), name
    assert loaded["conv8_1"] is params["conv8_1"]


def test_npz_with_raw_fc_layers_decimates_as_the_jax_tool(state_dict, tmp_path):
    raw = {k: v for k, v in jax_tool.convert_torchvision(state_dict).items()
           if not k.startswith("mod_conv")}
    raw["fc6/w"] = np.transpose(state_dict["classifier.0.weight"].numpy().reshape(
        4096, 512, 7, 7), (2, 3, 1, 0))
    raw["fc6/b"] = state_dict["classifier.0.bias"].numpy()
    raw["fc7/w"] = state_dict["classifier.3.weight"].numpy().T[None, None]
    raw["fc7/b"] = state_dict["classifier.3.bias"].numpy()
    src = tmp_path / "raw.npz"
    np.savez(src, **raw)
    outs = {}
    for name, main, extra in (("jax", jax_tool.main, []),
                              ("port", tool.main, ["--device", "cpu"])):
        outs[name] = tmp_path / f"{name}.npz"
        assert main([str(src), "--output", str(outs[name]), *extra]) == 0
    src.unlink()  # 0.5 GB
    with np.load(outs["port"]) as got, np.load(outs["jax"]) as want:
        _equal(dict(got), dict(want))
        assert got["mod_conv6/w"].shape == (3, 3, 512, 1024) and "fc6/w" not in got


def test_main_defaults_to_cuda(tmp_path):
    if torch.cuda.is_available():
        pytest.skip("a GPU is present; the no-CUDA error cannot occur")
    src = tmp_path / "empty.npz"
    np.savez(src, x=np.zeros(1))
    with pytest.raises(RuntimeError, match="cuda"):
        tool.main([str(src), "--output", str(tmp_path / "out.npz")])
