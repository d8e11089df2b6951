"""The model export CLI, as the JAX package's ``cli/export_model.py``.

    python -m ssd_tensorflow_tpu_torch.cli.export_model --checkpoint-file <ckpt> [flags]

Freezes a training checkpoint into a standalone inference bundle, the npz
format both packages read (``inference.save_bundle``): the float bundle,
or with ``--quantize`` an int8 W8A8 bundle (``models/qat.export_int8_bundle``:
a QAT checkpoint's stored grids, else calibrated on
``--calibration-images``). The same flags as the JAX CLI, plus
``--device`` (``cuda`` unless asked for ``cpu``), where the calibration
runs and the exported program is traced.

``--torch-export PATH`` takes the place of the JAX CLI's ``--stablehlo``
(which exits 1 here): it writes ``torch.export.save`` of the float
``apply_result`` with the parameters baked in, on a ``(N, H, W, 3)`` uint8
input (``N = --torch-export-batch-size``), traced on ``--device``. A bf16
VGG program holds the stem kernel's operator (``ssd_torch::fused_stem``),
so loading it needs the port imported, which registers that operator::

    import ssd_tensorflow_tpu_torch.inference  # registers ssd_torch::*
    program = torch.export.load(path).module()
    result = program(images)                   # (N, A, K+5)
"""

from __future__ import annotations

import argparse
import sys

import numpy as np
import torch

from ssd_tensorflow_tpu_torch import resolve_device
from ssd_tensorflow_tpu_torch.inference import (
    InferenceModel,
    load_calibration_images,
    load_params_from_train_checkpoint,
    save_bundle,
)
from ssd_tensorflow_tpu_torch.models import qat
from ssd_tensorflow_tpu_torch.models.ssd_vgg import apply_result
from ssd_tensorflow_tpu_torch.utils.checkpoint import checkpoint_config


def build_parser():
    parser = argparse.ArgumentParser(description="Export a trained model")
    parser.add_argument("--checkpoint-file", required=True, help="training checkpoint (.npz)")
    parser.add_argument("--output-file", default="model.ssdtpu.npz", help="output bundle file")
    parser.add_argument("--quantize", action="store_true",
                        help="export an int8 W8A8 deploy bundle (models/quantized.py)")
    parser.add_argument("--calibration-images", nargs="*", default=None,
                        help="images used to calibrate int8 activation scales")
    parser.add_argument(
        "--calibration-percentile", type=float, default=100.0,
        help="activation amplitude percentile for int8 scales; the default 100 (max-abs) "
        "is measured best (models/quantized.py)")
    parser.add_argument(
        "--allow-noise-calibration", action="store_true",
        help="permit calibrating on random noise when no images are given (deploy-quality "
        "scales need real images)")
    parser.add_argument("--stablehlo", default=None,
                        help="a JAX StableHLO program: refused here, use --torch-export")
    parser.add_argument("--stablehlo-batch-size", type=int, default=32,
                        help="batch size of --stablehlo (refused with it)")
    parser.add_argument("--torch-export", default=None, metavar="PATH",
                        help="also write the float forward as a torch.export program to PATH")
    parser.add_argument("--torch-export-batch-size", type=int, default=32,
                        help="batch size baked into the --torch-export program")
    parser.add_argument("--device", default="cuda", choices=["cuda", "cpu"],
                        help="where to calibrate and trace the exported program")
    return parser


class ResultProgram(torch.nn.Module):
    """``apply_result`` of fixed parameters, as a module whose buffers are
    the parameters (staged as :class:`~ssd_tensorflow_tpu_torch.inference.
    InferenceModel` stages them), so that ``torch.export`` bakes them in."""

    def __init__(self, params, config):
        super().__init__()
        self.config = config
        self.leaves = [(name, key) for name in params for key in params[name]]
        for name, key in self.leaves:
            self.register_buffer(f"{name}__{key}", params[name][key])

    def forward(self, images):
        params = {}
        for name, key in self.leaves:
            params.setdefault(name, {})[key] = getattr(self, f"{name}__{key}")
        return apply_result(params, images, self.config)


def export_program(params, model_cfg, batch: int, device="cuda"):
    """``torch.export.export`` of the float forward ``apply_result`` of
    ``params`` on a ``(batch, H, W, 3)`` uint8 input on ``device``."""
    model = InferenceModel(params, model_cfg, device=device)
    size = model_cfg.preset.image_size
    images = torch.zeros((batch, size.h, size.w, 3), dtype=torch.uint8, device=model.device)
    return torch.export.export(ResultProgram(model.params, model.config), (images,))


def _calibration_batch(args, model_cfg):
    """The uint8 calibration batch, or None when there is none and noise was
    not allowed."""
    h, w = model_cfg.preset.image_size.h, model_cfg.preset.image_size.w
    if args.calibration_images:
        return load_calibration_images(args.calibration_images, h, w)
    if not args.allow_noise_calibration:
        print("[!] int8 export needs --calibration-images (real images from the training "
              "distribution); pass --allow-noise-calibration to override for testing")
        return None
    print("[!] no calibration images given; using random noise")
    return np.random.default_rng(0).integers(0, 255, (2, h, w, 3), dtype=np.uint8)


def main(argv=None):
    args = build_parser().parse_args(argv)

    print("[i] Checkpoint file:", args.checkpoint_file)
    print("[i] Output file:    ", args.output_file)
    if args.stablehlo:
        print("[!] --stablehlo writes a JAX StableHLO program, which the PyTorch port has no "
              "counterpart for; use --torch-export PATH (a torch.export program)")
        return 1
    device = resolve_device(args.device)
    params, model_cfg, lid2name = load_params_from_train_checkpoint(args.checkpoint_file)

    if args.quantize:
        stored = checkpoint_config(args.checkpoint_file)
        calibration = None
        if any(stored.get(k) is not None for k in ("qat_act_amax", "qat_act_scales")):
            print("[i] QAT checkpoint: exporting with the trained activation grids "
                  "(no recalibration)")
        else:
            calibration = _calibration_batch(args, model_cfg)
            if calibration is None:
                return 1
        qat.export_int8_bundle(args.checkpoint_file, args.output_file, calibration,
                               percentile=args.calibration_percentile, device=device)
        print("[i] int8 bundle written:", args.output_file)
    else:
        save_bundle(args.output_file, params, model_cfg, lid2name)
        print("[i] Bundle written:", args.output_file)

    if args.torch_export:
        program = export_program(params, model_cfg, args.torch_export_batch_size, device)
        torch.export.save(program, args.torch_export)
        print("[i] torch.export program written:", args.torch_export)
    return 0


def run():
    sys.exit(main())


if __name__ == "__main__":
    run()
