#!/usr/bin/env python3
"""QAT finetune of the PyTorch port: close the int8 gap of a trained
checkpoint (the counterpart of ``tools/qat_finetune.py``).

Restores a float checkpoint, calibrates int8 activation scales on
held-out validation images, finetunes through the fake-quant forward
(``models/qat.py``) for a few epochs, then reports the validation mAP of
the float model, of post-training int8 (PTQ) and of QAT int8, the last two
through the real int8 deploy path (``models/quantized._forward``) with the
scales QAT trained against.

    python3 tools/torch_qat_finetune.py --name run1 --data-dir pascal-voc \\
        --epochs 10 --batch-size 32 --lr 1e-4 --output run1-qat [--device cuda|cpu]

The JAX tool's flags, output lines and exit codes, plus ``--device``:
``cuda`` unless the caller asks for ``cpu``; without a card it raises.
With ``--output`` the QAT checkpoint carries ``qat=True`` and the trained
quantizer (``qat_act_scales`` for VGG, ``qat_act_amax`` for the GroupNorm
families) in the npz format both packages read, so that
``cli/export_model.py --quantize`` deploys exactly those scales.
``chip_smoke.py`` phase 16 runs :func:`main` on the card. Imports nothing
of JAX or of the JAX package.
"""

from __future__ import annotations

import argparse
import sys
from pathlib import Path

import numpy as np

sys.path.insert(0, str(Path(__file__).resolve().parent.parent))


def evaluate(result_fn, td, anchors, batch_size, device, threshold=0.01):
    """Valid-set mAP of a ``(images) -> (B, A, K+5)`` result function."""
    import torch

    from ssd_tensorflow_tpu_torch.eval.average_precision import APCalculator, APs2mAP
    from ssd_tensorflow_tpu_torch.ops.postprocess import (
        DetectionConfig,
        decode_detections,
        detections_to_boxes,
    )

    det_cfg = DetectionConfig(top_k=200, confidence_threshold=threshold)
    calc = APCalculator()
    for batch, gt_lists, n in td.valid_generator(batch_size, num_workers=0):
        with torch.inference_mode():
            r = result_fn(torch.as_tensor(batch["images"]).to(device))
            k = r.shape[-1] - 5
            dets = decode_detections(r[..., : k + 1], r[..., k + 1:], anchors, det_cfg)
        boxes_per_image = detections_to_boxes(dets, td.lid2name)
        for i in range(n):
            calc.add_detections(gt_lists[i], boxes_per_image[i])
    return APs2mAP(calc.compute_aps())


def restore(ckpt, td, lr, device):
    """``(checkpoint config, model config, train config, state)``: the
    model config the checkpoint stores (else the dataset's preset), in
    float32 with the L2-norm epsilon QAT trains with; the checkpoint's
    parameters on ``device`` with fresh momentum."""
    from ssd_tensorflow_tpu_torch.inference import model_config_from_dict
    from ssd_tensorflow_tpu_torch.models.qat import qat_model_config
    from ssd_tensorflow_tpu_torch.models.ssd_vgg import ModelConfig, param_shapes
    from ssd_tensorflow_tpu_torch.parallel.train_step import TrainConfig, make_train_state
    from ssd_tensorflow_tpu_torch.utils.checkpoint import checkpoint_config, read_params

    ckpt_cfg = checkpoint_config(ckpt)
    saved = ckpt_cfg.get("model", {})
    model_cfg = qat_model_config(  # QAT math is exact integers in float32
        model_config_from_dict(saved) if saved else ModelConfig(
            preset_name=td.preset.name, num_classes=td.num_classes))
    train_cfg = TrainConfig(model=model_cfg, lr_values=(lr,), lr_boundaries=(), detect=None)
    params = read_params(ckpt, param_shapes(model_cfg))
    return ckpt_cfg, model_cfg, train_cfg, make_train_state(params, train_cfg, device=device)


def calibration_images(td, batch_size, count):
    """The first ``count`` validation images, in the generator's order."""
    calib = []
    for batch, _, n in td.valid_generator(batch_size, num_workers=0):
        calib.append(np.asarray(batch["images"][:n]))
        if sum(c.shape[0] for c in calib) >= count:
            break
    return np.concatenate(calib)[:count]


def int8_deploy(model_cfg, scales, device):
    """``params -> result function`` through the int8 deploy path: a
    GroupNorm family quantizes with its per-input-channel amax folded into
    the weights, VGG with per-layer scales (the train CLI's ``--qat`` split)."""
    from ssd_tensorflow_tpu_torch.models.quantized import (
        _forward,
        quantize_weights,
        quantize_weights_folded,
    )
    from ssd_tensorflow_tpu_torch.weights import stage_qparams

    family = model_cfg.preset.backbone != "vgg"

    def deploy(params):
        if family:
            staged = stage_qparams(quantize_weights_folded(params, scales), {}, device)
        else:
            staged = stage_qparams(quantize_weights(params), scales, device)
        return lambda x: _forward(staged, x, model_cfg)

    return deploy


def finetune(state, step, td, epochs, batch_size, num_workers):
    """``epochs`` QAT epochs over ``td``'s training batches, printing each
    epoch's mean loss -> ``(state, [mean loss of each epoch])``."""
    import torch

    means = []
    for e in range(epochs):
        losses = []
        for batch, _, _ in td.train_generator(batch_size, num_workers=num_workers):
            state, step_losses, _ = step(state, batch)
            losses.append(step_losses["total"])
        means.append(float(torch.stack(losses).mean()))
        print(f"[i] QAT epoch {e + 1}/{epochs}: loss {means[-1]:.4f}")
    return state, means


def save_qat_checkpoint(output, epochs, state, ckpt_cfg, model_cfg, td, entry):
    """The QAT checkpoint: the original config (train parameters, label
    map) with the full model dict, ``qat=True`` and the trained
    quantizer ``entry``, so that the export deploys exactly it."""
    from ssd_tensorflow_tpu_torch.inference import model_config_to_dict
    from ssd_tensorflow_tpu_torch.utils.checkpoint import CheckpointManager

    out_cfg = dict(
        ckpt_cfg,
        model=model_config_to_dict(model_cfg),
        lid2name=ckpt_cfg.get("lid2name", {str(k): v for k, v in td.lid2name.items()}),
        qat=True,
        **entry,
    )
    mgr = CheckpointManager(output, out_cfg)
    try:
        mgr.save(epochs, state, final=True)
    finally:
        mgr.close()
    print("[i] QAT checkpoint saved:", output)


def main(argv=None):
    parser = argparse.ArgumentParser(description="QAT finetune")
    parser.add_argument("--name", required=True, help="project dir with checkpoints")
    parser.add_argument("--data-dir", required=True)
    parser.add_argument("--output", default=None, help="dir for the QAT checkpoint")
    parser.add_argument("--epochs", type=int, default=10)
    parser.add_argument("--batch-size", type=int, default=32)
    parser.add_argument("--lr", type=float, default=1e-4)
    parser.add_argument("--calib-images", type=int, default=32)
    parser.add_argument("--num-workers", type=int, default=0)
    parser.add_argument("--device", default="cuda",
                        help="torch device (cuda unless asked for cpu; raises without a card)")
    args = parser.parse_args(argv)

    import torch

    from ssd_tensorflow_tpu_torch import resolve_device
    from ssd_tensorflow_tpu_torch.data.pipeline import TrainingData
    from ssd_tensorflow_tpu_torch.models.qat import make_qat_train_step, qat_scales
    from ssd_tensorflow_tpu_torch.models.ssd_vgg import apply_result
    from ssd_tensorflow_tpu_torch.ops.anchors import anchors_for_preset
    from ssd_tensorflow_tpu_torch.utils.checkpoint import find_checkpoint

    device = resolve_device(args.device)
    td = TrainingData(args.data_dir)
    ckpt, epoch = find_checkpoint(args.name)
    if ckpt is None:
        print("[!] no checkpoint in", args.name)
        return 1
    print(f"[i] Checkpoint: {ckpt} (epoch {epoch})")
    ckpt_cfg, model_cfg, train_cfg, state = restore(ckpt, td, args.lr, device)
    anchors_np = anchors_for_preset(model_cfg.preset)
    anchors = torch.as_tensor(anchors_np).to(device)

    # -- calibration on held-out validation images (deterministic order,
    # the train CLI's --qat scheme) ---------------------------------------
    calib = calibration_images(td, args.batch_size, args.calib_images)
    print(f"[i] Calibrating on {calib.shape[0]} images...")
    scales, entry = qat_scales(state.params, model_cfg, calibration_images=calib)
    deploy_int8 = int8_deploy(model_cfg, scales, device)

    # -- baselines --------------------------------------------------------
    params = state.params
    m_float = evaluate(lambda x: apply_result(params, x, model_cfg), td, anchors,
                       args.batch_size, device)
    m_ptq = evaluate(deploy_int8(params), td, anchors, args.batch_size, device)
    print(f"[i] valid mAP  float: {m_float:.4f}   PTQ int8: {m_ptq:.4f}")

    # -- QAT finetune -----------------------------------------------------
    step = make_qat_train_step(train_cfg, anchors_np, scales)
    state, _ = finetune(state, step, td, args.epochs, args.batch_size, args.num_workers)

    # -- QAT int8 evaluation (same deploy path, same scales) ---------------
    m_qat = evaluate(deploy_int8(state.params), td, anchors, args.batch_size, device)
    print(f"[i] valid mAP  float: {m_float:.4f}   PTQ int8: {m_ptq:.4f}   "
          f"QAT int8: {m_qat:.4f}")

    if args.output:
        save_qat_checkpoint(args.output, args.epochs, state, ckpt_cfg, model_cfg, td, entry)
    return 0


if __name__ == "__main__":
    sys.exit(main())
