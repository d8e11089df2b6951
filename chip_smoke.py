#!/usr/bin/env python3
"""Drive the PyTorch port's detection paths on one NVIDIA GPU.

Run from the repository root:

    python3 chip_smoke.py [--seed 0] [--batch 64]

Phases, each printing one JSON line; any failed check raises and exits
non-zero, and the final line is printed only when every phase passed:

1. device: the card's name and power limit (``nvidia-smi``), then the
   build of every kernel from ``ssd_tensorflow_tpu_torch/csrc/``.
2. conv_epilogue: every conv + bias + ReLU call of the vgg512 forward
   (trunk, the dilated mod_conv6, the extras) and its seven multibox
   head convs, recorded from one run at batch 2 and replayed with nonzero
   float32 biases, against the one-rounding reference
   ``bf16(act(conv_f32 + b))`` (TF32 off): the fused route
   (``layers.conv_relu``, cuDNN's conv + bias + ReLU) must be equal on
   >= 99 % of elements and the heads' route (``layers.conv2d_bias_in``,
   the bias carried in as input channels) on >= 99.9 % where K = 9 * cin
   is at most 2304; on the 512- and 1024-channel heads, where cuDNN's
   own float32 accumulation over K = 4608 / 9216 already leaves the
   bias-free conv short of that, on >= 99.5 % and no more than 0.1 %
   below that bias-free share (``conv_only_equal``). All within one bf16
   step of the largest output. As a control, the share of the route they
   replaced (bf16 conv + bf16 bias pass (+ ReLU)) on the same inputs.
3. kernels: each kernel against its plain PyTorch version on the card at
   its path's shapes (vgg512 batch 64; the stem probe at its TPU shape;
   NMS also at retina800's 5,000 candidates of 264 classes, the
   device-memory route, D = 1,025 and 5,000, timed at (64, 5,000)):
   NMS keep masks and the lane-unflatten sums bit-exact, every stem
   kernel within one bf16 step of its largest output. ``ms`` is device
   time from a ``torch.profiler`` window, ``event_ms`` the CUDA-event
   time per call over chained calls (it includes host launch cost).
4. paths, each driven with every launch count set to 0 just before it
   and read just after: the detection path ``InferenceModel.run_scores``
   -> ``detections_to_boxes`` on vgg512 bf16 with weights made from the
   seed, once with the split stem ("dma") and once with the whole uint8
   stem (``overrides={"pallas_stem_variant": "uint8"}``); then the
   ``fused_stem_pallas`` entry and the stem probes. Each detection run
   must launch its stem kernel and NMS (and not the other stem), give
   finite outputs with 0..200 detections per image, and agree with the
   same model run through its stem's plain version (conf within 0.02,
   argmax class on >= 99 % of anchors, locs within 0.05); it reports the
   peak device memory of that one run and images/s over chained batches.
5. int8_path: the shipped int8 W8A8 bundle
   (``assets/vgg512_int8_minivoc.ssdtpu.npz``, trained vgg512) through
   ``InferenceModel.from_bundle(...).run_scores`` on the same batch. Every
   conv's output (``int8_qconv``, the fused kernel ``csrc/int8_conv.cu``)
   on 2 images must equal the card chain's (``int8_qconv_plain``:
   quantize, im2col + ``_int_mm``, requant) on the same input bit for bit;
   the counted run must launch ``int8_qconv`` once a conv layer (32), the
   im2col route never, NMS, and no stem kernel; two more ``run_scores``
   must capture the forward's CUDA graph once and replay it twice
   (``inference.forward_graph``), each with the counted run's detections
   bit for bit; its (replayed) scores must be the same in two runs and
   identical to the eager forward's with ``int8_qconv`` patched to the
   chain, be finite and give 0..200 detections per image;
   it reports images/s, ms per batch and peak device memory as phase 4
   does.
6. train_path: the SGD training step of vgg512, 21 classes
   (``parallel/train_step.make_train_step``), weights from the seed, uint8
   images with 1-8 gt boxes each. (a) ``encode_targets_batch`` on the
   card equals the CPU's bit for bit at batch 32 (24,564 anchors). With
   cuDNN's TF32 at PyTorch's default (on), as a caller leaves it: a
   float32 forward within 1e-5 of the same forward with TF32 off, and (b)
   one float32 step at batch 2 on the card against the same step on the
   CPU: each loss within 1e-4 relative, each leaf's update within 1e-2 of
   its largest (or two ulps of its largest parameter, the resolution of a
   difference of two parameters). (c) bf16 at batch 32: 3 warm-up steps,
   then 10 steps on the same batch timed with CUDA events; every loss
   finite and the last total below the first; the counted 10 steps must
   launch ``nms_keep`` once a step and no stem kernel; ms/step, images/s
   and peak device memory; then one eval step (``make_eval_step``), which
   must launch ``nms_keep`` once. The steps detect at a confidence
   threshold of 0.01 (``train_config``). The detect of the float32 step,
   of the last bf16 step and of the eval step is held twice: its NMS keep
   mask against ``nms_keep_plain`` on the same (32, 200) candidates on
   the card, bit for bit, and its detections against ``decode_detections``
   on the CPU of the same probabilities and offsets; each must hold at
   least one detection.
7. family_int8_path, once for each shipped family bundle
   (``assets/resnet320_int8_minicoco.ssdtpu.npz``, 80 classes;
   ``assets/mobilenet320_int8_qat_minivoc.ssdtpu.npz``, QAT, 20 classes)
   at ``--batch`` x 320 x 320, uint8 images from the seed: on 2 images
   every W8A8 conv's output bit-exact against the card chain (as phase 5)
   and every weight-only depthwise conv (cuDNN's) and every GroupNorm with
   its activation and skip (``resnet.norm_act``, the kernel
   ``csrc/group_norm.cu``) equal to the CPU route bit for bit; the counted
   run must launch ``int8_qconv`` once a conv (48 / 28),
   ``group_norm_cuda`` once a GroupNorm (36 / 27), the im2col route never,
   NMS, and no stem kernel; two more ``run_scores`` one graph capture and
   two replays with the counted run's detections bit for bit; the
   (replayed) scores the same in two runs and identical to the
   chain-patched eager forward's and to the eager forward's with every
   GroupNorm on the plain route; ms per batch (CUDA events over 5 chained batches),
   images/s, peak device memory, and GroupNorm's device ms a batch (the
   ``ssd.group_norm`` spans of one profiled eager forward).
8. family_float_path: resnet320 and mobilenet320 in bf16 with weights from
   the seed at the same batch: every conv + bias call of the forward (the
   bias-in convs, the depthwise convs, the heads) held to one rounding as
   in phase 2, the long-K ones (K = 4608 / 9216) against cuDNN's own share;
   NMS launched, no stem kernel and no int8 conv; ms per batch,
   images/s, peak memory. At batch 2, the card against the CPU three
   ways: (a) the same model in float32 (TF32 off): conf within 1e-4,
   argmax equal on >= 99.9 % of anchors, locs within 1e-4; (b) the bf16
   scores no further from that float32 model than the CPU's bf16 scores
   are (conf and locs within twice the CPU's distance, or phase 4's 0.02
   / 0.05; argmax within 1 % of the CPU's share, or 99 %); (c) bf16 with
   the shipped bundle's trained weights (dequantized) on the two real
   JPEGs of phase 9: phase 4's argmax >= 99 % and locs < 0.05, conf
   < 0.05 (phase 4's 0.02 is out of mobilenet320's reach in bf16).
9. real_images: the three shipped bundles' ``run_scores`` on the card on
   the two miniVOC JPEGs of ``tests/torch_fixtures/bundle_detections.npz``
   (decoded on the CPU box) against the JAX package's CPU detections in
   that file: the same count per image; vgg512 a one-to-one match by
   class with IoU >= 0.99 and conf within 1e-4; the families the same
   against the port's CPU route on the same images, and against JAX the
   CPU tests' bounds (each detection of conf >= 0.1 matched both ways by
   class with IoU >= 0.95 and conf within 0.02: their GroupNorms sum in
   another order than XLA's). The largest conf and box-corner gaps are
   printed.
10. device_augment: the on-device augmentation
   (``data/device_augment.make_augment_fn``) at vgg512, batch 32, raw
   uint8 512 x 512 staged images with 1-8 gt boxes each, its draws from a
   CUDA generator. With the caller's TF32 on (cuDNN's and cuBLAS's, matmul
   precision "high"), the card's batch against the CPU's on the same
   draws: uint8 images equal on >= 99.9 % of pixels and within 1
   elsewhere, boxes within 1e-6, labels and masks equal; the caller's
   precision given back. Reports ms per batch (CUDA events over 5 calls,
   draws included), the share of images that took the positive fallback
   and peak memory.
11. qat_path, for mobilenet320 (the QAT family the repo ships, per-channel
   ``qat_act_amax``) and vgg512 (per-layer ``qat_act_scales``): the
   shipped bundle's dequantized weights (``dequantized_params``) in float32
   with ``l2_norm_eps`` 1e-3 (``qat.qat_model_config``); a raw batch (32,
   vgg512 8) augmented on the card; the activation grid calibrated on 8
   augmented images, stored in a checkpoint, restored and resumed with
   every calibration entry patched to raise; 3 warm-up and 5 (vgg512 3)
   timed QAT train steps on freshly augmented batches, every loss finite,
   NMS launched once a step and nothing else; one eval step through the
   fake-quant forward, NMS once; the detect of the last timed step and of
   the eval step held as in phase 6 (the NMS keep mask on the path's own
   (batch, 200) candidates against ``nms_keep_plain`` bit for bit, the
   detections against the CPU's decode); the export through
   ``qat.export_int8_bundle`` (calibration patched to raise), whose scales
   must equal the checkpoint's bit for bit (a family's ``a_scale`` =
   ``max(float32(amax) / 127, 1e-12)``); ``InferenceModel.from_bundle``
   on the card launching ``int8_qconv`` once a conv (28 / 32) and NMS once,
   its keep mask against ``nms_keep_plain`` bit for bit; the fake-quant forward against the exported int8 forward on 8 images,
   argmax > 0.95 for mobilenet320 (the JAX package's floor for mntest64;
   reported for vgg512). Then, cuDNN's TF32 at PyTorch's default, one
   QAT float32 step at batch 2 on the card against the CPU with the CPU's
   activation grids handed to the card's quantizers: each loss within
   1e-4 relative, each leaf's update within phase 6 (b)'s bound (or 1e-6
   of the largest update, where a leaf's update is float32 noise on both
   devices: a bias before a GroupNorm of one channel per group), and at
   most 0.2 % of the card quantizer's own roundings differing from the
   CPU's; the card's step left to its own roundings: each loss within
   1e-2 relative (``QAT_FREE_LOSS``). ms per step (each timed step with its batch's
   augmentation; ``augment_ms`` alone beside it), images/s, peak memory.
12. parallel (vgg512, 21 classes, bf16, weights from the seed, batch 32):
   (a) one ``make_train_step`` without a process group, twice, then under
   the one-rank NCCL group that ``parallel/mesh.make_mesh`` joins from a
   one-process ``torchrun`` environment (``RANK=0``, ``WORLD_SIZE=1``,
   ``MASTER_ADDR``, a free ``MASTER_PORT``), with ``shard_state`` (one
   broadcast) and ``shard_batch``: params and losses bit for bit equal to
   the step without a group (``cudnn.deterministic`` on for all three),
   which proves the gradient all-reduce and the broadcast run on NCCL;
   (b) ``TrainConfig(remat=True)`` against ``remat=False`` from the same
   state: each loss within 1e-3 relative, each leaf's update within 1e-2
   of that leaf's largest (or two ulps of its largest parameter), and a
   lower peak device memory over what was allocated before each step: the
   plain step runs before and after it, and the remat peak must lie below
   both by more than their spread (a remat that changed nothing fails),
   all three peaks printed; (c) 8 seeded host batches
   through ``parallel/prefetch.prefetch_to_device`` onto the card while the
   consumer runs a train step on each: every batch equal to its host
   arrays bit for bit, the host part passed through.
13. train_cli: ``cli/train.main`` in this process on the card, under that
   NCCL group, on dataset directories as ``process_dataset.py`` writes them
   (``staged_dataset``: 512 x 512 uint8 images from the seed, 1-8 gt
   boxes each, vgg512, 20 classes). The per-sample decode, resize and
   augmentation are staged (the card machine has no PIL, and its OpenCV,
   where present, is another build than the CPU box's):
   ``StagedProcessor`` takes the place of the pipeline's sample processor
   and hands out the staged images; that processor is held against the JAX
   package's on the CPU by ``tests/test_torch_pipeline.py``. The rest of
   the pipeline runs as it is. Run A (64 train, 32 valid images):
   ``--batch-size 32 --epochs 2 --checkpoint-interval 1 --num-workers 0``,
   bf16, the steps' detect at ``train_config``'s 0.01, then
   ``--continue-training yes --epochs 3``; run B: ``--device-augment
   true``, one epoch; run C (320 train images, ten steps an epoch): the
   CLI's own detect threshold (0.5) and its default input path, forked
   workers (one a core) over the shared-memory transport, started from
   the prefetch thread of a process that holds the card and the NCCL
   group, two epochs. Each run must return 0; ``e1``, ``e2``, ``e3`` and
   ``final`` must load through ``restore_checkpoint`` with their steps;
   the resumed run's first step must get e2's params and momentum bit for
   bit; every loss finite; every train and eval step's NMS keep mask equal
   to ``nms_keep_plain`` on its own candidates, bit for bit, and in runs A
   and B not empty; NMS launched
   once a train and once an eval step, no stem kernel and no
   int8 conv. Reports, for run A (a stress reading at threshold 0.01)
   and for run C (the CLI as a user runs it): the CLI's own images/s
   (``StepTimer``) per epoch, CUDA-event ms a step over the epochs after
   the first (start to start of consecutive steps within an epoch, and
   each step's own span), the device busy time of train steps of the
   first epoch under ``torch.profiler``, the idle share ``1 - busy / ms a
   step``, and the gap to phase 6's bare step: the CLI's host cost. Also
   peak memory, the free space of ``/dev/shm`` and the core count.
14. serving_cli: the serving and evaluation CLIs (``cli/export_model``,
   ``cli/detect``, ``cli/infer``) in this process on the card, on the 8
   miniVOC test images of ``tests/torch_fixtures/serving_images.npz``
   (``"host_io": "staged"``: ``StagedImageIO`` takes the place of
   ``data/image_io``'s decode and resize and hands out the fixture's
   pixels, decoded on the CPU box and held there against the port's own
   image I/O; drawing and writing images only record their calls; the
   rest of each CLI runs as it is). (a) export_model from a vgg512 bf16
   checkpoint of seeded weights: the float bundle (the checkpoint's
   parameters, config and labels), ``--torch-export`` at batch 2 (the
   graph must hold ``ssd_torch::fused_stem``; the loaded program on the
   card equals eager ``apply_result`` bit for bit and launches the stem
   once a call) and ``--quantize --calibration-images`` on the staged
   images, its activation scales within ``SERVING_CALIBRATION_GAP``
   (relative) of the JAX package's in the fixture. (b) detect with the
   shipped int8 bundle at its default batch of 32 (8 files padded),
   threshold 0.01: each ``.txt`` dump equals ``detect_boxes`` of the same
   batch, the detections match the fixture's JAX ones as phase 9's vgg512
   (IoU >= 0.99, conf within 1e-4, the same count), an annotated image a
   file; NMS once, ``int8_qconv`` once a conv, no stem. (c) infer with that
   bundle on a staged VOC tree of the 8 images (their XML annotations, a
   ``test.txt``), ``--dump-predictions --pascal-summary --coco-results``
   at 0.01: per-class AP and mAP within 1e-4 of the fixture's JAX values,
   each ``.npy`` dump finite of shape (24564, 25), the Pascal files
   written, the COCO results empty (VOC labels have no COCO category id,
   as in the JAX package); then with the exported float bf16 bundle: NMS
   and the stem once, its dumps against the same CLI with the stem's
   plain version at phase 4's bounds. (d) each CLI on 3 batches of 32
   real files, as it runs them: CUDA-event ms a batch, images/s, the
   device's busy ms a batch under ``torch.profiler``, the idle share, the
   bare ``run_scores`` (detect) or ``run`` (infer) of one batch and the
   gap, the CLI's host cost; peak memory, and its rise over what the phase
   found allocated.

15. multichip: data-parallel serving, tensor parallelism of conv6 / conv7
   and the multichip dry run. (a) Under phase 12's one-rank NCCL group,
   ``InferenceModel(mesh=make_mesh())`` of the shipped int8 bundle and of
   the seeded vgg512 bf16 model (split stem) at b64 equal ``mesh=None``
   bit for bit, launching NMS once, ``int8_qconv`` once a conv (the bundle)
   and ``fused_stem`` once (bf16); ``cli/detect.py --data-parallel 1``
   writes the ``.txt`` files of ``--data-parallel 0`` (staged images, as
   phase 14). (b) Four processes of this script (``--worker``) on the one
   card in a gloo group over CUDA tensors (NCCL takes one process a
   device): the int8 bundle at b64, 16 rows a process, must give one
   process's b64 detections bit for bit (or, where cuBLAS / cuDNN choose
   otherwise at 16 rows, phase 14's match: IoU >= 0.999, conf within
   1e-4, the gap printed); NMS once a batch on every process; ms a batch
   of each process (CUDA events over 5 batches), the four processes'
   images/s together (they share one card: not a scaling figure) and each
   one's peak memory. (c) Four processes on data 2 x model 2: the vgg512
   float32 step at b8 (TF32 off, ``cudnn.deterministic``) from a common
   state, its checkpoint gathered whole and written by rank 0, against
   one process summing conv7 in the same two halves
   (``conv7_in_two_halves``): each loss within 1e-5 relative, each leaf's
   update within 1e-4 of its largest (or two ulps of its largest
   parameter); against the plain one-process step, losses likewise and
   every leaf's update but conv7's within 1e-4, conv7's weight and bias
   and their momentum within 1e-3 (``TP_PLAIN_CONV7``: conv7's
   pre-activations that change sides of the ReLU, counted by the halves
   reference and held to ``TP_MAX_FLIPS``); the shard shapes, NMS once a
   step on each process; then bf16 steps at b32, finite, CUDA-event ms a
   step beside phase 6's one-process step, peak memory. (d)
   ``multichip.entry()``'s vgg300 bf16 forward at b8, once: finite, of
   shape (8, anchors, 25), each row's class probabilities summing to 1
   within 1e-2, ``fused_stem`` launched once; then
   ``multichip.dryrun_multichip(4)`` in a fresh process prints its ok line
   with mesh data 2 x model 2.

16. learning: evidence that the port learns, on the card, through the
   port's tools as their ``main`` wires them. (a) ``tools/
   torch_overfit_sanity.py``: vgg300 bf16, 3 classes, its 32 synthetic
   images (seed 7) in one batch, lr 1e-3, from the port's
   ``init_params(seed=0)``, 2000 steps with an eval at step 300 and at
   2000 (detect top 64 at 0.3, the VOC AP): train mAP >= 0.90 at step 2000
   (the JAX package's record on its chip is 0.97); the step-300 mAP is
   recorded beside the tool's ``--map-target`` 0.5, not held (when a run
   memorizes moves with the draw, in either package; this one first
   reaches 0.5 near step 350: ``tests/torch_overfit_witness.py``). Every
   loss finite, the step-300 eval leaves the parameters as they were, each eval launches
   NMS once and its keep mask and detections are held as in phase 6; the
   losses every 50 steps, CUDA-event ms a step (the median after 10
   steps), seconds and peak memory. (b) The trained state saved by
   ``CheckpointManager`` with its model config and 3-class label map, its
   32 images staged as both splits of a dataset
   (``staged_dataset(splits=...)``, ``StagedProcessor``), then
   ``tools/torch_qat_finetune.main`` with ``--epochs 10 --batch-size 32
   --calib-images 32 --lr 1e-4 --output``: the valid mAPs at top 200 and
   0.01 of the float model >= 0.90, of PTQ and QAT int8 each within 0.05
   of it, every epoch loss finite, NMS once an eval with its keep mask
   against ``nms_keep_plain``, ``int8_qconv`` once a conv of each int8
   eval. (c) The QAT checkpoint exported by ``cli/export_model.py
   --quantize`` with no calibration images (calibration patched to
   raise): the bundle's activation scales equal the checkpoint's
   ``qat_act_scales``; ``InferenceModel.from_bundle`` on the card,
   ``run_scores`` of the 32 images (NMS once, ``int8_qconv`` once a conv,
   the keep mask held) and their VOC mAP within 1e-3 of (b)'s QAT int8
   mAP.
17. retina_path: RetinaNet (``h100bench/configs/retinanet800-resnext50fpn-
   bf16.json``: retina800, bf16, the reference's seeded weights) through
   ``run_scores`` on a batch of the benchmark's staged 800x800 images,
   counted as phase 4's: NMS launched once (D = 5,000), 16 grouped convs
   and 10 head calls, no other kernel; the keep mask equal to
   ``nms_keep_plain`` on the same candidates; each image
   ``min(300, NMS survivors)`` valid rows, finite and sorted; the
   candidates per image, ms a batch, images/s, peak memory.

The line before the last lists the kernels with their launches, errors,
times and bounds; the last line is ``{"ok": true, "device": {...}}``.
Imports nothing of JAX or of the JAX package.
"""

from __future__ import annotations

import argparse
import contextlib
import dataclasses
import inspect
import json
import subprocess
import sys
import time
from pathlib import Path
from unittest import mock

#: Published dense peaks of one H100 SXM at its 700 W limit (NVIDIA data sheet).
PEAK_BF16_FLOPS = 989e12
PEAK_F32_FLOPS = 67e12
PEAK_BYTES_PER_S = 3.35e12
MEAN_BGR = (104.0, 117.0, 123.0)
INT8_BUNDLE = "assets/vgg512_int8_minivoc.ssdtpu.npz"
#: the SSD paper's training batch (the JAX CLI's default is 8)
TRAIN_BATCH = 32


def _emit(obj) -> None:
    print(json.dumps(obj), flush=True)


def _bound(n_bytes: float, n_ops: float, peak_ops: float):
    t_bytes = n_bytes / PEAK_BYTES_PER_S * 1e3
    t_ops = n_ops / peak_ops * 1e3
    return (t_ops, "operations") if t_ops >= t_bytes else (t_bytes, "bytes")


def _err(got, want):
    """``(max |got - want|, max |want|)`` in float32."""
    return (float((got.float() - want.float()).abs().max()), float(want.float().abs().max()))


def _within_a_step(name, got, want):
    """Both sum exact bf16 products in float32, in different orders: an
    output may round one bf16 step (2^-7 of the largest) apart, no more."""
    import torch

    err, scale = _err(got, want)
    tol = scale * 2.0 ** -7
    if not (scale > 0 and err <= tol and torch.isfinite(got.float()).all()):
        raise AssertionError(f"{name} differs from its plain version: max err {err} > {tol} "
                             f"(max |ref| {scale})")
    return err, tol


def _row(name, source, replaces, err, times, plain_ms, bound, library_ms, **extra):
    return {"name": name, "route": "cuda", "source": f"ssd_tensorflow_tpu_torch/csrc/{source}",
            "replaces": replaces, "max_abs_err": err, **times, "plain_ms": plain_ms,
            "bound_ms": bound[0], "bound_by": bound[1], "library_ms": library_ms, **extra}


def _times(fn, kernel_name: str, iters: int):
    from ssd_tensorflow_tpu_torch.timing import cuda_event_ms, kernel_device_ms

    return {"ms": kernel_device_ms(fn, kernel_name, iters=iters),
            "event_ms": cuda_event_ms(fn, iters=iters)}


def _plain_ms(fn):
    from ssd_tensorflow_tpu_torch.timing import cuda_event_ms

    return cuda_event_ms(fn, iters=3, warmup=1)


def _nms_inputs(rng, b: int, d: int, num_classes: int, device):
    """Score-sorted candidates with overlap clusters, class-shifted corners."""
    import numpy as np
    import torch

    from ssd_tensorflow_tpu_torch.ops.boxes import box_canvas_corners
    from ssd_tensorflow_tpu_torch.ops.nms import class_shifted

    w = rng.uniform(0.05, 0.5, (b, d))
    h = rng.uniform(0.05, 0.5, (b, d))
    cx, cy = rng.uniform(w / 2, 1 - w / 2), rng.uniform(h / 2, 1 - h / 2)
    boxes = np.stack([cx, cy, w, h], axis=-1)
    half = d // 2
    boxes[:, :half] = np.clip(
        boxes[:, np.arange(half) % 8] + rng.normal(0, 0.01, (b, half, 4)), 0.02, 0.98)
    classes = rng.integers(0, num_classes, (b, d))
    valid = np.sort(rng.uniform(0, 1, (b, d)), axis=1)[:, ::-1] > 0.3
    corners = box_canvas_corners(torch.tensor(boxes, dtype=torch.float32))
    shifted = class_shifted(corners, torch.tensor(classes)).contiguous()
    return shifted.to(device), torch.tensor(valid.copy()).to(device)


def conv_calls(model, images):
    """Every distinct conv + bias call of ``model``'s inference forward on
    ``images``, recorded: ``[{"kind", "x", "w", "stride", "padding",
    "dilation"}]``. Kinds: ``conv_relu`` (``layers.conv_relu``, the VGG
    trunk and extras), ``head`` (the multibox heads'
    ``layers.conv2d_bias_in``), ``bias_in`` (a family's other convs,
    ``layers.conv2d_bias_in``) and ``depthwise``
    (``layers.depthwise_conv2d``), each called by the float executor
    (``layers.float_conv_executor``; a head is its ``classifier*`` layer).
    A bias-in call's ``w`` is its filter without the bias channels."""
    import torch

    from ssd_tensorflow_tpu_torch.models import layers, ssd_vgg

    calls, layer, executor = [], [""], layers.float_conv_executor

    def record(fn, kind):
        def wrapper(*args, **kwargs):
            bound = inspect.signature(fn).bind(*args, **kwargs)
            bound.apply_defaults()
            head = kind == "bias_in" and layer[0].startswith("classifier")
            calls.append(("head" if head else kind, bound.arguments))
            return fn(*args, **kwargs)
        return wrapper

    def named_executor(params, inference=True):
        conv = executor(params, inference)

        def named(name, x, **kwargs):
            layer[0] = name
            return conv(name, x, **kwargs)

        return named

    with torch.inference_mode(), \
            mock.patch.object(ssd_vgg, "float_conv_executor", named_executor), \
            mock.patch.object(layers, "conv_relu", record(layers.conv_relu, "conv_relu")), \
            mock.patch.object(layers, "conv2d_bias_in", record(layers.conv2d_bias_in, "bias_in")), \
            mock.patch.object(layers, "depthwise_conv2d",
                              record(layers.depthwise_conv2d, "depthwise")):
        ssd_vgg.apply_scores(model.params, images, model.config)
    out, seen = [], set()
    for kind, a in calls:
        if kind == "conv_relu":
            w = a["params"]["w"]
        elif kind == "depthwise":
            w = a["w"]
        else:
            w = a["wb"][:, :-layers.BIAS_CHANNELS].contiguous(memory_format=torch.channels_last)
        call = {"kind": kind, "x": a["x"], "w": w, "stride": a.get("stride", 1),
                "padding": a.get("padding", "SAME"), "dilation": a.get("dilation", 1)}
        key = (kind, tuple(call["x"].shape), tuple(w.shape), call["stride"], call["padding"],
               call["dilation"])
        if key not in seen:
            seen.add(key)
            out.append(call)
    return out


def one_rounding_reference(call, bias):
    """``bf16(act(conv_f32(x, w) + b))``: the JAX package's f32-accumulate
    conv + bias (+ ReLU), rounded once (TF32 must be off)."""
    import torch
    import torch.nn.functional as F

    from ssd_tensorflow_tpu_torch.models import layers

    xn, pad = layers._same_input(call["x"], call["w"], call["stride"], call["padding"],
                                 call["dilation"])
    groups = xn.shape[1] if call["kind"] == "depthwise" else 1
    y = F.conv2d(xn.float(), call["w"].float(), None, call["stride"], pad, call["dilation"],
                 groups)
    y = y + bias.view(1, -1, 1, 1)
    if call["kind"] == "conv_relu":
        y = torch.relu(y)
    return y.to(torch.bfloat16).permute(0, 2, 3, 1)


def unfused(call, bias):
    """The route the one-rounding ones replaced: the bf16 conv, then a bf16
    bias pass (+ a ReLU pass)."""
    import torch

    from ssd_tensorflow_tpu_torch.models import layers

    if call["kind"] == "depthwise":
        return layers.depthwise_conv2d(call["x"], call["w"], bias, call["stride"],
                                       call["padding"], f32_out=False)
    y = layers.conv2d(call["x"], call["w"], bias, call["stride"], call["padding"],
                      call["dilation"])
    return torch.relu(y) if call["kind"] == "conv_relu" else y


def _route(call, bias):
    """``(route name, output)`` of the model's own conv + bias route."""
    from ssd_tensorflow_tpu_torch.models import layers

    if call["kind"] == "conv_relu":
        return "fused", layers.conv_relu({"w": call["w"], "b": bias}, call["x"], call["stride"],
                                         call["padding"], call["dilation"])
    if call["kind"] == "depthwise":
        return "depthwise_f32", layers.depthwise_conv2d(call["x"], call["w"], bias,
                                                        call["stride"], call["padding"],
                                                        f32_out=True)
    return "bias_in", layers.conv2d_bias_in(call["x"], layers.widen_bias(call["w"], bias),
                                            call["stride"], call["padding"], call["dilation"])


def conv_epilogue(model, images, seed: int, phase: str = "conv_epilogue"):
    """Phase 2 (and part of each family float path): the model's conv +
    bias (+ ReLU) routes against the one-rounding reference, on every such
    call of the forward (see the module doc)."""
    import torch

    gen = torch.Generator(device=images.device).manual_seed(seed)
    out = []
    with torch.inference_mode():
        for call in conv_calls(model, images[:2]):
            bias = torch.randn(call["w"].shape[0], generator=gen, device=images.device) * 0.5
            ref = one_rounding_reference(call, bias)
            plain = unfused(call, bias)
            cout, cin, kh, kw = call["w"].shape
            k = cin * kh * kw
            row = {"kind": call["kind"], "K": k,
                   "shape": {n: list(v.shape) if torch.is_tensor(v) else v
                             for n, v in call.items() if n != "kind"},
                   "unfused_equal": float((plain == ref).float().mean()),
                   "unfused_max_abs_err": _err(plain, ref)[0]}
            # (a map of a few hundred outputs may miss 99.9 % by two of them)
            floor = min(0.999, 1.0 - 2.0 / ref.numel())
            if call["kind"] == "conv_relu":
                floor = 0.99
            elif call["kind"] != "depthwise" and k > 2304:
                # the library conv's own share, without any bias: what its
                # float32 accumulation on the tensor cores leaves of 100 %
                row["conv_only_equal"] = float(
                    (unfused(call, None) == one_rounding_reference(call, torch.zeros_like(bias)))
                    .float().mean())
                floor = max(0.995, row["conv_only_equal"] - 0.001)
            route, got = _route(call, bias)
            err, scale = _err(got, ref)
            row.update(route=route, equal=float((got == ref).float().mean()), floor=floor,
                       max_abs_err=err, max_ref=scale)
            if not (row["equal"] >= floor and err <= scale * 2.0 ** -7):
                raise AssertionError(f"{route} conv + bias is not one rounding: {row}")
            out.append(row)
    kinds = {kind: [r for r in out if r["kind"] == kind]
             for kind in ("conv_relu", "head", "bias_in", "depthwise")}
    heads = kinds["head"]
    if len(heads) != len(model.config.preset.maps):
        raise AssertionError(f"expected one head conv per map, recorded {len(heads)}")
    family = model.config.preset.backbone != "vgg"
    if family != bool(kinds["bias_in"]) or (family and kinds["conv_relu"]):
        raise AssertionError(f"{model.config.preset_name}: conv routes {list(map(len, kinds.values()))}")
    summary = {"phase": phase, "preset": model.config.preset_name, "batch": 2, "layers": out,
               "heads_equal": [r["equal"] for r in heads],
               "heads_conv_only_equal": [r.get("conv_only_equal") for r in heads],
               "heads_max_abs_err": max(r["max_abs_err"] for r in heads)}
    for kind, rows in kinds.items():
        if rows:
            summary[f"{kind}_layers"] = len(rows)
            summary[f"{kind}_equal_min"] = min(r["equal"] for r in rows)
            summary[f"{kind}_unfused_equal_max"] = max(r["unfused_equal"] for r in rows)
    long_k = [r for r in out if "conv_only_equal" in r]
    summary["long_k"] = [{"kind": r["kind"], "K": r["K"], "equal": r["equal"],
                          "conv_only_equal": r["conv_only_equal"]} for r in long_k]
    _emit(summary)
    return summary


def _nms_row(name, batch: int, d: int, kernel: str, err, corners, valid, iters: int):
    from ssd_tensorflow_tpu_torch.ops import nms_cuda

    times = _times(lambda: nms_cuda.nms_keep(corners, valid), kernel, iters=iters)
    plain_ms = _plain_ms(lambda: nms_cuda.nms_keep_plain(corners, valid))
    # each pair j > i: 4 min/max, 4 add/sub, 2 clamps, mul, add, sub, div, compare
    n_ops = batch * (d * (d - 1) / 2 * 15 + d * 5)
    n_bytes = batch * d * (16 + 1 + 1)
    return _row(name, "nms.cu", "ssd_tensorflow_tpu/ops/nms_pallas.py:72", err, times,
                plain_ms, _bound(n_bytes, n_ops, PEAK_F32_FLOPS), None, shape=[batch, d])


def check_nms(rng, batch: int, device):
    """The NMS kernels against ``nms_keep_plain`` bit for bit: the
    shared-memory route at D = 200, 57, 256 (21 classes, SSD's), the
    device-memory route at D = 1,025 and 5,000 (264 classes, RetinaNet's
    five levels of 1,000); a timed row of each route, at (batch, 200) and
    (batch, 5,000)."""
    import torch

    from ssd_tensorflow_tpu_torch.ops import nms_cuda

    err = 0.0
    for d, classes in ((200, 21), (57, 21), (256, 21), (1025, 264), (5000, 264)):
        corners, valid = _nms_inputs(rng, batch, d, classes, device)
        got = nms_cuda.nms_keep(corners, valid)
        want = nms_cuda.nms_keep_plain(corners, valid)
        err = max(err, float((got.int() - want.int()).abs().max()))
        if not torch.equal(got, want):
            raise AssertionError(f"nms_keep differs from its plain version at D={d}: "
                                 f"{int((got != want).sum())} of {got.numel()} flags")
    rows = [_nms_row("nms_keep", batch, 200, "nms_kernel", err,
                     *_nms_inputs(rng, batch, 200, 21, device), iters=50)]
    rows.append(_nms_row("nms_keep_global", batch, 5000, "_global", err,
                         *_nms_inputs(rng, batch, 5000, 264, device), iters=10))
    return rows


def _stem_bound(b, h, w, c_in):
    """Whole-stem bound: conv1_1 (27 -> 64) + conv1_2 (576 -> 64) MACs;
    the input read once, pool1 written once."""
    n_ops = 2.0 * b * h * w * 64 * (27 + 9 * 64)
    n_bytes = b * h * w * 3 * c_in + b * (h // 2) * (w // 2) * 64 * 2 + (27 + 9 * 64) * 64 * 2
    return _bound(n_bytes, n_ops, PEAK_BF16_FLOPS)


def check_stem(params, images):
    """Row 2: the split stem kernel (conv1_2 + pool1) on conv1_1's output."""
    import torch
    import torch.nn.functional as F

    from ssd_tensorflow_tpu_torch.ops import stem_cuda

    c1 = stem_cuda.conv1_1_unbiased(params, stem_cuda._preprocess(images, MEAN_BGR))
    b1, w2, b2 = params["conv1_1"]["b"], params["conv1_2"]["w"], params["conv1_2"]["b"]
    err, tol = _within_a_step("fused_stem", stem_cuda.fused_stem(c1, b1, w2, b2),
                              stem_cuda.fused_stem_plain(c1, b1, w2, b2))
    times = _times(lambda: stem_cuda.fused_stem(c1, b1, w2, b2), "stem_kernel", iters=10)
    plain_ms = _plain_ms(lambda: stem_cuda.fused_stem_plain(c1, b1, w2, b2))
    c1n = c1.permute(0, 3, 1, 2)
    b1n = b1.to(torch.bfloat16).view(1, -1, 1, 1)
    w2b, b2b = w2.to(torch.bfloat16), b2.to(torch.bfloat16)
    library_ms = _plain_ms(
        lambda: F.max_pool2d(F.relu(F.conv2d(F.relu(c1n + b1n), w2b, b2b, padding=1)), 2))
    b, h, w, c = c1.shape
    n_ops = 2.0 * b * h * w * c * c * 9
    n_bytes = c1.numel() * 2 + b * (h // 2) * (w // 2) * c * 2 + w2.numel() * 2 + 2 * c * 4
    return _row("fused_stem", "stem.cu", "ssd_tensorflow_tpu/ops/stem_pallas.py:160", err, times,
                plain_ms, _bound(n_bytes, n_ops, PEAK_BF16_FLOPS), library_ms,
                shape=[b, h, w, c], tolerance=tol)


def library_stem(params, images, mean_bgr=MEAN_BGR):
    """The stem as PyTorch calls in bf16: preprocess, cuDNN conv1_1 + bias +
    ReLU, conv1_2 + bias + ReLU, 2x2 max-pool. A yardstick only."""
    import torch
    import torch.nn.functional as F

    mean = torch.tensor(mean_bgr, dtype=torch.float32, device=images.device)
    x = (images.float() - mean).to(torch.bfloat16).permute(0, 3, 1, 2)
    p1, p2 = params["conv1_1"], params["conv1_2"]
    bf = torch.bfloat16
    y = F.relu(F.conv2d(x, p1["w"].to(bf), p1["b"].to(bf), padding=1))
    y = F.relu(F.conv2d(y, p2["w"].to(bf), p2["b"].to(bf), padding=1))
    return F.max_pool2d(y, 2).permute(0, 2, 3, 1)


def probe_library(a1, w1, w2, variant: str):
    """One PyTorch call sequence (bf16 matmuls / cuDNN convolutions) for a
    stem-probe variant, or ``None`` where there is none (the aligned
    variant's math is wrong on purpose). A yardstick only."""
    import torch
    import torch.nn.functional as F

    from ssd_tensorflow_tpu_torch.ops.stem_probe import PROBE_VARIANTS

    code, n_taps = PROBE_VARIANTS[variant]
    if code == 0:
        return a1[:, :, :16].clone()
    if code in (1, 2):
        return torch.relu(a1[:, :, :16] @ w1[:, :64])
    if code == 4:
        return None
    b, t, _, wp, _ = a1.shape
    y1 = torch.relu(a1 @ w1).reshape(b * t, 34, wp, 128).permute(0, 3, 1, 2)
    taps = torch.zeros((3, 3, 128, 128), dtype=w2.dtype, device=w2.device)
    taps.view(9, 128, 128)[:n_taps] = w2.reshape(9, 128, 128)[:n_taps]
    y = torch.relu(F.conv2d(y1, taps.permute(3, 2, 0, 1), padding=(0, 1)))
    z = F.max_pool2d(y, (2, 1))
    return torch.maximum(z[:, :64], z[:, 64:]).permute(0, 2, 3, 1).reshape(b, t, 16, wp, 64)


def check_whole_stems(params, images):
    """Rows 3 and 4: the whole-stem uint8 kernel, and the fused_stem_pallas
    entry (preprocess + cuDNN conv1_1 + the split stem kernel), each from
    the raw uint8 batch to pool1. Row 4's ``ms`` is the entry's whole
    device time, since its function is the whole stem."""
    from ssd_tensorflow_tpu_torch.ops import stem_cuda

    library_ms = _plain_ms(lambda: library_stem(params, images))
    bound = _stem_bound(*images.shape[:3], c_in=1)
    rows = []
    for name, source, replaces, kernel_fn, plain_fn, kernel_name in (
        ("fused_stem_uint8", "stem_uint8.cu", "ssd_tensorflow_tpu/ops/stem_pallas.py:386",
         stem_cuda.fused_stem_uint8, stem_cuda.fused_stem_uint8_plain, "stem_uint8_kernel"),
        # the whole entry's device time: preprocess, conv1_1 and the kernel
        ("fused_stem_pallas", "stem.cu", "ssd_tensorflow_tpu/ops/stem_pallas.py:536",
         stem_cuda.fused_stem_pallas, _split_stem_plain, ""),
    ):
        err, tol = _within_a_step(name, kernel_fn(params, images, MEAN_BGR),
                                  plain_fn(params, images, MEAN_BGR))
        times = _times(lambda: kernel_fn(params, images, MEAN_BGR), kernel_name, iters=10)
        rows.append(_row(name, source, replaces, err, times,
                         _plain_ms(lambda: plain_fn(params, images, MEAN_BGR)), bound, library_ms,
                         shape=list(images.shape), tolerance=tol,
                         ms_covers=kernel_name or "preprocess + conv1_1 + stem_kernel"))
    return rows


def _split_stem_plain(params, images, mean_bgr):
    """The fused_stem_pallas entry with the kernel's plain version."""
    from ssd_tensorflow_tpu_torch.ops import stem_cuda

    c1 = stem_cuda.conv1_1_unbiased(params, stem_cuda._preprocess(images, mean_bgr))
    p1, p2 = params["conv1_1"], params["conv1_2"]
    return stem_cuda.fused_stem_plain(c1, p1["b"], p2["w"], p2["b"])


def _probe_bound(variant, b, t, wp):
    from ssd_tensorflow_tpu_torch.ops.stem_probe import PROBE_VARIANTS

    code, n_taps = PROBE_VARIANTS[variant]
    out_bytes = b * t * 16 * wp * 64 * 2
    if code == 0:
        return _bound(2 * out_bytes, 0.0, PEAK_BF16_FLOPS)
    if code in (1, 2):  # 16 rows of a1, the first 64 of w1's columns
        return _bound(2 * out_bytes + 64 * 64 * 2, 2.0 * b * t * 16 * wp * 64 * 64,
                      PEAK_BF16_FLOPS)
    rows = 34 if n_taps > 3 else 32  # taps of dy = 2 read a1's last two rows
    n_ops = 2.0 * b * t * wp * (rows * 64 * 128 + 32 * 128 * 128 * n_taps)
    n_bytes = b * t * rows * wp * 64 * 2 + out_bytes + (64 * 128 + n_taps * 128 * 128) * 2
    return _bound(n_bytes, n_ops, PEAK_BF16_FLOPS)


def check_probes(seed: int, device):
    """Rows 5 and 6: each stem-probe variant at the TPU probe's shape and
    the lane-unflatten sum, against their plain versions."""
    import torch

    from ssd_tensorflow_tpu_torch.ops import stem_probe

    rows = []
    a1, w1, w2 = stem_probe.probe_inputs(seed, device)
    b, t, _, wp, _ = a1.shape
    for variant in stem_probe.PROBE_VARIANTS:
        fn = (lambda v=variant: stem_probe.stem_probe(a1, w1, w2, v))
        got, want = fn(), stem_probe.stem_probe_plain(a1, w1, w2, variant)
        if variant == "copy":
            err, tol = _err(got, want)[0], 0.0
            if not torch.equal(got, want):
                raise AssertionError("stem_probe(copy) differs from its plain version")
        else:
            err, tol = _within_a_step(f"stem_probe({variant})", got, want)
        del got, want
        times = _times(fn, "probe_", iters=5)
        plain_ms = _plain_ms(lambda v=variant: stem_probe.stem_probe_plain(a1, w1, w2, v))
        library_ms = None
        if probe_library(a1, w1, w2, variant) is not None:
            library_ms = _plain_ms(lambda v=variant: probe_library(a1, w1, w2, v))
        rows.append(_row(f"stem_probe:{variant}", "stem_probe.cu",
                         f"tools/stem_kernel_probe.py:{PROBE_LINES[variant]}", err, times,
                         plain_ms, _probe_bound(variant, b, t, wp), library_ms,
                         shape=list(a1.shape), tolerance=tol))
    del a1

    x = torch.randn((36, 1536), generator=torch.Generator(device=device).manual_seed(seed),
                    device=device).to(torch.bfloat16)
    got, want = stem_probe.lane_unflatten_sum(x), stem_probe.lane_unflatten_sum_plain(x)
    if not torch.equal(got, want):
        raise AssertionError("lane_unflatten_sum differs from its plain version")
    times = _times(lambda: stem_probe.lane_unflatten_sum(x), "lane_unflatten", iters=50)
    # the practical bound of launch-sized work: an empty kernel on the same grid
    floor = _times(lambda: stem_probe.launch_floor(x), "launch_floor", iters=50)
    rows.append(_row("lane_unflatten_sum", "stem_probe.cu", "tools/stem_uint8_probe.py:45",
                     _err(got, want)[0], times,
                     _plain_ms(lambda: stem_probe.lane_unflatten_sum_plain(x)),
                     _bound(x.numel() * 2 + got.numel() * 2, x.numel(), PEAK_F32_FLOPS),
                     _plain_ms(lambda: x.view(36, 256, 6).sum(dim=-1)),
                     shape=list(x.shape), tolerance=0.0, launch_floor_ms=floor["ms"],
                     launch_floor_event_ms=floor["event_ms"]))
    return rows


#: the kernel body of each variant in tools/stem_kernel_probe.py
PROBE_LINES = {"copy": 46, "conv1_1": 50, "conv1_1_store": 57, "taps1": 67, "taps3": 67,
               "taps9": 67, "taps9_aligned": 86}


def _launch_counts():
    from ssd_tensorflow_tpu_torch.ops import (group_norm_cuda, int8_conv, nms_cuda, stem_cuda,
                                              stem_probe)

    return {"nms_keep": nms_cuda.nms_keep, "fused_stem": stem_cuda.fused_stem,
            "fused_stem_uint8": stem_cuda.fused_stem_uint8, "stem_probe": stem_probe.stem_probe,
            "lane_unflatten_sum": stem_probe.lane_unflatten_sum,
            "int8_conv": int8_conv.int8_conv, "int8_qconv": int8_conv.int8_qconv,
            "group_norm_cuda": group_norm_cuda.group_norm_cuda}


def counted(run):
    """Run ``run()`` with every kernel's launch count set to 0 just before
    and read just after: ``(result, {kernel: launches})``."""
    import torch

    wrappers = _launch_counts()
    for fn in wrappers.values():
        fn.launches = 0
    torch.cuda.synchronize()
    result = run()
    torch.cuda.synchronize()
    return result, {name: fn.launches for name, fn in wrappers.items()}


def _path_checks(name, dets, model, batch):
    """Finite detections, 0..200 per image, box lists that match the
    valid mask: ``(per-image counts, stats)``."""
    import torch

    from ssd_tensorflow_tpu_torch.ops.postprocess import detections_to_boxes

    rows = detections_to_boxes(dets, model.lid2name)
    counts = dets.valid.sum(dim=1)
    if len(rows) != batch or [len(r) for r in rows] != counts.tolist():
        raise AssertionError(f"{name}: detections_to_boxes rows disagree with the valid mask")
    if not (0 <= int(counts.min()) and int(counts.max()) <= 200):
        raise AssertionError(f"{name}: detection counts out of [0, 200]: {counts.tolist()}")
    v = dets.valid
    if not (torch.isfinite(dets.scores[v]).all() and torch.isfinite(dets.boxes[v]).all()):
        raise AssertionError(f"{name}: non-finite detections")
    return {"min": int(counts.min()), "max": int(counts.max()),
            "mean": float(counts.float().mean())}


def detection_path(model, images, batch: int):
    """Phase 4: one counted ``run_scores`` of ``model``, its checks, its
    agreement with its stem's plain version, and its throughput."""
    import torch

    from ssd_tensorflow_tpu_torch.models import ssd_vgg
    from ssd_tensorflow_tpu_torch.ops import stem_cuda
    from ssd_tensorflow_tpu_torch.ops.postprocess import detections_to_boxes
    from ssd_tensorflow_tpu_torch.timing import cuda_event_ms

    cfg = model.config
    variant = cfg.pallas_stem_variant
    stem, other = ("fused_stem_uint8", "fused_stem") if variant == "uint8" else \
        ("fused_stem", "fused_stem_uint8")
    torch.cuda.reset_peak_memory_stats()
    dets, launches = counted(lambda: model.run_scores(images))
    peak_mem_gib = torch.cuda.max_memory_allocated() / 2**30
    if (launches["nms_keep"] < 1 or launches[stem] < 1 or launches[other] != 0
            or launches["int8_conv"] or launches["int8_qconv"]):
        raise AssertionError(f"the {variant} path did not run its kernels: {launches}")
    counts = _path_checks(variant, dets, model, batch)

    with torch.inference_mode():
        conf, cls, locs = ssd_vgg.apply_scores(model.params, images, cfg)
        with mock.patch.object(stem_cuda, stem, getattr(stem_cuda, f"{stem}_plain")):
            conf_p, cls_p, locs_p = ssd_vgg.apply_scores(model.params, images, cfg)
    agree = {
        "conf_max_abs": float((conf - conf_p).abs().max()),
        "cls_share": float((cls == cls_p).float().mean()),
        "locs_max_abs": float((locs - locs_p).abs().max()),
        "locs_max_ref": float(locs_p.abs().max()),
    }
    if not (torch.isfinite(conf).all() and torch.isfinite(locs).all()):
        raise AssertionError("non-finite pre-NMS scores")
    if not (agree["conf_max_abs"] < 0.02 and agree["cls_share"] >= 0.99
            and agree["locs_max_abs"] < 0.05):
        raise AssertionError(f"the {variant} kernel path and its plain path disagree: {agree}")
    del conf, cls, locs, conf_p, cls_p, locs_p

    model_ms = cuda_event_ms(lambda: model.run_scores(images), iters=5, warmup=1)
    t0 = time.perf_counter()
    for _ in range(3):
        detections_to_boxes(model.run_scores(images))
    host_s = (time.perf_counter() - t0) / 3
    _emit({
        "phase": "main_path", "stem_variant": variant, "preset": cfg.preset_name,
        "dtype": cfg.compute_dtype, "batch": batch, "launches": launches,
        "detections_per_image": counts,
        "plain_stem_agreement": agree,
        "batch_ms": model_ms, "images_per_s": batch / model_ms * 1e3,
        "host_images_per_s_with_box_lists": batch / host_s,
        "peak_mem_gib": peak_mem_gib,
    })
    return launches


def qconv_calls(model, images):
    """Every W8A8 conv of the int8 ``model``'s eager forward on ``images``
    (``quantized._forward_scores``: the façade's would replay a graph),
    each checked as it runs against the card chain (``int8_qconv_plain``:
    quantize, im2col + ``_int_mm``, requant) on the same input:
    ``[(x shape, staged filter, stride, padding, dilation, equal)]``."""
    import torch

    from ssd_tensorflow_tpu_torch.models import quantized
    from ssd_tensorflow_tpu_torch.ops.int8_conv import int8_qconv_plain

    calls = []
    real = quantized.int8_qconv

    def record(x, layer, stride=1, padding="SAME", dilation=1, relu=True):
        y = real(x, layer, stride, padding, dilation, relu)
        want = int8_qconv_plain(x, layer, stride, padding, dilation, relu)
        calls.append((tuple(x.shape), layer["w"], stride, padding, dilation,
                      bool(torch.equal(y, want))))
        return y

    with mock.patch.object(quantized, "int8_qconv", record):
        quantized._forward_scores(model.params, images, model.config)
    return calls


def graph_replays(name, model, images, first):
    """Two more ``run_scores`` of ``images`` after the counted eager one
    that gave ``first``: the first captures the int8 forward's CUDA graph
    (``inference.forward_graph``) and replays it, the second replays it;
    each must give ``first``'s detections bit for bit -> how far the
    graph counters moved (1 capture, 2 replays)."""
    import torch

    from ssd_tensorflow_tpu_torch.inference import forward_graph

    before = (forward_graph.captures, forward_graph.replays)
    for _ in range(2):
        dets = model.run_scores(images)
        differ = [f for f in ("boxes", "scores", "classes", "valid")
                  if not torch.equal(getattr(dets, f), getattr(first, f))]
        if differ:
            raise AssertionError(f"{name}: the replayed forward's detections differ from the "
                                 f"eager one's in {differ}")
    moved = {"captures": forward_graph.captures - before[0],
             "replays": forward_graph.replays - before[1]}
    if moved != {"captures": 1, "replays": 2}:
        raise AssertionError(f"{name}: the forward graph moved its counters by {moved}")
    return moved


def int8_path(bundle, images, batch: int, device):
    """Phase 5: the shipped int8 bundle (see the module doc)."""
    import torch

    from ssd_tensorflow_tpu_torch.inference import InferenceModel
    from ssd_tensorflow_tpu_torch.models import quantized
    from ssd_tensorflow_tpu_torch.ops.int8_conv import int8_qconv_plain
    from ssd_tensorflow_tpu_torch.timing import cuda_event_ms

    model = InferenceModel.from_bundle(str(bundle), device=device)
    n_convs = len(model.act_scales)
    with torch.inference_mode():
        layers = []
        for shape, wt, stride, padding, dilation, equal in qconv_calls(model, images[:2]):
            layers.append({"x": list(shape), "k": [wt.kh, wt.kw, wt.cin, wt.cout],
                           "stride": stride, "padding": padding, "dilation": dilation})
            if not equal:
                raise AssertionError(f"int8_qconv differs from the card chain: {layers[-1]}")
    if len(layers) != n_convs:
        raise AssertionError(f"recorded {len(layers)} int8 convs, the bundle has {n_convs}")

    torch.cuda.reset_peak_memory_stats()
    dets, launches = counted(lambda: model.run_scores(images))
    peak_mem_gib = torch.cuda.max_memory_allocated() / 2**30
    if (launches["int8_qconv"] != n_convs or launches["int8_conv"]
            or launches["nms_keep"] < 1 or launches["fused_stem"] or launches["fused_stem_uint8"]):
        raise AssertionError(f"the int8 path did not run its kernels as it should: {launches}")
    counts = _path_checks("int8", dets, model, batch)
    graphs = graph_replays("int8", model, images, dets)

    with torch.inference_mode():
        scores = model.forward_scores(images)
        repeat = model.forward_scores(images)
        with mock.patch.object(quantized, "int8_qconv", int8_qconv_plain):
            plain = quantized._forward_scores(model.params, images, model.config)
    (conf, cls, locs), (conf_p, cls_p, locs_p) = scores, plain
    if not (torch.isfinite(conf).all() and torch.isfinite(locs).all()):
        raise AssertionError("int8: non-finite pre-NMS scores")
    if not all(torch.equal(a, b) for a, b in zip(scores, repeat)):
        raise AssertionError("int8: two runs of the same batch gave different scores")
    agree = {"conf_max_abs": float((conf - conf_p).abs().max()),
             "cls_share": float((cls == cls_p).float().mean()),
             "locs_max_abs": float((locs - locs_p).abs().max()),
             "scores_identical": all(torch.equal(a, b) for a, b in zip(scores, plain))}
    if not agree["scores_identical"]:
        raise AssertionError(f"the int8 path and its plain-route twin disagree: {agree}")
    del scores, repeat, plain, conf, cls, locs, conf_p, cls_p, locs_p

    batch_ms = cuda_event_ms(lambda: model.run_scores(images), iters=5, warmup=1)
    _emit({"phase": "int8_path", "bundle": str(Path(bundle).name),
           "preset": model.config.preset_name, "batch": batch, "launches": launches,
           "conv_layers": len(layers), "layers_bit_exact": True, "forward_graph": graphs,
           "plain_route_agreement": agree, "detections_per_image": counts,
           "batch_ms": batch_ms, "images_per_s": batch / batch_ms * 1e3,
           "peak_mem_gib": peak_mem_gib})
    return launches


def train_batch(rng, batch: int, size: int, num_classes: int, max_gt: int = 8):
    """uint8 images and 1..``max_gt`` random gt boxes per image (padded to
    ``max_gt`` with ``gt_mask``), as numpy."""
    import numpy as np

    n = rng.integers(1, max_gt + 1, batch)
    w, h = rng.uniform(0.05, 0.5, (2, batch, max_gt))
    boxes = np.stack([rng.uniform(w / 2, 1 - w / 2), rng.uniform(h / 2, 1 - h / 2), w, h], -1)
    return {"images": rng.integers(0, 256, (batch, size, size, 3), dtype=np.uint8),
            "gt_boxes": boxes.astype(np.float32),
            "gt_labels": rng.integers(0, num_classes, (batch, max_gt)).astype(np.int64),
            "gt_mask": np.arange(max_gt)[None, :] < n[:, None]}


def train_config():
    """vgg512, 21 classes, the JAX package's training defaults, but for
    the detect's confidence threshold: 0.01 (``InferenceModel``'s) in
    place of 0.5, which no foreground probability of a freshly
    initialized model reaches, so that the step's NMS gets candidates."""
    from ssd_tensorflow_tpu_torch.models.ssd_vgg import ModelConfig
    from ssd_tensorflow_tpu_torch.ops.postprocess import DetectionConfig
    from ssd_tensorflow_tpu_torch.parallel.train_step import TrainConfig

    return TrainConfig(model=ModelConfig(preset_name="vgg512", num_classes=20),
                       detect=DetectionConfig(confidence_threshold=0.01))


@contextlib.contextmanager
def recording_detect():
    """Keep, by reference, the last detect of the train or eval step: the
    inputs and detections of its ``decode_detections`` (``"decode"``) and
    the candidates and keep mask of its NMS stage (``"keep"``)."""
    from ssd_tensorflow_tpu_torch.ops import postprocess
    from ssd_tensorflow_tpu_torch.parallel import train_step

    rec = {}
    decode, keep = train_step.decode_detections, postprocess._keep

    def record_decode(*args):
        rec["decode"] = (args, decode(*args))
        return rec["decode"][1]

    def record_keep(*args):
        rec["keep"] = (args, keep(*args))
        return rec["keep"][1]

    with mock.patch.object(train_step, "decode_detections", record_decode), \
            mock.patch.object(postprocess, "_keep", record_keep):
        yield rec


def check_keep(rec, name, require_kept: bool = True):
    """The recorded NMS keep mask against ``nms_keep_plain`` on the same
    candidates on the card, bit for bit. Fails if the kernel kept nothing,
    unless ``require_kept`` is false."""
    import torch

    from ssd_tensorflow_tpu_torch.ops import nms_cuda, postprocess

    (boxes, cls_top, valid, cfg), got_keep = rec["keep"]
    if not got_keep.is_cuda:
        raise AssertionError(f"{name}: the NMS ran on {got_keep.device}")
    with mock.patch.object(nms_cuda, "nms_keep", nms_cuda.nms_keep_plain), \
            torch.inference_mode():
        want_keep = postprocess._keep(boxes, cls_top, valid, cfg)
    if not torch.equal(got_keep, want_keep):
        raise AssertionError(f"{name}: nms_keep differs from its plain version on "
                             f"{int((got_keep != want_keep).sum())} of {got_keep.numel()} flags")
    if require_kept and not got_keep.any():
        raise AssertionError(f"{name}: the NMS kernel got no candidate to keep")
    return {"nms_shape": list(valid.shape), "candidates": int(valid.sum()),
            "kept": int(got_keep.sum()), "keep_bit_exact": True}


def check_detect(rec, name):
    """:func:`check_keep`, and the recorded detections against
    ``decode_detections`` on the CPU of the same probabilities and
    offsets: valid, classes and scores equal, boxes within 1e-5 (the
    decode rounds its ``exp`` once from float64, so that an ulp of the
    card's ``expf`` cannot move a box across a canvas pixel)."""
    import torch

    from ssd_tensorflow_tpu_torch.ops import postprocess

    keep = check_keep(rec, name)
    (probs, locs, anchors, det_cfg), dets = rec["decode"]
    want = postprocess.decode_detections(probs.cpu(), locs.cpu(), anchors.cpu(), det_cfg)
    for field in ("valid", "classes", "scores"):
        if not torch.equal(getattr(dets, field).cpu(), getattr(want, field)):
            raise AssertionError(f"{name}: detections' {field} differ from the CPU's decode")
    box_err = float((dets.boxes.cpu() - want.boxes).abs().max())
    if not box_err <= 1e-5:
        raise AssertionError(f"{name}: detection boxes {box_err} off the CPU's decode")
    counts = dets.valid.sum(dim=1)
    return {**keep, "boxes_max_abs_err": box_err,
            "detections_per_image": {"min": int(counts.min()), "max": int(counts.max()),
                                     "mean": float(counts.float().mean())}}


@contextlib.contextmanager
def _library_defaults():
    """PyTorch's own TF32 defaults (cuDNN on, matmul off), as a caller who
    sets nothing has them; the previous flags come back after."""
    import torch

    saved = torch.backends.cudnn.allow_tf32, torch.backends.cuda.matmul.allow_tf32
    torch.backends.cudnn.allow_tf32, torch.backends.cuda.matmul.allow_tf32 = True, False
    try:
        yield
    finally:
        torch.backends.cudnn.allow_tf32, torch.backends.cuda.matmul.allow_tf32 = saved


def _float32_checks(cfg32, data, anchors, device):
    """TF32 at the library default: the float32 forward against TF32 off,
    and one float32 train step on the card against the CPU's, its detect
    held against the CPU's decode (phase 6 b)."""
    import torch

    from ssd_tensorflow_tpu_torch.models import ssd_vgg
    from ssd_tensorflow_tpu_torch.parallel import train_step

    params = ssd_vgg.init_params(cfg32.model, seed=1)
    on_card = {n: {k: v.to(device) for k, v in d.items()} for n, d in params.items()}
    images = torch.from_numpy(data["images"][:2]).to(device)
    outs = []
    for tf32 in (True, False):
        torch.backends.cudnn.allow_tf32 = tf32
        with torch.inference_mode():
            outs.append(ssd_vgg.apply_model(on_card, images, cfg32.model))
        if torch.backends.cudnn.allow_tf32 is not tf32:
            raise AssertionError("the float32 forward did not give the caller's TF32 flag back")
    torch.backends.cudnn.allow_tf32 = True
    tf32_err = max(float((a - b).abs().max()) / float(b.abs().max()) for a, b in zip(*outs))
    if not tf32_err <= 1e-5:
        raise AssertionError(f"float32 forward under TF32 defaults is {tf32_err} off full float32")
    del on_card, outs

    small = {k: v[:2] for k, v in data.items()}
    step = train_step.make_train_step(cfg32, anchors)
    with recording_detect() as rec:
        card, card_losses, card_dets = step(
            train_step.make_train_state(params, cfg32, device=device), small)
    detect = check_detect(rec, "float32 step")
    del rec
    cpu, cpu_losses, cpu_dets = step(train_step.make_train_state(params, cfg32, device="cpu"),
                                     small)
    detect["cpu_step_detections_per_image"] = cpu_dets.valid.sum(dim=1).tolist()
    detect["card_step_detections_per_image"] = card_dets.valid.sum(dim=1).tolist()
    loss_err = {k: abs(float(card_losses[k]) - float(v)) / abs(float(v))
                for k, v in cpu_losses.items()}
    worst = (0.0, "")
    for n, leaves in params.items():
        for k, old in leaves.items():
            want, got = cpu.params[n][k] - old, card.params[n][k].cpu() - old
            tol = max(1e-2 * float(want.abs().max()), 2.0 ** -22 * float(old.abs().max()))
            err = float((got - want).abs().max())
            if not err <= tol:
                raise AssertionError(
                    f"float32 step: {n}/{k} update {err} off the CPU's (tol {tol})")
            worst = max(worst, (err / max(float(want.abs().max()), 1e-30),
                                f"{n}/{k}: largest update {float(want.abs().max())}, "
                                f"largest parameter {float(old.abs().max())}"))
    if not max(loss_err.values()) <= 1e-4:
        raise AssertionError(f"float32 step: losses off the CPU's: {loss_err}")
    return {"tf32_default_forward_rel_err": tf32_err, "loss_rel_err": loss_err,
            "update_rel_err_max": worst[0], "update_rel_err_max_leaf": worst[1],
            "losses": {k: float(v) for k, v in cpu_losses.items()}, "detect": detect}


def train_path(seed: int, device):
    """Phase 6: the vgg512 SGD training step (see the module doc)."""
    import numpy as np
    import torch

    from ssd_tensorflow_tpu_torch.models.ssd_vgg import init_params
    from ssd_tensorflow_tpu_torch.ops.anchors import anchors_for_preset
    from ssd_tensorflow_tpu_torch.ops.matching import encode_targets_batch
    from ssd_tensorflow_tpu_torch.parallel import train_step

    cfg = train_config()
    anchors = anchors_for_preset(cfg.model.preset)
    data = train_batch(np.random.default_rng(seed), TRAIN_BATCH, cfg.model.preset.image_size.h,
                       cfg.model.num_classes)

    # (a) targets on the card against the CPU's
    targets = [encode_targets_batch(*(torch.from_numpy(data[k]).to(dev) for k in
                                      ("gt_boxes", "gt_labels", "gt_mask")),
                                    torch.from_numpy(anchors).to(dev), cfg.model.num_classes).cpu()
               for dev in ("cpu", device)]
    if not torch.equal(targets[0], targets[1]):
        raise AssertionError(f"encode_targets_batch: card and CPU differ on "
                             f"{int((targets[0] != targets[1]).sum())} entries")
    positives = int((targets[0][..., cfg.model.num_classes] == 0).sum())
    del targets

    # (b) float32 under the library's TF32 defaults
    with _library_defaults():
        f32 = _float32_checks(dataclasses.replace(
            cfg, model=dataclasses.replace(cfg.model, compute_dtype="float32")),
            data, anchors, device)

    # (c) bf16 at batch 32
    step = train_step.make_train_step(cfg, anchors)
    state = train_step.make_train_state(init_params(cfg.model, seed), cfg, device=device)
    batch = {k: torch.from_numpy(v).to(device) for k, v in data.items()}
    totals = []
    torch.cuda.reset_peak_memory_stats()
    for _ in range(3):
        state, losses, _ = step(state, batch)
        totals.append(losses["total"])

    def timed():
        nonlocal state
        start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        start.record()
        for _ in range(10):
            state, losses, dets = step(state, batch)
            totals.append(losses["total"])
        end.record()
        end.synchronize()
        return start.elapsed_time(end) / 10, dets

    with recording_detect() as rec:
        (step_ms, dets), launches = counted(timed)
    peak_mem_gib = torch.cuda.max_memory_allocated() / 2**30
    totals = [float(t) for t in totals]
    if not all(np.isfinite(totals)) or not totals[-1] < totals[0]:
        raise AssertionError(f"bf16 training: total loss not finite and falling: {totals}")
    if (launches["nms_keep"] != 10 or launches["fused_stem"] or launches["fused_stem_uint8"]
            or launches["int8_conv"] or launches["int8_qconv"]):
        raise AssertionError(f"the train path did not run its kernels as it should: {launches}")
    if dets.boxes.shape != (TRAIN_BATCH, 200, 4) or not dets.boxes.is_cuda:
        raise AssertionError(f"train step detections: {tuple(dets.boxes.shape)}")
    detect = check_detect(rec, "bf16 step")
    del rec

    with recording_detect() as rec:
        (eval_losses, eval_dets), eval_launches = counted(
            lambda: train_step.make_eval_step(cfg, anchors)(state.params, batch))
    eval_losses = {k: float(v) for k, v in eval_losses.items()}
    if not (all(np.isfinite(list(eval_losses.values())))
            and eval_dets.valid.shape == (TRAIN_BATCH, 200)):
        raise AssertionError(f"eval step: {eval_losses}")
    if eval_launches["nms_keep"] != 1:
        raise AssertionError(f"the eval step did not run NMS once: {eval_launches}")
    eval_detect = check_detect(rec, "eval step")
    del rec
    _emit({"phase": "train_path", "preset": cfg.model.preset_name, "batch": TRAIN_BATCH,
           "dtype": cfg.model.compute_dtype, "anchors": int(anchors.shape[0]),
           "targets_bit_exact": True, "positives": positives, "float32": f32,
           "launches": launches, "step_ms": step_ms, "images_per_s": TRAIN_BATCH / step_ms * 1e3,
           "peak_mem_gib": peak_mem_gib, "total_loss": totals, "step": state.step,
           "detect_threshold": cfg.detect.confidence_threshold, "detect": detect,
           "eval_losses": eval_losses, "eval_detect": eval_detect})
    return launches, step_ms


#: the shipped family bundles and their int8 conv count (every conv and head
#: but the depthwise ones): resnet320 stem 1 + block convs 32 + projections
#: 3 + extras 6 + heads 6; mobilenet320 stem 1 + pointwise 13 + extras 8 +
#: heads 6
FAMILY_BUNDLES = {"resnet320": ("assets/resnet320_int8_minicoco.ssdtpu.npz", 48),
                  "mobilenet320": ("assets/mobilenet320_int8_qat_minivoc.ssdtpu.npz", 28)}
#: GroupNorms of a forward of each family preset
FAMILY_NORMS = {"resnet320": 36, "mobilenet320": 27}
#: the number of classes of each family preset's shipped bundle
FAMILY_CLASSES = {"resnet320": 80, "mobilenet320": 20}
#: two miniVOC JPEGs decoded on the CPU box, with the JAX package's
#: detections of the three shipped bundles on them
#: (tests/test_torch_quantized_families.py writes and checks it)
REAL_IMAGES = "tests/torch_fixtures/bundle_detections.npz"


def _family_images(seed: int, batch: int, device):
    import numpy as np
    import torch

    rng = np.random.default_rng(seed + 7)
    return torch.from_numpy(rng.integers(0, 256, (batch, 320, 320, 3), dtype=np.uint8)).to(device)


def depthwise_calls(model, images):
    """Every depthwise conv of the int8 ``model``'s eager forward on
    ``images``: ``[(x, w, b, stride, padding, output)]``."""
    from ssd_tensorflow_tpu_torch.models import quantized

    calls = []
    real = quantized.depthwise_conv2d

    def record(x, w, b=None, stride=1, padding="SAME", f32_out=False):
        y = real(x, w, b, stride, padding, f32_out)
        calls.append((x, w, b, stride, padding, f32_out, y))
        return y

    with mock.patch.object(quantized, "depthwise_conv2d", record):
        quantized._forward_scores(model.params, images, model.config)
    return calls


def norm_calls(model, images):
    """Every GroupNorm of the family ``model``'s eager forward on ``images``,
    with its activation and skip (``resnet.norm_act``): ``[(x, gn, act, skip,
    output)]``."""
    from ssd_tensorflow_tpu_torch.models import mobilenet, quantized, resnet

    calls = []
    real = resnet.norm_act

    def record(x, gn, act=None, skip=None, norm=None):
        y = real(x, gn, act, skip, norm)
        calls.append((x, gn, act, skip, y))
        return y

    with mock.patch.object(resnet, "norm_act", record), \
            mock.patch.object(mobilenet, "norm_act", record):
        quantized._forward_scores(model.params, images, model.config)
    return calls


def group_norm_ms(model, images):
    """GroupNorm's device ms in one profiled eager forward
    (``quantized._forward_scores``; a replayed graph opens no span): the
    device time of the ``ssd.group_norm`` spans (``utils/profiling``)."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    from ssd_tensorflow_tpu_torch.models import quantized
    from ssd_tensorflow_tpu_torch.utils.profiling import profiler_events, span_device_ms

    with torch.inference_mode():
        quantized._forward_scores(model.params, images, model.config)
        torch.cuda.synchronize()
        with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
            quantized._forward_scores(model.params, images, model.config)
            torch.cuda.synchronize()
    return span_device_ms(profiler_events(prof)).get("ssd.group_norm")


def family_int8_path(name: str, root: Path, seed: int, batch: int, device):
    """Phase 7: a shipped family int8 bundle at ``batch`` x 320 x 320 (see
    the module doc)."""
    import torch

    from ssd_tensorflow_tpu_torch.inference import InferenceModel
    from ssd_tensorflow_tpu_torch.models import quantized, resnet
    from ssd_tensorflow_tpu_torch.ops.int8_conv import int8_qconv_plain
    from ssd_tensorflow_tpu_torch.timing import cuda_event_ms

    fname, n_convs = FAMILY_BUNDLES[name]
    n_norms = FAMILY_NORMS[name]
    model = InferenceModel.from_bundle(str(root / fname), device=device)
    if model.config.preset_name != name or model.act_scales != {}:
        raise AssertionError(f"{fname}: not a {name} family int8 bundle")
    images = _family_images(seed, batch, device)
    layers, dw = [], []
    with torch.inference_mode():
        for shape, wt, stride, padding, dilation, equal in qconv_calls(model, images[:2]):
            layers.append({"x": list(shape), "k": [wt.kh, wt.kw, wt.cin, wt.cout],
                           "stride": stride, "padding": padding})
            if not equal:
                raise AssertionError(f"{name}: int8_qconv differs from the card chain: "
                                     f"{layers[-1]}")
        for x, w, b, stride, padding, f32_out, got in depthwise_calls(model, images[:2]):
            want = quantized.depthwise_conv2d(x.cpu(), w.cpu(), b.cpu(), stride, padding, f32_out)
            dw.append({"x": list(x.shape), "stride": stride,
                       "equal": float((got.cpu() == want).float().mean())})
            if not torch.equal(got.cpu(), want):
                raise AssertionError(f"{name}: a depthwise conv differs from the CPU route: {dw[-1]}")
        norms = []
        for x, gn, act, skip, got in norm_calls(model, images[:2]):
            want = resnet.norm_act(x.cpu(), {k: v.cpu() for k, v in gn.items()}, act,
                                   None if skip is None else skip.cpu())
            norms.append({"x": list(x.shape), "act": act, "skip": skip is not None})
            if not torch.equal(got.cpu(), want):
                raise AssertionError(f"{name}: a GroupNorm differs from the CPU route: {norms[-1]}")
    if len(layers) != n_convs:
        raise AssertionError(f"{name}: recorded {len(layers)} int8 convs, expected {n_convs}")
    if (name == "mobilenet320") != bool(dw):
        raise AssertionError(f"{name}: recorded {len(dw)} depthwise convs")
    if len(norms) != n_norms:
        raise AssertionError(f"{name}: recorded {len(norms)} GroupNorms, expected {n_norms}")

    torch.cuda.reset_peak_memory_stats()
    dets, launches = counted(lambda: model.run_scores(images))
    peak_mem_gib = torch.cuda.max_memory_allocated() / 2**30
    if (launches["int8_qconv"] != n_convs or launches["int8_conv"]
            or launches["group_norm_cuda"] != n_norms
            or launches["nms_keep"] < 1 or launches["fused_stem"] or launches["fused_stem_uint8"]):
        raise AssertionError(f"the {name} int8 path did not run its kernels as it should: "
                             f"{launches}")
    counts = _path_checks(name, dets, model, batch)
    graphs = graph_replays(name, model, images, dets)
    with torch.inference_mode():
        scores = model.forward_scores(images)
        repeat = model.forward_scores(images)
        with mock.patch.object(quantized, "int8_qconv", int8_qconv_plain):
            plain = quantized._forward_scores(model.params, images, model.config)
        with mock.patch.object(resnet, "engages", lambda *a: False):
            plain_norms = quantized._forward_scores(model.params, images, model.config)
    if not (torch.isfinite(scores[0]).all() and torch.isfinite(scores[2]).all()):
        raise AssertionError(f"{name}: non-finite pre-NMS scores")
    if not all(torch.equal(a, b) for a, b in zip(scores, repeat)):
        raise AssertionError(f"{name}: two runs of the same batch gave different scores")
    if not all(torch.equal(a, b) for a, b in zip(scores, plain)):
        raise AssertionError(f"{name}: the scores differ from the plain-route model's")
    if not all(torch.equal(a, b) for a, b in zip(scores, plain_norms)):
        raise AssertionError(f"{name}: the scores differ from the plain-GroupNorm model's")
    del scores, repeat, plain, plain_norms
    batch_ms = cuda_event_ms(lambda: model.run_scores(images), iters=5, warmup=1)
    _emit({"phase": "family_int8_path", "bundle": Path(fname).name, "preset": name,
           "batch": batch, "launches": launches, "forward_graph": graphs,
           "int8_convs": len(layers),
           "int8_convs_bit_exact": True,
           "depthwise_convs": len(dw), "depthwise_equal_to_cpu": True,
           "group_norms": len(norms), "group_norms_equal_to_cpu": True,
           "scores_repeatable": True, "scores_identical_to_plain_route": True,
           "scores_identical_to_plain_group_norm": True,
           "detections_per_image": counts, "batch_ms": batch_ms,
           "images_per_s": batch / batch_ms * 1e3, "peak_mem_gib": peak_mem_gib,
           "group_norm_device_ms": group_norm_ms(model, images)})
    return launches


def dequantized_params(path):
    """A family int8 bundle's weights as float parameters: ``wq *
    w_scale``, divided by ``a_scale`` along the input channels where the
    activation scale was folded in; biases and GroupNorm leaves as they
    are. Returns ``(params, bundle config)``."""
    import numpy as np

    from ssd_tensorflow_tpu_torch.inference import load_bundle
    from ssd_tensorflow_tpu_torch.weights import params_from_jax, qparams_to_jax

    qparams, cfg, _, _ = load_bundle(str(path))
    tree = {}
    for name, leaf in qparams_to_jax(qparams).items():
        if "wq" in leaf:
            w = leaf["wq"].astype(np.float32) * leaf["w_scale"]
            leaf = {"w": w / leaf["a_scale"][:, None] if "a_scale" in leaf else w,
                    "b": leaf["b"]}
        tree[name] = leaf
    return params_from_jax(tree), cfg


def _card_and_cpu(params, cfg, images, device):
    """``forward_scores`` of one float model on the card and on the CPU."""
    import torch

    from ssd_tensorflow_tpu_torch.inference import InferenceModel

    with torch.inference_mode():
        card = InferenceModel(params, cfg, device=device).forward_scores(images.to(device))
        cpu = InferenceModel(params, cfg, device="cpu").forward_scores(images.cpu())
    return [v.cpu() for v in card], cpu


def family_float_path(name: str, root: Path, seed: int, batch: int, device):
    """Phase 8: a family's bf16 float model with weights from the seed at
    ``batch`` x 320 x 320, and its card-against-CPU checks (see the
    module doc)."""
    import numpy as np
    import torch

    from ssd_tensorflow_tpu_torch.inference import InferenceModel
    from ssd_tensorflow_tpu_torch.models import ssd_vgg
    from ssd_tensorflow_tpu_torch.timing import cuda_event_ms

    cfg = ssd_vgg.ModelConfig(preset_name=name, num_classes=FAMILY_CLASSES[name])
    params = ssd_vgg.init_params(cfg, seed=seed)
    model = InferenceModel(params, cfg, device=device)
    images = _family_images(seed, batch, device)
    epilogue = conv_epilogue(model, images, seed, phase=f"family_conv_epilogue:{name}")

    torch.cuda.reset_peak_memory_stats()
    dets, launches = counted(lambda: model.run_scores(images))
    peak_mem_gib = torch.cuda.max_memory_allocated() / 2**30
    if (launches["nms_keep"] < 1 or launches["int8_conv"] or launches["int8_qconv"]
            or launches["fused_stem"] or launches["fused_stem_uint8"]):
        raise AssertionError(f"the {name} float path did not run its kernels as it should: "
                             f"{launches}")
    counts = _path_checks(name, dets, model, batch)
    gaps = {}
    # (a) the same float32 model on the card (TF32 off) and on the CPU:
    # only the order of float32 sums differs
    f32 = dataclasses.replace(cfg, compute_dtype="float32")
    truth, truth_cpu = _card_and_cpu(params, f32, images[:2], device)
    gaps["float32_card_vs_cpu"] = g = _score_gaps(truth, truth_cpu)
    if not (g["conf_max_abs"] < 1e-4 and g["cls_share"] >= 0.999 and g["locs_max_abs"] < 1e-4):
        raise AssertionError(f"the {name} float32 model on the card differs from the CPU's: {g}")
    # (b) bf16 rounding noise, which each GroupNorm renormalizes and passes
    # on, moves near-tied anchors of a random-init model: the card's bf16
    # path no further from the float32 model than the CPU's
    card, cpu = _card_and_cpu(params, cfg, images[:2], device)
    if not all(torch.isfinite(v.float()).all() for v in card):
        raise AssertionError(f"{name}: non-finite pre-NMS scores")
    gaps["bf16_card_vs_cpu"] = _score_gaps(card, cpu)
    gaps["bf16_from_float32"] = {"card": _score_gaps(card, truth), "cpu": _score_gaps(cpu, truth)}
    c, p = gaps["bf16_from_float32"]["card"], gaps["bf16_from_float32"]["cpu"]
    if not (c["conf_max_abs"] <= max(0.02, 2 * p["conf_max_abs"])
            and c["locs_max_abs"] <= max(0.05, 2 * p["locs_max_abs"])
            and c["cls_share"] >= min(0.99, p["cls_share"] - 0.01)):
        raise AssertionError(f"the {name} bf16 float path on the card is further from the "
                             f"float32 model than the CPU's: {gaps}")
    # (c) bf16 with the shipped bundle's trained weights on the two real
    # JPEGs, the card against the CPU at phase 4's argmax and locs bounds;
    # conf within 0.05, the CPU tests' bound of the port against JAX
    # (mobilenet320's 27 GroupNorms carry bf16 rounding noise past phase
    # 4's 0.02 even here: ROADMAP.md section 3)
    trained, tcfg = dequantized_params(root / FAMILY_BUNDLES[name][0])
    with np.load(root / REAL_IMAGES) as data:
        jpegs = torch.from_numpy(data["images_320"])
    card, cpu = _card_and_cpu(trained, dataclasses.replace(tcfg, compute_dtype="bfloat16"),
                              jpegs, device)
    gaps["trained_bf16_card_vs_cpu"] = g = _score_gaps(card, cpu)
    if not (g["conf_max_abs"] < 0.05 and g["cls_share"] >= 0.99 and g["locs_max_abs"] < 0.05):
        raise AssertionError(f"the {name} bf16 model with trained weights on the card differs "
                             f"from the CPU's: {g}")
    batch_ms = cuda_event_ms(lambda: model.run_scores(images), iters=5, warmup=1)
    _emit({"phase": "family_float_path", "preset": name, "dtype": cfg.compute_dtype,
           "batch": batch, "launches": launches, "batch2": gaps,
           "conv_layers_checked": len(epilogue["layers"]), "detections_per_image": counts,
           "batch_ms": batch_ms, "images_per_s": batch / batch_ms * 1e3,
           "peak_mem_gib": peak_mem_gib})
    return launches


def _score_gaps(got, want):
    """conf, argmax class and locs of two ``(conf, cls, locs)`` triples."""
    (conf, cls, locs), (conf_w, cls_w, locs_w) = got, want
    return {"conf_max_abs": float((conf - conf_w).abs().max()),
            "cls_share": float((cls == cls_w).float().mean()),
            "locs_max_abs": float((locs - locs_w).abs().max()),
            "locs_max_ref": float(locs_w.abs().max())}


def _corners(boxes):
    """Center-form ``(..., 4)`` boxes -> ``(xmin, ymin, xmax, ymax)``."""
    import numpy as np

    return np.concatenate([boxes[..., :2] - boxes[..., 2:] / 2, boxes[..., :2] + boxes[..., 2:] / 2],
                          axis=-1)


def match_detections(got, want, min_iou: float, score_tol: float, min_score: float = 0.0):
    """Match ``want``'s detections of conf >= ``min_score`` one to one, in
    score order, to ``got``'s of the same class by the highest IoU of
    their canvas boxes; raise where a match has IoU < ``min_iou`` or a
    conf ``score_tol`` or more apart. Returns the largest conf gap, box
    corner gap (canvas pixels) and the least IoU of the matches."""
    import numpy as np

    gaps = {"matched": 0, "score_gap_max": 0.0, "corner_gap_max": 0.0, "iou_min": 1.0}
    for i in range(want["valid"].shape[0]):
        gv, wv = got["valid"][i], want["valid"][i]
        gb, wb = _corners(got["boxes"][i]), _corners(want["boxes"][i])
        used = np.zeros(gv.shape, bool)
        for r in np.flatnonzero(wv & (want["scores"][i] >= min_score)):
            cand = gv & ~used & (got["classes"][i] == want["classes"][i][r])
            if not cand.any():
                raise AssertionError(f"image {i}: no detection of class "
                                     f"{want['classes'][i][r]} left for row {r}")
            lo = np.maximum(gb[:, :2], wb[r, :2])
            hi = np.minimum(gb[:, 2:], wb[r, 2:])
            inter = np.prod(np.clip(hi - lo, 0, None), axis=1)
            area = np.prod(gb[:, 2:] - gb[:, :2], axis=1)
            iou = np.where(cand, inter / (area + np.prod(wb[r, 2:] - wb[r, :2]) - inter), -1.0)
            j = int(np.argmax(iou))
            used[j] = True
            gap = abs(float(got["scores"][i][j]) - float(want["scores"][i][r]))
            corner = float(np.abs(gb[j] - wb[r]).max())
            if not (iou[j] >= min_iou and gap < score_tol):
                raise AssertionError(f"image {i} row {r}: best match IoU {iou[j]}, conf gap {gap}")
            gaps["matched"] += 1
            gaps["score_gap_max"] = max(gaps["score_gap_max"], gap)
            gaps["corner_gap_max"] = max(gaps["corner_gap_max"], corner)
            gaps["iou_min"] = min(gaps["iou_min"], float(iou[j]))
    return gaps


def real_images(root: Path, device):
    """Phase 9: the three shipped bundles on two real JPEGs on the card
    against the JAX package's CPU detections (see the module doc)."""
    import numpy as np
    import torch

    from ssd_tensorflow_tpu_torch.inference import InferenceModel

    fields = ("boxes", "scores", "classes", "valid")
    with np.load(root / REAL_IMAGES) as data:
        fixture = {k: data[k] for k in data.files}
    bundles = {"vgg512": INT8_BUNDLE, **{n: f for n, (f, _) in FAMILY_BUNDLES.items()}}
    out, launches = {}, {}
    for name, fname in bundles.items():
        model = InferenceModel.from_bundle(str(root / fname), device=device)
        images = torch.from_numpy(fixture[f"images_{model.preset.image_size.h}"])
        dets, launches[name] = counted(lambda: model.run_scores(images.to(device)))
        card = {f: getattr(dets, f).cpu().numpy() for f in fields}
        jax_dets = {f: fixture[f"{name}_{f}"] for f in fields}
        row = {"detections_per_image": card["valid"].sum(axis=1).tolist(),
               "jax_detections_per_image": jax_dets["valid"].sum(axis=1).tolist()}
        if launches[name]["nms_keep"] < 1 or launches[name]["int8_qconv"] < 1:
            raise AssertionError(f"{name}: real-image run did not launch its kernels")
        if row["detections_per_image"] != row["jax_detections_per_image"]:
            raise AssertionError(f"{name}: detection counts {row}")
        if name == "vgg512":
            # every op of the VGG int8 path rounds as the JAX package's does
            row["against_jax"] = match_detections(card, jax_dets, 0.99, 1e-4)
        else:
            # the families' GroupNorms sum in another order than XLA's, so
            # their scores drift from the JAX package's as two compilations
            # of the JAX forward drift from each other (ROADMAP.md section 3;
            # tests/test_torch_quantized_families.py isolates the cause): held
            # to the CPU tests' bounds against JAX, and to the port's own CPU
            # route (the same arithmetic) at the strict bounds
            with torch.inference_mode():
                ref = InferenceModel.from_bundle(str(root / fname), device="cpu").run_scores(images)
            ref = {f: getattr(ref, f).numpy() for f in fields}
            row["cpu_detections_per_image"] = ref["valid"].sum(axis=1).tolist()
            if row["detections_per_image"] != row["cpu_detections_per_image"]:
                raise AssertionError(f"{name}: card and CPU detection counts {row}")
            row["against_cpu_route"] = match_detections(card, ref, 0.99, 1e-4)
            row["against_jax_conf_0.1"] = match_detections(card, jax_dets, 0.95, 0.02, 0.1)
            match_detections(jax_dets, card, 0.95, 0.02, 0.1)
        out[name] = row
    _emit({"phase": "real_images", "images": int(fixture["images_320"].shape[0]),
           "bundles": out})
    return launches


@contextlib.contextmanager
def _caller_tf32_on():
    """TF32 on for cuDNN and cuBLAS (float32 matmul precision "high"), as a
    caller may leave them; the previous settings come back after."""
    import torch

    saved = torch.backends.cudnn.allow_tf32, torch.get_float32_matmul_precision()
    torch.backends.cudnn.allow_tf32 = True
    torch.set_float32_matmul_precision("high")
    try:
        yield
    finally:
        torch.backends.cudnn.allow_tf32 = saved[0]
        torch.set_float32_matmul_precision(saved[1])


def device_augment_path(seed: int, device):
    """Phase 10: the on-device augmentation at vgg512 (see the module doc)."""
    import numpy as np
    import torch

    from ssd_tensorflow_tpu_torch.data import device_augment as da
    from ssd_tensorflow_tpu_torch.ops.anchors import anchors_for_preset
    from ssd_tensorflow_tpu_torch.timing import cuda_event_ms

    preset = train_config().model.preset
    size = preset.image_size.h
    anchors = anchors_for_preset(preset)
    acfg = da.augment_config_for(preset)
    data = train_batch(np.random.default_rng(seed + 11), TRAIN_BATCH, size, 20)
    cpu_batch = {k: torch.from_numpy(v) for k, v in data.items()}
    batch = {k: v.to(device) for k, v in cpu_batch.items()}
    generator = torch.Generator(device).manual_seed(seed)
    draws = da.draw_augment(generator, TRAIN_BATCH, acfg)
    on_card = torch.from_numpy(anchors).to(device)
    with _caller_tf32_on():
        torch.cuda.reset_peak_memory_stats()
        got = da.apply_augment(draws, batch, on_card, acfg)
        torch.cuda.synchronize()
        peak_mem_gib = torch.cuda.max_memory_allocated() / 2**30
        if torch.get_float32_matmul_precision() != "high":
            raise AssertionError("the augmentation did not give the caller's matmul precision back")
    want = da.apply_augment(draws.to("cpu"), cpu_batch, torch.from_numpy(anchors), acfg)
    if got["images"].device.type != device.type or got["images"].shape != (TRAIN_BATCH, size,
                                                                            size, 3):
        raise AssertionError(f"augmented images {got['images'].device} {got['images'].shape}")
    diff = (got["images"].cpu().int() - want["images"].int()).abs()
    equal = float((diff == 0).float().mean())
    box_err = float((got["gt_boxes"].cpu() - want["gt_boxes"]).abs().max())
    if not (int(diff.max()) <= 1 and equal >= 0.999 and box_err <= 1e-6
            and all(torch.equal(got[k].cpu(), want[k]) for k in ("gt_labels", "gt_mask"))):
        raise AssertionError(f"augmentation card against CPU: {equal} of pixels equal, largest "
                             f"gap {int(diff.max())}, boxes {box_err}")
    *_, has_pos = da.augment_geometry(draws, batch, on_card, acfg)
    fn = da.make_augment_fn(acfg, anchors)
    _, launches = counted(lambda: fn(generator, batch))
    batch_ms = cuda_event_ms(lambda: fn(generator, batch), iters=5, warmup=1)
    _emit({"phase": "device_augment", "preset": preset.name, "batch": TRAIN_BATCH,
           "staged": [size, size], "out": [acfg.out_h, acfg.out_w],
           "gt_per_image": data["gt_mask"].sum(1).tolist(), "pixels_equal_to_cpu": equal,
           "pixels_max_gap": int(diff.max()), "boxes_max_abs_err": box_err,
           "fallback_share": 1.0 - float(has_pos.float().mean()),
           "kept_boxes": int(got["gt_mask"].sum()), "batch_ms": batch_ms,
           "images_per_s": TRAIN_BATCH / batch_ms * 1e3, "peak_mem_gib": peak_mem_gib,
           "launches": launches})
    return launches


@contextlib.contextmanager
def no_calibration():
    """Every calibration entry of ``models/quantized.py`` patched to raise:
    a QAT checkpoint must never be recalibrated."""
    from ssd_tensorflow_tpu_torch.models import quantized

    boom = AssertionError("a QAT checkpoint was recalibrated")
    with mock.patch.object(quantized, "calibrate_activation_amax", side_effect=boom), \
            mock.patch.object(quantized, "calibrate_activation_scales", side_effect=boom), \
            mock.patch.object(quantized, "QuantizedModel", side_effect=boom):
        yield


@contextlib.contextmanager
def qat_grids(record=None, forced=None):
    """The port's activation fake quantization recording each integer grid
    into ``record`` (on the CPU), or taking each grid from ``forced`` in
    turn, so that a step handed another device's roundings is compared
    alone; yields ``{"differing": n}``, the roundings the forced step would
    have taken otherwise."""
    import torch

    from ssd_tensorflow_tpu_torch.models import qat

    real, grids, stats = qat.fake_quant_act, iter(forced or ()), {"differing": 0}

    def fake_quant_act(x, scale):
        s = scale if torch.is_tensor(scale) else torch.tensor(scale, device=x.device)
        # the quantizer's own grid: its values over the scale (|grid| <= 127,
        # so the one rounding of the product and of the quotient cancel)
        own = torch.round(real(x.detach(), scale) / s)
        if record is not None:
            record.append(own.to("cpu", torch.int8))
            return real(x, scale)
        grid = next(grids).to(x.device, x.dtype)
        stats["differing"] += int((own != grid).sum())
        in_range = (x.abs() <= 127.5 * scale).to(x.dtype)
        return (grid * scale).detach() + in_range * (x - x.detach())

    with mock.patch.object(qat, "fake_quant_act", fake_quant_act):
        yield stats


def _qat_step_card_vs_cpu(params, tcfg, act, batch, anchors, device):
    """One QAT float32 step at batch 2 on the card against the CPU, cuDNN's
    TF32 at PyTorch's default. With the CPU's activation grids handed to
    the card's step: each loss within 1e-4 relative, each leaf's update
    within phase 6 (b)'s bound or 1e-6 of the largest update, and at most
    ``QAT_ROUNDINGS_DIFFERING`` of the card quantizer's own roundings
    (given the CPU's upstream) differing from the CPU's. The card's step
    left to its own roundings: each loss within ``QAT_FREE_LOSS`` relative."""
    import torch

    from ssd_tensorflow_tpu_torch.models import qat
    from ssd_tensorflow_tpu_torch.parallel import train_step

    step = qat.make_qat_train_step(tcfg, anchors, act)
    small = {k: v[:2].cpu() for k, v in batch.items()}
    grids = []
    with _library_defaults():
        with qat_grids(record=grids):
            cpu, cpu_losses, _ = step(train_step.make_train_state(params, tcfg, device="cpu"),
                                      small)
        with qat_grids(forced=grids) as forced:
            card, card_losses, _ = step(train_step.make_train_state(params, tcfg, device=device),
                                        small)
        _, free_losses, _ = step(train_step.make_train_state(params, tcfg, device=device), small)
    loss_err = {k: abs(float(card_losses[k]) - float(v)) / abs(float(v))
                for k, v in cpu_losses.items()}
    updates = {(n, k): (cpu.params[n][k] - old, card.params[n][k].cpu() - old, old)
               for n, leaves in params.items() for k, old in leaves.items()}
    largest = max(float(want.abs().max()) for want, _, _ in updates.values())
    worst = (0.0, "")
    for (n, k), (want, got, old) in updates.items():
        # phase 6 (b)'s bound; a leaf whose update is float32 noise on both
        # devices (a bias before a GroupNorm of one channel per group has a
        # zero gradient in exact arithmetic) within 1e-6 of the largest
        tol = max(1e-2 * float(want.abs().max()), 2.0 ** -22 * float(old.abs().max()),
                  1e-6 * largest)
        err = float((got - want).abs().max())
        if not err <= tol:
            raise AssertionError(f"QAT step: {n}/{k} update {err} off the CPU's (tol {tol})")
        worst = max(worst, (err / max(float(want.abs().max()), 1e-6 * largest), f"{n}/{k}"))
    if not max(loss_err.values()) <= 1e-4:
        raise AssertionError(f"QAT step: losses off the CPU's: {loss_err}")
    roundings = sum(g.numel() for g in grids)
    if not forced["differing"] <= QAT_ROUNDINGS_DIFFERING * roundings:
        raise AssertionError(f"QAT step: {forced['differing']} of the card's {roundings} "
                             "activation roundings differ from the CPU's")
    free_err = {k: abs(float(free_losses[k]) - float(v)) / abs(float(v))
                for k, v in cpu_losses.items()}
    if not max(free_err.values()) <= QAT_FREE_LOSS:
        raise AssertionError(f"QAT step on its own roundings: losses off the CPU's: {free_err}")
    return {"loss_rel_err": loss_err, "update_rel_err_max": worst[0], "largest_update": largest,
            "update_rel_err_max_leaf": worst[1], "roundings": roundings,
            "card_roundings_differing": forced["differing"], "unforced_loss_rel_err": free_err,
            "losses": {k: float(v) for k, v in cpu_losses.items()}}


#: the share of the card quantizer's roundings, given the CPU's upstream,
#: that may differ from the CPU's (tests/test_torch_qat.py's bound against
#: JAX): an input within an ulp of a half step rounds either way
QAT_ROUNDINGS_DIFFERING = 2e-3
#: the card's QAT step on its own roundings against the CPU's, each loss
#: relative: a rounding that differs carries its step to every later layer
#: (measured on an H100: 1.5e-7 for mobilenet320, 1.5e-3 for vgg512)
QAT_FREE_LOSS = 1e-2
#: the QAT runs of phase 11: the shipped bundle whose dequantized weights
#: start the finetune, the batch, the timed steps
QAT_RUNS = {"mobilenet320": (FAMILY_BUNDLES["mobilenet320"][0], TRAIN_BATCH, 5),
            "vgg512": (INT8_BUNDLE, 8, 3)}
#: fake-quant against int8 argmax floor (the JAX package's tests/test_qat.py)
QAT_AGREEMENT = 0.95


def qat_path(name: str, root: Path, seed: int, device):
    """Phase 11: the QAT finetune path of one preset (see the module doc)."""
    import tempfile

    import numpy as np
    import torch

    from ssd_tensorflow_tpu_torch.data import device_augment as da
    from ssd_tensorflow_tpu_torch.inference import InferenceModel, load_bundle, model_config_to_dict
    from ssd_tensorflow_tpu_torch.models import qat, quantized
    from ssd_tensorflow_tpu_torch.ops.anchors import anchors_for_preset
    from ssd_tensorflow_tpu_torch.ops.postprocess import DetectionConfig
    from ssd_tensorflow_tpu_torch.parallel import train_step
    from ssd_tensorflow_tpu_torch.timing import cuda_event_ms
    from ssd_tensorflow_tpu_torch.utils.checkpoint import (
        checkpoint_config,
        restore_checkpoint,
        save_checkpoint,
    )

    fname, batch_size, steps = QAT_RUNS[name]
    params, bundle_cfg = dequantized_params(root / fname)
    cfg = qat.qat_model_config(bundle_cfg)
    tcfg = train_step.TrainConfig(model=cfg, detect=DetectionConfig(confidence_threshold=0.01))
    family = cfg.preset.backbone != "vgg"
    anchors = anchors_for_preset(cfg.preset)
    size = cfg.preset.image_size.h
    raw = {k: torch.from_numpy(v).to(device) for k, v in train_batch(
        np.random.default_rng(seed + 13), batch_size, size, cfg.num_classes).items()}
    augment = da.make_augment_fn(da.augment_config_for(cfg.preset), anchors)
    generator = torch.Generator(device).manual_seed(seed)
    first = augment(generator, raw)
    state = train_step.make_train_state(params, tcfg, device=device)
    out = {"phase": "qat_path", "preset": name, "bundle": Path(fname).name, "batch": batch_size,
           "dtype": cfg.compute_dtype, "l2_norm_eps": cfg.l2_norm_eps}

    with tempfile.TemporaryDirectory() as tmp:
        # calibrate on 8 augmented images, store the grid, restore, resume
        act, entry = qat.qat_scales(state.params, cfg, None, first["images"][:8])
        key = qat.qat_checkpoint_key(cfg)
        config = {"model": model_config_to_dict(cfg), **entry}
        save_checkpoint(f"{tmp}/e0.ckpt.npz", state, config)
        stored = checkpoint_config(f"{tmp}/e0.ckpt.npz")
        state = restore_checkpoint(f"{tmp}/e0.ckpt.npz", state)
        with no_calibration():
            act, resumed = qat.qat_scales(state.params, cfg, stored)
        if resumed != entry or list(entry) != [key]:
            raise AssertionError(f"{name}: the resumed QAT scales differ from the stored {key}")

        step = qat.make_qat_train_step(tcfg, anchors, act)
        torch.cuda.reset_peak_memory_stats()
        totals = []
        for _ in range(3):
            state, losses, _ = step(state, augment(generator, raw))
            totals.append(losses["total"])

        def timed():
            nonlocal state
            start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
            start.record()
            for _ in range(steps):
                state, losses, dets = step(state, augment(generator, raw))
                totals.append(losses["total"])
            end.record()
            end.synchronize()
            return start.elapsed_time(end) / steps, dets

        with recording_detect() as rec:
            (step_ms, dets), launches = counted(timed)
        peak_mem_gib = torch.cuda.max_memory_allocated() / 2**30
        step_detect = check_detect(rec, f"{name} QAT step")
        del rec
        totals = [float(t) for t in totals]
        if not all(np.isfinite(totals)):
            raise AssertionError(f"{name} QAT: a loss is not finite: {totals}")
        if (launches["nms_keep"] != steps or launches["int8_conv"] or launches["int8_qconv"]
                or launches["fused_stem"] or launches["fused_stem_uint8"]):
            raise AssertionError(f"the {name} QAT steps did not run their kernels as they "
                                 f"should: {launches}")
        augment_ms = cuda_event_ms(lambda: augment(generator, raw), iters=3, warmup=1)

        fwd = qat.make_qat_forward(cfg, act)
        with recording_detect() as rec:
            (eval_losses, _), eval_launches = counted(
                lambda: train_step.make_eval_step(tcfg, anchors, forward=fwd)(state.params, first))
        if eval_launches["nms_keep"] != 1 or not all(
                np.isfinite(float(v)) for v in eval_losses.values()):
            raise AssertionError(f"{name} QAT eval step: {eval_launches}, {eval_losses}")
        eval_detect = check_detect(rec, f"{name} QAT eval")
        del rec

        # export with exactly the stored grid, then deploy
        save_checkpoint(f"{tmp}/final.ckpt.npz", state, config)
        with no_calibration():
            qat.export_int8_bundle(f"{tmp}/final.ckpt.npz", f"{tmp}/qat.npz", device=device)
        qparams, _, _, bundle_scales = load_bundle(f"{tmp}/qat.npz")
        if family:
            want = qat.family_a_scales(stored[key])
            same = bundle_scales == {} and all(
                np.array_equal(qparams[k]["a_scale"].numpy(), v) for k, v in want.items())
        else:
            same = bundle_scales == stored[key]
        if not same:
            raise AssertionError(f"{name}: the exported bundle's scales are not the checkpoint's")
        n_convs = sum("wq" in leaf and not n.endswith("_dw") for n, leaf in qparams.items())
        model = InferenceModel.from_bundle(f"{tmp}/qat.npz", device=device)
    images = first["images"]
    with recording_detect() as rec:
        deploy, deploy_launches = counted(lambda: model.run_scores(images))
    if (deploy_launches["int8_qconv"] != n_convs or deploy_launches["int8_conv"]
            or deploy_launches["nms_keep"] != 1):
        raise AssertionError(f"the exported {name} bundle did not run its kernels as it should: "
                             f"{deploy_launches} ({n_convs} int8 convs)")
    deploy_keep = check_keep(rec, f"{name} QAT deploy")
    del rec
    counts = _path_checks(f"{name} QAT bundle", deploy, model, batch_size)
    with torch.no_grad():
        logits, _ = fwd(state.params, images[:8])
    with torch.inference_mode():
        ref = quantized._forward(model.params, images[:8], model.config)
    agree = float((logits.argmax(-1) == ref[..., : cfg.num_classes + 1].argmax(-1))
                  .float().mean())
    if family and not agree > QAT_AGREEMENT:
        raise AssertionError(f"{name}: fake-quant against int8 argmax agreement {agree}")
    out.update({"scales_key": key, "resumed_without_calibration": True,
                "launches": launches, "step_detect": step_detect, "eval_detect": eval_detect,
                "deploy_keep": deploy_keep, "step_ms": step_ms,
                "images_per_s": batch_size / step_ms * 1e3, "augment_ms": augment_ms,
                "peak_mem_gib": peak_mem_gib, "total_loss": totals,
                "eval_losses": {k: float(v) for k, v in eval_losses.items()},
                "eval_launches": eval_launches, "bundle_scales_equal_checkpoint": True,
                "int8_convs": n_convs, "deploy_launches": deploy_launches,
                "deploy_detections_per_image": counts, "fake_quant_vs_int8_argmax": agree,
                "card_vs_cpu": _qat_step_card_vs_cpu(params, tcfg, act, first, anchors, device)})
    _emit(out)
    return {f"qat_train:{name}": launches, f"qat_eval:{name}": eval_launches,
            f"qat_deploy:{name}": deploy_launches}


# ---------------------------------------------------------------------------
# 12. parallel: the one-rank NCCL group, remat and prefetch
# ---------------------------------------------------------------------------

#: remat may recompute in another cuDNN algorithm: its losses within 1e-3
#: relative, each leaf's update within 1e-2 of that leaf's largest
REMAT_LOSS = 1e-3
REMAT_UPDATE = 1e-2


def join_one_rank_group():
    """The environment of a one-process ``torchrun`` launch: ``make_mesh``
    then joins an NCCL group of one rank."""
    import os

    from ssd_tensorflow_tpu_torch.parallel.mesh import free_port

    os.environ.update(RANK="0", WORLD_SIZE="1", LOCAL_RANK="0", MASTER_ADDR="127.0.0.1",
                      MASTER_PORT=str(free_port()))


def _updates_within(new, ref, old, rel: float):
    """The largest gap of ``new``'s update from ``ref``'s, relative to each
    leaf's largest update of ``ref``, or two ulps of its largest parameter
    (the resolution of a difference of two parameters); raises above
    ``rel``."""
    worst = 0.0
    for n, leaves in old.items():
        for k, o in leaves.items():
            want = ref[n][k].float().cpu() - o
            got = new[n][k].float().cpu() - o
            tol = max(rel * float(want.abs().max()), 2.0 ** -22 * float(o.abs().max()))
            err = float((got - want).abs().max())
            if not err <= tol:
                raise AssertionError(f"{n}/{k}: update {err} off (tol {tol})")
            worst = max(worst, err / max(float(want.abs().max()), 1e-30))
    return worst


def parallel_path(seed: int, device):
    """Phase 12: the one-rank NCCL group, remat and prefetch (see the
    module doc)."""
    import numpy as np
    import torch
    import torch.distributed as dist

    from ssd_tensorflow_tpu_torch.models.ssd_vgg import init_params
    from ssd_tensorflow_tpu_torch.ops.anchors import anchors_for_preset
    from ssd_tensorflow_tpu_torch.parallel import mesh as pmesh
    from ssd_tensorflow_tpu_torch.parallel import train_step
    from ssd_tensorflow_tpu_torch.parallel.prefetch import prefetch_to_device

    cfg = train_config()
    anchors = anchors_for_preset(cfg.model.preset)
    size = cfg.model.preset.image_size.h
    data = train_batch(np.random.default_rng(seed + 12), TRAIN_BATCH, size, cfg.model.num_classes)
    host_params = init_params(cfg.model, seed)
    step = train_step.make_train_step(cfg, anchors)
    fresh = lambda: train_step.make_train_state(host_params, cfg, device=device)  # noqa: E731

    # (a) without a group, twice, then under the one-rank NCCL group
    saved = torch.backends.cudnn.deterministic
    torch.backends.cudnn.deterministic = True
    try:
        alone = [step(fresh(), data)[:2] for _ in range(2)]
        if dist.is_initialized():
            raise AssertionError("a process group exists before phase 12")
        join_one_rank_group()
        mesh = pmesh.make_mesh(device="cuda")
        if mesh is None or dist.get_backend() != "nccl" or dist.get_world_size() != 1:
            raise AssertionError(f"make_mesh did not join a one-rank NCCL group: {mesh}")
        placed = train_step.shard_state(fresh(), mesh)
        grouped, grouped_losses = step(placed, train_step.shard_batch(data, mesh))[:2]
    finally:
        torch.backends.cudnn.deterministic = saved
    ref, ref_losses = alone[0]
    leaves = [(n, k) for n in ref.params for k in ref.params[n]]
    repeat_equal = all(torch.equal(alone[1][0].params[n][k], ref.params[n][k]) for n, k in leaves)
    differ = [f"{n}/{k}" for n, k in leaves if not torch.equal(grouped.params[n][k],
                                                               ref.params[n][k])]
    loss_equal = all(torch.equal(grouped_losses[k], ref_losses[k]) for k in ref_losses)
    if differ or not loss_equal or grouped.step != 1:
        raise AssertionError(f"the one-rank NCCL step differs from the step without a group: "
                             f"{len(differ)} leaves ({differ[:4]}), losses equal {loss_equal}")
    del alone, grouped, placed

    # (b) remat against no remat, from the same state, each step's peak over
    # what was allocated before it (earlier runs' params stay alive); the
    # plain step runs before and after the remat step, and the remat peak
    # must lie below both by more than their own spread: a remat that
    # changed nothing would reproduce the plain peak and fail
    old = {n: {k: v.clone() for k, v in d.items()} for n, d in host_params.items()}
    runs = {}
    for key, remat in (("plain", False), ("remat", True), ("plain_again", False)):
        c = dataclasses.replace(cfg, remat=remat)
        state = fresh()
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        base = torch.cuda.memory_allocated()
        new, losses, _ = train_step.make_train_step(c, anchors)(state, data)
        torch.cuda.synchronize()
        runs[key] = (new.params, {k: float(v) for k, v in losses.items()},
                     torch.cuda.max_memory_allocated() / 2**30,
                     (torch.cuda.max_memory_allocated() - base) / 2**30)
        del state, new
    (p0, l0, peak0, over0), (p1, l1, peak1, over1) = runs["plain"], runs["remat"]
    peak0b, over0b = runs["plain_again"][2:]
    loss_rel = {k: abs(l1[k] - l0[k]) / abs(l0[k]) for k in l0}
    if not max(loss_rel.values()) <= REMAT_LOSS:
        raise AssertionError(f"remat losses off: {loss_rel}")
    update_rel = _updates_within(p1, p0, old, REMAT_UPDATE)
    spread = abs(over0 - over0b)
    if not over1 < min(over0, over0b) - spread:
        raise AssertionError(f"remat peak {over1} GiB over the state is not below the plain "
                             f"step's {over0} / {over0b} GiB by more than their spread")
    del runs, p0, p1

    # (c) 8 host batches through prefetch onto the card, a step on each
    rng = np.random.default_rng(seed + 13)
    host = [train_batch(rng, TRAIN_BATCH, size, cfg.model.num_classes) for _ in range(8)]
    state = fresh()
    mismatched = []
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for i, (dev, meta) in enumerate(prefetch_to_device(
            iter([(h, i) for i, h in enumerate(host)]), size=2, device=device,
            transform=lambda item: item)):
        if meta != i:
            raise AssertionError(f"prefetch passed host part {meta} for batch {i}")
        state, losses, _ = step(state, dev)
        mismatched += [f"{i}/{k}" for k, v in host[i].items()
                       if not (dev[k].is_cuda and torch.equal(dev[k].cpu(), torch.from_numpy(v)))]
    torch.cuda.synchronize()
    prefetch_ms = (time.perf_counter() - t0) * 1e3 / len(host)
    if mismatched or state.step != len(host) or not torch.isfinite(losses["total"]):
        raise AssertionError(f"prefetch: batches not equal to the host's: {mismatched}")
    _emit({"phase": "parallel", "preset": cfg.model.preset_name, "batch": TRAIN_BATCH,
           "dtype": cfg.model.compute_dtype, "backend": dist.get_backend(),
           "world_size": dist.get_world_size(), "nccl_step_bit_exact": True,
           "repeat_without_group_bit_exact": repeat_equal,
           "remat": {"loss_rel_err": loss_rel, "update_rel_err_max": update_rel,
                     "peak_mem_gib": {"no_remat": peak0, "remat": peak1,
                                      "no_remat_again": peak0b},
                     "peak_over_state_gib": {"no_remat": over0, "remat": over1,
                                             "no_remat_again": over0b}},
           "prefetch": {"batches": len(host), "bit_exact": True,
                        "host_ms_per_step_with_prefetch": prefetch_ms}})


# ---------------------------------------------------------------------------
# 13. train_cli: the training entry point on the card
# ---------------------------------------------------------------------------

CLI_TRAIN, CLI_VALID = 64, 32
#: the timing run's train images: ten steps an epoch at batch 32
CLI_TIMED_TRAIN = 320


class StagedProcessor:
    """Stands in for ``data/pipeline._SampleProcessor`` (same constructor):
    a sample's staged image, and its boxes as the pipeline's arrays. The
    per-sample decode, resize and augmentation are staged (the card
    machine has no PIL, and its OpenCV, where present, is another build
    than the CPU box's); they are held against the JAX package's on the CPU (``tests/test_torch_pipeline.py``). Everything
    around them runs as it is: the dataset files, the generators, the
    forked workers and the shared-memory transport. The images are
    registered before any worker forks, so that workers read them from
    the memory they inherit."""

    images: dict = {}

    def __init__(self, preset, num_classes, aug_config, train, max_gt):
        self.max_gt = max_gt

    def __call__(self, sample):
        from ssd_tensorflow_tpu_torch.data.transforms import boxes_to_arrays

        tag, i = sample.filename.rsplit("/", 1)
        boxes, labels, mask = boxes_to_arrays(sample.boxes, self.max_gt)
        return self.images[tag][int(i)], boxes, labels, mask, sample.boxes


def staged_dataset(root, seed: int, preset: str = "vgg512", n_train: int = CLI_TRAIN,
                   n_valid: int = CLI_VALID, splits: dict | None = None,
                   names: dict | None = None) -> str:
    """A dataset directory as ``process_dataset.py`` writes it
    (``training-data.json``, ``{train,valid}-samples.pkl``) over ``n_train``
    and ``n_valid`` staged uint8 images at the preset's size (vgg512: 512 x
    512) with 1-8 gt boxes each, made from the seed, 20 classes; or over the
    given ``splits`` (``{"train": batch, "valid": batch}``, each as
    :func:`train_batch` returns it, at the preset's size) with the label map
    ``names``. The images live in :class:`StagedProcessor`; returns the
    directory."""
    import json
    import pickle

    import numpy as np

    from ssd_tensorflow_tpu_torch.presets import get_preset_by_name, preset_to_dict
    from ssd_tensorflow_tpu_torch.types import Box, Point, Sample, Size

    names = names or {i: f"class{i}" for i in range(20)}
    pre = get_preset_by_name(preset)
    size = pre.image_size
    root = Path(root)
    root.mkdir(parents=True)
    if splits is None:
        rng = np.random.default_rng(seed + 14)
        splits = {which: train_batch(rng, n, size.h, len(names))
                  for which, n in (("train", n_train), ("valid", n_valid))}
    for which, data in splits.items():
        tag = f"{root}/{which}"
        StagedProcessor.images[tag] = data["images"]
        samples = [Sample(f"{tag}/{i}", [
            Box(names[int(lab)], int(lab), Point(float(b[0]), float(b[1])),
                Size(float(b[2]), float(b[3])))
            for b, lab, m in zip(data["gt_boxes"][i], data["gt_labels"][i], data["gt_mask"][i])
            if m], Size(size.w, size.h)) for i in range(len(data["images"]))]
        with open(root / f"{which}-samples.pkl", "wb") as f:
            pickle.dump(samples, f)
    with open(root / "training-data.json", "w") as f:
        json.dump({"preset": preset_to_dict(pre), "num-classes": len(names),
                   "colors": {v: [0, 0, 255] for v in names.values()},
                   "lid2name": {str(k): v for k, v in names.items()},
                   "lname2id": {v: k for k, v in names.items()}}, f)
    return str(root)


@contextlib.contextmanager
def staged_cli(cli, threshold=None):
    """The train CLI on :func:`staged_dataset` directories: the pipeline's
    per-sample processor replaced by :class:`StagedProcessor`, and, given
    ``threshold``, the steps' detect at that confidence threshold in place
    of the CLI's 0.5."""
    from ssd_tensorflow_tpu_torch.data import pipeline

    detect = cli.DetectionConfig
    with contextlib.ExitStack() as stack:
        stack.enter_context(mock.patch.object(pipeline, "_SampleProcessor", StagedProcessor))
        if threshold is not None:
            stack.enter_context(mock.patch.object(
                cli, "DetectionConfig",
                lambda **kw: detect(**dict(kw, confidence_threshold=threshold))))
        yield


class CliProbe:
    """Wraps the CLI's train and eval steps: a CUDA event at the start and
    end of each call, its losses, the state the first train call of a run
    gets, every NMS stage's candidates and keep mask, and, for the train
    calls of a run that ``profile`` names by their number in that run, the
    device time under ``torch.profiler``."""

    def __init__(self, profile: dict):
        self.profile = profile
        self.calls, self.keeps, self.first_states = [], [], []
        self.busy_ms = {}
        self._train_calls = {}

    @contextlib.contextmanager
    def patched(self, cli, run: str):
        import torch
        from torch.profiler import ProfilerActivity, profile

        from ssd_tensorflow_tpu_torch.ops import postprocess
        from ssd_tensorflow_tpu_torch.timing import device_kernels, per_call_ms

        keep = postprocess._keep
        make_train, make_eval = cli.make_train_step, cli.make_eval_step

        def record_keep(*args):
            out = keep(*args)
            self.keeps.append((run, args, out))
            return out

        def wrap(fn, kind):
            def call(*args):
                profiled = False
                if kind == "train":
                    if run not in [r for r, _ in self.first_states]:
                        self.first_states.append((run, args[0]))
                    i = self._train_calls.get(run, 0)
                    profiled = i in self.profile.get(run, ())
                    self._train_calls[run] = i + 1
                start = torch.cuda.Event(enable_timing=True)
                end = torch.cuda.Event(enable_timing=True)
                start.record()
                if profiled:
                    with profile(activities=[ProfilerActivity.CUDA]) as prof:
                        out = fn(*args)
                        torch.cuda.synchronize()
                    self.busy_ms.setdefault(run, []).append(per_call_ms(device_kernels(prof)))
                else:
                    out = fn(*args)
                end.record()
                self.calls.append({"run": run, "kind": kind, "start": start, "end": end,
                                   "losses": out[-2], "profiled": profiled})
                return out

            return call

        with mock.patch.object(cli, "make_train_step",
                               lambda *a, **k: wrap(make_train(*a, **k), "train")), \
                mock.patch.object(cli, "make_eval_step",
                                  lambda *a, **k: wrap(make_eval(*a, **k), "eval")), \
                mock.patch.object(postprocess, "_keep", record_keep):
            yield self


def _run_cli(cli, argv):
    """``cli.main(argv)`` with its standard output captured: ``(rc, output)``."""
    import io

    buf = io.StringIO()
    with contextlib.redirect_stdout(buf):
        rc = cli.main(argv)
    return rc, buf.getvalue()


def _cli_timing(probe, logs, runs, per_epoch: int, bare_step_ms: float):
    """The CLI's own images/s (``StepTimer``) for the epochs after the
    first, CUDA-event ms a step (the mean and the median of the start to
    start intervals of consecutive train calls within an epoch after the
    first, the profiled calls' intervals left out), each such call's own
    span, the profiled calls' device busy time, the idle share ``1 - busy
    / mean ms a step`` and the gap of the mean to the bare step."""
    import re

    import numpy as np

    rates = {int(e): float(r) for run in runs for e, r in re.findall(
        r"\[i\] Epoch (\d+) train throughput: ([0-9.]+) img/s", logs[run])}
    later = [c for c in probe.calls if c["kind"] == "train" and c["run"] in runs][per_epoch:]
    intervals = [a["start"].elapsed_time(b["start"]) for i, (a, b) in
                 enumerate(zip(later, later[1:])) if (i + 1) % per_epoch and not a["profiled"]]
    spans = [c["start"].elapsed_time(c["end"]) for c in later if not c["profiled"]]
    step_ms = float(np.mean(intervals))
    busy = [b for run in runs for b in probe.busy_ms.get(run, [])]
    busy_ms = float(np.mean(busy))
    return {"images_per_s_by_epoch": rates,
            "images_per_s": float(np.mean([rates[e] for e in rates if e > 1])),
            "step_interval_ms": intervals, "step_span_ms": spans, "ms_per_step": step_ms,
            "median_ms_per_step": float(np.median(intervals)),
            "busy_ms_per_step": busy, "idle_share": 1.0 - busy_ms / step_ms,
            "bare_step_ms": bare_step_ms, "host_cost_ms_per_step": step_ms - bare_step_ms}


def train_cli_path(seed: int, device, bare_step_ms: float):
    """Phase 13: the train CLI on the card (see the module doc)."""
    import os
    import tempfile

    import torch
    import torch.distributed as dist

    import ssd_tensorflow_tpu_torch.cli.train as cli
    from ssd_tensorflow_tpu_torch.models.ssd_vgg import init_params
    from ssd_tensorflow_tpu_torch.parallel import train_step
    from ssd_tensorflow_tpu_torch.utils.checkpoint import checkpoint_config, restore_checkpoint

    if not dist.is_initialized():
        raise AssertionError("phase 13 runs under phase 12's one-rank group")
    per_epoch = CLI_TRAIN // TRAIN_BATCH
    timed_per_epoch = CLI_TIMED_TRAIN // TRAIN_BATCH
    # profile train calls of the first epochs, which the timing leaves out
    probe = CliProbe({"a": {per_epoch - 1},
                      "c_defaults": {timed_per_epoch - 3, timed_per_epoch - 1}})
    out = {"phase": "train_cli", "preset": "vgg512", "batch": TRAIN_BATCH,
           "train_images": CLI_TRAIN, "valid_images": CLI_VALID, "dtype": "bfloat16",
           "dev_shm_free_gib": os.statvfs("/dev/shm").f_bavail * os.statvfs("/dev/shm").f_frsize
           / 2**30, "cpu_count": os.cpu_count()}
    with tempfile.TemporaryDirectory() as tmp:
        data = staged_dataset(Path(tmp) / "data", seed)
        timed = staged_dataset(Path(tmp) / "timed", seed + 1, n_train=CLI_TIMED_TRAIN)
        name, tb = str(Path(tmp) / "run_a"), str(Path(tmp) / "tb")
        common = ["--batch-size", str(TRAIN_BATCH), "--checkpoint-interval", "1",
                  "--tensorboard-dir", tb, "--device", device.type]
        stress = ["--name", name, "--data-dir", data, "--num-workers", "0", *common]
        threshold = train_config().detect.confidence_threshold
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        logs, launches = {}, {}
        for run, argv, thr in (
                ("a", stress + ["--epochs", "2"], threshold),
                ("a_resumed", stress + ["--epochs", "3", "--continue-training", "yes"], threshold),
                ("b_device_augment", stress + ["--epochs", "1", "--device-augment", "true",
                                               "--name", str(Path(tmp) / "run_b")], threshold),
                # the CLI's own threshold and input path: forked workers
                # (one a core) and the shared-memory transport
                ("c_defaults", ["--name", str(Path(tmp) / "run_c"), "--data-dir", timed,
                                "--epochs", "2", *common], None)):
            with probe.patched(cli, run), staged_cli(cli, thr):
                (rc, logs[run]), launches[run] = counted(lambda: _run_cli(cli, argv))
            if rc != 0:
                raise AssertionError(f"train CLI run {run} exited {rc}:\n{logs[run][-3000:]}")
        peak_mem_gib = torch.cuda.max_memory_allocated() / 2**30

        # the checkpoints, and the resumed run starting from e2 bit for bit
        template = train_step.make_train_state(init_params(train_config().model),
                                               train_config(), device="cpu")
        ckpts = {f: restore_checkpoint(str(Path(name) / f"{f}.ckpt.npz"), template)
                 for f in ("e1", "e2", "e3", "final")}
        if [ckpts[f].step for f in ("e1", "e2", "e3", "final")] != [per_epoch * e for e in
                                                                     (1, 2, 3, 3)]:
            raise AssertionError(f"checkpoint steps: {[c.step for c in ckpts.values()]}")
        if checkpoint_config(str(Path(name) / "final.ckpt.npz"))["epoch"] != 3:
            raise AssertionError("final.ckpt.npz is not stamped with epoch 3")
        resumed = dict(probe.first_states)["a_resumed"]
        e2 = ckpts["e2"]
        if not (resumed.step == e2.step and all(
                torch.equal(resumed.params[n][k].cpu(), e2.params[n][k]) and
                torch.equal(resumed.opt_state.trace[n][k].cpu(), e2.opt_state.trace[n][k])
                for n in e2.params for k in e2.params[n])):
            raise AssertionError("the resumed run did not start from e2.ckpt.npz bit for bit")
        del ckpts, template, resumed, e2

    # losses, NMS masks against the plain version, launches
    for c in probe.calls:
        if not all(torch.isfinite(v) for v in c["losses"].values()):
            raise AssertionError(f"{c['run']} {c['kind']}: losses not finite: {c['losses']}")
    kept = {}
    for run, args, keep in probe.keeps:
        kept.setdefault(run, []).append(
            # at the CLI's own 0.5 a fresh model may leave NMS no candidate
            check_keep({"keep": (args, keep)}, f"train CLI {run}",
                       require_kept=run != "c_defaults")["kept"])
    n_train = {r: sum(1 for c in probe.calls if c["run"] == r and c["kind"] == "train")
               for r in launches}
    n_eval = {r: sum(1 for c in probe.calls if c["run"] == r and c["kind"] == "eval")
              for r in launches}
    want_train = {"a": 2 * per_epoch, "a_resumed": per_epoch, "b_device_augment": per_epoch,
                  "c_defaults": 2 * timed_per_epoch}
    for run, n in launches.items():
        if (n_train[run] != want_train[run] or n["nms_keep"] != n_train[run] + n_eval[run]
                or n["fused_stem"] or n["fused_stem_uint8"] or n["int8_conv"]
                or n["int8_qconv"]):
            raise AssertionError(f"train CLI run {run}: {n_train[run]} train and {n_eval[run]} "
                                 f"eval steps, launches {n}")
    if len(probe.keeps) != sum(n["nms_keep"] for n in launches.values()):
        raise AssertionError("an NMS stage of the CLI's steps was not recorded")

    out.update({"runs": {r: {"rc": 0, "train_steps": n_train[r], "eval_steps": n_eval[r],
                             "launches": launches[r]} for r in launches},
                "checkpoints_restored": ["e1", "e2", "e3", "final"],
                "resumed_from_e2_bit_exact": True, "losses_finite": True,
                "nms_keeps_checked": len(probe.keeps), "nms_kept_per_call": kept,
                "keep_bit_exact": True,
                # the steps' detect at 0.01, where every image gives NMS its
                # 200 candidates and the AP accounting its most boxes: a
                # stress reading, not the CLI's own
                "timing_threshold_0.01": _cli_timing(probe, logs, ("a", "a_resumed"),
                                                     per_epoch, bare_step_ms),
                # the CLI as a user runs it: its 0.5 and its default workers
                "timing_cli_defaults": _cli_timing(probe, logs, ("c_defaults",),
                                                   timed_per_epoch, bare_step_ms),
                "peak_mem_gib": peak_mem_gib, "nms_launches": {r: n["nms_keep"] for r, n in
                                                               launches.items()}})
    _emit(out)
    total = {k: sum(n[k] for n in launches.values()) for k in next(iter(launches.values()))}
    return total


#: the serving phase's fixture: 8 miniVOC test images decoded and resized
#: on the CPU box, with the JAX package's results on them
SERVING_IMAGES = "tests/torch_fixtures/serving_images.npz"
#: the miniVOC split those images come from
MINIVOC_TEST = "tests/fixtures/minivoc/test/VOCdevkit/VOC2007"
#: how many of its test images (sorted by name) the serving phase runs
SERVING_COUNT = 8
#: the seed of the vgg512 parameters the serving phase exports (the
#: fixture holds the JAX package's calibration of them)
SERVING_SEED = 0


def serving_names(root: Path):
    """The serving fixture's image names: the first ``SERVING_COUNT`` miniVOC
    test JPEGs by name (the two of ``REAL_IMAGES`` first)."""
    jpegs = sorted((Path(root) / MINIVOC_TEST / "JPEGImages").glob("*.jpg"))
    return [p.stem for p in jpegs[:SERVING_COUNT]]


def staged_voc_dir(root: Path, dest: Path, names) -> str:
    """A Pascal VOC tree at ``dest`` whose test split (``load_test_data``
    reads VOC2012's) is the miniVOC images ``names``: their JPEG files and
    XML annotations copied from ``MINIVOC_TEST`` and a ``test.txt`` listing
    them. Returns the ``--data-dir``."""
    import shutil

    src = Path(root) / MINIVOC_TEST
    voc = Path(dest) / "test" / "VOCdevkit" / "VOC2012"
    for sub in ("Annotations", "JPEGImages", "ImageSets/Main"):
        (voc / sub).mkdir(parents=True, exist_ok=True)
    for n in names:
        shutil.copy(src / "Annotations" / f"{n}.xml", voc / "Annotations")
        shutil.copy(src / "JPEGImages" / f"{n}.jpg", voc / "JPEGImages")
    (voc / "ImageSets" / "Main" / "test.txt").write_text("".join(f"{n}\n" for n in names))
    return str(dest)


#: the serving CLIs' default batch (the JAX package's detect and infer)
SERVING_BATCH = 32
#: how many batches each CLI runs in the phase's timing
SERVING_TIMED = 3
#: the largest relative gap allowed between the card's int8 calibration of
#: the seeded vgg512 model on the staged images and the JAX package's CPU
#: calibration in the fixture: the H100 gave 1.8e-6 (classifier6), float32
#: sums in another order; the gate leaves ~50x that
SERVING_CALIBRATION_GAP = 1e-4


class StagedImageIO:
    """Stands in for ``ssd_tensorflow_tpu_torch/data/image_io.py`` in the
    serving phase. OpenCV builds differ between machines (a JPEG decode
    or a resize may give other pixels), and the card machine's may be
    missing, so the phase hands out the fixture's images, decoded and
    resized on the CPU box by the JAX package's ``preprocess_files``, the
    pixels the fixture's JAX results were taken on: ``imread`` of a fixture
    file gives an image of the file's own size filled with the file's index
    in the fixture, and ``resize`` of that image to the fixture's size gives
    the fixture's pixels (any other size raises).
    ``imwrite`` and ``draw_box`` record what they are given and draw or
    write nothing. ``tests/test_torch_serving_fixture.py`` holds the port's
    own ``image_io`` decode + resize to these pixels on the CPU."""

    def __init__(self, names, images, sizes):
        self.names = [str(n) for n in names]
        self.images, self.sizes = images, [(int(w), int(h)) for w, h in sizes]
        self.reads, self.writes, self.boxes = 0, [], 0

    def imread(self, path):
        import numpy as np

        name = Path(path).stem
        if name not in self.names:
            raise AssertionError(f"staged imread: {path} is not a fixture image")
        i = self.names.index(name)
        w, h = self.sizes[i]
        self.reads += 1
        return np.full((h, w, 3), i, np.uint8)

    def resize(self, img, size):
        staged = self.images[int(img[0, 0, 0])]
        if tuple(size) != (staged.shape[1], staged.shape[0]):
            raise AssertionError(f"staged resize to {size}: the fixture holds "
                                 f"{staged.shape[1]}x{staged.shape[0]}")
        return staged.copy()

    def imwrite(self, path, img):
        self.writes.append((str(path), tuple(img.shape)))
        return True

    def draw_box(self, img, box, color):
        self.boxes += 1

    @contextlib.contextmanager
    def patched(self):
        from ssd_tensorflow_tpu_torch.data import image_io

        with contextlib.ExitStack() as stack:
            for name in ("imread", "resize", "imwrite", "draw_box"):
                stack.enter_context(mock.patch.object(image_io, name, getattr(self, name)))
            yield self


class BatchClock:
    """Marks each batch of a serving CLI: a CUDA event and the host clock
    where ``InferenceModel.preprocess_files`` is called (a batch starts), and
    once more where the CLI returns."""

    def __init__(self):
        self.marks = []

    def mark(self):
        import torch

        event = torch.cuda.Event(enable_timing=True)
        event.record()
        self.marks.append((event, time.perf_counter()))

    @contextlib.contextmanager
    def patched(self):
        from ssd_tensorflow_tpu_torch.inference import InferenceModel

        preprocess = InferenceModel.preprocess_files

        def marked(model, files):
            self.mark()
            return preprocess(model, files)

        with mock.patch.object(InferenceModel, "preprocess_files", marked):
            yield self
        self.mark()

    def batch_ms(self):
        """CUDA-event ms of each batch, from its start to the next one's (or
        to the CLI's return)."""
        self.marks[-1][0].synchronize()
        return [a.elapsed_time(b) for (a, _), (b, _) in zip(self.marks, self.marks[1:])]


def _recording_ap(cli):
    """``cli.APCalculator`` patched to keep what ``compute_aps`` returns."""
    base = cli.APCalculator

    class Recording(base):
        last = None

        def compute_aps(self):
            Recording.last = super().compute_aps()
            return Recording.last

    return mock.patch.object(cli, "APCalculator", Recording), Recording


def _txt_rows(directory):
    """Every ``.txt`` dump line of a detect output, by image file."""
    return {p.name: p.read_text().splitlines() for p in sorted(Path(directory).glob("*.txt"))}


def _box_lines(rows):
    """detect's ``.txt`` lines of ``[(conf, Box)]``."""
    return [f"{b.label} {b.labelid} {b.center.x} {b.center.y} {b.size.w} {b.size.h}"
            for _, b in rows]


def _serving_timing(cli, argv, model, images, runs_bare, batches):
    """The CLI's batches as it runs them, ``batches`` of ``SERVING_BATCH``
    real files, with ``model`` already loaded (``from_bundle`` patched to
    hand it out): the CUDA-event ms of each batch (``BatchClock``), then,
    in a second run under ``torch.profiler``, the device's busy ms a batch
    (kernels and copies); the idle share ``1 - busy / mean ms``; the bare
    ``runs_bare`` (``run_scores`` for detect, ``run`` for infer with
    ``--dump-predictions``) of one batch on the card, and the gap to the
    mean, the CLI's host cost."""
    from torch.profiler import ProfilerActivity, profile

    import torch

    from ssd_tensorflow_tpu_torch.inference import InferenceModel
    from ssd_tensorflow_tpu_torch.timing import cuda_event_ms, device_kernels, per_call_ms

    with mock.patch.object(InferenceModel, "from_bundle", lambda *a, **k: model):
        clock = BatchClock()
        torch.cuda.synchronize()
        with clock.patched():
            rc, log = _run_cli(cli, argv)
        if rc != 0:
            raise AssertionError(f"{cli.__name__} exited {rc}:\n{log[-3000:]}")
        batch_ms = clock.batch_ms()
        if len(batch_ms) != batches:
            raise AssertionError(f"{cli.__name__} ran {len(batch_ms)} batches, not {batches}")
        torch.cuda.synchronize()
        with profile(activities=[ProfilerActivity.CUDA]) as prof:
            rc, _ = _run_cli(cli, argv)
            torch.cuda.synchronize()
        busy_ms = per_call_ms(device_kernels(prof, iters=batches))
    x = torch.from_numpy(images).to(model.device)
    with torch.inference_mode():
        bare_ms = cuda_event_ms(lambda: runs_bare(x), iters=5, warmup=1)
    mean_ms = sum(batch_ms) / len(batch_ms)
    return {"batch": int(images.shape[0]), "batches": batches, "batch_ms": batch_ms,
            "ms_per_batch": mean_ms, "images_per_s": images.shape[0] / mean_ms * 1e3,
            "busy_ms": busy_ms, "idle_share": 1.0 - busy_ms / mean_ms,
            "bare": runs_bare.__name__, "bare_ms": bare_ms, "host_cost_ms": mean_ms - bare_ms}


def serving_cli_path(root: Path, device):
    """Phase 14: the serving and evaluation CLIs on the card (see the
    module doc)."""
    import tempfile

    import torch

    import ssd_tensorflow_tpu_torch.cli.detect as detect_cli
    import ssd_tensorflow_tpu_torch.cli.export_model as export_cli
    import ssd_tensorflow_tpu_torch.cli.infer as infer_cli
    from ssd_tensorflow_tpu_torch.inference import (
        InferenceModel,
        load_bundle,
        model_config_to_dict,
    )
    from ssd_tensorflow_tpu_torch.models import ssd_vgg
    from ssd_tensorflow_tpu_torch.ops import stem_cuda
    from ssd_tensorflow_tpu_torch.parallel.train_step import TrainConfig, make_train_state
    from ssd_tensorflow_tpu_torch.utils.checkpoint import save_checkpoint

    import numpy as np

    t_phase = time.perf_counter()
    with np.load(root / SERVING_IMAGES) as data:
        fx = {k: data[k] for k in data.files}
    names = [str(n) for n in fx["names"]]
    if names != serving_names(root):
        raise AssertionError(f"the fixture's images {names} are not {serving_names(root)}")
    staged = StagedImageIO(names, fx["images"], fx["sizes"])
    fields = ("boxes", "scores", "classes", "valid")
    dev = ["--device", device.type]
    out = {"phase": "serving_cli", "host_io": "staged", "images": len(names),
           "bundle": INT8_BUNDLE}
    launches = {}
    torch.cuda.reset_peak_memory_stats()
    mem_at_start = torch.cuda.memory_allocated()
    with tempfile.TemporaryDirectory() as tmp, staged.patched():
        tmp = Path(tmp)
        data_dir = staged_voc_dir(root, tmp / "voc", names)
        files = [str(Path(data_dir) / "test" / "VOCdevkit" / "VOC2012" / "JPEGImages" /
                     f"{n}.jpg") for n in names]

        # (a) export: the float bundle and the program, then the calibrated int8 bundle
        t0 = time.perf_counter()
        cfg = ssd_vgg.ModelConfig(preset_name="vgg512", num_classes=20)
        params = ssd_vgg.init_params(cfg, seed=SERVING_SEED)
        voc = {i: n for i, n in enumerate(
            ("aeroplane", "bicycle", "bird", "boat", "bottle", "bus", "car", "cat", "chair",
             "cow", "diningtable", "dog", "horse", "motorbike", "person", "pottedplant",
             "sheep", "sofa", "train", "tvmonitor"))}
        ckpt = str(tmp / "run" / "e1.ckpt.npz")
        (tmp / "run").mkdir()
        save_checkpoint(ckpt, make_train_state(params, TrainConfig(model=cfg), device="cpu"),
                        {"model": model_config_to_dict(cfg), "epoch": 1,
                         "lid2name": {str(k): v for k, v in voc.items()}})
        float_bundle, program_path = str(tmp / "float.npz"), str(tmp / "model.pt2")
        (rc, log), launches["export"] = counted(lambda: _run_cli(export_cli, [
            "--checkpoint-file", ckpt, "--output-file", float_bundle, "--torch-export",
            program_path, "--torch-export-batch-size", "2", *dev]))
        if rc != 0:
            raise AssertionError(f"export_model exited {rc}:\n{log[-3000:]}")
        export_s = time.perf_counter() - t0
        loaded, cfg_b, lid2name, scales = load_bundle(float_bundle)
        if scales is not None or cfg_b != cfg or lid2name != voc or not all(
                torch.equal(loaded[n][k], params[n][k]) for n in params for k in params[n]):
            raise AssertionError("the float bundle is not the checkpoint's parameters")
        int8_bundle = str(tmp / "int8.npz")
        t0 = time.perf_counter()
        (rc, log), launches["export_quantize"] = counted(lambda: _run_cli(export_cli, [
            "--checkpoint-file", ckpt, "--output-file", int8_bundle, "--quantize",
            "--calibration-images", *files, *dev]))
        if rc != 0:
            raise AssertionError(f"export_model --quantize exited {rc}:\n{log[-3000:]}")
        quantize_s = time.perf_counter() - t0
        _, _, _, card_scales = load_bundle(int8_bundle)
        jax_scales = dict(zip((str(n) for n in fx["calibration_names"]),
                              fx["calibration_scales"]))
        if sorted(card_scales) != sorted(jax_scales):
            raise AssertionError("the int8 bundle's scales name other layers than JAX's")
        gaps = {k: abs(card_scales[k] - jax_scales[k]) / jax_scales[k] for k in jax_scales}
        worst = max(gaps, key=gaps.get)
        out["export"] = {"seconds": export_s, "quantize_seconds": quantize_s,
                         "calibration_gap_max": gaps[worst], "calibration_gap_layer": worst,
                         "calibration_gap_gate": SERVING_CALIBRATION_GAP}
        if gaps[worst] > SERVING_CALIBRATION_GAP:
            raise AssertionError(f"int8 calibration {worst}: {card_scales[worst]} against "
                                 f"JAX's {jax_scales[worst]} ({gaps[worst]:.3g} relative)")

        # the exported program on the card against the eager forward
        t0 = time.perf_counter()
        program = torch.export.load(program_path)
        held = sorted({str(n.target) for n in program.graph.nodes if "ssd_torch" in str(n.target)})
        if held != ["ssd_torch.fused_stem.default"]:
            raise AssertionError(f"the exported program holds {held}, not the stem operator")
        program = program.module()
        eager = InferenceModel(params, cfg, device=device)
        x2 = torch.from_numpy(fx["images"][:2]).to(device)
        with torch.inference_mode():
            got, launches["exported_program"] = counted(lambda: program(x2))
            want = ssd_vgg.apply_result(eager.params, x2, eager.config)
        if not torch.equal(got, want):
            raise AssertionError(f"the exported program differs from the eager forward by "
                                 f"{float((got - want).abs().max())}")
        if launches["exported_program"]["fused_stem"] != 1:
            raise AssertionError(f"exported program launches: {launches['exported_program']}")
        out["torch_export"] = {"batch": 2, "bit_exact": True, "operators": held,
                               "load_and_check_seconds": time.perf_counter() - t0}
        del program, eager, got, want

        # (b) detect: the shipped int8 bundle at the CLI's batch, 8 files padded
        bundle = str(root / INT8_BUNDLE)
        model = InferenceModel.from_bundle(bundle, device=device)
        n_convs = len(model.act_scales)
        (rc, log), launches["detect"] = counted(lambda: _run_cli(detect_cli, [
            *files, "--model", bundle, "--output-dir", str(tmp / "detect"), "--threshold",
            "0.01", *dev]))
        if rc != 0:
            raise AssertionError(f"detect exited {rc}:\n{log[-3000:]}")
        n = launches["detect"]
        if (n["nms_keep"] != 1 or n["int8_qconv"] != n_convs or n["int8_conv"]
                or n["fused_stem"] or n["fused_stem_uint8"]):
            raise AssertionError(f"detect launches {n}")
        padded = np.concatenate([fx["images"], np.repeat(fx["images"][-1:],
                                                        SERVING_BATCH - len(names), 0)])
        model.detection = type(model.detection)(top_k=200, confidence_threshold=0.01)
        dets = model.run_scores(padded)
        rows = model.detect_boxes(padded)
        dumps = _txt_rows(tmp / "detect")
        for i, name in enumerate(names):
            if dumps[f"{name}.jpg.txt"] != _box_lines(rows[i]):
                raise AssertionError(f"detect's dump of {name} is not detect_boxes' rows")
        card = {f: getattr(dets, f)[: len(names)].cpu().numpy() for f in fields}
        jax_dets = {f: fx[f"detect_{f}"] for f in fields}
        if card["valid"].sum(1).tolist() != jax_dets["valid"].sum(1).tolist():
            raise AssertionError(f"detect counts {card['valid'].sum(1)} against JAX's "
                                 f"{jax_dets['valid'].sum(1)}")
        out["detect"] = {"detections_per_image": card["valid"].sum(1).tolist(),
                         "against_jax": match_detections(card, jax_dets, 0.99, 1e-4),
                         "annotated_written": len([w for w in staged.writes
                                                   if "/detect/" in w[0]]),
                         "launches": n}
        if out["detect"]["annotated_written"] != len(names):
            raise AssertionError("detect did not write an annotated image a file")

        # (c) infer: the int8 bundle on the staged VOC test split
        common = ["--data-source", "pascal_voc", "--data-dir", data_dir, "--dump-predictions",
                  "yes", "--pascal-summary", "yes", "--coco-results", "yes", "--threshold",
                  "0.01", "--training-data", str(tmp / "none.json"), *dev]
        patch_ap, recording = _recording_ap(infer_cli)
        with patch_ap:
            (rc, log), launches["infer"] = counted(lambda: _run_cli(infer_cli, [
                "--bundle", bundle, "--output-dir", str(tmp / "infer"), *common]))
        if rc != 0:
            raise AssertionError(f"infer exited {rc}:\n{log[-3000:]}")
        n = launches["infer"]
        if (n["nms_keep"] != 1 or n["int8_qconv"] != n_convs or n["int8_conv"]
                or n["fused_stem"] or n["fused_stem_uint8"]):
            raise AssertionError(f"infer launches {n}")
        aps = recording.last
        jax_aps = dict(zip((str(k) for k in fx["ap_names"]), fx["ap_values"]))
        if sorted(aps) != sorted(jax_aps):
            raise AssertionError(f"infer's classes {sorted(aps)} against JAX's {sorted(jax_aps)}")
        ap_gap = max(abs(aps[k] - jax_aps[k]) for k in jax_aps)
        map_gap = abs(sum(aps.values()) / len(aps) - sum(jax_aps.values()) / len(jax_aps))
        if ap_gap > 1e-4 or map_gap > 1e-4:
            raise AssertionError(f"infer's AP {aps} against JAX's {jax_aps}")
        k_plus_5 = model.config.num_vars
        for name in names:
            dump = np.load(tmp / "infer" / f"{name}.jpg.npy")
            if dump.shape != (model.preset.num_anchors, k_plus_5) or not np.isfinite(dump).all():
                raise AssertionError(f"infer's dump of {name}: {dump.shape}, finite "
                                     f"{bool(np.isfinite(dump).all())}")
        summaries = sorted(p.name for p in (tmp / "infer").glob("comp4_det_test_*.txt"))
        coco = json.loads((tmp / "infer" / "coco_results.json").read_text())
        # the VOC source maps no label to a COCO category id: the writer
        # skips every detection and says so, as the JAX package's does
        if coco != [] or "skipped labels with no category id" not in log:
            raise AssertionError(f"infer's COCO results with the VOC source: {coco[:3]}")
        out["infer"] = {"mAP": sum(aps.values()) / len(aps), "ap_gap_max": ap_gap,
                        "map_gap": map_gap, "dumps": len(names),
                        "dump_shape": [model.preset.num_anchors, k_plus_5],
                        "pascal_summary_files": len(summaries), "coco_results": len(coco),
                        "launches": n}
        if not summaries:
            raise AssertionError("infer wrote no Pascal summary")

        # infer once more with the exported float bf16 bundle, and its plain stem
        with _recording_ap(infer_cli)[0]:
            (rc, log), launches["infer_float"] = counted(lambda: _run_cli(infer_cli, [
                "--bundle", float_bundle, "--output-dir", str(tmp / "float"), *common]))
        if rc != 0:
            raise AssertionError(f"infer of the float bundle exited {rc}:\n{log[-3000:]}")
        n = launches["infer_float"]
        if (n["nms_keep"] != 1 or n["fused_stem"] != 1 or n["int8_conv"] or n["int8_qconv"]
                or n["fused_stem_uint8"]):
            raise AssertionError(f"infer of the float bundle launches {n}")
        with mock.patch.object(stem_cuda, "fused_stem", stem_cuda.fused_stem_plain), \
                _recording_ap(infer_cli)[0]:
            rc, log = _run_cli(infer_cli, ["--bundle", float_bundle, "--output-dir",
                                           str(tmp / "float_plain"), *common])
        if rc != 0:
            raise AssertionError(f"infer with the plain stem exited {rc}:\n{log[-3000:]}")
        gaps = {"conf_max_abs": 0.0, "cls_share": 1.0, "locs_max_abs": 0.0}
        k1 = cfg.num_classes + 1
        for name in names:
            a = np.load(tmp / "float" / f"{name}.jpg.npy")
            b = np.load(tmp / "float_plain" / f"{name}.jpg.npy")
            gaps["conf_max_abs"] = max(gaps["conf_max_abs"], float(np.abs(a[:, :k1] - b[:, :k1]).max()))
            gaps["cls_share"] = min(gaps["cls_share"], float(np.mean(
                a[:, :k1].argmax(-1) == b[:, :k1].argmax(-1))))
            gaps["locs_max_abs"] = max(gaps["locs_max_abs"], float(np.abs(a[:, k1:] - b[:, k1:]).max()))
        if not (gaps["conf_max_abs"] < 0.02 and gaps["cls_share"] >= 0.99
                and gaps["locs_max_abs"] < 0.05):
            raise AssertionError(f"the float bundle's stem kernel and plain stem disagree: {gaps}")
        out["infer_float"] = {"launches": n, "plain_stem_agreement": gaps}

        # (d) time: each CLI on SERVING_TIMED batches of SERVING_BATCH real files,
        # the model loaded
        per_batch = SERVING_BATCH // len(files)
        many = files * (per_batch * SERVING_TIMED)
        images = np.concatenate([fx["images"]] * per_batch)
        model.detection = type(model.detection)(top_k=200, confidence_threshold=0.5)
        out["detect"]["timing"] = _serving_timing(
            detect_cli, [*many, "--model", bundle, "--output-dir", str(tmp / "t_detect"), *dev],
            model, images, model.run_scores, SERVING_TIMED)
        model.detection = type(model.detection)(top_k=200, confidence_threshold=0.01)
        out["infer"]["timing"] = _serving_timing(
            infer_cli, [*many, "--bundle", bundle, "--output-dir", str(tmp / "t_infer"),
                        "--dump-predictions", "yes", "--pascal-summary", "yes",
                        "--coco-results", "yes", "--threshold", "0.01", *dev],
            model, images, model.run, SERVING_TIMED)
    out.update({"staged_reads": staged.reads, "staged_writes": len(staged.writes),
                "staged_boxes_drawn": staged.boxes,
                "peak_mem_gib": torch.cuda.max_memory_allocated() / 2**30,
                "held_at_start_gib": mem_at_start / 2**30,
                "peak_over_start_gib": (torch.cuda.max_memory_allocated() - mem_at_start) / 2**30,
                "seconds": time.perf_counter() - t_phase})
    _emit(out)
    return launches


# ---------------------------------------------------------------------------
# 15. multichip: data-parallel serving, tensor parallelism and the dry run
# ---------------------------------------------------------------------------

#: processes of the phase's gloo runs, all on the one card
MULTI_PROCS = 4
#: the serving batch of (a) and (b): 16 rows a process in (b)
MULTI_BATCH = 64
#: batches each process times in (b)
MULTI_TIMED = 5
#: (b)'s hold where the 16-row batches' detections are not the 64-row
#: batch's bit for bit (other cuBLAS / cuDNN algorithms): phase 14's match
MULTI_MATCH_IOU, MULTI_MATCH_CONF = 0.999, 1e-4
#: (c)'s float32 step on data 2 x model 2 against one process that sums
#: conv7 in the same two halves (``conv7_in_two_halves``): each loss, and
#: each leaf's update, relative to the leaf's largest
TP_LOSS, TP_UPDATE = 1e-5, 1e-4
#: the same against the plain one-process step: the losses and every leaf
#: but conv7's at ``TP_LOSS`` / ``TP_UPDATE``. conv7's two float32 partial
#: sums round apart from one sum, a pre-activation within that rounding of
#: zero takes the other side of the ReLU, and each such flip moves conv7's
#: weight and bias gradients by one position's term. On the H100 at vgg512
#: b8: 2 flips, conv7's momentum 2.9e-4 and its bias update 2.5e-4 of
#: their largest, equal to the gaps of one process summing conv7 in two
#: halves; the next leaf, conv5_1, 5.1e-5. So conv7's weight and
#: bias, and their momentum, are held to ``TP_PLAIN_CONV7``, and the flips
#: the halves reference counts to ``TP_MAX_FLIPS`` (``TP_PLAIN_CONV7`` over
#: the ~1.45e-4 that one flip was found to move them)
TP_PLAIN_CONV7 = 1e-3
TP_MAX_FLIPS = 6
TP_FLOAT_BATCH, TP_BF16_BATCH = 8, 32


@contextlib.contextmanager
def conv7_in_two_halves(flips: list):
    """Within the block, the training forward's conv7 sums its 1024 input
    channels as two float32 partial sums of 512 added together, as conv7
    split over a ``model`` group of two does; each call appends to
    ``flips`` how many pre-activations take the other side of zero than
    the whole conv's."""
    import torch

    from ssd_tensorflow_tpu_torch.models import layers

    whole_conv = layers.conv_relu_train

    def conv(params, x, stride=1, padding="SAME", dilation=1):
        w = params["w"]
        if tuple(w.shape) != (1024, 1024, 1, 1):
            return whole_conv(params, x, stride, padding, dilation)
        half = w.shape[1] // 2
        pre = (layers.conv2d(x[..., :half], w[:, :half])
               + layers.conv2d(x[..., half:], w[:, half:])) + params["b"]
        with torch.no_grad():
            whole = layers.conv2d(x, w) + params["b"]
            flips.append(int(((pre > 0) != (whole > 0)).sum()))
        return torch.relu(pre)

    with mock.patch.object(layers, "conv_relu_train", conv):
        yield


def _unlaunched_env() -> dict:
    """This process's environment without the one-rank launch of phase 12."""
    import os

    return {k: v for k, v in os.environ.items()
            if k not in ("RANK", "WORLD_SIZE", "LOCAL_RANK", "MASTER_ADDR", "MASTER_PORT")}


def launch_workers(mode: str, payload: dict, n: int, timeout: float):
    """``n`` processes of this script in worker ``mode`` on the card
    (``parallel/mesh.spawn``, a ``torchrun`` launch's environment; every
    ``LOCAL_RANK`` is the one card), in a gloo group over CUDA tensors;
    each writes ``<out>.rank<r>.json``. Returns the reports; raises (after
    stopping every process) when one fails or the time runs out."""
    import os

    from ssd_tensorflow_tpu_torch.parallel.mesh import spawn

    env = dict(os.environ, OMP_NUM_THREADS=str(max(1, (os.cpu_count() or 1) // n)))
    spawn(n, [sys.executable, str(Path(__file__).resolve()), "--worker", mode,
              json.dumps(payload)], timeout, env=env, capture=True)
    return [json.loads(Path(f"{payload['out']}.rank{r}.json").read_text()) for r in range(n)]


def _sum_launches(reports, key):
    total = {}
    for rep in reports:
        for k, v in rep[key].items():
            total[k] = total.get(k, 0) + v
    return total


def serve_worker(payload, rank: int):
    """(b), one process: the int8 bundle served over a data mesh of every
    process at batch ``MULTI_BATCH`` (its 16 rows), counted once, then
    timed over ``MULTI_TIMED`` batches."""
    import numpy as np
    import torch

    from ssd_tensorflow_tpu_torch.inference import InferenceModel
    from ssd_tensorflow_tpu_torch.parallel.mesh import make_mesh

    mesh = make_mesh(device="cuda")
    model = InferenceModel.from_bundle(payload["bundle"], device="cuda", mesh=mesh)
    with np.load(payload["images"]) as f:
        images = f["images"]
    model.run_scores(images)  # warm-up
    torch.cuda.reset_peak_memory_stats()
    dets, launches = counted(lambda: model.run_scores(images))
    if rank == 0:
        np.savez(f"{payload['out']}.dets.npz",
                 **{f: getattr(dets, f).cpu().numpy() for f in ("boxes", "scores", "classes",
                                                               "valid")})
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    start.record()
    for _ in range(MULTI_TIMED):
        model.run_scores(images)
    end.record()
    torch.cuda.synchronize()
    return {"launches": launches, "rows": int(images.shape[0]) // mesh.shape["data"],
            "ms_per_batch": start.elapsed_time(end) / MULTI_TIMED,
            "wall_s": time.perf_counter() - t0,
            "peak_mem_gib": torch.cuda.max_memory_allocated() / 2**30}


def tp_worker(payload, rank: int):
    """(c), one process of data 2 x model 2: the float32 step from the
    common state (TF32 off, ``cudnn.deterministic``), its gathered
    checkpoint written by rank 0; then bf16 steps at b32, timed."""
    import numpy as np
    import torch

    from ssd_tensorflow_tpu_torch.models.ssd_vgg import init_params
    from ssd_tensorflow_tpu_torch.ops.anchors import anchors_for_preset
    from ssd_tensorflow_tpu_torch.parallel.mesh import make_mesh
    from ssd_tensorflow_tpu_torch.parallel import train_step
    from ssd_tensorflow_tpu_torch.utils.checkpoint import restore_checkpoint, save_checkpoint

    mesh = make_mesh(model=2, device="cuda")
    cfg16 = train_config()
    cfg32 = dataclasses.replace(cfg16, model=dataclasses.replace(cfg16.model,
                                                                 compute_dtype="float32"))
    anchors = anchors_for_preset(cfg32.model.preset)
    template = train_step.make_train_state(init_params(cfg32.model), cfg32, device="cuda")
    state = train_step.shard_state(restore_checkpoint(payload["state"], template), mesh,
                                   tensor_parallel=True)
    del template
    shapes = {f"{n}/{k}": list(state.params[n][k].shape)
              for n in ("mod_conv6", "mod_conv7") for k in ("w", "b")}
    with np.load(payload["batch"]) as f:
        batch = train_step.shard_batch({k: f[k] for k in f.files}, mesh)
    step32 = train_step.make_train_step(cfg32, anchors)
    torch.backends.cudnn.deterministic = True
    (new, losses, _), launches = counted(lambda: step32(state, batch))
    torch.backends.cudnn.deterministic = False
    save_checkpoint(payload["checkpoint"], new)
    del state, new, batch

    size = cfg16.model.preset.image_size.h
    data = train_batch(np.random.default_rng(payload["seed"]), TP_BF16_BATCH, size,
                       cfg16.model.num_classes)
    state = train_step.shard_state(
        train_step.make_train_state(init_params(cfg16.model, payload["seed"]), cfg16,
                                    device="cuda"), mesh, tensor_parallel=True)
    batch = train_step.shard_batch(data, mesh)
    step16 = train_step.make_train_step(cfg16, anchors)
    for _ in range(2):
        state, l16, _ = step16(state, batch)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    timed = 3
    start.record()
    for _ in range(timed):
        state, l16, _ = step16(state, batch)
    end.record()
    torch.cuda.synchronize()
    bf16 = {k: float(v) for k, v in l16.items()}
    if not all(np.isfinite(v) for v in bf16.values()):
        raise AssertionError(f"non-finite bf16 tensor-parallel losses {bf16}")
    return {"losses": {k: float(v) for k, v in losses.items()}, "launches": launches,
            "shapes": shapes, "bf16_losses": bf16, "bf16_ms_per_step": start.elapsed_time(end)
            / timed, "bf16_peak_mem_gib": torch.cuda.max_memory_allocated() / 2**30}


def run_worker(mode: str, payload: dict) -> int:
    """The body of one worker process (``--worker``): join the gloo group
    the parent's environment names, on the card, run ``mode``, write its
    report."""
    import os

    import torch
    import torch.distributed as dist

    sys.path.insert(0, str(Path(__file__).resolve().parent))
    from ssd_tensorflow_tpu_torch.parallel.mesh import local_device

    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    rank = int(os.environ["RANK"])
    local_device("cuda")
    dist.init_process_group("gloo", rank=rank, world_size=int(os.environ["WORLD_SIZE"]))
    try:
        report = {"serve": serve_worker, "tp": tp_worker}[mode](payload, rank)
        Path(f"{payload['out']}.rank{rank}.json").write_text(json.dumps(report))
    finally:
        dist.destroy_process_group()
    return 0


def multichip_path(root: Path, seed: int, device, bare_step_ms: float):
    """Phase 15: data-parallel serving under the one-rank NCCL group (a)
    and over four gloo processes on the card (b), tensor parallelism of
    conv6 / conv7 on data 2 x model 2 (c), and ``dryrun_multichip(4)`` on
    the card (d) (see the module doc)."""
    import tempfile

    import numpy as np
    import torch
    import torch.distributed as dist

    import ssd_tensorflow_tpu_torch.cli.detect as detect_cli
    from ssd_tensorflow_tpu_torch.inference import InferenceModel
    from ssd_tensorflow_tpu_torch.models import ssd_vgg
    from ssd_tensorflow_tpu_torch.ops.anchors import anchors_for_preset
    from ssd_tensorflow_tpu_torch.parallel import train_step
    from ssd_tensorflow_tpu_torch.parallel.mesh import make_mesh
    from ssd_tensorflow_tpu_torch.utils.checkpoint import restore_checkpoint, save_checkpoint

    t_phase = time.perf_counter()
    fields = ("boxes", "scores", "classes", "valid")
    bundle = str(root / INT8_BUNDLE)
    out = {"phase": "multichip", "processes": MULTI_PROCS}
    launches = {}
    rng = np.random.default_rng(seed + 15)
    images = rng.integers(0, 256, (MULTI_BATCH, 512, 512, 3), dtype=np.uint8)

    # (a) the one-rank NCCL group of phase 12: a mesh of one, bit for bit
    mesh = make_mesh(device="cuda")
    if mesh is None or dist.get_backend() != "nccl" or mesh.shape != {"data": 1, "model": 1}:
        raise AssertionError(f"phase 15 expects phase 12's one-rank NCCL group, got {mesh}")
    cfg = ssd_vgg.ModelConfig(preset_name="vgg512", num_classes=20, compute_dtype="bfloat16")
    params = ssd_vgg.init_params(cfg, seed=seed)
    x = torch.from_numpy(images).to(device)
    one_int8 = None
    for name, build in (("int8", lambda m: InferenceModel.from_bundle(bundle, device=device,
                                                                      mesh=m)),
                        ("bf16", lambda m: InferenceModel(params, cfg, device=device, mesh=m))):
        plain, meshed = build(None), build(mesh)
        want = plain.run_scores(x)
        got, n = counted(lambda: meshed.run_scores(x))
        differ = [f for f in fields if not torch.equal(getattr(got, f), getattr(want, f))]
        if differ:
            raise AssertionError(f"{name}: the mesh of one differs from mesh=None in {differ}")
        convs = len(plain.act_scales) if name == "int8" else 0
        if (n["nms_keep"] != 1 or n["int8_qconv"] != convs or n["int8_conv"]
                or n["fused_stem"] != (name == "bf16") or n["fused_stem_uint8"]):
            raise AssertionError(f"{name} served on the mesh of one launched {n}")
        launches[f"mesh1_{name}"] = n
        if name == "int8":
            one_int8 = {f: getattr(want, f).cpu().numpy() for f in fields}
            n_convs = convs
        del plain, meshed, want, got
    del x
    with np.load(root / SERVING_IMAGES) as data:
        fx = {k: data[k] for k in data.files}
    names = [str(n) for n in fx["names"]]
    staged = StagedImageIO(names, fx["images"], fx["sizes"])
    files = [str(root / MINIVOC_TEST / "JPEGImages" / f"{n}.jpg") for n in names]
    with tempfile.TemporaryDirectory() as tmp, staged.patched():
        tmp = Path(tmp)
        dumps = []
        for dp in (0, 1):
            (rc, log), n = counted(lambda: _run_cli(detect_cli, [
                *files, "--model", bundle, "--output-dir", str(tmp / f"dp{dp}"), "--threshold",
                "0.01", "--data-parallel", str(dp), "--device", device.type]))
            if rc != 0:
                raise AssertionError(f"detect --data-parallel {dp} exited {rc}:\n{log[-3000:]}")
            dumps.append(_txt_rows(tmp / f"dp{dp}"))
        if dumps[0] != dumps[1] or len(dumps[0]) != len(names):
            raise AssertionError("detect --data-parallel 1 wrote other files than 0")
        if n["nms_keep"] != 1 or n["int8_qconv"] != n_convs or n["int8_conv"]:
            raise AssertionError(f"detect --data-parallel 1 launched {n}")
        launches["detect_dp1"] = n
    out["a_mesh_of_one"] = {"backend": "nccl", "int8_bit_exact": True, "bf16_bit_exact": True,
                            "detect_dp1_files_equal": True,
                            "launches": {k: launches[k] for k in ("mesh1_int8", "mesh1_bf16",
                                                                  "detect_dp1")}}

    torch.cuda.empty_cache()
    with tempfile.TemporaryDirectory() as tmp:
        tmp = Path(tmp)
        # (b) four processes serving the int8 bundle on the card under gloo
        np.savez(tmp / "images.npz", images=images)
        t0 = time.perf_counter()
        reports = launch_workers("serve", {"bundle": bundle, "images": str(tmp / "images.npz"),
                                           "out": str(tmp / "serve")}, MULTI_PROCS, 600)
        serve_s = time.perf_counter() - t0
        for r, rep in enumerate(reports):
            n = rep["launches"]
            if n["nms_keep"] != 1 or n["int8_qconv"] != n_convs or n["int8_conv"]:
                raise AssertionError(f"serving process {r} launched {n}")
        with np.load(tmp / "serve.dets.npz") as f:
            got = {k: f[k] for k in fields}
        exact = all(np.array_equal(got[k], one_int8[k]) for k in fields)
        serving = {"rows_per_process": reports[0]["rows"], "bit_exact_to_one_process": exact,
                   "ms_per_batch_per_process": [rep["ms_per_batch"] for rep in reports],
                   "images_per_s_four_processes_sharing_one_card":
                       MULTI_BATCH * MULTI_TIMED / max(rep["wall_s"] for rep in reports),
                   "peak_mem_gib_per_process": [rep["peak_mem_gib"] for rep in reports],
                   "launches_per_process": [rep["launches"] for rep in reports],
                   "seconds": serve_s}
        if not exact:
            if got["valid"].sum(1).tolist() != one_int8["valid"].sum(1).tolist():
                raise AssertionError("gloo serving: detection counts differ from one process")
            serving["against_one_process"] = match_detections(got, one_int8, MULTI_MATCH_IOU,
                                                              MULTI_MATCH_CONF)
        out["b_gloo_serving"] = serving
        launches["gloo4_serve"] = _sum_launches(reports, "launches")

        # (c) tensor parallelism: float32 b8 against one process, bf16 b32 timed
        cfg16 = train_config()
        cfg32 = dataclasses.replace(cfg16, model=dataclasses.replace(cfg16.model,
                                                                     compute_dtype="float32"))
        anchors = anchors_for_preset(cfg32.model.preset)
        host = ssd_vgg.init_params(cfg32.model, seed)
        state = train_step.make_train_state(host, cfg32, device=device)
        save_checkpoint(str(tmp / "state.ckpt.npz"), state)
        data = train_batch(np.random.default_rng(seed + 16), TP_FLOAT_BATCH, 512,
                           cfg32.model.num_classes)
        np.savez(tmp / "batch.npz", **data)
        saved = torch.backends.cudnn.deterministic
        torch.backends.cudnn.deterministic = True
        step32, flips = train_step.make_train_step(cfg32, anchors), []
        try:
            refs = {"plain": step32(state, data)}
            with conv7_in_two_halves(flips):
                refs["halves"] = step32(state, data)
        finally:
            torch.backends.cudnn.deterministic = saved
        refs = {k: (v[0].params, v[0].opt_state.trace, {n: float(x) for n, x in v[1].items()})
                for k, v in refs.items()}
        del state
        torch.cuda.empty_cache()
        t0 = time.perf_counter()
        reports = launch_workers("tp", {"state": str(tmp / "state.ckpt.npz"),
                                        "batch": str(tmp / "batch.npz"), "seed": seed,
                                        "checkpoint": str(tmp / "tp.ckpt.npz"),
                                        "out": str(tmp / "tp")}, MULTI_PROCS, 900)
        tp_s = time.perf_counter() - t0
        if any(rep["losses"] != reports[0]["losses"] for rep in reports):
            raise AssertionError("the tensor-parallel processes disagree on the losses")
        want_shapes = {"mod_conv6/w": [512, 512, 3, 3], "mod_conv6/b": [512],
                       "mod_conv7/w": [1024, 512, 1, 1], "mod_conv7/b": [1024]}
        if any(rep["shapes"] != want_shapes for rep in reports):
            raise AssertionError(f"shard shapes {[rep['shapes'] for rep in reports]}")
        for r, rep in enumerate(reports):
            if rep["launches"]["nms_keep"] != 1:
                raise AssertionError(f"tensor-parallel process {r} launched {rep['launches']}")
        template = train_step.make_train_state(host, cfg32, device="cpu")
        gathered = restore_checkpoint(str(tmp / "tp.ckpt.npz"), template)
        zeros = {n: {k: torch.zeros_like(v) for k, v in d.items()} for n, d in host.items()}
        if not sum(flips) <= TP_MAX_FLIPS:
            raise AssertionError(f"conv7 in two halves flips {flips} ReLUs, over {TP_MAX_FLIPS}")
        against = {}
        for name in ("halves", "plain"):
            params, trace, losses = refs[name]
            loss_rel = {k: abs(reports[0]["losses"][k] - v) / abs(v) for k, v in losses.items()}
            if not max(loss_rel.values()) <= TP_LOSS:
                raise AssertionError(f"tensor-parallel losses off the {name} step: {loss_rel}")
            # against the plain step, conv7 apart at its own bound
            conv7 = name == "plain"
            parts = {"": ([n for n in host if not (conv7 and n == "mod_conv7")], TP_UPDATE)}
            if conv7:
                parts["_mod_conv7"] = (["mod_conv7"], TP_PLAIN_CONV7)
            against[name] = {"loss_rel_err": loss_rel}
            for key, (layers, tol) in parts.items():
                old = {n: host[n] for n in layers}
                against[name]["param_update_rel_err_max" + key] = _updates_within(
                    gathered.params, params, old, tol)
                against[name]["momentum_rel_err_max" + key] = _updates_within(
                    gathered.opt_state.trace, trace, {n: zeros[n] for n in layers}, tol)
        out["c_tensor_parallel"] = {
            "mesh": {"data": 2, "model": 2}, "float32_batch": TP_FLOAT_BATCH,
            "against_one_process_conv7_in_halves": against["halves"],
            "against_one_process": against["plain"], "conv7_relu_flips": flips,
            "shard_shapes": reports[0]["shapes"],
            "bf16_batch": TP_BF16_BATCH,
            "bf16_ms_per_step_per_process": [rep["bf16_ms_per_step"] for rep in reports],
            "one_process_bf16_ms_per_step_phase6": bare_step_ms,
            "bf16_losses": reports[0]["bf16_losses"],
            "bf16_peak_mem_gib_per_process": [rep["bf16_peak_mem_gib"] for rep in reports],
            "seconds": tp_s}
        launches["tp_step"] = _sum_launches(reports, "launches")
        del refs, gathered, template

    # (d) the one-device entry, then the dry run hosting its four processes
    from ssd_tensorflow_tpu_torch import multichip
    from ssd_tensorflow_tpu_torch.presets import get_preset_by_name

    fn, args = multichip.entry()
    result, n = counted(lambda: fn(*args))
    result = result.float()
    anchors300 = anchors_for_preset(get_preset_by_name("vgg300")).shape[0]
    probs = result[..., :21].sum(-1)
    if (tuple(result.shape) != (8, anchors300, 25) or not bool(torch.isfinite(result).all())
            or float((probs - 1).abs().max()) > 1e-2 or n["fused_stem"] != 1):
        raise AssertionError(f"multichip.entry(): shape {tuple(result.shape)}, launches {n}, "
                             f"probability sums off by {float((probs - 1).abs().max())}")
    launches["entry"] = n
    out["d_entry"] = {"shape": list(result.shape), "launches": n}
    del fn, args, result, probs
    t0 = time.perf_counter()
    proc = subprocess.run(
        [sys.executable, "-c", "from ssd_tensorflow_tpu_torch import multichip; "
         f"multichip.dryrun_multichip({MULTI_PROCS})"],
        cwd=str(root), env=_unlaunched_env(), capture_output=True, text=True, timeout=900)
    ok = [ln for ln in proc.stdout.splitlines() if "dryrun_multichip ok" in ln]
    if proc.returncode != 0 or not ok or "mesh={'data': 2, 'model': 2}" not in ok[0]:
        raise AssertionError(f"dryrun_multichip({MULTI_PROCS}) on the card: rc "
                             f"{proc.returncode}\n{proc.stdout[-2000:]}\n{proc.stderr[-3000:]}")
    out["d_dryrun"] = {"line": ok[0], "seconds": time.perf_counter() - t0}
    out["seconds"] = time.perf_counter() - t_phase
    _emit(out)
    return launches


# ---------------------------------------------------------------------------
# 16. learning: the port learns, is finetuned, exported and served on the card
# ---------------------------------------------------------------------------

#: the overfit run (``tools/torch_overfit_sanity.py``): 32 images of its
#: data (seed 7), all in one batch, from the port's ``init_params(seed=0)``;
#: the steps of its evals and the least train mAP there (None: recorded
#: beside the tool's ``--map-target``, not held: when a run memorizes moves
#: with the draw, in either package,
#: ``tests/torch_overfit_witness.py``; the JAX package's record on its chip
#: is 0.97 at step 2000)
LEARN_IMAGES = 32
LEARN_EVALS = {300: None, 2000: 0.90}
LEARN_MAP_TARGET = 0.5
#: steps left out of the median ms a step
LEARN_WARMUP = 10
#: the QAT finetune of the overfit state (``tools/torch_qat_finetune.py``)
LEARN_QAT_ARGS = ["--epochs", "10", "--batch-size", "32", "--calib-images", "32", "--lr", "1e-4"]
#: the least float mAP, and how far under it PTQ and QAT int8 may fall
LEARN_FLOAT_MAP = 0.90
LEARN_INT8_GAP = 0.05
#: the served bundle's mAP against the QAT tool's int8 mAP: the same int8
#: network, its softmax taken lazily (``reduce_head_maps``)
LEARN_SERVED_GAP = 1e-3


def _tool(name: str):
    """A module of ``tools/`` (scripts, not a package) by name."""
    import importlib

    tools = str(Path(__file__).resolve().parent / "tools")
    if tools not in sys.path:
        sys.path.insert(0, tools)
    return importlib.import_module(name)


def _launch_delta(run):
    """``run()`` and the kernels it launched, read without setting any
    count to 0 (inside a :func:`counted` run): ``(result, {kernel: n})``."""
    wrappers = _launch_counts()
    before = {name: fn.launches for name, fn in wrappers.items()}
    result = run()
    return result, {name: fn.launches - before[name] for name, fn in wrappers.items()}


def overfit_run(device):
    """Phase 16 (a): ``torch_overfit_sanity``'s functions as its ``main``
    wires them, with the evals of :data:`LEARN_EVALS` -> ``(cfg, state,
    batch, report, launches of each eval)``."""
    import io

    import numpy as np
    import torch

    from ssd_tensorflow_tpu_torch.models.ssd_vgg import init_params

    ov = _tool("torch_overfit_sanity")
    t0 = time.perf_counter()
    batch = ov.first_batch(ov.make_dataset(LEARN_IMAGES, np.random.default_rng(7)),
                           LEARN_IMAGES)
    cfg = ov.train_config()  # vgg300, bf16, lr 1e-3
    params = init_params(cfg.model, seed=0)
    state, train_step, eval_step = ov.setup(cfg, params, device)
    spans, losses = [], []

    def timed_step(state, batch):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        out = train_step(state, batch)
        end.record()
        spans.append((start, end))
        losses.append(torch.stack(list(out[1].values())))
        return out

    logged, evals, launches, done, printed = [], {}, {}, 0, io.StringIO()
    for stop, least in LEARN_EVALS.items():
        with contextlib.redirect_stdout(printed):
            state, log = ov.train(state, timed_step, batch, stop - done, first=done)
        logged += log
        done = stop
        before = {n: {k: v.clone() for k, v in d.items()} for n, d in state.params.items()}
        with recording_detect() as rec:
            (aps, mAP, _), n = counted(lambda: ov.evaluate(eval_step, state.params, batch))
        if not all(torch.equal(before[name][k], v) for name, d in state.params.items()
                   for k, v in d.items()):
            raise AssertionError(f"the overfit eval at step {stop} changed the parameters")
        del before
        if (n["nms_keep"] != 1 or n["fused_stem"] or n["fused_stem_uint8"] or n["int8_conv"]
                or n["int8_qconv"]):
            raise AssertionError(f"the overfit eval at step {stop} launched {n}")
        launches[stop] = n
        evals[stop] = {"mAP": mAP, "least": least,
                       "meets_map_target": bool(mAP >= LEARN_MAP_TARGET),
                       "aps": aps, **check_detect(rec, f"overfit eval at {stop}")}
        if least is not None and not mAP >= least:
            raise AssertionError(f"overfit train mAP {mAP} after {stop} steps, below {least}; "
                                 f"losses every 50 steps: {logged}")
    torch.cuda.synchronize()
    if not bool(torch.isfinite(torch.stack(losses)).all()):
        raise AssertionError(f"non-finite overfit losses: {logged}")
    step_ms = [a.elapsed_time(b) for a, b in spans]
    report = {"init": "init_params(seed=0)", "preset": cfg.model.preset_name,
              "dtype": cfg.model.compute_dtype,
              "images": LEARN_IMAGES, "batch": LEARN_IMAGES, "lr": cfg.lr_values[0],
              "steps": done, "losses_every_50": logged, "losses_finite": True,
              "evals": evals, "evals_left_parameters_unchanged": True,
              "ms_per_step_median": float(np.median(step_ms[LEARN_WARMUP:])),
              "ms_per_step_mean": float(np.mean(step_ms[LEARN_WARMUP:])),
              "first_step_ms": step_ms[0], "seconds": time.perf_counter() - t0}
    return cfg, state, batch, report, launches


def qat_finetune_run(cfg, state, batch, tmp: Path, device):
    """Phase 16 (b): the overfit state saved with the port's
    ``CheckpointManager``, its images staged as both splits of a dataset,
    and ``torch_qat_finetune.main`` on them -> ``(report, QAT checkpoint,
    launches of main)``."""
    import io

    import numpy as np

    from ssd_tensorflow_tpu_torch.data import pipeline
    from ssd_tensorflow_tpu_torch.inference import model_config_to_dict
    from ssd_tensorflow_tpu_torch.ops import postprocess
    from ssd_tensorflow_tpu_torch.utils.checkpoint import CheckpointManager, checkpoint_config

    ov, qf = _tool("torch_overfit_sanity"), _tool("torch_qat_finetune")
    t0 = time.perf_counter()
    project, output = tmp / "overfit", tmp / "overfit_qat"
    mgr = CheckpointManager(str(project), {
        "model": model_config_to_dict(cfg.model),
        "lid2name": {str(k): v for k, v in ov.LID2NAME.items()}})
    try:
        mgr.save(1, state)
    finally:
        mgr.close()
    data = staged_dataset(tmp / "overfit_data", 0, preset=cfg.model.preset_name,
                          splits={"train": batch, "valid": batch}, names=ov.LID2NAME)
    evals, epochs, keeps = [], [], []
    real_eval, real_finetune, real_keep = qf.evaluate, qf.finetune, postprocess._keep

    def evaluate(*args, **kw):
        mAP, n = _launch_delta(lambda: real_eval(*args, **kw))
        evals.append({"mAP": mAP, "launches": n})
        return mAP

    def finetune(*args, **kw):
        out = real_finetune(*args, **kw)
        epochs.extend(out[1])
        return out

    def keep(*args):
        out = real_keep(*args)
        keeps.append((args, out))
        return out

    argv = ["--name", str(project), "--data-dir", data, *LEARN_QAT_ARGS, "--output", str(output),
            "--device", device.type]
    printed = io.StringIO()
    with mock.patch.object(pipeline, "_SampleProcessor", StagedProcessor), \
            mock.patch.object(qf, "evaluate", evaluate), \
            mock.patch.object(qf, "finetune", finetune), \
            mock.patch.object(postprocess, "_keep", keep), contextlib.redirect_stdout(printed):
        rc, launches = counted(lambda: qf.main(argv))
    ckpt = str(output / "final.ckpt.npz")
    if rc != 0:
        raise AssertionError(f"torch_qat_finetune exited {rc}:\n{printed.getvalue()[-3000:]}")
    n_convs = len(checkpoint_config(ckpt)["qat_act_scales"])
    maps = [e["mAP"] for e in evals]
    n_epochs = int(LEARN_QAT_ARGS[LEARN_QAT_ARGS.index("--epochs") + 1])
    if len(evals) != 3 or len(epochs) != n_epochs or not np.isfinite(epochs).all():
        raise AssertionError(f"QAT finetune: mAPs {maps}, epoch losses {epochs}")
    m_float, m_ptq, m_qat = maps
    for e, int8 in zip(evals, (0, n_convs, n_convs)):
        n = e["launches"]
        if (n["nms_keep"] != 1 or n["int8_qconv"] != int8 or n["int8_conv"]
                or n["fused_stem"] or n["fused_stem_uint8"]):
            raise AssertionError(f"QAT finetune eval launched {n} (int8 convs {int8})")
    if (launches["nms_keep"] != 3 or launches["int8_qconv"] != 2 * n_convs
            or launches["int8_conv"]):
        raise AssertionError(f"torch_qat_finetune.main launched {launches}")
    kept = [check_keep({"keep": k}, "QAT finetune eval")["kept"] for k in keeps]
    if len(kept) != 3:
        raise AssertionError(f"{len(kept)} NMS stages recorded for 3 evals")
    if not (m_float >= LEARN_FLOAT_MAP and m_ptq >= m_float - LEARN_INT8_GAP
            and m_qat >= m_float - LEARN_INT8_GAP):
        raise AssertionError(f"QAT finetune mAPs float {m_float}, PTQ {m_ptq}, QAT {m_qat}: "
                             f"float must reach {LEARN_FLOAT_MAP}, int8 stay within "
                             f"{LEARN_INT8_GAP} of it")
    report = {"args": LEARN_QAT_ARGS, "valid_map": {"float": m_float, "ptq_int8": m_ptq,
                                                    "qat_int8": m_qat},
              "epoch_losses": epochs, "int8_convs": n_convs,
              "evals_launches": [e["launches"] for e in evals], "nms_kept": kept,
              "keep_bit_exact": True, "seconds": time.perf_counter() - t0}
    return report, ckpt, launches


def served_bundle_run(ckpt, batch, m_qat, tmp: Path, device):
    """Phase 16 (c): the QAT checkpoint exported by ``cli/export_model.py
    --quantize`` (calibration patched to raise) and served by
    ``InferenceModel.from_bundle(...).run_scores`` -> ``(report, launches)``."""
    import torch

    from ssd_tensorflow_tpu_torch.cli import export_model
    from ssd_tensorflow_tpu_torch.inference import InferenceModel, load_bundle
    from ssd_tensorflow_tpu_torch.ops.postprocess import DetectionConfig, detections_to_boxes
    from ssd_tensorflow_tpu_torch.utils.checkpoint import checkpoint_config

    t0 = time.perf_counter()
    bundle = str(tmp / "overfit_qat.ssdtpu.npz")
    with no_calibration():
        rc, printed = _run_cli(export_model, ["--checkpoint-file", ckpt, "--output-file", bundle,
                                              "--quantize", "--device", device.type])
    if rc != 0:
        raise AssertionError(f"export_model --quantize exited {rc}:\n{printed[-3000:]}")
    stored = checkpoint_config(ckpt)["qat_act_scales"]
    if load_bundle(bundle)[3] != stored:
        raise AssertionError("the exported bundle's activation scales are not the checkpoint's")
    model = InferenceModel.from_bundle(
        bundle, device=device, detection=DetectionConfig(top_k=200, confidence_threshold=0.01))
    images = torch.from_numpy(batch["images"]).to(device)
    with recording_detect() as rec:
        dets, launches = counted(lambda: model.run_scores(images))
    if (launches["nms_keep"] != 1 or launches["int8_qconv"] != len(stored) or launches["int8_conv"]
            or launches["fused_stem"] or launches["fused_stem_uint8"]):
        raise AssertionError(f"the served bundle launched {launches}")
    keep = check_keep(rec, "served bundle")
    _, served = _tool("torch_overfit_sanity").train_map(
        detections_to_boxes(dets, model.lid2name), batch)
    if not abs(served - m_qat) <= LEARN_SERVED_GAP:
        raise AssertionError(f"the served bundle's mAP {served} is not the QAT tool's {m_qat}")
    return {"scales_equal_checkpoint": True, "int8_convs": len(stored), "mAP": served,
            "gap_to_qat_int8": served - m_qat, "launches": launches, **keep,
            "seconds": time.perf_counter() - t0}, launches


def learning_path(device):
    """Phase 16: (a) the overfit run, (b) its QAT finetune, (c) its export
    and serving (see the module doc) -> the launches of each path."""
    import tempfile

    import torch

    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    cfg, state, batch, overfit, eval_launches = overfit_run(device)
    overfit["peak_mem_gib"] = torch.cuda.max_memory_allocated() / 2**30
    with tempfile.TemporaryDirectory() as tmp:
        qat, ckpt, qat_launches = qat_finetune_run(cfg, state, batch, Path(tmp), device)
        del state
        served, served_launches = served_bundle_run(ckpt, batch, qat["valid_map"]["qat_int8"],
                                                    Path(tmp), device)
    _emit({"phase": "learning", "overfit": overfit, "qat_finetune": qat,
           "served_bundle": served, "seconds": time.perf_counter() - t0,
           "peak_mem_gib": torch.cuda.max_memory_allocated() / 2**30})
    overfit_eval = {k: sum(n[k] for n in eval_launches.values())
                    for k in next(iter(eval_launches.values()))}
    return {"learning:overfit_eval": overfit_eval, "learning:qat_eval": qat_launches,
            "learning:served_bundle": served_launches}


#: RetinaNet's configuration file, as the benchmark's cell serves it
RETINA_CONFIG = "h100bench/configs/retinanet800-resnext50fpn-bf16.json"


def retina_path(root: Path, seed: int, batch: int, device):
    """Phase 17: RetinaNet (retina800, bf16, the benchmark's configuration
    and its seeded weights) through ``InferenceModel.run_scores`` on a batch
    of the benchmark's staged images, with every counter set to 0 just
    before the call and read just after: NMS once (the device-memory route,
    D = 5,000), 16 grouped convs, 10 head calls and no other kernel; the
    recorded keep mask equal to ``nms_keep_plain`` on the same candidates;
    each image ``min(max_detections, NMS survivors)`` valid rows, finite, in
    descending score order; the candidates sent to NMS per image
    (``retina_select.candidates``). Its ms a batch, images/s and peak
    memory."""
    import torch

    sys.path.insert(0, str(root / "h100bench"))
    from benchlib import pool
    from reference import retinanet_resnext50fpn as ref

    from ssd_tensorflow_tpu_torch.inference import InferenceModel, model_config_from_dict
    from ssd_tensorflow_tpu_torch.models import layers, resnext_fpn
    from ssd_tensorflow_tpu_torch.ops import postprocess
    from ssd_tensorflow_tpu_torch.ops.postprocess import DetectionConfig
    from ssd_tensorflow_tpu_torch.timing import cuda_event_ms

    cfg = json.loads((root / RETINA_CONFIG).read_text())
    det = DetectionConfig(**cfg["detection"])
    model = InferenceModel(ref.seeded_params(cfg, seed, device),
                           model_config_from_dict(cfg["model"]), detection=det, device=device)
    augment = json.loads((root / "h100bench/traffic/serve-b64.json").read_text())["augment"]
    images = pool.images(batch, cfg["preset"]["image_size"], augment, seed, device)
    model.run_scores(images)  # cuDNN's plans, outside the counted call
    rec, keep = {}, postprocess._keep

    def record_keep(*args):
        rec["keep"] = (args, keep(*args))
        return rec["keep"][1]

    layers.grouped_conv.calls = resnext_fpn.retina_head.calls = 0
    postprocess.retina_select.candidates = 0
    torch.cuda.reset_peak_memory_stats()
    with mock.patch.object(postprocess, "_keep", record_keep):
        dets, launches = counted(lambda: model.run_scores(images))
    peak_mem_gib = torch.cuda.max_memory_allocated() / 2**30
    calls = {"grouped_conv": layers.grouped_conv.calls,
             "retina_head": resnext_fpn.retina_head.calls}
    others = {k: n for k, n in launches.items() if k != "nms_keep" and n}
    if launches["nms_keep"] != 1 or others or calls != {"grouped_conv": 16, "retina_head": 10}:
        raise AssertionError(f"retina800: launches {launches}, calls {calls}")
    kept = check_keep(rec, "retina800")
    (_, _, valid, _), keep_mask = rec["keep"]
    sent = valid.sum(dim=1)
    if int(postprocess.retina_select.candidates) != int(sent.sum()):
        raise AssertionError("retina800: retina_select.candidates disagrees with the candidates "
                             "NMS got")
    rows = dets.valid.sum(dim=1)
    want_rows = keep_mask.sum(dim=1).clamp_max(det.max_detections)
    if not torch.equal(rows, want_rows):
        raise AssertionError(f"retina800: valid rows {rows.tolist()} are not min("
                             f"{det.max_detections}, NMS survivors) {want_rows.tolist()}")
    v = dets.valid
    scores = torch.where(v, dets.scores, torch.zeros_like(dets.scores))
    if not (torch.isfinite(dets.scores[v]).all() and torch.isfinite(dets.boxes[v]).all()
            and bool((scores[:, 1:] <= scores[:, :-1]).all())):
        raise AssertionError("retina800: non-finite or unsorted detections")
    batch_ms = cuda_event_ms(lambda: model.run_scores(images), iters=3, warmup=1)
    _emit({"phase": "retina_path", "preset": cfg["model"]["preset_name"], "batch": batch,
           "launches": launches, "calls": calls, **kept,
           "candidates_per_image": {"min": int(sent.min()), "median": int(sent.median()),
                                    "max": int(sent.max())},
           "survivors_per_image": {"min": int(keep_mask.sum(1).min()),
                                   "max": int(keep_mask.sum(1).max())},
           "rows_per_image": {"min": int(rows.min()), "max": int(rows.max())},
           "batch_ms": batch_ms, "images_per_s": batch / batch_ms * 1e3,
           "peak_mem_gib": peak_mem_gib})
    return launches


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--batch", type=int, default=64)
    ap.add_argument("--worker", nargs=2, metavar=("MODE", "PAYLOAD"), help=argparse.SUPPRESS)
    args = ap.parse_args(argv)

    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: torch.cuda.is_available() is False; this check needs a GPU",
              file=sys.stderr)
        return 2
    if args.worker:  # one process of phase 15's gloo runs
        return run_worker(args.worker[0], json.loads(args.worker[1]))
    sys.path.insert(0, str(Path(__file__).resolve().parent))
    import numpy as np

    from ssd_tensorflow_tpu_torch.inference import InferenceModel
    from ssd_tensorflow_tpu_torch.models import ssd_vgg
    from ssd_tensorflow_tpu_torch.ops import _build, stem_cuda, stem_probe

    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    device = torch.device("cuda")

    # 1. device and build
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True, check=True).stdout.strip().splitlines()
    print(smi[0], flush=True)
    t0 = time.perf_counter()
    _build.libraries()
    ptxas = {name: [ln.strip() for ln in _build.build_log(name).splitlines()
                    if "registers" in ln or "spill" in ln or "Performance Loss" in ln]
             for name in _build.SOURCES}
    _emit({"phase": "build", "seconds": time.perf_counter() - t0, "ptxas": ptxas,
           "torch": torch.__version__, "cuda": torch.version.cuda,
           "cudnn": torch.backends.cudnn.version()})

    cfg = ssd_vgg.ModelConfig(preset_name="vgg512", num_classes=20, compute_dtype="bfloat16")
    params = ssd_vgg.init_params(cfg, seed=args.seed)
    model = InferenceModel(params, cfg, device=device)
    rng = np.random.default_rng(args.seed)
    size = cfg.preset.image_size
    images = torch.from_numpy(
        rng.integers(0, 256, (args.batch, size.h, size.w, 3), dtype=np.uint8)).to(device)

    # 2. the conv epilogue repair
    conv_epilogue(model, images, args.seed)

    # 3. each kernel against its plain version at its path's shapes
    with torch.inference_mode():
        kernels = [*check_nms(rng, args.batch, device), check_stem(model.params, images),
                   *check_whole_stems(model.params, images), *check_probes(args.seed, device)]
    _emit({"phase": "kernels", "checked": [k["name"] for k in kernels]})

    # 4. the paths, each counted on its own
    launches = {
        "dma": detection_path(model, images, args.batch),
        "uint8": detection_path(
            InferenceModel(params, cfg, overrides={"pallas_stem_variant": "uint8"},
                           device=device), images, args.batch),
    }
    # 5. the shipped int8 bundle
    launches["int8"] = int8_path(Path(__file__).resolve().parent / INT8_BUNDLE, images,
                                 args.batch, device)
    # 6. the training step
    launches["train"], bare_step_ms = train_path(args.seed, device)
    # 7.-9. the two other families, int8 and float, and the real images
    root = Path(__file__).resolve().parent
    for name in FAMILY_BUNDLES:
        launches[f"family_int8:{name}"] = family_int8_path(name, root, args.seed, args.batch,
                                                           device)
    for name in FAMILY_BUNDLES:
        launches[f"family_float:{name}"] = family_float_path(name, root, args.seed, args.batch,
                                                             device)
    launches.update({f"real_images:{k}": v for k, v in real_images(root, device).items()})
    # 10.-11. the on-device augmentation and the QAT finetune path
    launches["device_augment"] = device_augment_path(args.seed, device)
    for name in QAT_RUNS:
        launches.update(qat_path(name, root, args.seed, device))
    # 12.-13. the one-rank NCCL group, remat, prefetch, and the train CLI
    parallel_path(args.seed, device)
    launches["train_cli"] = train_cli_path(args.seed, device, bare_step_ms)
    # 14. the serving and evaluation CLIs
    launches.update({f"serving_cli:{k}": v for k, v in serving_cli_path(root, device).items()})
    # 15. data-parallel serving, tensor parallelism and the dry run
    launches.update({f"multichip:{k}": v
                     for k, v in multichip_path(root, args.seed, device, bare_step_ms).items()})
    # 16. the port learns: overfit, QAT finetune, export and serve
    launches.update(learning_path(device))
    # 17. RetinaNet's serving path
    launches["retina800"] = retina_path(root, args.seed, args.batch, device)
    with torch.inference_mode():
        _, launches["fused_stem_pallas"] = counted(
            lambda: stem_cuda.fused_stem_pallas(model.params, images, MEAN_BGR))
        a1, w1, w2 = stem_probe.probe_inputs(args.seed, device)
        for v in stem_probe.PROBE_VARIANTS:
            _, launches[f"stem_probe:{v}"] = counted(
                lambda v=v: stem_probe.stem_probe(a1, w1, w2, v))
        del a1
        x = torch.randn((36, 1536), device=device).to(torch.bfloat16)
        _, launches["lane_unflatten_sum"] = counted(lambda: stem_probe.lane_unflatten_sum(x))
    _emit({"phase": "paths", "launches": launches})
    path_of = {"nms_keep": ("dma", "nms_keep"), "fused_stem": ("dma", "fused_stem"),
               "fused_stem_uint8": ("uint8", "fused_stem_uint8"),
               "nms_keep_global": ("retina800", "nms_keep"),
               "fused_stem_pallas": ("fused_stem_pallas", "fused_stem"),
               "lane_unflatten_sum": ("lane_unflatten_sum", "lane_unflatten_sum")}
    for k in kernels:
        path, counter = path_of.get(k["name"], (k["name"], "stem_probe"))
        k["launches"] = launches[path][counter]
        if k["launches"] < 1:
            raise AssertionError(f"{k['name']} was not launched on its path {path}")
        # every path that launched it, with its launches there
        k["launched_by"] = {p: n[counter] for p, n in launches.items()
                            if n.get(counter) and (counter != "stem_probe" or p == path)}

    _emit({"kernels": kernels})
    import torch.distributed as dist

    if dist.is_initialized():
        dist.destroy_process_group()
    _emit({"ok": True, "device": {"platform": "gpu", "kind": torch.cuda.get_device_name(0),
                                  "count": torch.cuda.device_count()}})
    return 0


if __name__ == "__main__":
    sys.exit(main())
