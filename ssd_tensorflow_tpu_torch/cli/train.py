"""The training CLI, as the JAX package's ``cli/train.py``.

    python -m ssd_tensorflow_tpu_torch.cli.train --data-dir <dir> [flags]
    torchrun --nproc-per-node N -m ssd_tensorflow_tpu_torch.cli.train ...

The same flags, epochs, summaries and checkpoints as the JAX package's
CLI, plus ``--device`` (``cuda`` unless asked for ``cpu``). It reads the
dataset directory that ``process_dataset.py`` writes, and writes and
resumes checkpoints in the JAX package's npz format. Under ``torchrun``
each process drives one card (``parallel/mesh.py``): it takes a
contiguous shard of the sample lists, truncated so that every process runs
the same number of steps, feeds ``batch_size / world`` rows a step, and
the train step averages the gradients over the group. Only rank 0 writes
checkpoints; every rank writes its own summaries.

``--checkpoint-backend orbax`` and ``--profiler-port`` have no counterpart
here (ROADMAP.md queue 1 item 11) and exit 1.
"""

from __future__ import annotations

import argparse
import math
import multiprocessing as mp
import os
import signal
import sys

import numpy as np
import torch
import torch.distributed as dist

from ssd_tensorflow_tpu_torch.data.pipeline import TrainingData
from ssd_tensorflow_tpu_torch.eval.average_precision import APCalculator, APs2mAP
from ssd_tensorflow_tpu_torch.models.ssd_vgg import ModelConfig, init_params
from ssd_tensorflow_tpu_torch.models.vgg16 import load_pretrained_vgg
from ssd_tensorflow_tpu_torch.ops.anchors import anchors_for_preset
from ssd_tensorflow_tpu_torch.ops.postprocess import DetectionConfig, detections_to_boxes
from ssd_tensorflow_tpu_torch.parallel.mesh import make_mesh, mesh_device, world
from ssd_tensorflow_tpu_torch.parallel.multihost import (
    local_rows,
    local_rows_many,
    process_shard,
)
from ssd_tensorflow_tpu_torch.parallel.prefetch import prefetch_to_device
from ssd_tensorflow_tpu_torch.parallel.train_step import (
    TrainConfig,
    make_eval_step,
    make_train_state,
    make_train_step,
    shard_state,
)
from ssd_tensorflow_tpu_torch.types import Box, Point, Size, str2bool
from ssd_tensorflow_tpu_torch.utils.checkpoint import (
    CheckpointManager,
    checkpoint_config,
    find_checkpoint,
    restore_checkpoint,
)
from ssd_tensorflow_tpu_torch.utils.profiling import StepTimer, trace
from ssd_tensorflow_tpu_torch.utils.summaries import (
    ImageSummary,
    LossSummary,
    NetSummary,
    PrecisionSummary,
)
from ssd_tensorflow_tpu_torch.utils.tensorboard import SummaryWriter
from ssd_tensorflow_tpu_torch.weights import params_to_jax

_REFUSED = ("has no counterpart in the PyTorch port (ROADMAP.md queue 1 item 11: {why})")


def build_parser():
    parser = argparse.ArgumentParser(description="Train the SSD")
    parser.add_argument("--name", default="test", help="project name")
    parser.add_argument("--data-dir", default="pascal-voc", help="data directory")
    parser.add_argument("--vgg-dir", default="vgg_graph",
                        help="directory holding vgg16.npz pretrained weights (optional)")
    parser.add_argument("--epochs", type=int, default=200, help="number of epochs")
    parser.add_argument(
        "--epochs-per-run", type=int, default=0,
        help="stop (with a resumable final checkpoint, exit 0) after this many epochs in this "
        "process; 0 = no per-process cap. Rerun with --continue-training until --epochs is "
        "reached")
    parser.add_argument("--batch-size", type=int, default=8, help="batch size")
    parser.add_argument("--tensorboard-dir", default="tb", help="tensorboard data directory")
    parser.add_argument("--checkpoint-interval", type=int, default=5,
                        help="checkpoint interval")
    parser.add_argument(
        "--checkpoint-backend", default="npz", choices=["npz", "orbax"],
        help="npz: single-file e{N}.ckpt.npz archives. orbax: refused (a JAX library)")
    parser.add_argument("--lr-values", type=str, default="0.00075;0.0001;0.00001",
                        help="learning rate values")
    parser.add_argument("--lr-boundaries", type=str, default="320000;400000",
                        help="learning rate change boundaries (in batches)")
    parser.add_argument("--momentum", type=float, default=0.9, help="momentum")
    parser.add_argument("--weight-decay", type=float, default=0.0005,
                        help="L2 normalization factor")
    parser.add_argument("--continue-training", type=str2bool, default="False",
                        help="continue training from the latest checkpoint")
    parser.add_argument("--num-workers", type=int, default=mp.cpu_count(),
                        help="number of parallel data workers")
    parser.add_argument("--compute-dtype", default="bfloat16", choices=["bfloat16", "float32"],
                        help="conv compute precision")
    parser.add_argument("--data-parallel", type=int, default=0,
                        help="data-parallel mesh size (0 = every process of the group)")
    parser.add_argument(
        "--qat", type=str2bool, default="False",
        help="quantization-aware training: train through the int8 fake-quantizer "
        "(models/qat.py; forces --compute-dtype float32; activation scales calibrate on the "
        "first validation batches)")
    parser.add_argument(
        "--device-augment", type=str2bool, default="False",
        help="run the SSD augmentation chain on the device (the host only decodes + resizes; "
        "data/device_augment.py)")
    parser.add_argument("--augment-seed", type=int, default=0,
                        help="seed of the on-device augmentation")
    parser.add_argument(
        "--cache-images", type=str2bool, default="False",
        help="cache decoded images in RAM across epochs (identical pixels, no re-decode; size "
        "the dataset's decoded bytes against available memory before enabling)")
    parser.add_argument("--profile-dir", default=None,
                        help="write a torch.profiler trace of one step to this directory")
    parser.add_argument("--profiler-port", type=int, default=0,
                        help="a live profiler server port: refused (0 = off)")
    parser.add_argument("--device", default="cuda", choices=["cuda", "cpu"],
                        help="where to train (one card per process under torchrun)")
    return parser


def _gt_box_lists(gt_boxes, gt_labels, gt_mask, lid2name, num_real):
    """Fixed-shape ``(B, G, ...)`` gt arrays -> per-image Box lists (for
    the AP accounting when the ground truth was augmented on the device)."""
    out = []
    for i in range(num_real):
        boxes = []
        for j in np.nonzero(gt_mask[i])[0]:
            cx, cy, w, h = (float(v) for v in gt_boxes[i, j])
            lid = int(gt_labels[i, j])
            boxes.append(Box(lid2name[lid], lid, Point(cx, cy), Size(w, h)))
        out.append(boxes)
    return out


def _losses_for_summary(losses, batch_size, num_real):
    """Rescale batch-mean losses to per-real-sample means (padded rows
    contribute zero conf/loc; l2 is batch-independent)."""
    a = batch_size / max(num_real, 1)
    conf = float(losses["confidence"]) * a
    loc = float(losses["localization"]) * a
    l2 = float(losses["l2"])
    return {"confidence": conf, "localization": loc, "l2": l2, "total": conf + loc + l2}


def _host_losses(pending):
    """``[(losses, num_real)]`` of device scalars -> host floats, in one
    transfer."""
    if not pending:
        return []
    keys = sorted(pending[0][0])
    flat = local_rows(torch.stack([losses[k].float() for losses, _ in pending for k in keys]))
    flat = flat.reshape(len(pending), len(keys))
    return [(dict(zip(keys, row.tolist())), n) for row, (_, n) in zip(flat, pending)]


def main(argv=None):
    args = build_parser().parse_args(argv)

    for k, v in sorted(vars(args).items()):
        print(f"[i] {k.replace('_', ' ').capitalize():24s}: {v}")

    if args.checkpoint_backend == "orbax":
        print("[!] --checkpoint-backend orbax " + _REFUSED.format(
            why="orbax is a JAX library; npz checkpoints are the port's format"))
        return 1
    if args.profiler_port:
        print("[!] --profiler-port " + _REFUSED.format(
            why="torch.profiler has no live server; use --profile-dir"))
        return 1

    # ------------------------------------------------------------------
    # The process group (torchrun) and the device
    # ------------------------------------------------------------------
    mesh = make_mesh(data=args.data_parallel or None, device=args.device)
    device = mesh_device(mesh, args.device)
    rank, n_proc = world()

    # ------------------------------------------------------------------
    # Resume or fresh start
    # ------------------------------------------------------------------
    start_epoch = 0
    checkpoint_file = None
    if args.continue_training:
        checkpoint_file, last_epoch = find_checkpoint(args.name)
        if checkpoint_file is None or last_epoch is None:
            print("[!] No network state found in " + args.name)
            return 1
        start_epoch = last_epoch
    else:
        os.makedirs(args.name, exist_ok=True)

    print("[i] Starting at epoch:    ", start_epoch + 1)

    # ------------------------------------------------------------------
    # Training data
    # ------------------------------------------------------------------
    if args.cache_images:
        from ssd_tensorflow_tpu_torch.data.transforms import enable_decode_cache

        enable_decode_cache(True)
        print("[i] Decode cache:          enabled (serial pipeline benefits most; fork workers "
              "each hold their own copy)")
    try:
        td = TrainingData(args.data_dir)
        print("[i] # training samples:   ", td.num_train)
        print("[i] # validation samples: ", td.num_valid)
        print("[i] # classes:            ", td.num_classes)
        print("[i] Image size:           ", td.preset.image_size)
    except (AttributeError, RuntimeError) as e:
        print("[!] Unable to load training data:", str(e))
        return 1

    # ------------------------------------------------------------------
    # Several processes: each owns a contiguous shard of the sample lists
    # and feeds batch_size / world rows a step. Every process must run the
    # same number of steps (a step is a collective): the shards are cut to
    # the shortest one's length.
    # ------------------------------------------------------------------
    local_batch_size = args.batch_size
    pre_shard_valid = td.valid_samples
    if n_proc > 1:
        if args.batch_size % n_proc:
            print(f"[!] batch size {args.batch_size} not divisible by {n_proc} processes")
            return 1
        local_batch_size = args.batch_size // n_proc
        train_len = len(td.train_samples) // n_proc
        valid_len = len(td.valid_samples) // n_proc
        td.train_samples = process_shard(td.train_samples)[:train_len]
        td.valid_samples = process_shard(td.valid_samples)[:valid_len]
        td.num_train = len(td.train_samples)
        td.num_valid = len(td.valid_samples)
        print(f"[i] Multi-process: process {rank}/{n_proc}, {td.num_train} local train "
              f"samples, local batch {local_batch_size}")

    # ------------------------------------------------------------------
    # Model + train step
    # ------------------------------------------------------------------
    lr_values = tuple(float(x) for x in args.lr_values.split(";") if x)
    lr_boundaries = tuple(int(x) for x in args.lr_boundaries.split(";") if x)
    if len(lr_values) != len(lr_boundaries) + 1:
        print("[!] need one more lr value than boundaries")
        return 1

    if args.qat and args.compute_dtype != "float32":
        print("[i] QAT forces --compute-dtype float32 (exact-integer math)")
        args.compute_dtype = "float32"
    model_cfg = ModelConfig(
        preset_name=td.preset.name,
        num_classes=td.num_classes,
        compute_dtype=args.compute_dtype,
        # QAT needs the large eps (models/qat.py); the value rides in the
        # checkpoint config so that deploy computes what QAT trained
        l2_norm_eps=1e-3 if args.qat else 1e-12,
    )
    train_cfg = TrainConfig(
        model=model_cfg,
        lr_values=lr_values,
        lr_boundaries=lr_boundaries,
        momentum=args.momentum,
        weight_decay=args.weight_decay,
        detect=DetectionConfig(confidence_threshold=0.5),
    )
    anchors = anchors_for_preset(td.preset)

    from ssd_tensorflow_tpu_torch.inference import model_config_to_dict

    config_dict = {
        "model": model_config_to_dict(model_cfg),
        "train": {
            "lr_values": list(lr_values),
            "lr_boundaries": list(lr_boundaries),
            "momentum": args.momentum,
            "weight_decay": args.weight_decay,
        },
        "lid2name": {str(k): v for k, v in td.lid2name.items()},
    }

    print("[i] Creating the model...")
    params = init_params(model_cfg, seed=0)
    vgg_npz = os.path.join(args.vgg_dir, "vgg16.npz")
    if model_cfg.preset.backbone != "vgg":
        pass  # --vgg-dir bootstrap only applies to the VGG family
    elif start_epoch == 0 and os.path.exists(vgg_npz):
        print("[i] Loading pretrained VGG weights from", vgg_npz)
        params = load_pretrained_vgg(vgg_npz, params)
    elif start_epoch == 0:
        print(f"[!] {vgg_npz} not found — training from random init")

    state = make_train_state(params, train_cfg, device=device)
    if checkpoint_file is not None:
        print("[i] Restoring checkpoint", checkpoint_file)
        state = restore_checkpoint(checkpoint_file, state)

    print(f"[i] Mesh: {dict(zip(('data', 'model'), (n_proc, 1)))} over {n_proc} process(es), "
          f"this one on {device}")
    state = shard_state(state, mesh)

    if args.qat:
        from ssd_tensorflow_tpu_torch.models import qat

        stored = checkpoint_config(checkpoint_file) if checkpoint_file is not None else None
        key = qat.qat_checkpoint_key(model_cfg)
        calib = None
        if (stored or {}).get(key) is not None:
            # resume: keep training against the quantizer the earlier
            # epochs optimized, never recalibrated on finetuned params
            print("[i] QAT: resuming with the checkpoint's activation scales")
        else:
            if not pre_shard_valid:
                print("[!] QAT needs validation images to calibrate int8 scales; re-run "
                      "process_dataset with --validation-fraction > 0")
                return 1
            # calibrate on the whole validation list: every process must
            # derive the same scales (valid_generator is deterministic)
            sharded_valid = td.valid_samples
            td.valid_samples = pre_shard_valid
            calib = []
            for batch, _, n in td.valid_generator(local_batch_size, num_workers=0):
                calib.append(batch["images"][:n])
                if sum(c.shape[0] for c in calib) >= 32:
                    break
            td.valid_samples = sharded_valid
            calib = np.concatenate(calib)[:32]
            print(f"[i] QAT: calibrating int8 scales on {calib.shape[0]} images")
        act_scales, entry = qat.qat_scales(state.params, model_cfg, stored, calib)
        # deploy with the scales QAT trained against: the checkpoints carry them
        config_dict.update(entry)
        qat_fwd = qat.make_qat_forward(model_cfg, act_scales)
        train_step = qat.make_qat_train_step(train_cfg, anchors, act_scales)
        # evaluate the network QAT optimizes, not the float one
        eval_step = make_eval_step(train_cfg, anchors, forward=qat_fwd)
    else:
        train_step = make_train_step(train_cfg, anchors)
        eval_step = make_eval_step(train_cfg, anchors)

    augment_fn = None
    if args.device_augment:
        from ssd_tensorflow_tpu_torch.data.device_augment import (
            augment_config_for,
            make_augment_fn,
            step_generator,
        )

        aug_cfg = augment_config_for(td.preset, td.augmentation)
        augment_fn = make_augment_fn(aug_cfg, anchors, rank=rank, world=n_proc)
        print("[i] On-device augmentation:  enabled")

    # ------------------------------------------------------------------
    # Summaries + checkpoints
    # ------------------------------------------------------------------
    writer = SummaryWriter(args.tensorboard_dir)
    ckpt_mgr = CheckpointManager(args.name, config_dict, max_to_keep=20) if rank == 0 else None

    training_ap_calc = APCalculator()
    validation_ap_calc = APCalculator()
    labels = list(td.lname2id.keys())
    training_ap = PrecisionSummary(writer, "training", labels)
    validation_ap = PrecisionSummary(writer, "validation", labels)
    training_imgs = ImageSummary(writer, "training", td.label_colors)
    validation_imgs = ImageSummary(writer, "validation", td.label_colors)
    training_loss = LossSummary(writer, "training", td.num_train)
    validation_loss = LossSummary(writer, "validation", td.num_valid)
    net_summary = NetSummary(writer)

    if start_epoch == 0:
        net_summary.push(0, params_to_jax(state.params))
        writer.flush()

    try:
        from tqdm import tqdm
    except ImportError:
        def tqdm(x, **kw):
            return x

    n_train_batches = td.num_train_batches(local_batch_size)
    n_valid_batches = td.num_valid_batches(local_batch_size)

    profiled = False
    # profile the second trained epoch (the first pays the warm-up) unless
    # the run spans one epoch
    profile_epoch = start_epoch + 1 if args.epochs - start_epoch > 1 else start_epoch

    # ------------------------------------------------------------------
    # Epoch loop. SIGTERM / SIGUSR1 finish the current epoch, write
    # final.ckpt.npz stamped with the reached epoch and exit 0: the handler
    # only sets a flag; the loop stops at an epoch boundary.
    # ------------------------------------------------------------------
    stop_requested = []

    def _request_stop(signum, frame):  # noqa: ARG001
        stop_requested.append(signum)
        print(f"\n[!] Signal {signum}: will checkpoint and exit after this epoch")

    for sig in (signal.SIGTERM, signal.SIGUSR1):
        try:
            signal.signal(sig, _request_stop)
        except ValueError:  # not the main thread
            break

    print("[i] Training...")
    completed_epoch = start_epoch
    for e in range(start_epoch, args.epochs):
        training_imgs_samples = []
        validation_imgs_samples = []

        timer = StepTimer()
        pending_losses = []  # device scalars; fetched once per epoch
        # a producer thread overlaps augmentation and the copy to the
        # device with the device's work
        generator = prefetch_to_device(
            td.train_generator(local_batch_size, args.num_workers, raw=augment_fn is not None),
            size=2, device=device, transform=lambda item: (item[0], (item[1], item[2])))
        description = "[i] Train {:>2}/{}".format(e + 1, args.epochs)
        for batch_i, (dev_batch, (gt_lists, num_real)) in enumerate(tqdm(
                generator, total=n_train_batches, desc=description, unit="batches")):
            if augment_fn is not None:
                dev_batch = augment_fn(step_generator(args.augment_seed, e, batch_i, device),
                                       dev_batch)

            # epoch 0 skips the AP and image accounting
            saved_images = None
            if e > 0 and len(training_imgs_samples) < 3:
                saved_images = local_rows(dev_batch["images"][:3])
            if args.profile_dir and not profiled and e >= profile_epoch:
                with trace(args.profile_dir):
                    state, losses, dets = train_step(state, dev_batch)
                profiled = True
                print("[i] Profiler trace written to", args.profile_dir)
            else:
                state, losses, dets = train_step(state, dev_batch)
            timer.step(num_real)
            pending_losses.append((losses, num_real))

            if e == 0:
                continue

            if augment_fn is not None:
                # the augmented geometry lives on the device
                gt_host = local_rows_many([dev_batch["gt_boxes"], dev_batch["gt_labels"],
                                           dev_batch["gt_mask"]])
                gt_lists = _gt_box_lists(*gt_host, td.lid2name, num_real)
            boxes_per_image = detections_to_boxes(dets, td.lid2name)
            for i in range(num_real):
                boxes = boxes_per_image[i]
                training_ap_calc.add_detections(gt_lists[i], boxes)
                if len(training_imgs_samples) < 3 and saved_images is not None:
                    training_imgs_samples.append((saved_images[i], boxes))

        for losses, num_real in _host_losses(pending_losses):
            if math.isnan(losses["confidence"]):
                print("[!] Confidence loss is NaN.")
            # the losses are means over the global batch; scale by the
            # global real count (the shards are equal)
            training_loss.add(_losses_for_summary(losses, args.batch_size, num_real * n_proc),
                              num_real)
        steps_s, imgs_s = timer.rates()
        print(f"[i] Epoch {e + 1} train throughput: {imgs_s:.1f} img/s ({steps_s:.2f} steps/s)")

        pending_losses = []
        generator = prefetch_to_device(
            td.valid_generator(local_batch_size, args.num_workers), size=2, device=device,
            transform=lambda item: (item[0], (item[1], item[2])))
        description = "[i] Valid {:>2}/{}".format(e + 1, args.epochs)
        for dev_batch, (gt_lists, num_real) in tqdm(
                generator, total=n_valid_batches, desc=description, unit="batches"):
            losses, dets = eval_step(state.params, dev_batch)
            pending_losses.append((losses, num_real))

            if e == 0:
                continue

            # only fetch images while summary slots remain
            host_images = (local_rows(dev_batch["images"])
                           if len(validation_imgs_samples) < 3 else None)
            boxes_per_image = detections_to_boxes(dets, td.lid2name)
            for i in range(num_real):
                boxes = boxes_per_image[i]
                validation_ap_calc.add_detections(gt_lists[i], boxes)
                if len(validation_imgs_samples) < 3:
                    validation_imgs_samples.append((host_images[i], boxes))

        for losses, num_real in _host_losses(pending_losses):
            validation_loss.add(_losses_for_summary(losses, args.batch_size, num_real * n_proc),
                                num_real)

        # -- summaries ----------------------------------------------------
        training_loss.push(e + 1)
        validation_loss.push(e + 1)
        net_summary.push(e + 1, params_to_jax(state.params))

        APs = training_ap_calc.compute_aps()
        mAP = APs2mAP(APs)
        training_ap.push(e + 1, mAP, APs)
        if e > 0:
            print(f"[i] Epoch {e + 1}: train mAP {mAP:.4f}", end="")

        APs = validation_ap_calc.compute_aps()
        mAP = APs2mAP(APs)
        validation_ap.push(e + 1, mAP, APs)
        if e > 0:
            print(f", valid mAP {mAP:.4f}")

        training_ap_calc.clear()
        validation_ap_calc.clear()
        training_imgs.push(e + 1, training_imgs_samples)
        validation_imgs.push(e + 1, validation_imgs_samples)
        writer.flush()

        if (e + 1) % args.checkpoint_interval == 0 and ckpt_mgr is not None:
            path = ckpt_mgr.save(e + 1, state)
            print("[i] Checkpoint saved:", path)

        completed_epoch = e + 1
        stop = bool(stop_requested)
        if dist.is_initialized():
            # a signal may reach some processes only: all stop, or none
            flag = torch.tensor([float(stop)], device=device)
            dist.all_reduce(flag, op=dist.ReduceOp.MAX)
            stop = bool(flag.item())
        if stop:
            break
        if args.epochs_per_run and completed_epoch - start_epoch >= args.epochs_per_run:
            print(f"[i] Per-process epoch budget reached ({args.epochs_per_run}); writing a "
                  f"resumable checkpoint at epoch {completed_epoch} (restart with "
                  "--continue-training)")
            break

    writer.close()
    if ckpt_mgr is not None:
        ckpt_mgr.save(completed_epoch, state, final=True)
        ckpt_mgr.close()
        print("[i] Checkpoint saved:", os.path.join(args.name, "final.ckpt.npz"))
    if dist.is_initialized():
        # the other ranks leave once rank 0's checkpoints are on disk
        dist.barrier()
    return 0


def run():
    """The console entry point: :func:`main`, then the process group (if
    ``main`` joined one) is left."""
    try:
        rc = main()
    finally:
        if dist.is_initialized():
            dist.destroy_process_group()
    sys.exit(rc)


if __name__ == "__main__":
    run()
