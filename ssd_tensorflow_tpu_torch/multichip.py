"""The one-device entry and the multichip dry run, as the JAX package's
``__graft_entry__.py``.

    python -c "from ssd_tensorflow_tpu_torch import multichip; multichip.dryrun_multichip(4)"

:func:`entry` is the vgg300 forward at batch 8 on one device.
:func:`dryrun_multichip` runs, over ``n`` processes, what the JAX
package's runs over ``n`` devices, in the same order, with the same shapes
and the same checks: a vgg300 float32 train step on a ``data x model``
mesh (``model`` 2 when ``n`` is even and at least 4: conv6 / conv7
tensor-parallel) fed by the on-device augmentation; data-parallel serving
of that model over ``n``; an rtest64 (ResNet family) train step; int8
data-parallel serving of its ``QuantizedModel``. It hosts itself: without
a launch it starts ``n`` gloo processes of this module
(``parallel/mesh.spawn``) on the visible cards, or on the CPU with
``device="cpu"`` (more processes than cards share a card: gloo takes CUDA
tensors for ``all_reduce`` and ``broadcast``); under a launch (``torchrun
--nproc-per-node n``) it runs in the launched group.
"""

from __future__ import annotations

import argparse
import os
import sys

import numpy as np
import torch
import torch.distributed as dist

from ssd_tensorflow_tpu_torch import resolve_device


def entry(device="cuda"):
    """A forward of the flagship model (vgg300 SSD, bf16): ``(fn,
    example_args)`` with the parameters and a zero uint8 batch of 8 on
    ``device``; ``fn(*example_args)`` is ``apply_result``'s ``(8, A, K+5)``
    result."""
    from ssd_tensorflow_tpu_torch.models.ssd_vgg import ModelConfig, apply_result, init_params

    dev = resolve_device(device)
    config = ModelConfig(preset_name="vgg300", num_classes=20)
    params = {name: {k: v.to(dev) for k, v in leaves.items()}
              for name, leaves in init_params(config, seed=0).items()}
    images = torch.zeros((8, 300, 300, 3), dtype=torch.uint8, device=dev)

    def fn(params, images):
        with torch.inference_mode():
            return apply_result(params, images, config)

    return fn, (params, images)


def _box_batch(rng, n: int, size: int) -> dict:
    return {
        "images": rng.integers(0, 255, (n, size, size, 3), dtype=np.uint8),
        "gt_boxes": np.tile(np.asarray([[0.5, 0.5, 0.4, 0.4]], np.float32), (n, 4, 1)),
        "gt_labels": np.zeros((n, 4), np.int32),
        "gt_mask": np.ones((n, 4), bool),
    }


def _dryrun(n_devices: int, device: str) -> str:
    """The dry run in a process of an ``n_devices`` group; returns the ok
    line."""
    from ssd_tensorflow_tpu_torch.data.device_augment import AugmentConfig, make_augment_fn
    from ssd_tensorflow_tpu_torch.inference import InferenceModel
    from ssd_tensorflow_tpu_torch.models.quantized import QuantizedModel
    from ssd_tensorflow_tpu_torch.models.ssd_vgg import ModelConfig, init_params
    from ssd_tensorflow_tpu_torch.ops.anchors import anchors_for_preset
    from ssd_tensorflow_tpu_torch.ops.postprocess import DetectionConfig
    from ssd_tensorflow_tpu_torch.parallel.mesh import make_mesh, mesh_device, world
    from ssd_tensorflow_tpu_torch.parallel.train_step import (
        TrainConfig,
        make_train_state,
        make_train_step,
        shard_batch,
        shard_state,
    )
    from ssd_tensorflow_tpu_torch.presets import get_preset_by_name

    # dp x tp mesh: a model dimension when the device count allows it
    model_axis = 2 if n_devices % 2 == 0 and n_devices >= 4 else 1
    mesh = make_mesh(data=n_devices // model_axis, model=model_axis, device=device)
    if world()[1] != n_devices or mesh is None:
        raise RuntimeError(f"dryrun_multichip({n_devices}) runs in a group of {n_devices} "
                           f"processes, this one has {world()[1]}")
    dev = mesh_device(mesh)

    cfg = TrainConfig(
        model=ModelConfig(preset_name="vgg300", num_classes=20, compute_dtype="float32"),
        detect=DetectionConfig(top_k=16, confidence_threshold=0.5),
    )
    anchors = anchors_for_preset(get_preset_by_name("vgg300"))
    params = init_params(cfg.model, seed=0)
    state = shard_state(make_train_state(params, cfg, device=dev), mesh,
                        tensor_parallel=model_axis > 1)

    batch_size = mesh.shape["data"]
    rng = np.random.default_rng(0)
    batch = shard_batch(_box_batch(rng, batch_size, 300), mesh)
    # the on-device augmentation under the same mesh: the global batch's
    # draws, each process applying its rows'
    augment = make_augment_fn(AugmentConfig(out_h=300, out_w=300, sampler_trials=4), anchors,
                              rank=mesh.coordinate["data"], world=mesh.shape["data"])
    batch = augment(torch.Generator(dev).manual_seed(1), batch)

    state, losses, dets = make_train_step(cfg, anchors)(state, batch)
    total = float(losses["total"])
    assert np.isfinite(total), f"non-finite loss in dry run: {total}"
    assert state.step == 1

    # data-parallel serving over the same processes
    serve_mesh = make_mesh(data=n_devices, device=device)
    serve = InferenceModel(params, cfg.model, detection=cfg.detect, mesh=serve_mesh)
    boxes = serve.detect_boxes(rng.integers(0, 255, (n_devices, 300, 300, 3), dtype=np.uint8))
    assert len(boxes) == n_devices

    # a ResNet-family train step under a data mesh
    fam_cfg = TrainConfig(
        model=ModelConfig(preset_name="rtest64", num_classes=20, compute_dtype="float32"),
        detect=DetectionConfig(top_k=16, confidence_threshold=0.5),
    )
    fam_anchors = anchors_for_preset(get_preset_by_name("rtest64"))
    fam_params = init_params(fam_cfg.model, seed=2)
    fam_mesh = make_mesh(data=n_devices, device=device)
    fam_state = shard_state(make_train_state(fam_params, fam_cfg, device=dev), fam_mesh)
    fam_state, fam_losses, _ = make_train_step(fam_cfg, fam_anchors)(
        fam_state, shard_batch(_box_batch(rng, n_devices, 64), fam_mesh))
    fam_total = float(fam_losses["total"])
    assert np.isfinite(fam_total), f"family dry-run loss: {fam_total}"

    # the int8 deploy path under the serving mesh
    calib = rng.integers(0, 255, (4, 64, 64, 3), dtype=np.uint8).astype(np.float32)
    qm = QuantizedModel(fam_params, fam_cfg.model, calib, device=dev)
    int8_serve = InferenceModel(qm.qparams, fam_cfg.model, detection=fam_cfg.detect,
                                act_scales=qm.act_scales, mesh=serve_mesh)
    int8_boxes = int8_serve.detect_boxes(
        rng.integers(0, 255, (n_devices, 64, 64, 3), dtype=np.uint8))
    assert len(int8_boxes) == n_devices

    shape = (dets.boxes.shape[0] * mesh.shape["data"], *dets.boxes.shape[1:])
    return (f"[i] dryrun_multichip ok: mesh={dict(mesh.shape)}, "
            f"loss={total:.4f}, detections shape={shape}, "
            f"dp-serving over {n_devices} devices ok, "
            f"family (rtest64) step loss={fam_total:.4f} ok, "
            f"int8 dp-serving over {n_devices} devices ok")


#: seconds the processes a dry run hosts have to finish
HOST_TIMEOUT = 1800.0


def _host(n_devices: int, device: str) -> None:
    """Start ``n_devices`` gloo processes of this module and wait for them;
    raises (after stopping the others) when one fails or
    ``HOST_TIMEOUT`` passes. Each process takes ``OMP_NUM_THREADS``
    threads, by default its share of the cores."""
    from ssd_tensorflow_tpu_torch.parallel.mesh import spawn

    threads = os.environ.get("OMP_NUM_THREADS") or str(max(1, (os.cpu_count() or 1)
                                                            // n_devices))
    root = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    env = dict(os.environ, OMP_NUM_THREADS=threads,
               PYTHONPATH=root + os.pathsep + os.environ.get("PYTHONPATH", ""))
    spawn(n_devices, [sys.executable, "-m", "ssd_tensorflow_tpu_torch.multichip",
                      str(n_devices), "--device", device, "--gloo"], HOST_TIMEOUT, env=env)


def dryrun_multichip(n_devices: int, device: str = "cuda") -> None:
    """Run the full training step, serving, the family step and int8
    serving over ``n_devices`` processes (see the module doc); rank 0
    prints the ok line. Without a launch, starts the processes itself on
    ``device``: the visible cards (raises without one), or ``cpu``."""
    from ssd_tensorflow_tpu_torch.parallel.mesh import launched

    if not (launched() or dist.is_initialized()):
        resolve_device(device)
        _host(n_devices, device)
        return
    line = _dryrun(n_devices, device)
    if dist.get_rank() == 0:
        print(line, flush=True)


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description="one process of dryrun_multichip")
    ap.add_argument("n_devices", type=int)
    ap.add_argument("--device", default="cuda", choices=["cpu", "cuda"])
    ap.add_argument("--gloo", action="store_true",
                    help="start a gloo group from the launch environment first")
    args = ap.parse_args(argv)
    from ssd_tensorflow_tpu_torch.parallel.mesh import local_device

    torch.set_num_threads(int(os.environ.get("OMP_NUM_THREADS", torch.get_num_threads())))
    if args.gloo:
        local_device(args.device)
        dist.init_process_group("gloo", rank=int(os.environ["RANK"]),
                                world_size=int(os.environ["WORLD_SIZE"]))
    try:
        dryrun_multichip(args.n_devices, args.device)
    finally:
        if dist.is_initialized():
            dist.destroy_process_group()
    return 0


if __name__ == "__main__":
    sys.exit(main())
